"""Errors, machine constants, rng and fixtures."""
