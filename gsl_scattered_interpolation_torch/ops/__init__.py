"""Geometry and the wrappers of the hand-written GPU kernels."""
