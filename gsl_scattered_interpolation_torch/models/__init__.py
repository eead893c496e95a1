"""Triangulation engines and the interpolation facade."""
