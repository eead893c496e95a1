"""Triangulation engines, the interpolation facade and families, the
geometry consumers.

The modules below are the ones the JAX package's ``models/__init__.py``
imports, so ``gsi.models.<module>`` resolves in both packages; the others
(the RBF and kriging family, ``device_cavity``, ``surface``, ``thinning``,
``convert``) are imported by name.
"""

from . import (  # noqa: F401
    device_delaunay,
    geometry_extras,
    device_tri,
    host_tree,
    interp1d,
    interp2d,
    scattered,
)
