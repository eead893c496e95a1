"""gsl_scattered_interpolation_torch — scattered-data interpolation in PyTorch.

The port of ``gsl_scattered_interpolation_tpu`` to PyTorch and CUDA on an
NVIDIA H100, built slice by slice (ROADMAP.md).  It imports neither JAX nor
the JAX package, which stays the reference its tests hold it against.

Layout:
  ops/       geometry, Morton order and the wrappers of the hand-written
             kernels
  models/    triangulation engines and the ScatteredInterp facade; the RBF
             and kriging family: rbf (RbfInterp), rbf_compact
             (CompactRbf), rbf_pu (partition-of-unity thin-plate fit and
             evaluate), kriging (OrdinaryKriging, LocalKriging); the GSL
             structured family: interp1d (Interp1D, Spline1D), interp2d
             (Interp2D, Spline2D); the geometry consumers: geometry_extras
             (hull, Voronoi, Qhull import), surface (alpha shapes),
             thinning; convert (fitted JAX state into the port's)
  kernels/   CUDA sources (csrc/) and their nvcc build
  parallel/  sharded paths on torch.distributed, one process per rank:
             dp-sharded evaluation, tp-sharded RBF CG and Cholesky, the
             sp compact-RBF ring
  utils/     errors, machine constants, rng, fixtures, integrity checks,
             serialize (.npz), config (environment), profiling, testing

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
The JAX package's ``setup_x64`` has no counterpart: each entry point takes
``dtype=``.
"""

from .version import __version__  # noqa: F401
from . import models, ops, parallel, utils  # noqa: F401
from .models.interp1d import Interp1D, Spline1D, interp, spline  # noqa: F401
from .models.interp2d import Interp2D, Spline2D, interp2d, spline2d  # noqa: F401
from .models.scattered import ScatteredInterp  # noqa: F401
