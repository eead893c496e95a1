"""Device meshes over the ranks of the process group.

The counterpart of the JAX package's ``parallel/mesh.py``.  Two named axes
cover this workload:

  * ``dp``: data parallel over QUERY batches (queries are independent
    against a replicated triangulation);
  * ``tp``: parallel over SITE blocks of RBF kernel matrices and of the
    rows of a Cholesky factor (all-gathered matvecs, reduced scalars).

The compact-RBF ring runs on a 1-D mesh of its own, ``sp``, as JAX's
``Mesh(devices, ("sp",))``.  A mesh spans the ranks of the default process
group (:func:`launch.init_group`), one device per rank; making a mesh
never starts a group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: join one first (parallel.launch.init_group)"
        )
    return dist.get_world_size()


def make_mesh(dp: int | None = None, tp: int = 1, device="cuda") -> DeviceMesh:
    """Mesh over the group's ranks with axes (dp, tp)."""
    n = _world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    return init_device_mesh(
        torch.device(device).type, (dp, tp), mesh_dim_names=("dp", "tp")
    )


def make_ring_mesh(device="cuda") -> DeviceMesh:
    """1-D mesh with axis ``sp`` over every rank of the group, for
    :mod:`ring`."""
    return init_device_mesh(
        torch.device(device).type, (_world_size(),), mesh_dim_names=("sp",)
    )
