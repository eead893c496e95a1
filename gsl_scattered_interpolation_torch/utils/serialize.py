"""Triangulation serialization (the checkpoint/resume analog).

The counterpart of ``gsl_scattered_interpolation_tpu/utils/serialize.py``:
a DeviceTriangulation and, optionally, its response vector round-trip
through one ``.npz`` file with the JAX package's field names and dtypes,
so a file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.device_tri import DeviceTriangulation

_FIELDS = [f.name for f in dataclasses.fields(DeviceTriangulation)]


def save(path, tri: DeviceTriangulation, response=None) -> None:
    arrays = {
        f: getattr(tri, f).cpu().numpy() for f in _FIELDS if f != "grid_res"
    }
    arrays["grid_res"] = np.asarray(tri.grid_res)
    if response is not None:
        arrays["response"] = torch.as_tensor(response).cpu().numpy()
    np.savez_compressed(path, **arrays)


def load(path, device="cuda"):
    """(DeviceTriangulation, response tensor or None) on ``device``."""
    with np.load(path) as f:
        fields = {
            k: torch.as_tensor(f[k], device=device)
            for k in _FIELDS
            if k != "grid_res"
        }
        tri = DeviceTriangulation(grid_res=int(f["grid_res"]), **fields)
        resp = (
            torch.as_tensor(f["response"], device=device)
            if "response" in f
            else None
        )
    return tri, resp
