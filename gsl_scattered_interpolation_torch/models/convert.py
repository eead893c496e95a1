"""Carry a triangulation across from the JAX package.

:func:`from_jax_arrays` takes the fields of a JAX ``DeviceTriangulation``
as numpy arrays (``np.asarray`` of each) and the response vector, so the
port and the JAX package can be run on identical state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device_tri import DeviceTriangulation


def from_jax_arrays(fields: dict, device="cuda"):
    """(DeviceTriangulation, response tensor or None) on ``device``.

    ``fields`` holds every field of the JAX ``DeviceTriangulation`` by name
    (``grid_res`` as an int) and, optionally, ``"response"``: the response
    vector in device layout (``reindex_response``).
    """
    tensors = {}
    for f in dataclasses.fields(DeviceTriangulation):
        if f.name == "grid_res":
            tensors[f.name] = int(fields[f.name])
        else:
            tensors[f.name] = torch.tensor(
                np.asarray(fields[f.name]), device=device
            )
    response = fields.get("response")
    if response is not None:
        response = torch.tensor(np.asarray(response), device=device)
    return DeviceTriangulation(**tensors), response
