"""Carry state across from the JAX package.

:func:`from_jax_arrays` takes the fields of a JAX ``DeviceTriangulation``
as numpy arrays (``np.asarray`` of each) and the response vector;
:func:`from_jax_build_state` the fields of a JAX device-build
``BuildState``, and :func:`from_jax_cavity_state` those of a JAX cavity
``CavityState``.  The port and the JAX package can then run on identical
state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device_cavity import CavityState
from .device_delaunay import BuildState
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


def from_jax_build_state(fields: dict, device="cuda") -> BuildState:
    """The port's BuildState on ``device`` from a JAX ``BuildState``.

    ``fields`` maps each field name to a numpy array (``np.asarray`` of the
    JAX array).  The JAX arrays have M rows; the port's get the spare trash
    row M after them (-1 ids, zero cache).
    """

    def rows(name, fill):
        a = torch.tensor(np.asarray(fields[name]), device=device)
        return torch.cat([a, torch.full_like(a[:1], fill)])

    def scalar(name):
        return torch.tensor(int(fields[name]), dtype=torch.int32, device=device)

    return BuildState(
        tri_v=rows("tri_v", -1),
        tri_n=rows("tri_n", -1),
        cc=rows("cc", 0),
        n_tris=scalar("n_tris"),
        site_tri=torch.tensor(np.asarray(fields["site_tri"]), device=device),
        n_left=scalar("n_left"),
    )


def from_jax_cavity_state(fields: dict, device="cuda") -> CavityState:
    """The port's CavityState on ``device`` from a JAX ``CavityState``.

    ``fields`` maps each field name to a numpy array.  tri_v and tri_n get
    the spare trash row M after their M rows (-1 ids).
    """

    def rows(name):
        a = torch.tensor(np.asarray(fields[name]), device=device)
        return torch.cat([a, torch.full_like(a[:1], -1)])

    def scalar(name):
        return torch.tensor(int(fields[name]), dtype=torch.int32, device=device)

    return CavityState(
        tri_v=rows("tri_v"),
        tri_n=rows("tri_n"),
        n_tris=scalar("n_tris"),
        site_tri=torch.tensor(np.asarray(fields["site_tri"]), device=device),
        n_left=scalar("n_left"),
    )
