"""Carry state across from the JAX package.

:func:`from_jax_arrays` takes the fields of a JAX ``DeviceTriangulation``
as numpy arrays (``np.asarray`` of each) and the response vector;
:func:`from_jax_build_state` the fields of a JAX device-build
``BuildState``, and :func:`from_jax_cavity_state` those of a JAX cavity
``CavityState``.  The port and the JAX package can then run on identical
state.

For the RBF and kriging family, the fitted models: :func:`cell_grid_from_jax`
(a ``CellGrid``), :func:`pu_tps_from_jax` (a ``PuTps``),
:func:`variogram_from_jax`, :func:`rbf_interp_from_jax` and
:func:`compact_rbf_from_jax` (an ``RbfInterp``'s or ``CompactRbf``'s
weights).  The port then evaluates a JAX fit, so a test can hold ``eval``
against JAX's apart from the fit.

For the GSL structured family: :func:`interp1d_from_jax` (an ``Interp1D``
from its knots and ``coef`` or ``dd``) and :func:`interp2d_from_jax` (an
``Interp2D`` from its grid and derivative grids).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import interp1d, interp2d, kriging, rbf, rbf_compact, rbf_pu
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


def _tensor(a, device, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def cell_grid_from_jax(fields: dict, device="cuda") -> rbf_compact.CellGrid:
    """The port's CellGrid on ``device`` from a JAX ``CellGrid``: each field
    by name, arrays as numpy (``n_sites`` and ``cell_size`` as numbers)."""
    return rbf_compact.CellGrid(
        xs_pad=_tensor(fields["xs_pad"], device),
        slot_site=_tensor(fields["slot_site"], device),
        n_sites=int(fields["n_sites"]),
        cell_size=float(fields["cell_size"]),
        origin=_tensor(fields["origin"], device),
    )


def pu_tps_from_jax(fields: dict, device="cuda") -> rbf_pu.PuTps:
    """The port's PuTps on ``device`` from a JAX ``PuTps`` (fields by name,
    arrays as numpy; ``cell`` and ``rad`` as numbers)."""
    arrays = {
        name: _tensor(fields[name], device)
        for name in ("xs9", "lam", "poly", "origin", "shift", "scale")
    }
    return rbf_pu.PuTps(
        cell=float(fields["cell"]), rad=float(fields["rad"]), **arrays
    )


def variogram_from_jax(vg) -> kriging.Variogram:
    """The port's Variogram from a JAX ``Variogram`` (a tuple of the model
    name and three numbers)."""
    model, nugget, sill, range_ = vg
    return kriging.Variogram(str(model), float(nugget), float(sill), float(range_))


def rbf_interp_from_jax(fields: dict, device="cuda") -> rbf.RbfInterp:
    """A port RbfInterp on ``device`` holding a JAX ``RbfInterp``'s fit.

    ``fields``: ``kernel`` (its name), ``epsilon``, ``smooth``, ``shift``,
    ``scale``, ``xs``, ``values``, ``lam`` and ``poly_coef``, arrays as
    numpy.  The port's dtype is ``xs``'s.
    """
    m = object.__new__(rbf.RbfInterp)
    m.kernel = rbf.KERNELS[str(fields["kernel"])]
    m.epsilon = float(fields["epsilon"])
    m.smooth = float(fields["smooth"])
    m.shift = np.asarray(fields["shift"], np.float64)
    m.scale = np.asarray(fields["scale"], np.float64)
    m.xs = _tensor(fields["xs"], device)
    for name in ("values", "lam", "poly_coef"):
        setattr(m, name, _tensor(fields[name], device, m.xs.dtype))
    m.solver = "direct"
    m.block = 4096
    m.solve_info = {}
    return m


def compact_rbf_from_jax(fields: dict, device="cuda") -> rbf_compact.CompactRbf:
    """A port CompactRbf on ``device`` holding a JAX ``CompactRbf``'s fit,
    ready to ``eval`` and report its ``residual``.

    ``fields``: ``grid`` (the fields of its CellGrid, as for
    :func:`cell_grid_from_jax`), ``epsilon``, ``smooth``, ``shift``,
    ``scale``, ``values`` and ``lam_pad``, arrays as numpy.
    """
    m = object.__new__(rbf_compact.CompactRbf)
    m.grid = cell_grid_from_jax(fields["grid"], device)
    m.kernel = rbf.KERNELS["wendland_c2"]
    m.epsilon = float(fields["epsilon"])
    m.smooth = float(fields["smooth"])
    m.shift = np.asarray(fields["shift"], np.float64)
    m.scale = np.asarray(fields["scale"], np.float64)
    dtype = m.grid.xs_pad.dtype
    m.values = _tensor(fields["values"], device, dtype)
    m.lam_pad = _tensor(fields["lam_pad"], device, dtype)
    m.lam64 = None
    m.refine_history = []
    return m


def interp1d_from_jax(fields: dict, device="cuda") -> interp1d.Interp1D:
    """A port Interp1D on ``device`` holding a JAX ``Interp1D``'s state.

    ``fields``: ``kind``, ``x``, ``y`` and ``coef`` (or, for the polynomial
    kind, ``dd``), arrays as numpy.  The port's dtype is ``x``'s.
    """
    kind = str(fields["kind"])
    m = object.__new__(interp1d.Interp1D)
    m.kind = kind
    m.type = interp1d.TYPES[kind]
    m.x = _tensor(fields["x"], device)
    m.y = _tensor(fields["y"], device, m.x.dtype)
    name = "dd" if kind == "polynomial" else "coef"
    setattr(m, name, _tensor(fields[name], device, m.x.dtype))
    return m


def interp2d_from_jax(fields: dict, device="cuda") -> interp2d.Interp2D:
    """A port Interp2D on ``device`` holding a JAX ``Interp2D``'s state.

    ``fields``: ``kind``, ``x``, ``y``, ``z`` and, for bicubic, ``zx``,
    ``zy`` and ``zxy``, arrays as numpy.  The port's dtype is ``x``'s.
    """
    kind = str(fields["kind"])
    m = object.__new__(interp2d.Interp2D)
    m.kind = kind
    m.x = _tensor(fields["x"], device)
    names = ("y", "z") + (("zx", "zy", "zxy") if kind == "bicubic" else ())
    for name in names:
        setattr(m, name, _tensor(fields[name], device, m.x.dtype))
    return m
