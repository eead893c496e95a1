"""ScatteredInterp: the gsl_interp-style facade over the Delaunay engines.

Construct once from sites and values (the ``simplex_tree_init`` analog),
then evaluate batches of queries (``find_leaf`` + ``interp_point``) with
the init/eval/eval_e shape of GSL's interpolation families.

Engines:
  * ``"host"`` — the arbitrary-dimension Bowyer-Watson engine
    (models.host_tree), frozen to tensors on ``device``;
  * ``"device"`` — the 2D parallel build on ``device``
    (models.device_delaunay), whose flip verdicts run in a CUDA kernel on
    the card;
  * ``"cavity"`` — the parallel Bowyer-Watson build on ``device`` for any
    d >= 2 (models.device_cavity);
  * ``"auto"`` — device for d == 2, cavity for d == 3, host otherwise, as in
    the JAX package.

Evaluation runs on ``device`` through the batched query path
(models.device_tri): brute force up to ``DENSE_LOCATE_MAX_TRIS`` simplexes,
past it a cell index built at the first query and cached, with the
visibility walk for the queries the index cannot settle.  ``eval_deriv`` returns the piecewise-constant gradient
of the linear interpolant in the containing simplex.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device_cavity, device_delaunay, device_tri, host_tree
from ..utils import errors, profiling

DEFAULT = host_tree.DEFAULT
NOSTANDARDIZE = host_tree.NOSTANDARDIZE
ISOSCALE = host_tree.ISOSCALE


class ScatteredInterp:
    """See module docstring.

    device: where the triangulation is built and lives, and queries run
    ("cuda" unless the caller asks for the CPU).  dtype: the precision of
    the device builds' predicates and of the query path; ``None`` picks
    float32 on CUDA (the fast path) and float64 on the CPU (GSL parity);
    ``"accurate"`` is float64 on every device.  ``build_stats``: the
    device and cavity builds' counts and the host seconds of their phases
    (``triangulate``'s ``stats``); empty for the host engine.
    """

    name = "linear_simplex"
    min_size = 1

    def __init__(
        self,
        sites,
        values,
        lo=None,
        hi=None,
        flags: int = DEFAULT,
        key=None,
        engine: str = "auto",
        dtype=None,
        grid_res: int = 256,
        device="cuda",
    ):
        device = torch.device(device)
        if dtype == "accurate":
            dtype = torch.float64
        elif dtype is None:
            dtype = torch.float32 if device.type == "cuda" else torch.float64
        sites = np.asarray(sites, np.float64)
        values = np.asarray(values, np.float64)
        if sites.ndim != 2:
            raise errors.InvalidArgumentError("sites must be [n, d]")
        n, d = sites.shape
        if values.shape != (n,):
            raise errors.InvalidArgumentError(
                f"values shape {values.shape} != ({n},)"
            )
        if engine == "auto":
            engine = "device" if d == 2 else "cavity" if d == 3 else "host"
        if engine not in ("host", "device", "cavity"):
            raise errors.InvalidArgumentError(f"unknown engine {engine!r}")
        self.engine = engine
        self.dim = d
        self.n_sites = n
        self.build_stats = {}
        if engine in ("device", "cavity"):
            build = (
                device_delaunay if engine == "device" else device_cavity
            ).triangulate
            tri, self.shuffle = build(
                sites, lo=lo, hi=hi, flags=flags, key=key, dtype=dtype,
                grid_res=grid_res, device=device, stats=self.build_stats,
            )
            self.tri = tri.cast(dtype)
            self.response = device_tri.response_for_build(
                self.shuffle, values, d=d, device=device
            ).to(dtype)
            self.tree = None
        else:
            self.tree = host_tree.build(
                sites, lo=lo, hi=hi, flags=flags, key=key
            )
            self.tri = device_tri.freeze(
                self.tree, grid_res=grid_res, device=device
            ).cast(dtype)
            self.response = device_tri.reindex_response(
                self.tree, values, device=device
            ).to(dtype)
            self.shuffle = self.tree.shuffle
        self._cells = None
        self._resp_tri = None

    # -- evaluation ------------------------------------------------------

    def _queries(self, q):
        q = torch.as_tensor(q, dtype=self.tri.dtype, device=self.tri.device)
        return torch.atleast_2d(q)

    def _get_cells(self):
        """The cell index, built at the first query past
        ``DENSE_LOCATE_MAX_TRIS`` simplexes and cached, with the triangles'
        response rows that evaluation by it reads; None below it, where
        brute force answers."""
        if (
            self._cells is None
            and self.dim in (2, 3)
            and self.tri.n_tris > device_tri.DENSE_LOCATE_MAX_TRIS
        ):
            self._cells = device_tri.build_cell_index(self.tri)
            self._resp_tri = device_tri.vertex_responses(
                self.tri, self.response
            )
        return self._cells

    def _locate(self, q):
        cells = self._get_cells()
        if cells is not None:
            return device_tri.locate_cells(self.tri, cells, q)
        if self.tri.n_tris <= device_tri.DENSE_LOCATE_MAX_TRIS:
            return device_tri.locate_dense(self.tri, q)
        return device_tri.locate(self.tri, q)

    def eval(self, q, strict: bool = False):
        """Barycentric interpolation at [B, d] raw query points.

        Values fade to 0 toward and outside the data hull (cage-vertex
        zeros, linear_simplex.c:697-706); out-of-cage queries return 0.
        ``strict=True`` raises DomainError if any query is outside the cage.
        The call is the span ``scattered.eval``.
        """
        with profiling.span("scattered.eval"):
            q = self._queries(q)
            vals = device_tri.interp(
                self.tri, self.response, q, cells=self._get_cells(),
                resp_tri=self._resp_tri,
            )
            if strict:
                _, _, ok = self._locate(q)
                if not bool(torch.all(ok)):
                    raise errors.DomainError("query outside the cage domain")
            return vals

    def eval_e(self, q):
        """(values [B], status [B]): SUCCESS, or EDOM outside the cage."""
        q = self._queries(q)
        leaf, w, ok = self._locate(q)
        r = self.response[self.tri.tri_verts[leaf]]
        vals = torch.where(ok, torch.sum(w * r, dim=-1), 0.0)
        status = torch.where(
            ok, torch.tensor(errors.SUCCESS), torch.tensor(errors.EDOM)
        ).to(torch.int32)
        return vals, status

    def eval_deriv(self, q):
        """Gradient [B, d] of the piecewise-linear interpolant.

        Constant per simplex: grad = sum_k r_k * grad(w_k), with the weight
        gradients read off the simplex's affine map rows.
        """
        q = self._queries(q)
        d = self.dim
        leaf, w, ok = self._locate(q)
        row = self.tri.affine[leaf]
        A = row[:, : d * d].reshape(-1, d, d)  # dcoords/dq
        r = self.response[self.tri.tri_verts[leaf]]  # [B, d+1]
        # w = [coords, 1 - sum(coords)] => dw/dq rows: A, then -sum of A rows.
        g = torch.sum(r[:, :d, None] * A, dim=1) - r[:, d:] * torch.sum(
            A, dim=1
        )
        return torch.where(ok[:, None], g, 0.0)

    # -- introspection ---------------------------------------------------

    @property
    def n_simplexes(self) -> int:
        return int(self.tri.n_tris)
