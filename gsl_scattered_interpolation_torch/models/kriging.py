"""Ordinary kriging with variogram fitting and per-query error estimates.

The counterpart of the JAX package's ``models/kriging.py``:

* **Empirical semivariogram**: all-pairs squared differences and
  distances in one broadcast (subsampled above ``max_pairs_sites``),
  binned by distance with two ``index_add_`` scatters.
* **Model fitting**: spherical / exponential / gaussian variogram models.
  For a candidate range the model is LINEAR in (nugget, sill), so fitting
  is a scan over a range grid with a closed-form 2x2 weighted least-squares
  solve per candidate, all candidates in one vectorized pass.
* **Prediction**: ``OrdinaryKriging`` factorizes the saddle system
  ``[[Gamma, 1], [1^T, 0]] [w; mu] = [gamma(q); 1]`` once (LU) and solves
  every query's right-hand side against it; ``LocalKriging`` solves one
  (k+1) saddle system per query over its k nearest sites, a chunk of
  queries in one batched LU solve.  Variances are ``w . gamma(q) + mu``.

Everything runs on the fit's device; the variogram too, in float64 (the
JAX package pins it to the host, a workaround for its TPU's per-op
compiles).
Coordinates are standardized like the rest of the engine.
"""

from __future__ import annotations

import itertools
import logging
from typing import NamedTuple

import numpy as np
import torch

from . import rbf, rbf_compact
from ..utils import config, errors

log = logging.getLogger(__name__)


def _vg_spherical(h, rng_):
    t = torch.clamp(h / rng_, 0.0, 1.0)
    return 1.5 * t - 0.5 * t**3


def _vg_exponential(h, rng_):
    return 1.0 - torch.exp(-3.0 * h / rng_)


def _vg_gaussian(h, rng_):
    return 1.0 - torch.exp(-3.0 * (h / rng_) ** 2)


VARIOGRAM_MODELS = {
    "spherical": _vg_spherical,
    "exponential": _vg_exponential,
    "gaussian": _vg_gaussian,
}


class Variogram(NamedTuple):
    model: str
    nugget: float
    sill: float      # partial sill (model amplitude above the nugget)
    range_: float

    def __call__(self, h):
        h = torch.as_tensor(h)
        base = VARIOGRAM_MODELS[self.model](h, self.range_)
        return self.nugget * (h > 0).to(base.dtype) + self.sill * base


def _linspace(start, stop, num: int, like):
    """``jnp.linspace``'s values: start + (i / (num - 1)) * (stop - start),
    the last exactly ``stop``; in ``like``'s dtype and device."""
    t = torch.arange(num, dtype=like.dtype, device=like.device) / (num - 1)
    out = start + t * (stop - start)
    out[-1] = stop
    return out


def empirical_variogram(
    sites_std, values, n_bins: int = 15, max_pairs_sites: int = 2000, key=0
):
    """(bin_centers, gamma_hat, counts) from standardized sites.

    Tensors in, tensors out, on the inputs' device.  Above
    ``max_pairs_sites`` sites, the all-pairs pass runs on a random
    subsample of that many sites (logged; the estimate stays unbiased).
    ``key`` picks it: an int seeds a ``torch.Generator`` (so it is not the
    JAX package's subsample for the same int), and an index array is the
    subsample itself.
    """
    n = sites_std.shape[0]
    if n > max_pairs_sites:
        log.info(
            "empirical_variogram: subsampling %d of %d sites for the "
            "all-pairs pass (raise max_pairs_sites to use more)",
            max_pairs_sites, n,
        )
        if isinstance(key, (int, np.integer)):
            gen = torch.Generator().manual_seed(int(key))
            idx = torch.randperm(n, generator=gen)[:max_pairs_sites]
        else:
            idx = torch.tensor(np.asarray(key), dtype=torch.int64)
            if idx.shape != (max_pairs_sites,):
                raise errors.InvalidArgumentError(
                    f"key must be an int or {max_pairs_sites} site indices"
                )
        idx = idx.to(sites_std.device)
        sites_std = sites_std[idx]
        values = values[idx]
        n = max_pairs_sites
    D = rbf.pairwise_dist(sites_std, sites_std)
    G = 0.5 * (values[:, None] - values[None, :]) ** 2
    iu = torch.triu_indices(n, n, offset=1, device=D.device)
    d = D[iu[0], iu[1]]
    g = G[iu[0], iu[1]]
    hmax = torch.max(d) * 0.6  # conventional cutoff: short lags carry it
    edges = _linspace(0.0, hmax, n_bins + 1, d)
    which = torch.clamp(
        torch.searchsorted(edges, d, right=True) - 1, 0, n_bins - 1
    )
    valid = (d <= hmax).to(d.dtype)
    counts = d.new_zeros(n_bins).index_add_(0, which, valid)
    sums = d.new_zeros(n_bins).index_add_(0, which, valid * g)
    centers = 0.5 * (edges[:-1] + edges[1:])
    gamma = torch.where(
        counts > 0, sums / torch.where(counts > 0, counts, 1.0), 0.0
    )
    return centers, gamma, counts


def fit_variogram(
    centers, gamma, counts, model: str = "spherical", n_ranges: int = 64
) -> Variogram:
    """Weighted LSQ fit; linear solve in (nugget, sill) per candidate range.

    Runs on the inputs' device (numpy inputs: the CPU, float64).
    """
    if model not in VARIOGRAM_MODELS:
        raise errors.InvalidArgumentError(
            f"unknown variogram model {model!r}"
        )
    def tensor(a):
        return a if torch.is_tensor(a) else torch.tensor(np.asarray(a, np.float64))

    centers = tensor(centers)
    gamma = tensor(gamma).to(centers)
    w = tensor(counts).to(centers)
    vg = VARIOGRAM_MODELS[model]
    ranges = _linspace(float(centers[1]), float(centers[-1]) * 1.5, n_ranges, centers)
    basis = vg(centers[None, :], ranges[:, None])  # [R, bins] sill multiplier
    # min over (nugget a, sill b): sum w (a + b*basis - gamma)^2
    A00 = torch.sum(w)
    A01 = torch.sum(w * basis, dim=1)
    A11 = torch.sum(w * basis * basis, dim=1)
    b0 = torch.sum(w * gamma)
    b1 = torch.sum(w * basis * gamma, dim=1)
    det = A00 * A11 - A01 * A01
    a = torch.clamp_min((A11 * b0 - A01 * b1) / det, 0.0)  # nugget >= 0
    b = torch.clamp_min((A00 * b1 - A01 * b0) / det, 1e-12)  # positive sill
    sse = torch.sum(w * (a[:, None] + b[:, None] * basis - gamma) ** 2, dim=1)
    i = int(torch.argmin(sse))
    return Variogram(
        model=model, nugget=float(a[i]), sill=float(b[i]), range_=float(ranges[i])
    )


class OrdinaryKriging:
    """Ordinary kriging predictor with per-query variance.

    Args:
      sites: [N, d] raw coords; values: [N].
      variogram: a fitted Variogram, or None to fit one automatically
        (empirical + weighted-LSQ over `model`).
      dtype: float32 on CUDA and float64 on the CPU unless given.
      device: where the fit runs and the model lives.
    """

    def __init__(
        self,
        sites,
        values,
        variogram: Variogram | None = None,
        model: str = "spherical",
        standardize: bool = True,
        dtype=None,
        device="cuda",
    ):
        device, dtype = config.device_dtype(device, dtype)
        sites = np.asarray(sites, np.float64)
        values = np.asarray(values, np.float64)
        n, d = sites.shape
        if values.shape != (n,):
            raise errors.InvalidArgumentError("values shape mismatch")
        self.shift, self.scale = rbf.standardization(sites, standardize)
        self.xs = torch.tensor(
            self.scale * (sites - self.shift), dtype=dtype, device=device
        )
        self.values = torch.tensor(values, dtype=dtype, device=device)
        # Records whether the auto-fitted variogram saw a subsample;
        # user-supplied variograms are whatever the user fitted them on.
        self.variogram_subsampled = False
        if variogram is None:
            c, g, w = empirical_variogram(self.xs.double(), self.values.double())
            self.variogram_subsampled = n > 2000
            variogram = fit_variogram(c, g, w, model=model)
        self.variogram = variogram

        # Factorize the (n+1) ordinary-kriging saddle matrix once.
        Gmat = self.variogram(rbf.pairwise_dist(self.xs, self.xs))
        ones = Gmat.new_ones((n, 1))
        K = torch.cat([
            torch.cat([Gmat, ones], dim=1),
            torch.cat([ones.T, Gmat.new_zeros((1, 1))], dim=1),
        ])
        self._lu = torch.linalg.lu_factor(K)

    def predict(self, q):
        """(mean [B], variance [B]) at raw query points [B, d]."""
        q = torch.atleast_2d(
            torch.as_tensor(q, dtype=self.xs.dtype, device=self.xs.device)
        )
        qs = _to_std(q, self.shift, self.scale)
        gq = self.variogram(rbf.pairwise_dist(qs, self.xs))  # [B, N]
        rhs = torch.cat([gq, gq.new_ones((gq.shape[0], 1))], dim=1)
        sol = torch.linalg.lu_solve(*self._lu, rhs.T).T  # [B, N+1]
        w = sol[:, :-1]
        mu = sol[:, -1]
        mean = w @ self.values
        var = torch.sum(w * gq, dim=1) + mu
        return mean, torch.clamp_min(var, 0.0)

    def eval(self, q):
        return self.predict(q)[0]


def _to_std(q, shift, scale):
    scale = torch.as_tensor(scale, dtype=q.dtype, device=q.device)
    shift = torch.as_tensor(shift, dtype=q.dtype, device=q.device)
    return scale * (q - shift)


class LocalKriging:
    """Local-neighborhood ordinary kriging: error estimates at scale.

    ``OrdinaryKriging`` factorizes the dense (n+1) saddle system, O(n^3)
    work and O(n^2) memory.  Here sites are bucketed into a uniform grid;
    each query gathers its 3^d cell neighborhood, selects its k nearest
    sites (``torch.topk``) and solves its own (k+1) ordinary-kriging
    saddle system; a chunk of queries solves as one batched LU with
    partial pivoting, so memory is O(chunk * k^2), independent of n.  Any
    d.  The variogram is fitted on a subsample exactly as OrdinaryKriging
    does (see ``variogram_subsampled``).
    """

    def __init__(
        self,
        sites,
        values,
        variogram: Variogram | None = None,
        model: str = "spherical",
        k_neighbors: int = 24,
        standardize: bool = True,
        target_per_cell: float = 4.0,
        dtype=None,
        device="cuda",
    ):
        device, dtype = config.device_dtype(device, dtype)
        sites = np.asarray(sites, np.float64)
        values = np.asarray(values, np.float64)
        n, d = sites.shape
        if values.shape != (n,):
            raise errors.InvalidArgumentError("values shape mismatch")
        self.shift, self.scale = rbf.standardization(sites, standardize)
        xs_std = self.scale * (sites - self.shift)
        self.k = int(k_neighbors)
        self.variogram_subsampled = n > 2000
        if variogram is None:
            c, g, w = empirical_variogram(
                torch.tensor(xs_std, device=device),
                torch.tensor(values, device=device),
            )
            variogram = fit_variogram(c, g, w, model=model)
        self.variogram = variogram
        # Cell size: ~target_per_cell sites/cell, so the 3^d neighborhood
        # holds ~3^d*target >= k candidates with margin.
        rho = float((target_per_cell / max(n, 1)) ** (1.0 / d))
        self.grid = rbf_compact.build_cell_grid(
            xs_std, rho, device=device, dtype=dtype
        )
        self.v_pad = rbf_compact.pack_values(
            self.grid, torch.tensor(values, dtype=dtype, device=device)
        )
        self.dtype = dtype

    def predict(self, q, chunk: int = 4096):
        """(mean [B], variance [B]) at raw query points [B, d]."""
        xs_pad = self.grid.xs_pad
        q = torch.atleast_2d(
            torch.as_tensor(q, dtype=self.dtype, device=xs_pad.device)
        )
        qs = _to_std(q, self.shift, self.scale)
        *G, cap, d = xs_pad.shape
        n_cells = int(np.prod(G))
        args = (
            xs_pad.reshape(n_cells, cap, d),
            self.v_pad.reshape(n_cells, cap),
            self.grid.cell_size,
            self.grid.origin,
        )
        means, vars_ = [], []
        for s in range(0, qs.shape[0], chunk):
            m, v = _local_predict(
                *args, qs[s : s + chunk], self.variogram, Gs=tuple(G), k=self.k
            )
            means.append(m)
            vars_.append(v)
        if not means:
            return qs.new_zeros(0), qs.new_zeros(0)
        return torch.cat(means), torch.cat(vars_)

    def eval(self, q):
        return self.predict(q)[0]


def _local_predict(xs_flat, v_flat, cell, origin, qs, vg, *, Gs, k):
    """One chunk of local-kriging predictions: (mean [B], variance [B]).

    Any d: the neighborhood is the 3^d adjacent-cell block.  Pad slots of
    the k-nearest selection (fewer real candidates than k) get identity
    rows and columns and drop out of the unbiasedness constraint.
    """
    cap = xs_flat.shape[1]
    d = qs.shape[1]
    dtype = qs.dtype
    ij = torch.floor((qs - origin) / cell).to(torch.int64)
    ax = [torch.clamp(ij[:, a], 0, Gs[a] - 1) for a in range(d)]
    xs_parts, v_parts, ok_parts = [], [], []
    for offs in itertools.product((-1, 0, 1), repeat=d):
        na = [ax[a] + offs[a] for a in range(d)]
        inb = torch.ones_like(na[0], dtype=torch.bool)
        idx = torch.zeros_like(na[0])
        for a in range(d):
            inb = inb & (na[a] >= 0) & (na[a] < Gs[a])
            idx = idx * Gs[a] + torch.clamp(na[a], 0, Gs[a] - 1)
        idx = torch.where(inb, idx, 0)
        xs_parts.append(xs_flat[idx])               # [B, cap, d]
        v_parts.append(v_flat[idx])
        ok_parts.append(inb[:, None].expand(inb.shape[0], cap))
    xc = torch.cat(xs_parts, dim=1)                 # [B, 3^d*cap, d]
    vc = torch.cat(v_parts, dim=1)
    ok = torch.cat(ok_parts, dim=1)
    ok = ok & torch.all(torch.abs(xc) < 1e6, dim=-1)  # poison pads

    kk = min(k, 3**d * cap)
    d2 = torch.sum((xc - qs[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(ok, d2, torch.inf)
    _, sel = torch.topk(d2, kk, dim=1, largest=False)  # [B, kk] nearest
    xk = torch.take_along_dim(xc, sel[..., None], dim=1)
    vk = torch.take_along_dim(vc, sel, dim=1)
    okk = torch.take_along_dim(ok, sel, dim=1)
    # saddle system [[Gamma, e], [e^T, 0]]
    diff = xk[:, :, None, :] - xk[:, None, :, :]
    h = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
    Gm = vg(h).to(dtype)                            # [B, kk, kk]
    eye = torch.eye(kk, dtype=dtype, device=qs.device)
    Gm = torch.where(okk[:, :, None] & okk[:, None, :], Gm, eye)
    e = okk.to(dtype)
    B = qs.shape[0]
    K = torch.cat([
        torch.cat([Gm, e[:, :, None]], dim=2),
        torch.cat([e[:, None, :], Gm.new_zeros((B, 1, 1))], dim=2),
    ], dim=1)                                       # [B, kk+1, kk+1]
    hq = torch.sqrt(
        torch.clamp_min(torch.sum((xk - qs[:, None, :]) ** 2, dim=-1), 0.0)
    )
    gq = torch.where(okk, vg(hq).to(dtype), 0.0)
    rhs = torch.cat([gq, gq.new_ones((B, 1))], dim=1)
    sol = torch.linalg.solve(K, rhs[..., None])[..., 0]  # [B, kk+1]
    w = sol[:, :-1]
    mu = sol[:, -1]
    mean = torch.sum(w * torch.where(okk, vk, 0.0), dim=1)
    var = torch.sum(w * gq, dim=1) + mu
    return mean, torch.clamp_min(var, 0.0)
