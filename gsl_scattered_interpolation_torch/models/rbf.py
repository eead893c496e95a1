"""Radial-basis-function interpolation on tensors.

The counterpart of the JAX package's ``models/rbf.py``:

* **Assembly**: the kernel matrix A[i,j] = phi(|x_i - x_j|) comes from one
  Gram matmul (|a|^2 + |b|^2 - 2 a.b) in full float32 or float64: the port
  never enables TF32.
* **Solvers**: dense Cholesky (strictly PD kernels, with optional ridge
  ``smooth``) or LU on the polynomial-augmented saddle system
  (conditionally PD kernels like thin-plate); matrix-free conjugate
  gradients that rebuild kernel blocks from coordinates; and, for
  conditionally PD kernels at scale, right-preconditioned GMRES on the
  constraint subspace with a local-Lagrange approximate inverse.
* **Evaluation** is a [B, N] kernel matmul plus the polynomial tail.

Kernels: gaussian, multiquadric, inverse_multiquadric, linear, cubic,
thin_plate (r^2 log r, +degree-1 polynomial), wendland_c2 (compactly
supported (1-r)_+^4 (4r+1), strictly PD for d<=3).

Sites are standardized (scale*(x-shift)) before radii are measured, so
shape parameters are resolution-independent.

The Krylov loops are Python loops over device tensors that keep JAX's
stopping rule (:func:`while_loop`).  ``torch.log`` stands where the JAX
package calls its polynomial ``accurate.log`` (a TPU workaround); in
float32 the two differ by 1-2 ulps.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import morton
from ..utils import errors
from ..utils.config import device_dtype

log = logging.getLogger(__name__)

# The host reads a Krylov loop's condition once every CHECK_EVERY steps.
CHECK_EVERY = 8


class Kernel(NamedTuple):
    name: str
    phi: Callable  # (r, eps) -> value
    poly_degree: int  # -1: none needed; 0: constant; 1: affine
    strictly_pd: bool


def _phi_gaussian(r, eps):
    return torch.exp(-((eps * r) ** 2))


def _phi_mq(r, eps):
    return torch.sqrt(1.0 + (eps * r) ** 2)


def _phi_imq(r, eps):
    return 1.0 / torch.sqrt(1.0 + (eps * r) ** 2)


def _phi_linear(r, eps):
    return r


def _phi_cubic(r, eps):
    return r * r * r


def _phi_tps(r, eps):
    # r^2 log r, smoothly 0 at r=0.
    safe = torch.where(r > 0, r, 1.0)
    return torch.where(r > 0, r * r * torch.log(safe), 0.0)


def _phi_wendland_c2(r, eps):
    # Support radius rho = 1/eps: (1 - eps r)_+^4 (4 eps r + 1).
    t = eps * r
    base = torch.clamp_min(1.0 - t, 0.0)
    return base**4 * (4.0 * t + 1.0)


KERNELS = {
    "gaussian": Kernel("gaussian", _phi_gaussian, -1, True),
    "multiquadric": Kernel("multiquadric", _phi_mq, 0, False),
    "inverse_multiquadric": Kernel(
        "inverse_multiquadric", _phi_imq, -1, True
    ),
    "linear": Kernel("linear", _phi_linear, 0, False),
    "cubic": Kernel("cubic", _phi_cubic, 1, False),
    "thin_plate": Kernel("thin_plate", _phi_tps, 1, False),
    "wendland_c2": Kernel("wendland_c2", _phi_wendland_c2, -1, True),
}


def pairwise_d2(a, b):
    """[Na, Nb] SQUARED distances via the Gram-matmul trick."""
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    g = a @ b.T
    return torch.clamp_min(a2[:, None] + b2[None, :] - 2.0 * g, 0.0)


def pairwise_dist(a, b):
    """[Na, Nb] Euclidean distances via the Gram-matmul trick."""
    return torch.sqrt(pairwise_d2(a, b))


def _phi_tps_d2(d2, eps):
    # r^2 log r = d2 * log(d2) / 2; the additive tiny kills the 0*(-inf)
    # NaN at coincident points with no branch and no sqrt.
    return 0.5 * d2 * torch.log(d2 + 1e-37)


# phi variants taking SQUARED distance (cheaper streamed matvecs).
_PHI_D2 = {"thin_plate": _phi_tps_d2}
# Homogeneity exponent: phi(h r) = h^s phi(r) (+ a term the polynomial part
# absorbs, for thin-plate's log).
_SCALE_EXPO = {"thin_plate": 2.0, "cubic": 3.0, "linear": 1.0}


def _kernel_name(phi) -> str | None:
    for name, k in KERNELS.items():
        if k.phi is phi:
            return name
    return None


def _poly_basis(x, degree: int):
    """[N, m] polynomial tail basis: degree 0 -> [1]; 1 -> [1, x...]."""
    n = x.shape[0]
    if degree < 0:
        return x.new_zeros((n, 0))
    cols = [x.new_ones((n, 1))]
    if degree >= 1:
        cols.append(x)
    return torch.cat(cols, dim=-1)


def _poly_basis_batched(x, degree: int):
    """[.., w, m] polynomial tail basis over batched point sets."""
    ones = x.new_ones(x.shape[:-1] + (1,))
    if degree < 1:
        return ones
    return torch.cat([ones, x], dim=-1)


def standardization(sites, standardize: bool = True):
    """(shift, scale) of the engine's scale*(x - shift): the bounding box's
    centre and reciprocal extents (1 where an extent is 0), or the
    identity."""
    d = sites.shape[1]
    if not standardize:
        return np.zeros(d), np.ones(d)
    lo, hi = sites.min(0), sites.max(0)
    ext = hi - lo
    return (lo + hi) / 2.0, np.where(ext > 0, 1.0 / np.where(ext > 0, ext, 1), 1.0)


def while_loop(cond, body, state):
    """``jax.lax.while_loop(cond, body, state)`` over a tuple of tensors.

    ``cond`` returns a 0-d bool tensor and must turn false within a bounded
    number of steps (the solvers' iteration cap is part of it).  The host
    reads it once every ``CHECK_EVERY`` steps; between reads every step
    keeps the old state wherever ``cond`` is false, so a converged state
    stays frozen and the result, its iteration count included, is the one
    JAX's loop stops at.
    """
    while bool(cond(state)):
        for _ in range(CHECK_EVERY):
            go = cond(state)
            new = body(state)
            state = tuple(torch.where(go, a, b) for a, b in zip(new, state))
    return state


def _solve_saddle(K, rhs):
    """LU solve of the saddle system; a singular one raises SingularError."""
    try:
        sol = torch.linalg.solve(K, rhs[:, None])[:, 0]
    except torch.linalg.LinAlgError as e:
        raise errors.SingularError(
            "singular RBF system (duplicate sites?)"
        ) from e
    errors.strict_check(
        torch.isfinite(sol), errors.SingularError,
        "singular RBF system (duplicate sites?)",
    )
    return sol


class RbfInterp:
    """RBF interpolant s(x) = sum_i lambda_i phi(|x - x_i|) + P(x).

    Args:
      sites: [N, d] raw coordinates.
      values: [N].
      kernel: one of KERNELS.
      epsilon: shape parameter (support reciprocal for wendland).  Default
        0.5 * N^(1/d) in standardized coordinates; thin_plate, cubic and
        linear ignore it.
      smooth: ridge added to the kernel diagonal (smoothing spline);
        0.0 interpolates exactly.
      solver: "direct" (Cholesky/LU), "cg" (matrix-free), or "pcg"
        (matrix-free GMRES on the constraint subspace, right-preconditioned
        by a local-Lagrange approximate inverse over Morton-ordered sites);
        "auto" picks direct for N <= 8192, else pcg for poly-augmented
        kernels and cg otherwise.
      standardize: measure radii in scale*(x-shift) coordinates.
      dtype: float32 on CUDA and float64 on the CPU unless given.
      device: where the fit runs and the model lives.
    """

    def __init__(
        self,
        sites,
        values,
        kernel: str = "thin_plate",
        epsilon: float | None = None,
        smooth: float = 0.0,
        solver: str = "auto",
        standardize: bool = True,
        cg_tol: float = 1e-10,
        cg_maxiter: int = 500,
        block: int = 4096,
        precond_neighbors: int = 50,
        precond_anchors: int = 12,
        dtype=None,
        device="cuda",
    ):
        if kernel not in KERNELS:
            raise errors.InvalidArgumentError(
                f"unknown RBF kernel {kernel!r}; have {sorted(KERNELS)}"
            )
        self.kernel = KERNELS[kernel]
        device, dtype = device_dtype(device, dtype)
        sites = np.asarray(sites, np.float64)
        values = np.asarray(values, np.float64)
        n, d = sites.shape
        if values.shape != (n,):
            raise errors.InvalidArgumentError("values shape mismatch")
        self.shift, self.scale = standardization(sites, standardize)
        self.xs = torch.tensor(
            self.scale * (sites - self.shift), dtype=dtype, device=device
        )
        self.values = torch.tensor(values, dtype=dtype, device=device)

        if epsilon is None:
            # ~1/(mean spacing): n points in a unit box -> h ~ n^(-1/d).
            epsilon = 0.5 * float(n) ** (1.0 / d)
        self.epsilon = float(epsilon)
        self.smooth = float(smooth)

        if solver == "auto":
            if n <= 8192:
                solver = "direct"
            else:
                solver = "pcg" if self.kernel.poly_degree >= 0 else "cg"
        self.solver = solver
        self.block = int(block)
        self.solve_info = {}
        self._precond_q = int(precond_neighbors)
        self._precond_anchors = int(precond_anchors)
        self._fit(cg_tol, cg_maxiter, self.block)

    # -- fitting ----------------------------------------------------------

    def _fit(self, cg_tol, cg_maxiter, block):
        xs, y = self.xs, self.values
        n = xs.shape[0]
        phi = self.kernel.phi
        eps = self.epsilon
        if self.solver == "direct":
            A = phi(pairwise_dist(xs, xs), eps)
            A = A + self.smooth * torch.eye(n, dtype=A.dtype, device=A.device)
            P = _poly_basis(xs, self.kernel.poly_degree)
            m = P.shape[1]
            if m == 0:  # every kernel without a tail is strictly PD
                L, info = torch.linalg.cholesky_ex(A)
                if int(info):
                    raise errors.SingularError(
                        "RBF kernel matrix is not positive definite "
                        "(duplicate sites?)"
                    )
                self.lam = torch.cholesky_solve(y[:, None], L)[:, 0]
                self.poly_coef = A.new_zeros(0)
            else:
                # Saddle system [[A,P],[P^T,0]] [lam;c] = [y;0].
                top = torch.cat([A, P], dim=1)
                bot = torch.cat([P.T, A.new_zeros((m, m))], dim=1)
                K = torch.cat([top, bot], dim=0)
                rhs = torch.cat([y, A.new_zeros(m)])
                sol = _solve_saddle(K, rhs)
                self.lam = sol[:n]
                self.poly_coef = sol[n:]
        elif self.solver == "pcg":
            # Morton-order the sites so the preconditioner's anchors are
            # spread over the domain, fit, then un-permute the coefficients.
            order = morton.morton_order(xs.cpu().numpy())
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            order_t = torch.as_tensor(order, device=xs.device)
            xs_m = xs[order_t]
            P = _poly_basis(xs_m, self.kernel.poly_degree)
            lam_m, self.poly_coef, info = _projected_pcg_matfree(
                xs_m, y[order_t], P, phi, eps, self.smooth,
                cg_tol, cg_maxiter, block,
                q=self._precond_q, n_anchor=self._precond_anchors,
            )
            self.lam = lam_m[torch.as_tensor(inv, device=xs.device)]
            self.solve_info = info
        else:
            P = _poly_basis(xs, self.kernel.poly_degree)
            if P.shape[1] == 0:
                self.lam, it = _cg_matfree(
                    xs, y, phi, eps, self.smooth, cg_tol, cg_maxiter, block
                )
                self.poly_coef = xs.new_zeros(0)
            else:
                self.lam, self.poly_coef, it = _projected_cg_matfree(
                    xs, y, P, phi, eps, self.smooth, cg_tol, cg_maxiter,
                    block,
                )
            self.solve_info = {"iters": it}

    # -- evaluation --------------------------------------------------------

    def _eval_std(self, qs):
        out = []
        for s in range(0, qs.shape[0], self.block):
            qb = qs[s : s + self.block]
            B = self.kernel.phi(pairwise_dist(qb, self.xs), self.epsilon)
            v = B @ self.lam
            if self.poly_coef.shape[0]:
                v = v + _poly_basis(qb, self.kernel.poly_degree) @ self.poly_coef
            out.append(v)
        return torch.cat(out) if out else qs.new_zeros(0)

    def _std(self, q):
        q = torch.atleast_2d(
            torch.as_tensor(q, dtype=self.xs.dtype, device=self.xs.device)
        )
        scale = torch.as_tensor(self.scale, dtype=q.dtype, device=q.device)
        shift = torch.as_tensor(self.shift, dtype=q.dtype, device=q.device)
        return scale * (q - shift)

    def eval(self, q):
        """Interpolant values at [B, d] raw query points."""
        return self._eval_std(self._std(q))

    def eval_deriv(self, q):
        """Gradient [B, d] by autograd of the interpolant."""
        q = torch.atleast_2d(
            torch.as_tensor(q, dtype=self.xs.dtype, device=self.xs.device)
        ).detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self.eval(q).sum(), q)
        return g

    def residual(self):
        """Max |s(x_i) - y_i| at the sites (fit diagnostics)."""
        return torch.max(torch.abs(self.eval_sites() - self.values))

    def eval_sites(self):
        return self._eval_std(self.xs)


def _make_block_matvec(xs, phi, eps, smooth, block):
    """Matrix-free (A + smooth I) v with kernel blocks streamed from coords."""
    n = xs.shape[0]
    phi_d2 = _PHI_D2.get(_kernel_name(phi))

    def matvec(v):
        out = torch.empty_like(v)
        for s in range(0, n, block):
            xb = xs[s : s + block]
            if phi_d2 is not None:
                K = phi_d2(pairwise_d2(xb, xs), eps)
            else:
                K = phi(pairwise_dist(xb, xs), eps)
            out[s : s + block] = K @ v
        return out + smooth * v

    return matvec


def _cg(mv, dot, b, tol, maxiter):
    """CG from x0 = 0 until |r|^2 <= tol^2 |b|^2 or ``maxiter`` iterations:
    (x, r.r, iterations), JAX's loop and stopping rule."""
    b2 = dot(b, b)
    target = tol * tol * b2

    def cond(state):
        *_, rs, it = state
        return (rs > target) & (it < maxiter)

    def body(state):
        x, r, p, rs, it = state
        Ap = mv(p)
        alpha = rs / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new, it + 1

    it0 = torch.zeros((), dtype=torch.int32, device=b.device)
    x, _, _, rs, it = while_loop(
        cond, body, (torch.zeros_like(b), b, b, b2, it0)
    )
    return x, rs, it


def _cg_matfree(xs, y, phi, eps, smooth, tol, maxiter, block):
    """Conjugate gradients on (A + smooth I) lam = y without storing A:
    (lam, iterations).

    Relative tolerance on ||r||/||b||.  Global kernels (gaussian, IMQ) have
    condition numbers that grow explosively with N and flatness: plain CG
    is practical for compactly supported kernels or with a ridge.
    """
    matvec = _make_block_matvec(xs, phi, eps, smooth, block)
    x, _, it = _cg(matvec, torch.dot, y, tol, maxiter)
    return x, int(it)


def _projected_cg_matfree(xs, y, P, phi, eps, smooth, tol, maxiter, block):
    """Null-space projected CG for conditionally-PD kernels (TPS etc.):
    (lam, poly_coef, iterations).

    The saddle system [[A,P],[P^T,0]][lam;c]=[y;0] restricted to the
    constraint subspace P^T lam = 0 is positive definite, so CG applies to
    Pi A Pi lam = Pi y with Pi = I - Q Q^T (Q = reduced-QR basis of P); the
    polynomial tail follows as c = R^{-1} Q^T (y - A lam).
    """
    Q, R = torch.linalg.qr(P)  # [n, m], [m, m]

    def proj(v):
        return v - Q @ (Q.T @ v)

    matvec = _make_block_matvec(xs, phi, eps, smooth, block)
    lam, _, it = _cg(lambda v: proj(matvec(proj(v))), torch.dot, proj(y), tol, maxiter)
    lam = proj(lam)
    c = torch.linalg.solve_triangular(
        R, (Q.T @ (y - matvec(lam)))[:, None], upper=True
    )[:, 0]
    return lam, c, int(it)


def _local_lagrange_precond(
    xs, phi, eps, m: int, q: int = 50, n_anchor: int = 12, chunk: int = 4096
):
    """Local-Lagrange approximate inverse C ~= A^-1, applied as z = C r.

    For every site i, solve a LOCAL interpolation problem over its ``q``
    nearest neighbors plus ``n_anchor`` globally spread anchor sites, with
    the cardinal right-hand side ``e_i`` and the polynomial constraint; the
    solution is one sparse row ``C[i]``.  The anchors carry the smooth,
    global modes that pure k-NN sets miss.

    Build: one cKDTree query on the host (as in the JAX package), then
    batched LU solves of [chunk, q+n_anchor+m, .] local saddles on the
    sites' device.  Apply is a gather and a row-dot.  Returns (apply, C).
    """
    from scipy.spatial import cKDTree

    xs_h = xs.cpu().numpy()
    n, d = xs_h.shape
    q = min(q, n)
    _, nbrs = cKDTree(xs_h).query(xs_h, k=q)
    nbrs = nbrs.reshape(n, q).astype(np.int64)  # col 0 == i itself
    # Anchors: Morton-strided global sites (xs is Morton-ordered upstream).
    anchors = np.linspace(0, n - 1, n_anchor, dtype=np.int32).astype(np.int64)
    L = np.concatenate(
        [nbrs, np.broadcast_to(anchors, (n, n_anchor))], axis=1
    )  # [n, w]
    w = L.shape[1]
    # Duplicate columns (an anchor already among the neighbors) make the
    # local system singular: mark the later occurrence and decouple it.
    dup = np.zeros((n, w), bool)
    srt = np.sort(L, axis=1)
    eq = srt[:, 1:] == srt[:, :-1]
    order = np.argsort(L, axis=1, kind="stable")
    dup_sorted = np.concatenate([np.zeros((n, 1), bool), eq], axis=1)
    np.put_along_axis(dup, order, dup_sorted, axis=1)

    L_t = torch.as_tensor(L, device=xs.device)
    dup_t = torch.as_tensor(dup, device=xs.device)
    # Every local system is built in UNIT-scaled coordinates where the
    # kernel is homogeneous: c_local = c_unit / h^s.
    expo = _SCALE_EXPO.get(_kernel_name(phi))
    eye = torch.eye(w, dtype=xs.dtype, device=xs.device)

    def solve_chunk(Lc, dupc):
        c = Lc.shape[0]
        xb = xs[Lc]  # [c, w, d]
        keep = ~dupc
        if expo is not None:
            rel = xb - xb[:, :1, :]
            dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
            rad = torch.amax(torch.where(keep, dist, 0.0), dim=1)
            rad = torch.clamp_min(rad, 1e-30)[:, None, None]
            xb = rel / rad
        xb = torch.where(dupc[..., None], 1e8, xb)
        diff = xb[:, :, None, :] - xb[:, None, :, :]
        A = phi(torch.sqrt(torch.sum(diff * diff, dim=-1)), eps)
        # decouple poisoned rows: identity diagonal, zero elsewhere
        A = torch.where(keep[:, :, None] & keep[:, None, :], A, 0.0)
        A = A + torch.where(dupc[:, :, None], eye, 0.0)
        rhs = A.new_zeros((c, w))
        rhs[:, 0] = 1.0
        if m:
            Pb = _poly_basis_batched(xb, 1 if m == 3 else 0)
            Pb = torch.where(keep[..., None], Pb, 0.0)
            top = torch.cat([A, Pb], dim=2)
            bot = torch.cat([Pb.transpose(1, 2), A.new_zeros((c, m, m))], dim=2)
            A = torch.cat([top, bot], dim=1)
            rhs = torch.cat([rhs, A.new_zeros((c, m))], dim=1)
        sol = torch.linalg.solve(A, rhs[..., None])[..., 0]
        c_loc = sol[:, :w] * keep  # poisoned slots contribute 0
        if expo is not None:
            c_loc = c_loc / (rad[:, :, 0] ** expo)
        return c_loc

    C = torch.cat([
        solve_chunk(L_t[s : s + chunk], dup_t[s : s + chunk])
        for s in range(0, n, chunk)
    ])
    Cm = torch.where(dup_t, 0.0, C)

    def apply(r):
        """z = C r (nonsymmetric approximate inverse), for GMRES."""
        return torch.sum(Cm * r[L_t], dim=1)

    return apply, C


def _projected_pcg_matfree(
    xs, y, P, phi, eps, smooth, tol, maxiter, block,
    q: int = 50, n_anchor: int = 12,
):
    """Preconditioned solve on the constraint subspace, at scale.

    The same formulation as :func:`_projected_cg_matfree` (Pi A Pi on
    {P^T lam = 0}), solved by right-preconditioned restarted GMRES with the
    raw (nonsymmetric) local-Lagrange inverse, which converges in far fewer
    matvecs than a symmetrized PCG on thin-plate systems.

    Returns (lam, poly_coef, info dict with iters (matvecs) and
    rel_residual).
    """
    n = xs.shape[0]
    m = P.shape[1]
    if m:
        Q, R = torch.linalg.qr(P)

        def proj(v):
            return v - Q @ (Q.T @ v)

    else:

        def proj(v):
            return v

    matvec = _make_block_matvec(xs, phi, eps, smooth, block)
    pre, _ = _local_lagrange_precond(xs, phi, eps, m, q=q, n_anchor=n_anchor)

    def pmv(v):
        return proj(matvec(proj(v)))

    lam, rel, mv = _gmres_right(
        pmv, lambda r: proj(pre(r)), proj(y),
        m=min(60, max(10, n - 1)), tol=tol,
        max_restarts=max(1, maxiter // 60),
    )
    lam = proj(lam)
    if m:
        c = torch.linalg.solve_triangular(
            R, (Q.T @ (y - matvec(lam)))[:, None], upper=True
        )[:, 0]
    else:
        c = xs.new_zeros(0)
    info = {"iters": mv, "rel_residual": rel}
    log.info("projected GMRES: %d matvecs, rel residual %.2e", mv, rel)
    return lam, c, info


def _gmres_right(pmv, prec, b, m: int = 60, tol: float = 1e-10,
                 max_restarts: int = 20):
    """Right-preconditioned restarted GMRES(m).

    Solves pmv(x) = b with x = prec(u); the preconditioner may be
    NONSYMMETRIC.  The Arnoldi inner loop runs masked modified Gram-Schmidt
    with full [m+1, n] contractions on the device; the small least-squares
    problem min ||beta e1 - H y|| is solved on the host in float64, as in
    the JAX package.  One host read of the residual per restart.

    Returns (x, rel_residual, matvecs).
    """
    n = b.shape[0]
    bnorm = float(torch.linalg.vector_norm(b))
    rows = torch.arange(m + 1, device=b.device)
    x = torch.zeros_like(b)
    matvecs = 0
    res = bnorm
    for _ in range(max_restarts):
        r = b - pmv(x)
        beta = torch.linalg.vector_norm(r)
        V = b.new_zeros((m + 1, n))
        V[0] = r / torch.where(beta > 0, beta, 1.0)
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            w = pmv(prec(V[j]))
            h = (V @ w) * (rows <= j).to(b.dtype)  # masked MGS, rows 0..j
            w = w - V.T @ h
            hnorm = torch.linalg.vector_norm(w)
            h[j + 1] = hnorm
            H[:, j] = h
            V[j + 1] = w / torch.where(hnorm > 0, hnorm, 1.0)
        rhs = np.zeros(m + 1)
        rhs[0] = float(beta)
        y = np.linalg.lstsq(H.cpu().double().numpy(), rhs, rcond=None)[0]
        x = x + prec(V[:m].T @ torch.as_tensor(y, dtype=b.dtype, device=b.device))
        res = float(torch.linalg.vector_norm(b - pmv(x)))
        matvecs += m + 2
        if res <= tol * bnorm:
            break
    return x, res / max(bnorm, 1e-300), matvecs
