"""The RBF and kriging family, the JAX package's and the port's, on the CPU.

Prints one JSON line per check, each on the same numpy inputs for both:

* ``wrap``: the compact RBF's 9-stencil matvec on 60 sites from
  ``default_rng(0).uniform(-0.5, 0.5)`` (values ``sin(3x) + y``) at
  epsilon 0.8, 2.5 and 4.0 (grids of 1, 2 and 3 cells per axis), each
  package's largest difference from the dense Wendland matvec; then
  ``CompactRbf`` of 60, 100 and 200 sites from ``default_rng(0).uniform(-1,
  1)`` (values ``sin(3x)·cos(2y)``, tol 1e-12): each package's ``residual()``
  and the largest miss of its ``eval`` at the sites.
* ``cond``: ``RbfInterp(solver="direct")`` at 80 sites (tests/test_rbf.py's
  inputs) per kernel and epsilon: the kernel matrix's condition number and
  the largest difference of the weights and of 300 evaluations.
* ``cg``: the relative CG residual per iteration of the projected thin-plate
  system at 150 sites with ``smooth`` 0.01, by JAX's jitted and eager
  matvecs and by the port's, at iterations 11, 16, 21 and 26.
* ``kriging``: the weather set's auto-fitted variogram, the number of
  diagonal distances above 0, the condition number of its saddle matrix
  and both packages' means at two queries; at ``--kriging-sites``
  (bench.py's kriging_100k sites and noise) both packages' variograms
  and, with each, the port's RMSE and calibration at 50,000 queries.
* ``gmres``: ``RbfInterp(kernel="thin_plate", solver="pcg")`` of
  ``--gmres-sites`` sites from ``default_rng(32).uniform(-1, 1)`` with
  ``cg_maxiter=--gmres-maxiter``: matvecs, relative residual and seconds.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/rbf_parity.py --gmres-sites 20000 --gmres-maxiter 180

(about 25 minutes; ``--gmres-sites 0`` and ``--kriging-sites 0`` skip the
slow checks).  Set ``GSI_TPU_CACHE_DIR`` to a scratch directory so the JAX
import leaves the checkout alone.
"""

import argparse
import json
import time

import numpy as np
import torch

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from gsl_scattered_interpolation_tpu.models import kriging as jkr  # noqa: E402
from gsl_scattered_interpolation_tpu.models import rbf as jrbf  # noqa: E402
from gsl_scattered_interpolation_tpu.models import rbf_compact as jrc  # noqa: E402
from gsl_scattered_interpolation_tpu.utils import datasets  # noqa: E402

from gsl_scattered_interpolation_torch.models import convert, kriging, rbf, rbf_compact  # noqa: E402

CPU = "cpu"


def emit(name, **rec):
    print(json.dumps({"check": name, **rec}), flush=True)


def wrap():
    xs = np.random.default_rng(0).uniform(-0.5, 0.5, (60, 2))
    v = np.sin(3 * xs[:, 0]) + xs[:, 1]
    diff = xs[:, None, :] - xs[None, :, :]
    r = np.sqrt((diff**2).sum(-1))
    for eps in (0.8, 2.5, 4.0):
        dense = rbf_compact._phi64(r, eps) @ v
        g = jrc.build_cell_grid(xs, 1 / eps)
        gt = rbf_compact.build_cell_grid(xs, 1 / eps, device=CPU)
        theirs = np.asarray(jrc.unpack_values(g, jrc.matvec_pad(
            g, jrbf.KERNELS["wendland_c2"].phi, eps, 0.0, jrc.pack_values(g, jnp.asarray(v)))))
        ours = rbf_compact.unpack_values(gt, rbf_compact.matvec_pad(
            gt, rbf.KERNELS["wendland_c2"].phi, eps, 0.0,
            rbf_compact.pack_values(gt, torch.tensor(v)))).numpy()
        emit("wrap_matvec", epsilon=eps, grid=list(g.shape),
             jax_vs_dense=float(np.abs(theirs - dense).max()),
             port_vs_dense=float(np.abs(ours - dense).max()))
    for n in (60, 100, 200):
        s = np.random.default_rng(0).uniform(-1, 1, (n, 2))
        f = np.sin(3 * s[:, 0]) * np.cos(2 * s[:, 1])
        ref = jrc.CompactRbf(s, f, tol=1e-12, maxiter=2000)
        ours = rbf_compact.CompactRbf(s, f, tol=1e-12, maxiter=2000, device=CPU)
        emit("wrap_fit", sites=n, grid=list(ours.grid.shape),
             jax_residual=float(ref.residual()),
             jax_eval_miss=float(np.abs(np.asarray(ref.eval(s)) - f).max()),
             port_residual=float(ours.residual()),
             port_eval_miss=float(np.abs(ours.eval(s).numpy() - f).max()))


def cond():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (80, 2))
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    q = np.random.default_rng(3).uniform(-1.1, 1.1, (300, 2))
    cases = [(k, None) for k in ("linear", "cubic", "thin_plate")]
    cases += [("wendland_c2", 2.0)]
    cases += [(k, e) for k in ("gaussian", "multiquadric", "inverse_multiquadric")
              for e in (2.0, 8.0)]
    for k, eps in cases:
        ref = jrbf.RbfInterp(x, f, kernel=k, epsilon=eps)
        ours = rbf.RbfInterp(x, f, kernel=k, epsilon=eps, device=CPU)
        A = np.asarray(ref.kernel.phi(jrbf.pairwise_dist(ref.xs, ref.xs), ref.epsilon))
        emit("cond", kernel=k, epsilon=ref.epsilon, condition=float(np.linalg.cond(A)),
             max_lam=float(np.abs(np.asarray(ref.lam)).max()),
             lam_diff=float(np.abs(ours.lam.numpy() - np.asarray(ref.lam)).max()),
             eval_diff=float(np.abs(ours.eval(q).numpy() - np.asarray(ref.eval(q))).max()))


def cg():
    x = np.random.default_rng(12).uniform(-1, 1, (150, 2))
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    ref = jrbf.RbfInterp(x, f, kernel="thin_plate", solver="direct")
    xs, y = ref.xs, ref.values
    eager = jrbf._make_block_matvec(xs, jrbf.KERNELS["thin_plate"].phi, 1.0, 0.01, 64)
    Q, _ = jnp.linalg.qr(jrbf._poly_basis(xs, 1))
    xt, yt = torch.tensor(np.asarray(xs)), torch.tensor(np.asarray(y))
    ours = rbf._make_block_matvec(xt, rbf.KERNELS["thin_plate"].phi, 1.0, 0.01, 64)
    Qt, _ = torch.linalg.qr(rbf._poly_basis(xt, 1))

    def run(A, Q, b, dot, iters=26):
        def P(v):
            return v - Q @ (Q.T @ v)

        b = P(b)
        r = p = b
        rs = dot(r, r)
        b2 = float(rs)
        out = []
        for _ in range(iters):
            Ap = P(A(P(p)))
            alpha = rs / dot(p, Ap)
            r = r - alpha * Ap
            rn = dot(r, r)
            p = r + rn / rs * p
            rs = rn
            out.append(float(np.sqrt(float(rs) / b2)))
        return out

    runs = {"jax_jit": run(jax.jit(eager), Q, y, jnp.vdot),
            "jax_eager": run(eager, Q, y, jnp.vdot),
            "port": run(ours, Qt, yt, torch.dot)}
    for it in (11, 16, 21, 26):
        emit("cg_residual", iteration=it, **{k: v[it - 1] for k, v in runs.items()})


def kriging_checks(n_sites):
    sites, temps = datasets.weather()
    ref = jkr.OrdinaryKriging(sites, temps)
    D = np.asarray(jrbf.pairwise_dist(ref.xs, ref.xs))
    G = np.asarray(ref.variogram(D))
    n = len(temps)
    K = np.block([[G, np.ones((n, 1))], [np.ones((1, n)), np.zeros((1, 1))]])
    ours = kriging.OrdinaryKriging(sites, temps, device=CPU)
    q = np.array([[-88.0, 41.5], [-88.5, 42.0]])
    emit("kriging_weather", variogram=list(ref.variogram),
         port_variogram=list(ours.variogram),
         diagonal_distances_above_0=int((np.diag(D) > 0).sum()),
         condition=float(np.linalg.cond(K)),
         jax_means=np.asarray(ref.predict(q)[0]).tolist(),
         port_means=ours.predict(q)[0].tolist())
    if not n_sites:
        return
    rng = np.random.default_rng(23)
    x = rng.uniform(0, 10, (n_sites, 2))
    f = np.sin(x[:, 0] * 0.8) + 0.5 * np.cos(x[:, 1] * 1.1) + 0.05 * rng.standard_normal(n_sites)
    q = rng.uniform(0.5, 9.5, (50_000, 2))
    truth = np.sin(q[:, 0] * 0.8) + 0.5 * np.cos(q[:, 1] * 1.1)
    y_new = truth + 0.05 * rng.standard_normal(len(q))
    vgs = {"jax": convert.variogram_from_jax(jkr.LocalKriging(x, f).variogram),
           "port": kriging.LocalKriging(x, f, device=CPU).variogram}
    for name, vg in vgs.items():
        mean, var = kriging.LocalKriging(x, f, variogram=vg, device=CPU).predict(q, chunk=8192)
        mean, var = mean.numpy(), var.numpy()
        emit("kriging_fit", sites=n_sites, variogram_of=name, variogram=list(vg),
             rmse=float(np.sqrt(np.mean((mean - truth) ** 2))),
             calibration=float(np.mean((mean - y_new) ** 2) / np.mean(var)))


def gmres(n_sites, maxiter):
    s = np.random.default_rng(32).uniform(-1, 1, (n_sites, 2))
    v = np.sin(3 * s[:, 0]) * np.cos(2 * s[:, 1]) + s[:, 1]
    for name, make in (
        ("port", lambda: rbf.RbfInterp(s, v, kernel="thin_plate", solver="pcg",
                                       cg_maxiter=maxiter, device=CPU)),
        ("jax", lambda: jrbf.RbfInterp(s, v, kernel="thin_plate", solver="pcg",
                                       cg_maxiter=maxiter)),
    ):
        t0 = time.perf_counter()
        m = make()
        emit("gmres", package=name, sites=n_sites, cg_maxiter=maxiter,
             matvecs=m.solve_info["iters"], rel_residual=m.solve_info["rel_residual"],
             seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gmres-sites", type=int, default=20000)
    ap.add_argument("--gmres-maxiter", type=int, default=180)
    ap.add_argument("--kriging-sites", type=int, default=100_000)
    args = ap.parse_args()
    wrap()
    cond()
    cg()
    kriging_checks(args.kriging_sites)
    if args.gmres_sites:
        gmres(args.gmres_sites, args.gmres_maxiter)


if __name__ == "__main__":
    main()
