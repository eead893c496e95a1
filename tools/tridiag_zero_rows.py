"""Time the tridiagonal kernel on right-hand sides whose solution rows turn
to zero, on one CUDA card.

The cyclic spline solve (``solve_symm_cyc_tridiag``) solves its matrix
with two right-hand sides, the data b and the Sherman-Morrison column u,
which is zero except its first and last rows; its sweeps decay
geometrically from both ends, so most rows divide an exact zero.  This
script builds the float64 cspline_periodic system of chip_smoke.py's gsl1d_1m
knots (10^6 rows, ``default_rng(41)``) and times ``tridiag.thomas_cuda``
(CUDA events, 3 calls) on [b], [u], [b, b] and [b, u], printing each
time with the count of zero and subnormal rows of the solution:

    PYTHONPATH=. python3 tools/tridiag_zero_rows.py
"""

import subprocess

import numpy as np
import torch

import chip_smoke
from gsl_scattered_interpolation_torch.ops import tridiag

N = 999_999


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(41)
    x = np.cumsum(rng.uniform(0.5, 1.5, N + 1))
    h = torch.tensor(np.diff(x), device="cuda")
    h_next = torch.roll(h, -1)
    d = (2.0 * (h + h_next)).contiguous()
    e = h_next[:-1].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = torch.randn(N, generator=gen, device="cuda", dtype=torch.float64)
    u = torch.zeros_like(b)
    u[0] = -d[0]
    u[-1] = h_next[-1]
    tiny = torch.finfo(torch.float64).tiny
    for label, rhs in (("b", b[:, None]), ("u", u[:, None]),
                       ("b,b", torch.stack([b, b], -1)), ("b,u", torch.stack([b, u], -1))):
        rhs = rhs.contiguous()
        ms = chip_smoke.time_ms(lambda: tridiag.thomas_cuda(d, e, rhs), 3)
        sol = tridiag.thomas_cuda(d, e, rhs)
        zeros = int((sol == 0).sum())
        subnormal = int(((sol != 0) & (sol.abs() < tiny)).sum())
        print(f"rhs [{label}]: {ms:.2f} ms, {zeros} zero and {subnormal} subnormal rows")


if __name__ == "__main__":
    main()
