"""uniform: points uniform in the cube ``box`` = [lo, hi]^dim.

Frozen copies of ``chip_smoke.py``'s generators: sites as its
``headline_problem`` draws them (lines 140-149 there; bench.py:82-84 for
the headline's 2,000 sites and bench.py:155-158 for the 1M build's sites,
numpy's ``default_rng`` on the host), queries as its ``uniform_queries``
(lines 152-158: torch's generator on the device).
"""

import torch


def sites(rng, n: int, dim: int, params: dict):
    """[n, dim] float64 numpy array from ``rng`` (numpy Generator)."""
    lo, hi = params["box"]
    return rng.uniform(lo, hi, size=(n, dim))


def queries(gen, shape: tuple, dim: int, params: dict, dtype, device) -> torch.Tensor:
    """[*shape, dim] tensor of ``dtype`` made on ``device`` from ``gen``."""
    lo, hi = params["box"]
    q = torch.rand(*shape, dim, generator=gen, device=device, dtype=dtype)
    return q * (hi - lo) + lo
