"""The comparison that decides ``correct``.

Every request of the window stores its answers at the sampled rows of its
pool batch (:func:`generate.sample_rows`).  Once the window has closed and
the program's state is freed, the configuration's plain reference works
the values at those queries out again from the sites, the values and the
queries alone, and every stored answer is held against them.  An answer's
error is its distance to the nearest value that the reference admits: the
Delaunay triangle's, or a tie's (see the reference's docstring).

Numbers compared, each beside its limit:

* ``err_max``: the largest error over every sampled answer of every
  request (a non-finite answer counts as ``NOT_FINITE``).

A request with an answer over the limit is ``failed``.
"""

from __future__ import annotations

import torch

from benchmark.parts import find


def reference(config: dict, sites, values, queries, device, precision="float64"):
    """(value [M], admitted values [M, k], uncertified) of the
    configuration's reference (``reference/<config["reference"]>.py``) at
    ``queries`` [M, dim], float64 (its control's precision on request)."""
    return find("reference", config["reference"]).admitted(
        config, sites, values, queries, device, precision)


# The error of an answer that is not finite (JSON has no infinity).
NOT_FINITE = 1e30


def errors(answers, ties) -> torch.Tensor:
    """Error of each answer [..., S] against its admitted values
    [..., S, k]: the distance to the nearest, ``NOT_FINITE`` where the
    answer is not finite."""
    a = answers.to(torch.float64)
    d = (a[..., None] - ties.to(torch.float64)).abs()
    d = torch.where(torch.isnan(d), torch.inf, d).amin(dim=-1)
    return torch.where(torch.isfinite(a), d, NOT_FINITE)


def judge(stored, slots, ties, limit: float) -> dict:
    """Hold every request's stored answers against the reference.

    stored [R, S]: request r's answers at the sampled rows of its pool
    batch ``slots[r]``; ties [pool, S, k] the admitted values there.
    Returns {"attempted", "failed", "err_max", "checks"}.
    """
    R = stored.shape[0]
    if R == 0:
        return {"attempted": 0, "failed": 0, "err_max": NOT_FINITE,
                "checks": {"err_max": {"value": NOT_FINITE, "limit": limit}}}
    worst = torch.empty(R, dtype=torch.float64, device=stored.device)
    slots = torch.as_tensor(slots, device=stored.device)
    for s in range(ties.shape[0]):
        sel = slots == s
        if bool(sel.any()):
            worst[sel] = errors(stored[sel], ties[s].to(stored.device)).amax(dim=-1)
    err_max = float(worst.max())
    failed = int((worst > limit).sum())
    return {
        "attempted": R,
        "failed": failed,
        "err_max": err_max,
        "checks": {"err_max": {"value": err_max, "limit": limit}},
    }
