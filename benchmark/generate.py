"""The inputs of a cell, made from ``--seed``: sites, values, query pool and
the sampled rows that the comparison reads.

One general generator.  The configuration gives the sites (how many, in
how many dimensions, spread by which distribution) and the function
sampled at them; the traffic mix gives the batches (size, pool, dtype,
distribution).  Distributions and functions are parts found by name
(:mod:`benchmark.parts`).  Every seed makes the same sizes; only the
points differ.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.parts import find

SEED_MOD = 2**63


def _seeds(seed: int):
    """(sites, queries, sample) seeds: one stream each."""
    s = int(seed) % SEED_MOD
    return s, (s + 1) % SEED_MOD, (s + 2) % SEED_MOD


def problem(config: dict, seed: int):
    """(sites [n, dim] float64, values [n] float64), numpy, on the host."""
    dist = config["site_distribution"]
    rng = np.random.default_rng(_seeds(seed)[0])
    sites = find("distributions", dist["name"]).sites(rng, config["sites"], config["dim"], dist)
    return sites, find("functions", config["function"]).values(sites)


def query_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """[pool, batch, dim] queries in the traffic's dtype, made on ``device``."""
    dist = traffic["query_distribution"]
    gen = torch.Generator(device=device).manual_seed(_seeds(seed)[1])
    return find("distributions", dist["name"]).queries(
        gen, (traffic["pool"], traffic["batch"]), config["dim"], dist,
        getattr(torch, traffic["dtype"]), device)


def sample_rows(traffic: dict, seed: int, device) -> torch.Tensor:
    """[pool, sample_rows] row indices of each pool batch whose answers
    every request of that batch is judged by."""
    gen = torch.Generator().manual_seed(_seeds(seed)[2])
    rows = torch.randint(0, traffic["batch"], (traffic["pool"], traffic["sample_rows"]),
                         generator=gen)
    return rows.to(device)
