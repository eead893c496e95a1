"""Small cells for the CPU tests: a cell with its configuration and traffic
cut to a size a test run holds."""

from __future__ import annotations

from benchmark import run


def small_parts(workload: str, sites: int = 300, batch: int = 2000, sample_rows: int = 256,
                pool: int = 4):
    cell, config, traffic = run.cell_parts(run.load_spec(), workload)
    config = dict(config, sites=sites)
    traffic = dict(traffic, batch=batch, pool=pool, sample_rows=sample_rows)
    return cell, config, traffic


def execute_small(workload: str, seconds: float = 1.0, trace: bool = False, fault=None,
                  seed: int = 2**31 + 12345, **kw) -> dict:
    return run.execute(workload, seed, seconds, trace, device="cpu", fault=fault,
                       given=small_parts(workload, **kw))
