"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]
    python3 -m benchmark.control --workload <cell> --seeds <n> ... --fault <name> [--seconds <s>]

Without ``--fault`` it reads the low-precision control: for each seed it
makes the cell's inputs as a run does (sites, values, query pool, sampled
rows) and puts the reference, computed in TF32 (the precision below the
configuration's float32 with TF32 off), in the program's place: its
answers at the sampled rows are held against the float64 reference
exactly as a run's are.  The answers are deterministic, so each sampled
query is answered once, where a window would repeat it.

With ``--fault`` it runs the cell for ``--seconds`` with that fault of
``benchmark/tests/faults.py`` planted under the timed path, at the cell's
own size.

Prints one JSON line per seed: ``err_max`` beside the limit.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, generate, run


def reading(config, traffic, seed, device) -> dict:
    """The TF32 control's ``err_max`` at one seed."""
    sites, values = generate.problem(config, seed)
    pool = generate.query_pool(config, traffic, seed, device)
    rows = generate.sample_rows(traffic, seed, device)
    queries = torch.stack([pool[s][rows[s]] for s in range(pool.shape[0])])
    del pool
    P, S, dim = queries.shape
    flat = queries.reshape(-1, dim)
    t0 = time.perf_counter()
    _, ties, _ = check.reference(config, sites, values, flat, device)
    answers, _, uncertified = check.reference(config, sites, values, flat, device,
                                              precision="tf32")
    verdict = check.judge(answers.reshape(P, S), list(range(P)), ties.reshape(P, S, -1),
                          config["limits"]["err_max"])
    return {"seed": seed, "err_max": verdict["err_max"],
            "limit": config["limits"]["err_max"], "failed_slots": verdict["failed"],
            "control_uncertified": uncertified, "seconds": time.perf_counter() - t0}


def fault_reading(workload, seed, seconds, fault, device) -> dict:
    """``err_max`` of a run of ``workload`` with ``fault`` planted."""
    from benchmark.tests import faults

    try:
        res = run.execute(workload, seed, seconds, False, device=device, fault=fault)
    finally:
        faults.undo()
    c = res["checks"]["err_max"]
    return {"seed": seed, "fault": fault, "err_max": c["value"], "limit": c["limit"],
            "attempted": res["attempted"], "failed": res["failed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, config, traffic = run.cell_parts(run.load_spec(), args.workload)
    for seed in args.seeds:
        if args.fault:
            got = fault_reading(args.workload, seed, args.seconds, args.fault, args.device)
        else:
            got = reading(config, traffic, seed, args.device)
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
