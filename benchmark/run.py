"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number compared
with its limit.  The same numbers end standard error.  Without the cards,
or if JAX or the JAX package was loaded, it prints no result and exits 1.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import parts  # noqa: E402

ROOT = parts.HERE.parent


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, workload: str):
    """(cell, config, traffic) of ``workload``, each found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]

    def load(kind, name):
        path = parts.HERE / kind / f"{name}.json"
        if not path.is_file():
            raise SystemExit(f"benchmark: no {kind} file named {name!r}")
        return json.loads(path.read_text())

    return cell, load("configs", cell["config"]), load("traffic", cell["traffic"])


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``.  A metric ``<base>.<variant>`` with
    no file of its own is ``<base>``'s reading under another name: the same
    quantity in cells that report another end-to-end metric or bound."""
    while not parts.exists("metrics", name) and "." in name:
        name = name.rsplit(".", 1)[0]
    return parts.find("metrics", name).read


def read_metrics(metrics: list[dict], run: dict) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(workload, seed, seconds, trace, device="cuda", fault=None, spec=None,
            given=None) -> dict:
    """One run; the result object (without the card check).

    ``given`` (cell, config, traffic) and ``fault`` let the tests
    drive a run at a small size on the CPU, with the timed path broken
    underneath.
    """
    import torch

    from benchmark import serve

    spec = load_spec() if spec is None else spec
    cell, config, traffic = cell_parts(spec, workload) if given is None else given
    run = serve.single(config, traffic, seed, seconds, trace, device, T_PROCESS, fault)
    run.update(cell=cell, config=config, traffic=traffic)
    verdict = run["verdict"]
    result = {
        "correct": verdict["failed"] == 0 and verdict["attempted"] > 0
        and not run["forbidden"],
        "attempted": verdict["attempted"],
        "failed": verdict["failed"],
        "metrics": read_metrics(metrics_for(spec, workload, trace), run),
        "device": {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": run["memory_peak_bytes"]},
    }
    if trace and run["trace"]:
        result["device"]["busy_s"] = run["trace"]["busy_s"]
        result["device"]["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                               "idle_gaps": run["trace"]["idle_gaps"]}
    result["checks"] = dict(verdict["checks"],
                            forbidden_modules={"value": len(run["forbidden"]), "limit": 0})
    result["_forbidden"] = run["forbidden"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell, _, _ = cell_parts(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 1
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec)
    forbidden = result.pop("_forbidden")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    if forbidden:
        print(f"benchmark: loaded {', '.join(forbidden)}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
