"""Parts dropped into the folders are found by name, with no edit to any file
that is there: a configuration with a new system, field and site
distribution, a traffic mix with a new query distribution, and a metric."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(run.__file__).resolve().parents[1]

CLUSTERED = '''
"""clustered: Gaussian clusters about seeded centres in ``centres``; queries
are clipped to ``box``."""
import numpy as np
import torch


def sites(rng, n, dim, params):
    lo, hi = params["centres"]
    centres = rng.uniform(lo, hi, size=(params["clusters"], dim))
    pick = rng.integers(0, params["clusters"], n)
    return centres[pick] + rng.normal(0, params["sigma"], (n, dim))


def queries(gen, shape, dim, params, dtype, device):
    lo, hi = params["centres"]
    c = torch.rand(params["clusters"], dim, generator=gen, device=device,
                   dtype=dtype) * (hi - lo) + lo
    pick = torch.randint(0, params["clusters"], shape, generator=gen, device=device)
    q = c[pick] + params["sigma"] * torch.randn(*shape, dim, generator=gen,
                                                device=device, dtype=dtype)
    return q.clamp(*params["box"])
'''

RAMP = '''
"""ramp: x + 2y."""


def values(sites):
    return sites[:, 0] + 2 * sites[:, 1]
'''

WALK = '''
"""walk: ScatteredInterp's triangulation answered by the visibility walk."""
import torch

from gsl_scattered_interpolation_torch.models import device_tri, scattered


def build(config, sites, values, device):
    si = scattered.ScatteredInterp(sites, values, flags=getattr(scattered, config["flags"]),
                                   dtype=getattr(torch, config["dtype"]), device=device)
    return lambda q: device_tri.interp(si.tri, si.response, q, method="walk")


def counters():
    return {"walk.queries": device_tri.locate.queries}
'''

SCRIPT = """
import json, sys
from benchmark import parts
from benchmark.tests.helpers import execute_small
res = execute_small("tri2d_ramp.eval_clustered", seconds=0.5, trace=True)
res.pop("_forbidden")
print(json.dumps({"res": res, "loaded": sorted(k for k in sys.modules
                                               if k.startswith("benchmark."))}))
"""


def _copy(tmp_path) -> Path:
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    return dst


def test_new_parts_are_found_by_name(tmp_path):
    dst = _copy(tmp_path)
    b = dst / "benchmark"
    (b / "distributions" / "clustered.py").write_text(CLUSTERED)
    (b / "functions" / "ramp.py").write_text(RAMP)
    (b / "systems" / "walk.py").write_text(WALK)
    (b / "metrics" / "requests_per_s.py").write_text(
        "def read(run):\n    return run['requests'] / run['window_s']\n")
    config = json.loads((b / "configs" / "tri2d_2k.json").read_text())
    clustered = {"name": "clustered", "box": [-0.45, 0.45], "centres": [-0.3, 0.3],
                 "clusters": 5, "sigma": 0.03}
    (b / "configs" / "tri2d_ramp.json").write_text(json.dumps(dict(
        config, name="tri2d_ramp", system="walk", function="ramp",
        site_distribution=clustered)))
    mix = json.loads((b / "traffic" / "eval.json").read_text())
    (b / "traffic" / "eval_clustered.json").write_text(json.dumps(dict(
        mix, query_distribution=clustered)))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tri2d_ramp.eval_clustered", "config": "tri2d_ramp",
                              "traffic": "eval_clustered", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "requests_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "device", "moves": "eval_qps",
                              "workloads": ["tri2d_ramp.eval_clustered"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(dst), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=dst, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    res = out["res"]
    assert res["correct"] is True and res["checks"]["err_max"]["value"] < 1e-5
    assert res["metrics"]["requests_per_s"]["value"] > 0
    for part in ("distributions.clustered", "functions.ramp", "systems.walk",
                 "metrics.requests_per_s", "loops.closed", "reference.delaunay_linear"):
        assert f"benchmark.{part}" in out["loaded"]


def test_every_part_of_the_benchmark_is_found():
    spec = run.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.reader(m["name"]))
    for w in spec["workloads"]:
        _, config, traffic = run.cell_parts(spec, w["name"])
        from benchmark.parts import find

        for kind, name in (("systems", config["system"]), ("reference", config["reference"]),
                           ("functions", config["function"]),
                           ("distributions", config["site_distribution"]["name"]),
                           ("distributions", traffic["query_distribution"]["name"]),
                           ("loops", traffic["loop"])):
            assert find(kind, name)


def test_a_variant_reads_its_base_metric():
    read = run.reader("eval_qps.cells")
    assert read is run.reader("eval_qps")
    with pytest.raises(SystemExit):
        run.reader("no_such_metric.cells")


def test_a_mix_the_harness_does_not_build_is_refused():
    spec = run.load_spec()
    spec["workloads"].append({"name": "tri2d_2k.open", "config": "tri2d_2k",
                              "traffic": "no_such_mix", "chips": 1, "why": "test"})
    with pytest.raises(SystemExit):
        run.cell_parts(spec, "tri2d_2k.open")
    from benchmark.parts import find

    with pytest.raises(SystemExit):
        find("loops", "open")
