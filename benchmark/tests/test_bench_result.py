"""The result line: its keys, its checks, and no result without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests.helpers import execute_small

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_five_keys_and_checks_last(trace):
    res = execute_small("tri2d_2k.eval", trace=trace)
    res.pop("_forbidden")
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["err_max"]["value"] <= res["checks"]["err_max"]["limit"]
    json.loads(json.dumps(res))  # every value is plain JSON
    names = {m["name"] for m in run.metrics_for(run.load_spec(), "tri2d_2k.eval", trace)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert {"eval_qps", "setup_s"} <= set(res["metrics"])


def test_run_without_a_card_fails_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tri2d_2k.eval",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_run_outside_a_checkout_of_the_port_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tri2d_2k.eval",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_card_run_is_correct(cuda_card):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tri2d_2k.eval",
         "--seed", str(2**31 + 7), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
