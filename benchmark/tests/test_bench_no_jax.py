"""A cell's import path loads neither JAX nor the JAX package, compared by
whole top-level module names (the port's name begins with the package's)."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark import serve

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys
from benchmark import run
from benchmark.tests.helpers import execute_small
res = execute_small("tri2d_2k.eval", seconds=0.5, trace=True)
print(json.dumps({"correct": res["correct"], "forbidden": res["_forbidden"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_cell_import_path_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["forbidden"] == []
    assert "gsl_scattered_interpolation_torch" in out["top"]
    assert not set(out["top"]) & set(serve.FORBIDDEN)


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "gsl_scattered_interpolation_tpu_like", sys)
    assert "gsl_scattered_interpolation_tpu" not in serve.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert serve.forbidden_modules() == ["jax"]
