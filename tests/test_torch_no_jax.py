"""The port runs without JAX and without the JAX package.

The card's machine has no JAX, so neither the port nor chip_smoke.py may
import it, directly or through ``gsl_scattered_interpolation_tpu``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (test files import both frameworks)
import numpy as np
import pytest
import torch  # noqa: F401

from gsl_scattered_interpolation_tpu.utils import datasets

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "gsl_scattered_interpolation_torch"
FORBIDDEN = ("jax", "jaxlib", "gsl_scattered_interpolation_tpu")

_SCRIPT = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
# One intra-op thread: the test workers share the machine's cores, and a
# thread pool per process would oversubscribe them.
torch.set_num_threads(1)
import chip_smoke
from gsl_scattered_interpolation_torch import ScatteredInterp
from gsl_scattered_interpolation_torch.utils import datasets
sites, temps = datasets.weather()
si = ScatteredInterp(sites, temps, key=0, engine="host", device="cpu")
v = si.eval(np.array([[-88.0, 41.5], [1e7, 1e7]]))
tri = chip_smoke.host_triangulation(30, 0, "cpu")
print(si.n_simplexes, tri.n_tris, float(v[0]), float(v[1]))
sd = ScatteredInterp(sites, temps, key=0, engine="device", device="cpu")
vd = sd.eval(np.array([[-88.0, 41.5], [1e7, 1e7]]))
td = chip_smoke.device_triangulation(30, 0, "cpu")
print(sd.n_simplexes, td.n_tris, float(vd[0]), float(vd[1]))
from gsl_scattered_interpolation_torch.models import device_tri
q = np.array([[-88.0, 41.5], [-87.6, 42.1], [-89.4, 41.1], [1e7, 1e7]])
routes = [sd.eval(q)]
device_tri.DENSE_LOCATE_MAX_TRIS = 8  # the facade now builds its cell index
routes.append(sd.eval(q))
qt = sd._queries(q)
routes.append(device_tri.interp(sd.tri, sd.response, qt, method="walk"))
cells = device_tri._build_cell_index_device(sd.tri)
routes.append(device_tri.interp(sd.tri, sd.response, qt, method="cells", cells=cells))
print(sd._cells is not None, cells.complete)
for v in routes:
    print(*(float(x) for x in v))
from gsl_scattered_interpolation_torch.models import device_delaunay as dd
stats = dict()
tc, _ = dd.triangulate(np.random.default_rng(0).uniform(-0.5, 0.5, (600, 2)), device="cpu",
                       chunk_threshold=100, seed_min=100, stats=stats)
print(tc.n_tris, stats["seeded"])
sites3 = np.random.default_rng(3).uniform(-0.5, 0.5, (40, 3))
s3 = ScatteredInterp(sites3, sites3 @ np.array([1.0, -2.0, 0.5]), key=0, engine="cavity", device="cpu")
q3 = np.array([[0.1, -0.2, 0.05], [0.0, 0.1, -0.1], [1e7, 1e7, 1e7]])
v3 = [s3.eval(q3)]
device_tri.DENSE_LOCATE_MAX_TRIS = 8  # the facade's 3D cell index
s3._cells = None
v3.append(s3.eval(q3))
print(s3.engine, s3._cells is not None, s3._cells.k)
for v in v3:
    print(*(float(x) for x in v))
from gsl_scattered_interpolation_torch.models import kriging, rbf, rbf_compact, rbf_pu
xr = np.random.default_rng(5).uniform(-1, 1, (120, 2))
fr = np.sin(3 * xr[:, 0]) * np.cos(2 * xr[:, 1])
fits = [rbf.RbfInterp(xr, fr, device="cpu").eval(xr),
        rbf.RbfInterp(xr, fr, solver="pcg", cg_tol=1e-12, device="cpu").eval(xr),
        rbf_compact.CompactRbf(xr, fr, tol=1e-12, device="cpu").eval(xr),
        rbf_pu.evaluate(rbf_pu.fit(xr, fr, device="cpu"), xr),
        kriging.LocalKriging(xr, fr, device="cpu").predict(xr)[0]]
print(*(float((v.numpy() - fr).__abs__().max()) for v in fits))
import gsl_scattered_interpolation_torch as gsi
from gsl_scattered_interpolation_torch.models import geometry_extras, surface, thinning
from gsl_scattered_interpolation_torch.utils import config, integrity, profiling, serialize, testing
xs = np.linspace(0.0, 3.0, 12)
one = [gsi.interp(xs, np.sin(xs), k, device="cpu").eval(xs) for k in ("cspline", "akima")]
two = gsi.interp2d(xs, xs, np.outer(np.sin(xs), np.cos(xs)), device="cpu").eval(xs, xs)
print(float(max((v.numpy() - np.sin(xs)).__abs__().max() for v in one)),
      float((two.numpy() - np.sin(xs) * np.cos(xs)).__abs__().max()))
from scipy.spatial import Delaunay
tri = geometry_extras.from_scipy_delaunay(Delaunay(xr), xr, device="cpu")
th = thinning.thin(xr, fr, tol=0.05, key=0, device="cpu")
print(len(geometry_extras.convex_hull_points(tri)), len(geometry_extras.voronoi(tri)[0]),
      th.max_error <= 0.05, surface.alpha_shape(tri, 0.5).faces.shape[1])
"""


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_slice_runs_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(forbidden=FORBIDDEN)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    sites, temps = datasets.weather()
    lines = out.stdout.split("\n")
    for engine, line in zip(("host", "device"), lines[:2]):
        n_simplexes, n_tris, inside, outside = line.split()
        assert int(n_simplexes) == 2 * len(sites) + 1 and int(n_tris) == 61, engine
        assert temps.min() <= float(inside) <= temps.max()
        assert float(outside) == 0.0
        assert np.isfinite(float(inside))
    # Both engines triangulate the weather set alike away from its
    # cocircular quad, so this query gets the same value.
    assert float(lines[0].split()[2]) == pytest.approx(float(lines[1].split()[2]), abs=1e-9)
    # Brute force, the facade's lazy cell index, the walk and the device
    # index give the device engine's values alike.
    assert lines[2].split() == ["True", "False"]
    dense, *others = (np.array(line.split(), float) for line in lines[3:7])
    assert dense[-1] == 0.0 and np.all(np.isfinite(dense))
    for v in others:
        np.testing.assert_allclose(v, dense, rtol=0, atol=1e-9)
    # The chunked route, seeded from Qhull.
    assert lines[7].split() == ["1201", "True"]
    # The 3D cavity build, by brute force and through its 3D cell index.
    assert lines[8].split() == ["cavity", "True", "24"]
    dense3, cells3 = (np.array(line.split(), float) for line in lines[9:11])
    assert dense3[-1] == 0.0 and np.all(np.isfinite(dense3))
    np.testing.assert_allclose(cells3, dense3, rtol=0, atol=1e-9)
    # The RBF and kriging family interpolates its sites: RbfInterp direct
    # and pcg, CompactRbf, the partition-of-unity fit, LocalKriging.
    resid = np.array(lines[11].split(), float)
    assert resid.shape == (5,) and np.all(resid < 1e-6), resid
    # The GSL structured family reproduces its knots; the geometry
    # consumers run over a Qhull import.
    knots = np.array(lines[12].split(), float)
    assert knots.shape == (2,) and np.all(knots < 1e-12), knots
    n_hull, n_vor, thin_ok, face_width = lines[13].split()
    assert int(n_hull) >= 3 and int(n_vor) > 100 and thin_ok == "True" and face_width == "2"
