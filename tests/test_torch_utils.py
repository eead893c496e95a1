"""The port's small modules against the JAX package's, on the CPU.

* ``ops/geometry``: unstandardize, bary_coords, bary_coords_scaled,
  contains, worst_violation and in_sphere within 1e-15 in float64 for
  d = 2 and 3 (closed-form Cramer solves in both packages), with the
  degenerate-simplex rules (ok False, finite outputs); for d = 4 each
  package runs a general LU (LAPACK in the port, XLA's in JAX), so
  well-conditioned simplexes are held within 1e-15 times the condition
  number;
* ``utils/integrity``: check_structure and check_delaunay give JAX's
  verdicts on the trees of tests/test_host_tree.py:88-141 and on corrupted
  copies; output_triangulation writes byte-equal files;
* ``utils/errors.strict_check``, ``utils/config`` and ``utils/profiling``;
* the package layout: every module that the JAX package's
  ``models/__init__.py`` and ``utils/__init__.py`` import resolves as an
  attribute of the port's subpackage after a bare ``import`` of the port,
  and ``utils/machine``'s constants and the ``version`` module equal JAX's.
"""

import ast
import json
import logging
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsl_scattered_interpolation_tpu as jgsi
from gsl_scattered_interpolation_tpu import version as jversion
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.ops import geometry as jgeom
from gsl_scattered_interpolation_tpu.utils import config as jconfig
from gsl_scattered_interpolation_tpu.utils import datasets as jdatasets
from gsl_scattered_interpolation_tpu.utils import integrity as jintegrity
from gsl_scattered_interpolation_tpu.utils import machine as jmachine

from gsl_scattered_interpolation_torch import version
from gsl_scattered_interpolation_torch.models import host_tree
from gsl_scattered_interpolation_torch.ops import geometry
from gsl_scattered_interpolation_torch.utils import config, errors, integrity, machine, profiling

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _simplexes(d, n, seed):
    """n random simplexes [n, d+1, d] and queries [n, d]; the first two
    simplexes degenerate, exactly in floating point (a repeated vertex; all
    vertices in the plane x_0 = 0.3)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (n, d + 1, d))
    v[0, 1] = v[0, 0]
    v[1, :, 0] = 0.3
    q = rng.uniform(-1, 1, (n, d))
    q[2] = v[2].mean(0)  # strictly inside
    return v, q


def _eq(got, want, tol=1e-15):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        scale = np.maximum(1.0, np.abs(want[fin]))
        assert np.all(np.abs(got[fin] - want[fin]) <= tol * scale)


@pytest.mark.parametrize("d", [2, 3])
def test_geometry_helpers_match_jax(d):
    v, q = _simplexes(d, 64, d)
    tv, tq = torch.tensor(v), torch.tensor(q)
    coords, ok = geometry.bary_coords(tv, tq)
    jcoords, jok = jgeom.bary_coords(jnp.asarray(v), jnp.asarray(q))
    _eq(coords, jcoords)
    _eq(ok, jok)
    assert not ok[0] and not ok[1] and ok[2]
    assert torch.isfinite(coords).all() and (coords[:2] == 0).all()
    _eq(geometry.contains(coords, ok), jgeom.contains(jcoords, jok))
    _eq(geometry.contains(coords), jgeom.contains(jcoords))
    assert bool(geometry.contains(coords, ok)[2])
    _eq(geometry.worst_violation(coords, ok), jgeom.worst_violation(jcoords, jok))
    _eq(geometry.worst_violation(coords), jgeom.worst_violation(jcoords))
    scale = np.random.default_rng(d).uniform(0.5, 2.0, d)
    shift = np.random.default_rng(d + 1).uniform(-1, 1, d)
    cs, oks = geometry.bary_coords_scaled(tv, tq, torch.tensor(scale))
    jcs, joks = jgeom.bary_coords_scaled(jnp.asarray(v), jnp.asarray(q), jnp.asarray(scale))
    _eq(cs, jcs)
    _eq(oks, joks)
    std = geometry.standardize(tq, torch.tensor(shift), torch.tensor(scale))
    _eq(geometry.unstandardize(std, torch.tensor(shift), torch.tensor(scale)),
        jgeom.unstandardize(jgeom.standardize(jnp.asarray(q), shift, scale), shift, scale))
    center, r2, cok = geometry.circumsphere(tv)
    jc, jr2, jcok = jgeom.circumsphere(jnp.asarray(v))
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        got = geometry.in_sphere(center.to(dt), r2.to(dt), cok, tq.to(dt))
        want = jgeom.in_sphere(jnp.asarray(jc, jdt), jnp.asarray(jr2, jdt), jcok,
                               jnp.asarray(q, jdt))
        _eq(got, want)
    # A degenerate simplex contains every point.
    assert bool(geometry.in_sphere(center, r2, cok, tq)[0])


def test_geometry_4d_lu_matches_jax():
    v, q = _simplexes(4, 64, 4)
    v, q = v[2:], q[2:]  # the non-degenerate simplexes
    M = np.swapaxes(v[:, :4, :] - v[:, 4:, :], -1, -2)
    cond = np.linalg.cond(M)[:, None]
    coords, ok = geometry.bary_coords(torch.tensor(v), torch.tensor(q))
    jcoords, jok = jgeom.bary_coords(jnp.asarray(v), jnp.asarray(q))
    assert ok.all() and np.asarray(jok).all()
    jcoords = np.asarray(jcoords)
    assert np.all(np.abs(coords.numpy() - jcoords)
                  <= 1e-15 * cond * np.maximum(1.0, np.abs(jcoords)))
    center, _, _ = geometry.circumsphere(torch.tensor(v))
    jc = np.asarray(jgeom.circumsphere(jnp.asarray(v))[0])
    cond = np.linalg.cond(v[:, :4, :] - v[:, 1:, :])[:, None]
    assert np.all(np.abs(center.numpy() - jc) <= 1e-15 * cond * np.maximum(1.0, np.abs(jc)))


def _corrupt_link(tree):
    node = tree.leaves()[3]
    k = int(np.nonzero(tree.tri_links[node])[0][0])
    tree.tri_links[node, k] = node  # its own neighbour
    return tree


def _corrupt_vertex(tree):
    node = tree.leaves()[2]
    tree.tri_points[node, 1] = tree.tri_points[node, 0]  # a repeated vertex
    return tree


def _move_point(tree):
    # A data point moved into a leaf's circumsphere breaks the Delaunay
    # property; the structure stays sound.
    node = tree.leaves()[len(tree.leaves()) // 2]
    c, _ = tree._circumsphere_pts(tree.tri_points[node])
    pid = next(p for p in range(tree.n_points) if p not in tree.tri_points[node])
    tree.data = tree.data.copy()
    tree.data[tree.shuffle[pid]] = c / tree.scale + tree.shift
    return tree


TREES = {
    "uniform_2d_cavity": lambda m: m.build(np.random.default_rng(50).uniform(-0.5, 0.5, (50, 2)),
                                           flags=m.NOSTANDARDIZE, method="cavity"),
    "uniform_2d_flips": lambda m: m.build(np.random.default_rng(10).uniform(-0.5, 0.5, (10, 2)),
                                          flags=m.NOSTANDARDIZE, method="flips"),
    "uniform_3d_cavity": lambda m: m.build(np.random.default_rng(7).uniform(-0.5, 0.5, (40, 3)),
                                           flags=m.NOSTANDARDIZE),
    "uniform_3d_flips": lambda m: m.build(np.random.default_rng(7).uniform(-0.5, 0.5, (40, 3)),
                                          flags=m.NOSTANDARDIZE, method="flips"),
    "lattice_2d": lambda m: m.build(
        np.stack(np.meshgrid(*[np.arange(5.0)] * 2, indexing="ij"), -1).reshape(-1, 2),
        flags=m.NOSTANDARDIZE),
    "weather": lambda m: m.build(jdatasets.weather()[0]),
}


def _verdict(fn, tree):
    try:
        fn(tree)
    except AssertionError as e:
        return str(e).split(":")[0].split(" in ")[0]
    return "ok"


@pytest.mark.parametrize("corrupt", [None, _corrupt_link, _corrupt_vertex, _move_point])
@pytest.mark.parametrize("name", sorted(TREES))
def test_integrity_verdicts_match_jax(name, corrupt):
    ours, theirs = TREES[name](host_tree), TREES[name](jht)
    if corrupt is not None:
        ours, theirs = corrupt(ours), corrupt(theirs)
    for fn, jfn in ((integrity.check_structure, jintegrity.check_structure),
                    (integrity.check_delaunay, jintegrity.check_delaunay)):
        v = _verdict(fn, ours)
        assert v == _verdict(jfn, theirs)
        # The port's checks read a JAX tree as well.
        assert v == _verdict(fn, theirs)
    if corrupt is None and name != "uniform_3d_flips":
        assert _verdict(integrity.check_structure, ours) == "ok"
        assert _verdict(integrity.check_delaunay, ours) == "ok"


@pytest.mark.parametrize("standardize", [False, True])
def test_output_triangulation_byte_equal(tmp_path, standardize):
    sites, temps = jdatasets.weather()
    ours, theirs = host_tree.build(sites), jht.build(sites)
    files = {}
    for tag, mod, tree in (("port", integrity, ours), ("jax", jintegrity, theirs)):
        paths = {k: tmp_path / f"{tag}_{k}.txt" for k in ("lines", "points", "circles")}
        mod.output_triangulation(
            tree, temps, standardize=standardize, lines_path=paths["lines"],
            points_path=paths["points"], circles_path=paths["circles"])
        files[tag] = {k: p.read_bytes() for k, p in paths.items()}
    for k in ("lines", "points", "circles"):
        assert len(files["port"][k]) > 100
        assert files["port"][k] == files["jax"][k], k


def test_strict_check():
    errors.strict_check(torch.tensor([True, True]), errors.DomainError, "fine")
    with pytest.raises(errors.SingularError, match="bad"):
        errors.strict_check(torch.tensor([True, False]), errors.SingularError, "bad")


def test_config_reads_the_jax_names(monkeypatch):
    monkeypatch.delenv("GSI_TPU_SEED", raising=False)
    assert config.env_seed(5) == jconfig.env_seed(5) == 5
    monkeypatch.setenv("GSI_TPU_SEED", "17")
    assert config.env_seed(5) == jconfig.env_seed(5) == 17
    level = config.log.level
    monkeypatch.setenv("GSI_TPU_VERBOSE", "1")
    try:
        config.env_setup()
        assert config.log.level == logging.INFO
    finally:
        config.log.setLevel(level)


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", None, torch.float32),
    ("cpu", None, torch.float64),
    ("cuda", torch.float64, torch.float64),
    ("cpu", torch.float32, torch.float32),
])
def test_device_dtype_rule(device, dtype, want):
    """The port's precision rule, where the JAX package reads GSI_TPU_X64:
    float32 on CUDA, float64 elsewhere, unless dtype is given.  No tensor
    is made, so the CUDA cases need no card."""
    got_device, got_dtype = config.device_dtype(device, dtype)
    assert got_device == torch.device(device)
    assert got_dtype == want


def test_timer_and_trace(tmp_path):
    timer = profiling.Timer()
    x = torch.arange(1000.0)
    with timer.time("sum", result=x):
        y = x.sum()
    out = timer.timed("mul", torch.mul, x, 2.0)
    timer.timed("mul", torch.mul, y, 3.0)
    assert torch.equal(out, x * 2.0)
    assert timer.counts == {"sum": 1, "mul": 2}
    assert all(t >= 0.0 for t in timer.times.values())
    assert timer.report().splitlines()[0].startswith("mul: ")
    with profiling.trace(str(tmp_path / "tr")):
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _reference_submodules(subpackage):
    """The modules the JAX package's ``<subpackage>/__init__.py`` imports."""
    path = REPO / "gsl_scattered_interpolation_tpu" / subpackage / "__init__.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 1 and node.module is None:
            names += [a.name for a in node.names]
    return names


SUBMODULES = [(sub, name) for sub in ("models", "utils", "parallel")
              for name in _reference_submodules(sub)]


@pytest.fixture(scope="module")
def port_attributes():
    """{(subpackage, name): module name} as a fresh process sees them after
    nothing but ``import gsl_scattered_interpolation_torch as gsi``: in
    this process other imports have already set the attributes."""
    script = (
        "import json, torch\n"
        "torch.set_num_threads(1)\n"
        "import gsl_scattered_interpolation_torch as gsi\n"
        f"pairs = {SUBMODULES!r}\n"
        "print(json.dumps({f'{s}.{n}': getattr(getattr(getattr(gsi, s), n, None), "
        "'__name__', None) for s, n in pairs}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_exposes_submodules():
    assert len(SUBMODULES) == 18
    for sub, name in SUBMODULES:
        assert getattr(getattr(jgsi, sub), name).__name__ == (
            f"gsl_scattered_interpolation_tpu.{sub}.{name}")


@pytest.mark.parametrize("sub,name", SUBMODULES, ids=lambda v: v)
def test_port_exposes_the_reference_submodules(port_attributes, sub, name):
    assert port_attributes[f"{sub}.{name}"] == f"gsl_scattered_interpolation_torch.{sub}.{name}"


def test_machine_constants_and_version_match_jax():
    for const in ("DBL_EPSILON", "SQRT_DBL_EPSILON", "ROOT5_DBL_EPSILON"):
        assert getattr(machine, const) == getattr(jmachine, const), const
    assert machine.SQRT_DBL_EPSILON == 1.4901161193847656e-08
    assert version.__version__ == jversion.__version__ == jgsi.__version__
    import gsl_scattered_interpolation_torch as gsi

    assert gsi.__version__ == version.__version__
