"""Port's utils/serialize.py against the JAX package's, on the CPU: a
``.npz`` written by either package loads in the other with the same
fields, and ``interp`` of the loaded triangulation equals the original's
(tests/test_scattered_api.py::TestSerialize's round trip)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu import ScatteredInterp as JaxInterp
from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.utils import datasets as jdatasets
from gsl_scattered_interpolation_tpu.utils import serialize as jser

from gsl_scattered_interpolation_torch import ScatteredInterp
from gsl_scattered_interpolation_torch.models import device_tri
from gsl_scattered_interpolation_torch.utils import serialize

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _queries():
    rng = np.random.default_rng(2)
    return rng.uniform([-89.0, 41.2], [-87.0, 42.8], size=(100, 2))


@pytest.fixture(scope="module")
def weather():
    sites, temps = jdatasets.weather()
    return sites, temps


@pytest.mark.parametrize("engine", ["host", "device"])
def test_round_trip(tmp_path, weather, engine):
    sites, temps = weather
    si = ScatteredInterp(sites, temps, key=0, engine=engine, device=CPU)
    p = tmp_path / "tri.npz"
    serialize.save(p, si.tri, si.response)
    tri2, resp2 = serialize.load(p, device=CPU)
    for f in dataclasses.fields(tri2):
        a, b = getattr(tri2, f.name), getattr(si.tri, f.name)
        if f.name == "grid_res":
            assert a == b
        else:
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    q = torch.tensor(_queries())
    torch.testing.assert_close(
        device_tri.interp(tri2, resp2, q), device_tri.interp(si.tri, si.response, q),
        rtol=0, atol=0,
    )
    serialize.save(tmp_path / "bare.npz", si.tri)
    assert serialize.load(tmp_path / "bare.npz", device=CPU)[1] is None


def test_jax_file_loads_in_the_port(tmp_path, weather):
    sites, temps = weather
    si = JaxInterp(sites, temps, key=0)
    p = tmp_path / "jax.npz"
    jser.save(p, si.tri, si.response)
    tri, resp = serialize.load(p, device=CPU)
    q = _queries()
    want = np.asarray(jdt.interp(si.tri, si.response, jnp.asarray(q)))
    got = device_tri.interp(tri, resp, torch.tensor(q)).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_file_loads_in_jax(tmp_path, weather):
    sites, temps = weather
    si = ScatteredInterp(sites, temps, key=0, engine="host", device=CPU)
    p = tmp_path / "port.npz"
    serialize.save(p, si.tri, si.response)
    jtri, jresp = jser.load(p)
    for f in jtri._fields:
        if f != "grid_res":
            assert np.asarray(getattr(jtri, f)).dtype == getattr(si.tri, f).numpy().dtype
    q = _queries()
    got = np.asarray(jdt.interp(jtri, jresp, jnp.asarray(q)))
    want = device_tri.interp(si.tri, si.response, torch.tensor(q)).numpy()
    np.testing.assert_array_equal(got, want)
