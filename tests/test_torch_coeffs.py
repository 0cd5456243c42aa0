"""`assemble_coeffs` in orbit form, the Eddington set and the 1-D layer
partition: port against the JAX package on the small test LUT, with a
grid whose thick upper layers solve 1-D (aspect >= 2) and thin lower
layers 3-D.

Tolerances: interpolated and analytic Eddington coefficients agree to a
few float32 ulps (atol 2e-6; the Eddington direct-source terms a13/a23
cancel, atol 2e-5); the closed-form dir2dir is held at 5e-5 (see
test_torch_optprop.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts import coeffs as jc
from tenstream_tpu.pprts import sun as jsun
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts import coeffs as tc
from tenstream_tpu_torch.pprts import sun as tsun
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def opps():
    jl = load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                            basename=os.path.join(REPO, "tests", "data", "luts"))
    return JOptProp(jl), OptProp(lut_from_arrays(jl, device="cpu"), device="cpu")


def _scene():
    rng = np.random.default_rng(11)
    nz, nx, ny = 5, 6, 4
    kabs = (1e-5 + 1e-3 * rng.random((nz, nx, ny))).astype(np.float32)
    ksca = (1e-5 + 5e-3 * rng.random((nz, nx, ny))).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (nz, nx, ny)).astype(np.float32)
    dz = np.array([500.0, 250.0, 120.0, 60.0, 40.0], np.float32)  # dx = 100: two 1-D layers
    return kabs, ksca, g, dz


def test_determine_1d_layers():
    _, _, _, dz = _scene()
    dz3 = np.broadcast_to(dz[:, None, None], (5, 6, 4))
    j = np.asarray(jc.determine_1d_layers(jnp.asarray(dz3), 100.0, 2.0))
    t = tc.determine_1d_layers(torch.as_tensor(dz3.copy()), 100.0, 2.0)
    np.testing.assert_array_equal(t, j)
    assert t.tolist() == [True, True, False, False, False]


@pytest.mark.parametrize("need_dir", [True, False], ids=["solar", "thermal"])
def test_assemble_coeffs_orbit(opps, need_dir):
    jo, to = opps
    kabs, ksca, g, dz = _scene()
    l1d = np.array([True, True, False, False, False])
    sun_dir = jsun.sundir_from_angles(215.0, 38.0)
    js, ts = jsun.suninfo_from_sundir(sun_dir), tsun.suninfo_from_sundir(sun_dir)
    # compiled, as the JAX solver runs it
    jcf, jed = jax.jit(lambda kabs, ksca, g, dz3d: jc.assemble_coeffs(
        jo.scheme, jo, kabs, ksca, g, dz3d, 100.0, l1d, js, need_dir, orbit=True))(
        jnp.asarray(kabs), jnp.asarray(ksca), jnp.asarray(g), jnp.asarray(dz)[:, None, None])
    tcf, ted = tc.assemble_coeffs(to.scheme, to, torch.as_tensor(kabs), torch.as_tensor(ksca),
                                  torch.as_tensor(g), torch.as_tensor(dz)[:, None, None], 100.0,
                                  l1d, ts, need_dir, orbit=True)
    np.testing.assert_array_equal(tcf.diff2diff.idx, jcf.diff2diff.idx)
    np.testing.assert_allclose(tcf.diff2diff.orb.numpy(), np.asarray(jcf.diff2diff.orb),
                               atol=2e-6)
    for name, a, b in zip(("a11", "a12", "a13", "a23", "a33"), ted, jed):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)
    if need_dir:
        np.testing.assert_allclose(tcf.dir2diff.numpy(), np.asarray(jcf.dir2diff), atol=2e-5)
        np.testing.assert_allclose(tcf.dir2dir.numpy(), np.asarray(jcf.dir2dir), atol=5e-5)
    else:
        assert tcf.dir2dir is None and tcf.dir2diff is None and jcf.dir2dir is None


def test_eddington_and_delta_scale():
    from tenstream_tpu.ops.delta_scale import delta_scale as jds
    from tenstream_tpu.ops.eddington import eddington_coeff_ec as jedd
    from tenstream_tpu_torch.ops.delta_scale import delta_scale as tds
    from tenstream_tpu_torch.ops.eddington import eddington_coeff_ec as tedd

    rng = np.random.default_rng(5)
    n = 2000
    kabs = (10.0 ** rng.uniform(-7, -1, n)).astype(np.float32)
    ksca = (10.0 ** rng.uniform(-7, -1, n)).astype(np.float32)
    g = rng.uniform(-0.5, 0.95, n).astype(np.float32)
    for a, b in zip(tds(*map(torch.as_tensor, (kabs, ksca, g))),
                    jds(*map(jnp.asarray, (kabs, ksca, g)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-12)
    tau = (10.0 ** rng.uniform(-5, 2, n)).astype(np.float32)
    w0 = rng.uniform(0, 1, n).astype(np.float32)
    for mu in (0.0, 0.3, 1.0):
        for name, a, b in zip(("a11", "a12", "a13", "a23", "a33"),
                              tedd(torch.as_tensor(tau), torch.as_tensor(w0), torch.as_tensor(g), mu),
                              jedd(jnp.asarray(tau), jnp.asarray(w0), jnp.asarray(g), mu)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5, err_msg=name)
