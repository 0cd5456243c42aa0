"""`OptProp` lookups of the port against the JAX package, on the small
test LUT and on the committed production LUT: `dir_coeffs` for all four
sun octants and `diff_coeffs_orbit`, through the one-hot per-layer path
(aspect constant per layer) and the multilinear corner path.

Tolerances: interpolated coefficients are the same multilinear values
summed in another order, so they agree to a few float32 ulps (atol
2e-6).  The closed-form dir2dir has float32 cancellation in its class
integrals (`_i0 - _i1/b`); the JAX package's own eager and compiled
evaluations differ by up to 1.9e-5 on the golden scene, so it is held at
atol 5e-5."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import LUT as JLUT
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.optprop.lut import LUT
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz")
INTERP_ATOL = 2e-6
DIR2DIR_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["small", "production"])
def opps(request):
    if request.param == "small":
        jl = load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                                basename=os.path.join(REPO, "tests", "data", "luts"))
        tl = lut_from_arrays(jl, device="cpu")
    else:
        jl = JLUT.load(PRODUCTION)
        tl = LUT.load(PRODUCTION, device="cpu")
    return JOptProp(jl), OptProp(tl, device="cpu")


def _fields(per_layer_aspect: bool):
    rng = np.random.default_rng(7)
    nz, nx, ny = 3, 5, 6
    tau = (10.0 ** rng.uniform(-3, 1.5, (nz, nx, ny))).astype(np.float32)
    w0 = rng.uniform(0.0, 1.0, (nz, nx, ny)).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (nz, nx, ny)).astype(np.float32)
    if per_layer_aspect:
        asp = np.array([0.1, 0.7, 1.9], np.float32)[:, None, None]
    else:
        asp = rng.uniform(0.05, 2.5, (nz, nx, ny)).astype(np.float32)
    return tau, w0, g, asp


def test_lut_from_arrays_matches_load():
    jl = JLUT.load(PRODUCTION)
    a, b = lut_from_arrays(jl, device="cpu"), LUT.load(PRODUCTION, device="cpu")
    assert a.scheme == b.scheme == "3_10"
    for k in ("dir2dir", "dir2diff", "diff2diff"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    for k in ("tau", "w0", "aspect", "g", "phi", "theta"):
        np.testing.assert_array_equal(getattr(a.dir_axes, k), getattr(b.dir_axes, k))


@pytest.mark.parametrize("switch_x,switch_y,per_layer", [
    (False, False, True), (True, False, False), (False, True, True), (True, True, False)],
    ids=["octant0-onehot", "switchx-multilinear", "switchy-onehot", "switchxy-multilinear"])
def test_dir_coeffs_octants(opps, per_layer, switch_x, switch_y):
    jo, to = opps
    f = _fields(per_layer)
    phi, theta = 33.0, 52.0
    jdd, jdf = jo.dir_coeffs(*f, phi, theta, switch_x=switch_x, switch_y=switch_y)
    tdd, tdf = to.dir_coeffs(*(torch.as_tensor(a) for a in f), phi, theta,
                             switch_x=switch_x, switch_y=switch_y)
    np.testing.assert_allclose(tdf.numpy(), np.asarray(jdf), atol=INTERP_ATOL)
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), atol=DIR2DIR_ATOL)


@pytest.mark.parametrize("per_layer", [True, False], ids=["onehot", "multilinear"])
def test_diff_coeffs_orbit(opps, per_layer):
    jo, to = opps
    np.testing.assert_array_equal(to._solver_orbit_idx, jo._solver_orbit_idx)
    f = _fields(per_layer)
    j = jo.diff_coeffs_orbit(*f)
    t = to.diff_coeffs_orbit(*(torch.as_tensor(a) for a in f))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=INTERP_ATOL)


def test_lut_dir2dir_interpolated(opps):
    """With the closed form off, dir2dir is interpolated like dir2diff."""
    jo, to = opps
    jl = JOptProp(jo.lut, analytic_dir2dir=False)
    tl = OptProp(to.lut, analytic_dir2dir=False, device="cpu")
    f = _fields(True)
    jdd, _ = jl.dir_coeffs(*f, 71.0, 20.0, switch_x=True)
    tdd, _ = tl.dir_coeffs(*(torch.as_tensor(a) for a in f), 71.0, 20.0, switch_x=True)
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), atol=INTERP_ATOL)
