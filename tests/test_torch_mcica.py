"""McICA partial cloudiness in the port against the JAX package.

- `core.prng.Threefry` against `jax.random` (the threefry2x32 default in
  the mode the JAX package runs under): PRNGKey, fold_in, 32-bit random
  bits and the float32 uniform mapping, bit for bit, at several seeds and
  shapes.
- `mcica_subcolumns` masks and `mcica_condensate` equal to JAX's exactly,
  for the three overlaps.
- `specint_pprts` with `cld_frac`, and with the same field as `atm.cfrac`,
  against one JAX solve on a 3x3-column scene of 13 layers (a broken
  boundary-layer cloud two layers deep, a vegetation canopy in the lowest
  layer through `extra_tau / extra_w0 / extra_g`), ecCKD 32+32, chunks of
  8, the production LUT with interpolated dir2dir.  Gates: fluxes within
  0.1 W/m2, absorption within 1e-4 W/m3 (`test_torch_specint.py`'s)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import LUT as JLUT
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.spectral import mcica as jmcica
from tenstream_tpu.spectral import vegetation as jveg
from tenstream_tpu.spectral.ecckd import EcckdGasOptics as JEcckd
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.convert import atmosphere_from_arrays, lut_from_arrays
from tenstream_tpu_torch.core.prng import Threefry
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import mcica as tmcica
from tenstream_tpu_torch.spectral import specint_pprts
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT_PATH = os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
NX = NY = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_jax_runs_the_partitionable_threefry():
    """The mode the port copies; the classic mode lays out the counters
    differently."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 712, 2 ** 31 - 1, -3])
def test_threefry_keys_and_fold_in_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = Threefry.from_seed(seed)
    assert tuple(np.asarray(jk).tolist()) == tk.key
    for data in (0, 1, 5, 2 ** 32 - 1):
        assert tuple(np.asarray(jax.random.fold_in(jk, data)).tolist()) == tk.fold_in(data).key


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 4, 5), (32, 13, 3, 3), (2, 1, 257)])
@pytest.mark.parametrize("seed", [712, 11])
def test_threefry_bits_and_uniform_equal_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    tk = Threefry.from_seed(seed).fold_in(1)
    bits_j = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tk.bits(shape, device="cpu").numpy(), bits_j)
    u_j = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32))
    u_t = tk.uniform(shape, device="cpu").numpy()
    assert u_t.dtype == np.float32
    np.testing.assert_array_equal(u_t.view(np.int32), u_j.view(np.int32))
    assert u_t.min() >= 0.0 and u_t.max() < 1.0


def _cloud_fraction(nlay, nx, ny, seed=5):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 1.0, (nlay, nx, ny)).astype(np.float32)
    f[f < 0.35] = 0.0
    f[: nlay // 3] = 0.0  # clear aloft
    f[-2] = 1.0  # an overcast layer
    return f


@pytest.mark.parametrize("overlap", ["maxrand", "max", "random"])
def test_mcica_subcolumns_equal_jax(overlap):
    f = _cloud_fraction(12, 5, 6)
    for kind in (0, 1):
        jk = jax.random.fold_in(jax.random.PRNGKey(712), kind)
        tk = Threefry.from_seed(712).fold_in(kind)
        mj = np.asarray(jmcica.mcica_subcolumns(jk, f, 16, overlap=overlap))
        mt = tmcica.mcica_subcolumns(tk, torch.as_tensor(f), 16, overlap=overlap).numpy()
        np.testing.assert_array_equal(mt, mj)
        assert 0.1 < mt.mean() < 0.9  # both outcomes occur
    lwc = np.random.default_rng(1).uniform(0.0, 0.5, f.shape).astype(np.float32)
    cj = np.asarray(jmcica.mcica_condensate(jk, f, lwc, 8, overlap=overlap))
    ct = tmcica.mcica_condensate(tk, f, lwc, 8, overlap=overlap).numpy()
    np.testing.assert_array_equal(ct, cj)
    with pytest.raises(ValueError, match="overlap"):
        tmcica.mcica_subcolumns(tk, torch.as_tensor(f), 2, overlap="exp")


def _scene():
    zlev = np.concatenate([np.geomspace(20e3, 3000.0, 8), np.arange(2500.0, -1.0, -500.0)])
    jatm = jsetup(z_grid=zlev)
    nlay = jatm.nlay
    lwc = np.zeros((nlay, NX, NY), np.float32)
    lwc[nlay - 4:nlay - 2] = 0.15  # grid-mean condensate
    cf = np.zeros((nlay, NX, NY), np.float32)
    cf[nlay - 4:nlay - 2] = np.random.default_rng(2).uniform(0.2, 0.9, (2, NX, NY))
    # a canopy in the lowest layer: leaf area density 0.4 m2/m3 over 500 m
    # cells' lowest 10 m, grass albedo over the solar range
    dz = np.asarray(jatm.dz, np.float32)
    tau_veg = np.zeros((nlay, NX, NY), np.float32)
    tau_veg[-1, 1:, :2] = 0.4 * 10.0
    w0_veg = np.full((nlay, NX, NY), jveg.get_albedo_for_range("grass", 0.3, 2.5), np.float32)
    g_veg = np.full((nlay, NX, NY), 0.1, np.float32)
    return jatm, dz, lwc, cf, (tau_veg, w0_veg, g_veg)


@pytest.fixture(scope="module")
def mcica_runs():
    jatm, dz, lwc, cf, (tv, wv, gv) = _scene()
    nlay = jatm.nlay
    jl = JLUT.load(LUT_PATH)
    kw = dict(albedo=0.15, lthermal=True, lsolar=True, lwc=lwc, band_chunk=8,
              extra_tau=tv, extra_w0=wv, extra_g=gv)
    js = JSolver(JGrid.create(nlay, NX, NY, 500.0, 500.0, dz), JOptProp(jl, analytic_dir2dir=False))
    js.set_angles(jsun(100.0, 30.0))
    rj = jspecint(js, jatm, specint=JEcckd(n_gpt=32), cld_frac=cf, **kw)
    out = {"jax": [np.asarray(a) for a in rj]}
    tl = lut_from_arrays(jl, "cpu")
    for how in ("cld_frac", "atm_cfrac"):
        atm = atmosphere_from_arrays(jatm)
        ts = PprtsSolver(Grid.create(nlay, NX, NY, 500.0, 500.0, dz, device="cpu"),
                         OptProp(tl, analytic_dir2dir=False, device="cpu"))
        ts.set_angles(sundir_from_angles(100.0, 30.0))
        extra = {"cld_frac": cf}
        if how == "atm_cfrac":
            atm.cfrac, extra = cf, {}
        out[how] = [a.numpy() for a in specint_pprts(ts, atm, specint=EcckdGasOptics(n_gpt=32),
                                                     **extra, **kw)]
    ts = PprtsSolver(Grid.create(nlay, NX, NY, 500.0, 500.0, dz, device="cpu"),
                     OptProp(tl, analytic_dir2dir=False, device="cpu"))
    ts.set_angles(sundir_from_angles(100.0, 30.0))
    out["overcast"] = [a.numpy() for a in specint_pprts(
        ts, atmosphere_from_arrays(jatm), specint=EcckdGasOptics(n_gpt=32), **kw)]
    return out


@pytest.mark.parametrize("how", ["cld_frac", "atm_cfrac"])
def test_specint_mcica_matches_jax(mcica_runs, how):
    ref, got = mcica_runs["jax"], mcica_runs[how]
    for name, a, b in zip(("edir", "edn", "eup"), ref[:3], got[:3]):
        np.testing.assert_allclose(b, a, atol=FLUX_ATOL, err_msg=f"{how} {name}")
    np.testing.assert_allclose(got[3], ref[3], atol=ABSO_ATOL, err_msg=f"{how} abso")


def test_broken_cloud_transmits_more_than_overcast(mcica_runs):
    """McICA's reason to exist: the same water in broken cloud lets more
    sunlight through than spread over the whole layer."""
    mc, pp = mcica_runs["cld_frac"], mcica_runs["overcast"]
    sfc = lambda r: float(r[0][-1].mean() + r[1][-1].mean())
    assert sfc(mc) > 1.02 * sfc(pp), (sfc(mc), sfc(pp))
