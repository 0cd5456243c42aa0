"""The port's RRTMG_SW and repwvl gas optics, with the Fu ice
parameterization, against the JAX package on the same atmospheres and
seeded cloud fields.

Gates: the gas optics are the same float64 numpy arithmetic on both sides,
cast to float32, and are held equal (rtol 1e-6; measured equal bit for
bit); RRTMG's derived cloud tables and the Fu ice parameterization
(float64) at rtol 1e-12; the per-g-point float32 cloud and ice optics at
rtol 1e-6 (measured equal), for whole spectra and for chunks given as
slices and as index arrays."""

import numpy as np
import pytest
import torch

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.spectral import fu_ice as jfu
from tenstream_tpu.spectral import repwvl as jrep
from tenstream_tpu.spectral import rrtmg_sw as jrr
from tenstream_tpu_torch.convert import atmosphere_from_arrays
from tenstream_tpu_torch.spectral import fu_ice as tfu
from tenstream_tpu_torch.spectral import repwvl as trep
from tenstream_tpu_torch.spectral import rrtmg_sw as trr
from tenstream_tpu_torch.spectral.specint import _BACKENDS
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

GSELS = (slice(None), slice(8, 13), np.array([3, 11, 0, 7]))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b, rtol=1e-6, msg=""):
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    assert b.shape == a.shape, (msg, b.shape, a.shape)
    np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), rtol=rtol, atol=0.0,
                               err_msg=msg)


@pytest.fixture(scope="module")
def atms():
    """The standard atmosphere on two grids: 40 layers to 40 km (the
    example's) and bench.py's 39-layer LES column."""
    z_low = np.arange(0.0, 24 * 100.0 + 1.0, 100.0)
    z_high = np.geomspace(24 * 100.0 + 250.0, 20e3, 16)
    out = []
    for j in (jsetup(nlay=40, ztop=40e3),
              jsetup(z_grid=np.concatenate([z_high[::-1], z_low[::-1][1:]]))):
        out.append((j, atmosphere_from_arrays(j)))
    return out


def _props_equal(j, t, label):
    for name in ("tau", "w0", "g", "weight", "planck", "planck_srfc"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None, f"{label} {name}"
            continue
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        _eq(a, b, msg=f"{label} {name}")


@pytest.mark.parametrize("which", [0, 1])
def test_rrtmg_sw_solar_matches_jax(atms, which):
    jatm, tatm = atms[which]
    _props_equal(jrr.RrtmgSwOptics().solar(jatm), trr.RrtmgSwOptics().solar(tatm),
                 f"rrtmg_sw atm {which}")
    # the optional TSI rescale of the Kurucz total
    j = jrr.RrtmgSwOptics(tsi=1361.0).solar(jatm)
    t = trr.RrtmgSwOptics(tsi=1361.0).solar(tatm)
    _eq(j.weight, t.weight, msg="tsi weight")
    assert abs(float(t.weight.sum()) - 1361.0) < 1e-2


def test_rrtmg_sw_setcoef_and_laysolfr_match_jax(atms):
    jatm, tatm = atms[0]
    jb, tb = jrr.RrtmgSwOptics(), trr.RrtmgSwOptics()
    d = tb._d
    jc = jrr._setcoef(*jb._column(jatm), jb._d["preflog"], jb._d["tref"])
    tc = trr._setcoef(*tb._column(tatm), d["preflog"], d["tref"])
    for k in ("jp", "jt", "jt1", "indfor", "indself", "tropo"):
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    for k in ("forfac", "forfrac", "selffac", "selffrac"):
        _eq(jc[k], tc[k], rtol=1e-12, msg=k)
    for cfg in trr._BANDS:
        kind, layreffr = cfg["sflux"]
        for kk in ("lo", "up"):
            assert trr._laysolfr(kk, layreffr, tc) == jrr._laysolfr(kk, layreffr, jc)


def test_rrtmg_sw_cloud_tables_equal_jax():
    j = jrr.RrtmgSwOptics()._cloud_tables()
    t = trr.RrtmgSwOptics()._cloud_tables()
    for name, a, b in zip(("reff", "kext", "w0", "g"), j, t):
        assert np.shape(a) == np.shape(b)
        _eq(a, b, rtol=1e-12, msg=f"rrtmg cloud table {name}")
    assert t[1].shape == (112, len(t[0]))


def _cloud_fields(seed, shape=(6, 3, 4), ice=False):
    rng = np.random.default_rng(seed)
    water = (rng.random(shape) * 0.5).astype(np.float32)
    water[0] = 0.0
    reff = ((10.0 if ice else 2.0) + (80.0 if ice else 30.0) * rng.random(shape)).astype(
        np.float32)
    dz = np.linspace(40.0, 400.0, shape[0]).astype(np.float32)[:, None, None] * np.ones(
        shape, np.float32)
    return water, reff, dz


@pytest.mark.parametrize("gsel", GSELS, ids=["all", "slice", "index"])
def test_rrtmg_sw_cloud_optics_match_jax(gsel):
    water, reff, dz = _cloud_fields(8)
    j = jrr.RrtmgSwOptics().cloud_optprops_gpt("sw", water, reff, dz, gsel=gsel)
    t = trr.RrtmgSwOptics().cloud_optprops_gpt("sw", *(torch.as_tensor(a)
                                                       for a in (water, reff, dz)), gsel=gsel)
    for name, a, b in zip(("tau", "w0", "g"), j, t):
        _eq(a, b, msg=f"rrtmg cloud {name}")


def test_rrtmg_sw_thermal_raises(atms):
    with pytest.raises(NotImplementedError, match="RRTMG_LW"):
        trr.RrtmgSwOptics().thermal(atms[0][1])


def test_backends_registered():
    assert _BACKENDS["rrtmg_sw"] is trr.RrtmgSwOptics
    assert _BACKENDS["repwvl"] is trep.RepwvlOptics


@pytest.mark.parametrize("n_wvl", [15, 20, 25, 50])
@pytest.mark.parametrize("kind", ["solar", "thermal"])
def test_repwvl_gas_optics_match_jax(atms, n_wvl, kind):
    for which, (jatm, tatm) in enumerate(atms):
        j = getattr(jrep.RepwvlOptics(n_wvl), kind)(jatm)
        t = getattr(trep.RepwvlOptics(n_wvl), kind)(tatm)
        _props_equal(j, t, f"repwvl {n_wvl} {kind} atm {which}")
        assert t.tau.shape[0] == n_wvl


def test_repwvl_rayleigh_matches_jax(atms):
    lam = np.linspace(0.25, 4.0, 37)
    for co2 in (280.0, 410.0):
        _eq(jrep.rayleigh_bodhaine(lam, co2), trep.rayleigh_bodhaine(lam, co2), rtol=1e-14,
            msg=f"bodhaine co2 {co2}")
    jatm, tatm = atms[1]
    jb, tb = jrep.RepwvlOptics(), trep.RepwvlOptics()
    _eq(jb._rayleigh_tau(jb._load("sw"), jatm), tb._rayleigh_tau(tb._load("sw"), tatm),
        rtol=1e-14, msg="rayleigh tau")


@pytest.mark.parametrize("solar", [True, False])
def test_fu_ice_matches_jax(solar):
    _, reice, _ = _cloud_fields(9, ice=True)
    reice[0, 0, 0] = 200.0  # De above its bound
    wvl = np.array([0.3, 0.55, 1.6, 2.2, 3.7, 8.5, 10.8, 15.0, 60.0])
    j = jfu.fu_ice_optprop(wvl, reice, solar)
    t = tfu.fu_ice_optprop(wvl, torch.as_tensor(reice), solar)
    for name, a, b in zip(("kext", "w0", "g"), j, t):
        assert b.dtype == torch.float64
        _eq(a, b, rtol=1e-12, msg=f"fu ice {'solar' if solar else 'thermal'} {name}")


@pytest.mark.parametrize("kind", ["sw", "lw"])
@pytest.mark.parametrize("gsel", GSELS, ids=["all", "slice", "index"])
def test_repwvl_cloud_and_ice_optics_match_jax(kind, gsel):
    jb, tb = jrep.RepwvlOptics(15), trep.RepwvlOptics(15)
    water, reff, dz = _cloud_fields(10)
    iwc, reice, _ = _cloud_fields(11, ice=True)
    targs = lambda *a: tuple(torch.as_tensor(x) for x in a)
    for label, jf, tf, args in (
            ("droplet", jb.cloud_optprops_gpt, tb.cloud_optprops_gpt, (water, reff, dz)),
            ("ice", jb.ice_optprops_gpt, tb.ice_optprops_gpt, (iwc, reice, dz))):
        j = jf(kind, *args, gsel=gsel)
        t = tf(kind, *targs(*args), gsel=gsel)
        for name, a, b in zip(("tau", "w0", "g"), j, t):
            assert b.dtype == torch.float32
            _eq(a, b, msg=f"repwvl {label} {kind} {name}")
    # the Mie table is read once per kind
    assert set(tb._mie) == {kind}
