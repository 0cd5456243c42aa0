"""The port's atmosphere and gas optics against the JAX package:
`atm.py` (the analytic standard atmosphere, trace gases, hydrostatics,
`setup_standard_atmosphere`, `merge_dyn_rad_grid`, `load_background`,
`setup_tenstr_atm`, `abso2hr`), `ops/planck.py::planck_radiance_wavenumber`,
`spectral/gasoptics.py` (gray, synthetic CKD, `cloud_optprops`) and
`spectral/ecckd.py` (gas optical depths, Planck, per-g-point droplet and
ice optics, `planck_at`).

Host-side float64 numpy is the same code in both packages and must agree
to float64 round-off; float32 results (optical properties, Planck
radiances, cloud optics) within 1e-6 relative.  The one exception is the
float32 quadrature of `planck_radiance_wavenumber` and the synthetic
backend's thermal Planck built from it: XLA's float32 expm1 is off by up
to 4.7 ulp where torch's is within 0.5 (ROADMAP, faults found), so they
are held at 3e-6."""

import numpy as np
import pytest
import torch

import tenstream_tpu.atm as jatm_mod
import tenstream_tpu.spectral.ecckd as jecckd
import tenstream_tpu.spectral.gasoptics as jgas
import tenstream_tpu_torch.atm as tatm_mod
import tenstream_tpu_torch.spectral.ecckd as tecckd
import tenstream_tpu_torch.spectral.gasoptics as tgas
from tenstream_tpu.ops.planck import planck_radiance_wavenumber as jplanck
from tenstream_tpu_torch.convert import atmosphere_from_arrays
from tenstream_tpu_torch.ops.planck import planck_radiance_wavenumber as tplanck
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

RTOL = 1e-6
RTOL_F32_QUADRATURE = 3e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a, b, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _same_atm(ja, ta):
    for k in ("plev", "tlev", "zlev"):
        np.testing.assert_allclose(getattr(ta, k), getattr(ja, k), rtol=1e-12, err_msg=k)
    assert ta.gases.keys() == ja.gases.keys()
    for k in ja.gases:
        np.testing.assert_allclose(ta.gases[k], ja.gases[k], rtol=1e-12, err_msg=k)
    for k in ("lwc", "reliq", "iwc", "reice", "cfrac"):
        a, b = getattr(ja, k), getattr(ta, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b, a)


def _zgrid():
    z_low = np.arange(0.0, 2401.0, 100.0)
    z_high = np.geomspace(2650.0, 20e3, 16)
    return np.concatenate([z_high[::-1], z_low[::-1][1:]])


def test_standard_atmosphere_functions():
    z = np.linspace(0.0, 80e3, 41)
    ja, ta = jatm_mod.us_standard_atmosphere(z), tatm_mod.us_standard_atmosphere(z)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-12, err_msg=k)
    jg, tg = jatm_mod.standard_trace_gases(z, ja["p"]), tatm_mod.standard_trace_gases(z, ta["p"])
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-12, err_msg=k)
    plev = np.linspace(101325.0, 5000.0, 11)
    tlay = np.linspace(288.0, 220.0, 10)
    np.testing.assert_allclose(tatm_mod.hydrostat_lev(plev, tlay, 12.0),
                               jatm_mod.hydrostat_lev(plev, tlay, 12.0), rtol=1e-12)
    for kw in ({}, {"nlay": 12, "ztop": 30e3}, {"z_grid": _zgrid()}):
        _same_atm(jatm_mod.setup_standard_atmosphere(**kw), tatm_mod.setup_standard_atmosphere(**kw))
    bg_j = jatm_mod.setup_standard_atmosphere(nlay=20)
    bg_t = tatm_mod.setup_standard_atmosphere(nlay=20)
    zd = np.linspace(3000.0, 0.0, 7)
    td = np.linspace(270.0, 290.0, 7)
    (mj, kj), (mt, kt) = jatm_mod.merge_dyn_rad_grid(bg_j, zd, td), tatm_mod.merge_dyn_rad_grid(
        bg_t, zd, td)
    assert kj == kt
    _same_atm(mj, mt)
    bj, bt = jatm_mod.load_background(), tatm_mod.load_background()
    assert bj.keys() == bt.keys()
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])


def test_setup_tenstr_atm_per_column():
    rng = np.random.default_rng(11)
    nlev, nx, ny = 9, 3, 2
    plev = np.linspace(60000.0, 101000.0, nlev)  # TOA -> surface
    plev3 = plev[:, None, None] * (1.0 + 0.01 * rng.random((nlev, nx, ny)))
    tlev = np.linspace(260.0, 290.0, nlev)
    lwc = np.zeros((nlev - 1, nx, ny))
    lwc[3:5] = rng.random((2, nx, ny))
    kw = dict(tlev=tlev, h2ovmr=np.full(nlev - 1, 5e-3), lwc=lwc,
              reliq=np.full((nlev - 1, nx, ny), 8.0), cfrac=np.full((nlev - 1, nx, ny), 0.5),
              surface_height=rng.random((nx, ny)) * 50.0, skin_temperature=np.full((nx, ny), 291.0))
    ja, ta = jatm_mod.setup_tenstr_atm(plev3, **kw), tatm_mod.setup_tenstr_atm(plev3, **kw)
    _same_atm(ja, ta)
    np.testing.assert_array_equal(ta.skin_temperature, ja.skin_temperature)
    np.testing.assert_allclose(ta.dz, ja.dz, rtol=1e-12)
    np.testing.assert_allclose(ta.air_molecules_per_m2(), ja.air_molecules_per_m2(), rtol=1e-12)
    np.testing.assert_allclose(ta.layer_air_density(), ja.layer_air_density(), rtol=1e-12)


def test_abso2hr():
    ja = jatm_mod.setup_standard_atmosphere(z_grid=_zgrid())
    ta = atmosphere_from_arrays(ja)
    abso = np.random.default_rng(2).standard_normal((ja.nlay, 3, 3)).astype(np.float32) * 1e-3
    play = ja.play[:, None, None] * np.ones((3, 3))
    tlay = ja.tlay[:, None, None] * np.ones((3, 3))
    hj = jatm_mod.abso2hr(abso, play, tlay)
    ht = tatm_mod.abso2hr(torch.as_tensor(abso), ta.play[:, None, None] * np.ones((3, 3)),
                          ta.tlay[:, None, None] * np.ones((3, 3)))
    _f32(hj, ht.numpy(), atol=1e-12)


@pytest.mark.parametrize("T", [5777.0, np.linspace(180.0, 320.0, 17)])
def test_planck_radiance_wavenumber(T):
    for lo, hi in ((10.0, 350.0), (630.0, 700.0), (2600.0, 3250.0), (38000.0, 50000.0)):
        _f32(jplanck(lo, hi, T), tplanck(lo, hi, T).numpy(), rtol=RTOL_F32_QUADRATURE,
             msg=f"{lo}-{hi}")


def _props_equal(pj, pt, label, planck_rtol=RTOL):
    for k in ("tau", "w0", "g", "weight", "planck", "planck_srfc"):
        a, b = getattr(pj, k), getattr(pt, k)
        assert (a is None) == (b is None), f"{label} {k}"
        if a is not None:
            assert b.dtype == torch.float32 and b.device.type == "cpu"
            _f32(a, b.numpy(), rtol=planck_rtol if k == "planck" else RTOL, msg=f"{label} {k}")


@pytest.fixture(scope="module")
def atms():
    ja = jatm_mod.setup_standard_atmosphere(z_grid=_zgrid())
    return ja, atmosphere_from_arrays(ja)


@pytest.mark.parametrize("backend", ["gray", "synthck"])
def test_gray_and_synthetic_backends(atms, backend):
    ja, ta = atms
    jb = {"gray": jgas.GrayGasOptics, "synthck": jgas.SyntheticCKD}[backend]()
    tb = {"gray": tgas.GrayGasOptics, "synthck": tgas.SyntheticCKD}[backend]()
    assert (tb.n_gpt_solar, tb.n_gpt_thermal) == (jb.n_gpt_solar, jb.n_gpt_thermal)
    _props_equal(jb.solar(ja), tb.solar(ta), f"{backend} solar")
    _props_equal(jb.thermal(ja), tb.thermal(ta), f"{backend} thermal",
                 planck_rtol=RTOL_F32_QUADRATURE)
    np.testing.assert_allclose(tgas.rayleigh_optical_depth(ta.plev, 0.55),
                               jgas.rayleigh_optical_depth(ja.plev, 0.55), rtol=1e-12)


def test_geometric_cloud_optics():
    rng = np.random.default_rng(4)
    lwc = rng.random((6, 3, 3)).astype(np.float32)
    reff = (1.0 + 20.0 * rng.random((6, 3, 3))).astype(np.float32)
    dz = np.full((6, 3, 3), 100.0, np.float32)
    for a, b in zip(jgas.cloud_optprops(lwc, reff, dz),
                    tgas.cloud_optprops(*(torch.as_tensor(x) for x in (lwc, reff, dz)))):
        _f32(a, b.numpy())


@pytest.mark.parametrize("n_gpt", [16, 32])
@pytest.mark.parametrize("columns", [False, True], ids=["1d", "per_column"])
def test_ecckd_solar_thermal(atms, n_gpt, columns):
    ja, ta = atms
    if columns:
        # per-(x, y)-column temperatures and water vapour
        ja = jatm_mod.setup_standard_atmosphere(z_grid=_zgrid())
        rng = np.random.default_rng(5)
        shape = (2, 3)
        ja.tlev = ja.tlev[:, None, None] + rng.standard_normal((ja.nlay + 1,) + shape)
        ja.plev = ja.plev[:, None, None] * np.ones(shape)
        ja.gases = {k: v[:, None, None] * (1.0 + 0.1 * rng.random((ja.nlay,) + shape))
                    for k, v in ja.gases.items()}
        ta = atmosphere_from_arrays(ja)
    jb, tb = jecckd.EcckdGasOptics(n_gpt=n_gpt), tecckd.EcckdGasOptics(n_gpt=n_gpt)
    _props_equal(jb.solar(ja), tb.solar(ta), "solar")
    _props_equal(jb.thermal(ja), tb.thermal(ta), "thermal")
    T = np.array([[250.0, 288.5], [301.2, 199.0]])
    _f32(jb.planck_at(T), tb.planck_at(T), msg="planck_at")
    _f32(jb.planck_at(290.0), tb.planck_at(290.0), msg="planck_at scalar")


def test_ecckd_tables_come_from_the_repository_data():
    tb = tecckd.EcckdGasOptics()
    jb = jecckd.EcckdGasOptics()
    assert tb.data_dir == jb.data_dir  # the same committed data/ecckd files
    assert tb.data_dir.endswith("data/ecckd")
    with pytest.raises(FileNotFoundError):
        tecckd.EcckdGasOptics(n_gpt=32, data_dir="/nonexistent").solar(
            tatm_mod.setup_standard_atmosphere(nlay=4))


@pytest.mark.parametrize("kind", ["sw", "lw"])
@pytest.mark.parametrize("phase", ["droplet", "ice"])
def test_ecckd_particle_optics_per_gpoint(kind, phase):
    rng = np.random.default_rng(6)
    shape = (5, 3, 4)
    water = (rng.random(shape) * 0.5).astype(np.float32)
    reff = ((2.0 if phase == "droplet" else 10.0) + 60.0 * rng.random(shape)).astype(np.float32)
    dz = np.full(shape, 120.0, np.float32)
    jb, tb = jecckd.EcckdGasOptics(n_gpt=32), tecckd.EcckdGasOptics(n_gpt=32)
    jf = jb.cloud_optprops_gpt if phase == "droplet" else jb.ice_optprops_gpt
    tf = tb.cloud_optprops_gpt if phase == "droplet" else tb.ice_optprops_gpt
    targs = tuple(torch.as_tensor(a) for a in (water, reff, dz))
    for gsel in (slice(None), slice(8, 16), np.array([3, 17, 4, 30])):
        j = jf(kind, water, reff, dz, gsel=gsel)
        if phase == "ice":
            # the JAX ice optics ignore gsel and return every g-point
            # (ROADMAP, faults found); the port selects
            j = tuple(np.asarray(a)[gsel] for a in jf(kind, water, reff, dz))
        t = tf(kind, *targs, gsel=gsel)
        for name, a, b in zip(("tau", "w0", "g"), j, t):
            assert tuple(b.shape) == tuple(np.shape(a))
            _f32(a, b.numpy(), atol=1e-12, msg=f"{phase} {kind} {name}")
