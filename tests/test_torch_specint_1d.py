"""`specint_pprts` of the port against the JAX spectral driver with the
1-D solvers and the RRTMG_SW / repwvl backends, and against the Fortran
reference's own results.

Scenes: bench.py's scene at 4x4 columns (its 39-layer z grid and cloud
boxes), sun (120, 40), albedo 0.15.

Gates:
  * 1-D paths (2str, DISORT) against JAX: every field within a fraction of
    its largest magnitude, 1e-5 for two-stream (measured up to 3e-6) and
    1e-4 for DISORT (measured up to 2.3e-5), with band_chunk >= ngpt (the
    JAX package solves every g-point in one call) and with chunks of 8
    (the port sums the chunks in g-point order; the rounding of the
    other order of sums is inside the same bounds);
  * 3_10 paths against JAX, the rule of `tests/test_torch_specint.py`:
    fluxes within 0.1 W/m2, absorption within 1e-4 W/m3 (LUT-interpolated
    dir2dir), per-band niter within 2;
  * the port's 2str path against the Fortran reference's results at
    `tests/test_reference_results.py`'s tolerances (evidence that does
    not go through JAX).

The JAX solves are shared through module fixtures."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.convert import atmosphere_from_arrays, lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.optprop.lut import LUT
from tenstream_tpu_torch.pprts.buildings import Buildings
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import specint_pprts
from tenstream_tpu_torch.spectral.specint import _BACKENDS

HERE = os.path.dirname(os.path.abspath(__file__))
NX = NY = 4
SUN = (120.0, 40.0)
RTOL_2STR = 1e-5
RTOL_DISORT = 1e-4
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
K_COLLAPSE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, no oversubscription when test
    files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_scene(nx, ny, seed=7):
    """bench.py's `build_scene` at nx x ny columns."""
    z_low = np.arange(0.0, 24 * 100.0 + 1.0, 100.0)
    z_high = np.geomspace(24 * 100.0 + 250.0, 20e3, 16)
    atm = jsetup(z_grid=np.concatenate([z_high[::-1], z_low[::-1][1:]]))
    rng = np.random.default_rng(seed)
    lwc = np.zeros((atm.nlay, nx, ny), np.float32)
    zc = atm.zlev[:-1]
    cloudy = np.where((zc > 600.0) & (zc < 2000.0))[0]
    for _ in range(max(4, nx * ny // 16)):
        i, j = rng.integers(0, nx), rng.integers(0, ny)
        k = rng.choice(cloudy)
        di, dj = rng.integers(1, 4), rng.integers(1, 4)
        lwc[k:k + 2, i:i + di, j:j + dj] = rng.uniform(0.1, 0.6)
    return atm, lwc


def _extras(case, nz):
    """Per-case inputs: ice with an extra gray layer, or partial clouds
    (McICA)."""
    rng = np.random.default_rng(13)
    if case == "ice":
        iwc = np.zeros((nz, NX, NY), np.float32)
        iwc[10:12, 1:3, :] = rng.uniform(0.005, 0.03, (2, 2, NY))
        extra = np.zeros((nz, NX, NY), np.float32)
        extra[-3:] = 0.05
        return dict(iwc=iwc, reice=np.full((nz, NX, NY), 40.0, np.float32), extra_tau=extra,
                    extra_w0=np.full((nz, NX, NY), 0.9, np.float32),
                    extra_g=np.full((nz, NX, NY), 0.7, np.float32))
    if case == "mcica":
        return dict(cld_frac=rng.uniform(0.2, 1.0, (nz, NX, NY)).astype(np.float32))
    return {}


# (solver type, backend, extra inputs, lthermal)
CASES_1D = {
    "2str-rrtmg_sw": ("2str", "rrtmg_sw", "", False),
    "2str-repwvl-ice": ("2str", "repwvl", "ice", True),
    "2str-ecckd": ("2str", "ecckd", "", True),
    "2str-ecckd-mcica": ("2str", "ecckd", "mcica", True),
    "schwarzschild-ecckd": ("schwarzschild", "ecckd", "", True),
    "disort-ecckd": ("disort", "ecckd", "", True),
}


def _port_solver(solver_type, nlay, dz, opp=None, opts=None):
    s = PprtsSolver(Grid.create(nlay, NX, NY, 100.0, 100.0, dz, device="cpu"), opp,
                    options=Options(dict(opts or {}), read_env=False), solver_type=solver_type)
    s.set_angles(sundir_from_angles(*SUN))
    return s


@pytest.fixture(scope="module")
def jax_1d():
    """One JAX call per case, shared by the band_chunk variants."""
    jatm, lwc = bench_scene(NX, NY)
    dz = np.asarray(jatm.dz, np.float32)
    out = {}
    for name, (st, backend, extra, lthermal) in CASES_1D.items():
        js = JSolver(JGrid.create(jatm.nlay, NX, NY, 100.0, 100.0, dz), solver_type=st)
        js.set_angles(jsun(*SUN))
        r = jspecint(js, jatm, albedo=0.15, lthermal=lthermal, lsolar=True, specint=backend,
                     lwc=lwc, **_extras(extra, jatm.nlay))
        out[name] = tuple(np.asarray(a) for a in r)
    return jatm, lwc, out


@pytest.mark.parametrize("band_chunk", [256, 8], ids=["all-gpoints", "chunks-of-8"])
@pytest.mark.parametrize("case", list(CASES_1D))
def test_specint_1d_matches_jax(jax_1d, case, band_chunk):
    jatm, lwc, ref = jax_1d
    st, backend, extra, lthermal = CASES_1D[case]
    ts = _port_solver(st, jatm.nlay, np.asarray(jatm.dz, np.float32))
    res = specint_pprts(ts, atmosphere_from_arrays(jatm), albedo=0.15, lthermal=lthermal,
                        lsolar=True, specint=backend, lwc=lwc, band_chunk=band_chunk,
                        **_extras(extra, jatm.nlay))
    rtol = RTOL_DISORT if st == "disort" else RTOL_2STR
    for name, a, b in zip(("edir", "edn", "eup", "abso"), ref[case], res):
        b = b.numpy()
        assert b.shape == a.shape, name
        err, scale = float(np.abs(b - a).max()), float(np.abs(a).max())
        assert err <= rtol * scale, f"{case} {name}: {err:.3e} > {rtol} x {scale:.3e}"
    # TOA direct irradiance = the solar weights times mu
    weight = _BACKENDS[backend]().solar(atmosphere_from_arrays(jatm)).weight
    np.testing.assert_allclose(res.edir[0].numpy(),
                               float(weight.sum()) * np.cos(np.deg2rad(SUN[1])), rtol=1e-5)


def test_buildings_on_a_1d_solver_raise():
    jatm, lwc = bench_scene(2, 2)
    atm = atmosphere_from_arrays(jatm)
    s = PprtsSolver(Grid.create(atm.nlay, 2, 2, 100.0, 100.0, np.asarray(atm.dz, np.float32),
                                device="cpu"), solver_type="2str")
    s.set_angles(sundir_from_angles(*SUN))
    solid = torch.zeros((atm.nlay, 2, 2), dtype=torch.bool)
    solid[-1, 0, 0] = True
    with pytest.raises(ValueError, match="buildings need a 3-D solver"):
        specint_pprts(s, atm, albedo=0.15, lthermal=True, lsolar=True, specint="ecckd",
                      buildings=Buildings(solid=solid, albedo=0.2, temp=290.0))


def test_rrtmg_sw_thermal_raises_through_specint():
    jatm, _ = bench_scene(2, 2)
    atm = atmosphere_from_arrays(jatm)
    s = PprtsSolver(Grid.create(atm.nlay, 2, 2, 100.0, 100.0, np.asarray(atm.dz, np.float32),
                                device="cpu"))
    s.set_angles(sundir_from_angles(*SUN))
    with pytest.raises(NotImplementedError, match="RRTMG_LW"):
        specint_pprts(s, atm, albedo=0.15, lthermal=True, lsolar=True, specint="rrtmg_sw")


# ---------------------------------------------------------------------------
# the 3_10 solver with the RRTMG_SW and repwvl backends
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jlut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def _3d_solvers(jlut):
    jatm, _ = bench_scene(NX, NY)
    opts = {"atm_collapse": K_COLLAPSE, "specint_cache": "f32"}
    dz = np.asarray(jatm.dz, np.float32)
    js = JSolver(JGrid.create(jatm.nlay, NX, NY, 100.0, 100.0, dz),
                 JOptProp(jlut, analytic_dir2dir=False),
                 options=JOptions(dict(opts), read_env=False))
    js.set_angles(jsun(*SUN))
    ts = _port_solver(None, jatm.nlay, dz,
                      OptProp(lut_from_arrays(jlut, "cpu"), analytic_dir2dir=False, device="cpu"),
                      opts)
    return js, ts


def _band_niters(solver):
    out = {}
    for tag, rows in solver._band_rows.items():
        for g, (key, row) in rows.items():
            sol = solver.solutions.get(key)
            if sol is not None:
                out[(tag, g)] = int(np.atleast_1d(np.asarray(sol.niter_diff))[row])
    return out


def _check_3d(rj, rt, nj, nt, label):
    for name, a, b in zip(("edir", "edn", "eup"), rj[:3], rt[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=FLUX_ATOL,
                                   err_msg=f"{label} {name}")
    np.testing.assert_allclose(rt[3].numpy(), np.asarray(rj[3]), atol=ABSO_ATOL,
                               err_msg=f"{label} abso")
    assert nj.keys() == nt.keys(), label
    worst = max(abs(nj[k] - nt[k]) for k in nj)
    assert worst <= 2, f"{label}: per-band niter differs by {worst}"


@pytest.mark.parametrize("backend,lthermal,chunk", [("rrtmg_sw", False, 16),
                                                    ("repwvl", True, 15)])
def test_specint_3_10_gas_optics_match_jax(jlut, backend, lthermal, chunk):
    js, ts = _3d_solvers(jlut)
    jatm, lwc = bench_scene(NX, NY)
    kw = dict(albedo=0.15, lthermal=lthermal, lsolar=True, specint=backend, lwc=lwc,
              band_chunk=chunk)
    rj = jspecint(js, jatm, **kw)
    rt = specint_pprts(ts, atmosphere_from_arrays(jatm), **kw)
    _check_3d(rj, rt, _band_niters(js), _band_niters(ts), backend)
    assert ts.nz_solve == jatm.nlay - (K_COLLAPSE - 1)


def test_one_3_10_solver_two_solar_spectra_matches_jax(jlut):
    """One solver sees ecCKD's 32 solar g-points and then RRTMG_SW's 112:
    the warm cache and the frozen regroup order are keyed by "solar" only,
    so in both packages RRTMG's g-points 0-31 run in ecCKD's frozen order,
    warm from ecCKD's states of the same index, and 32-111 follow cold in
    natural order; the order stays ecCKD's.  Both converge to the same
    fields (reference behaviour, ROADMAP section 3)."""
    js, ts = _3d_solvers(jlut)
    jatm, lwc = bench_scene(NX, NY)
    tatm = atmosphere_from_arrays(jatm)
    kw = dict(albedo=0.15, lthermal=False, lsolar=True, lwc=lwc, band_chunk=16)
    for backend in ("ecckd", "rrtmg_sw"):
        rj = jspecint(js, jatm, specint=backend, **kw)
        rt = specint_pprts(ts, tatm, specint=backend, **kw)
        _check_3d(rj, rt, _band_niters(js), _band_niters(ts), f"two spectra, {backend}")
    order = ts._band_order["solar"]
    np.testing.assert_array_equal(order, np.asarray(js._band_order["solar"]))
    assert sorted(order.tolist()) == list(range(32))


# ---------------------------------------------------------------------------
# the Fortran reference's results (tests/test_reference_results.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_scene():
    z = np.load(os.path.join(HERE, "data", "reference_specint.npz"))
    gases = {k.split(".")[-1][2:]: z[f"scene.g_{k.split('g_')[-1]}"]
             for k in z.files if k.startswith("scene.g_")}
    plev = z["scene.plev"].copy()
    tlev = z["scene.tlev"].copy()
    nbg = plev.size - 11
    tlev[nbg + 5] = 288.0
    tlev[nbg + 6] = 288.0  # isothermal cloud levels
    atm = Atmosphere(plev=plev, tlev=tlev, zlev=z["scene.zlev"], gases=gases)
    icld = nbg + 5
    rho = 0.5 * (plev[icld] + plev[icld + 1]) / (287.058 * 288.0)
    lwc = np.zeros((atm.nlay, 3, 3), np.float32)
    lwc[icld] = 1e-2 * rho  # g/kg -> g/m3
    reliq = np.full((atm.nlay, 3, 3), 10.0, np.float32)
    return atm, lwc, reliq, z


def _reference_solve(scene, backend, solar, solver_type="2str", opp=None, opts=None):
    atm, lwc, reliq, _ = scene
    s = PprtsSolver(Grid.create(atm.nlay, 3, 3, 100.0, 100.0, np.asarray(atm.dz, np.float32),
                                device="cpu"), opp,
                    options=Options(dict(opts or {}), read_env=False), solver_type=solver_type)
    s.set_angles(sundir_from_angles(180.0, 60.0))
    return specint_pprts(s, atm, albedo=0.3 if solar else 0.1, lsolar=solar, lthermal=not solar,
                         specint=backend, lwc=lwc, reliq=reliq)


@pytest.mark.parametrize("backend,rname", [("ecckd", "ecckd"), ("repwvl", "repwvl"),
                                           ("rrtmg_sw", "rrtm")])
def test_solar_2str_vs_reference(reference_scene, backend, rname):
    """`test_reference_results.py::test_solar_vs_reference`'s gates."""
    atm, _, _, z = reference_scene
    res = _reference_solve(reference_scene, backend, True)
    r_edir = z[f"{rname}.lwF.swT.edir"][0, 0]
    r_eup = z[f"{rname}.lwF.swT.eup"][0, 0]
    r_edn = z[f"{rname}.lwF.swT.edn"][0, 0]
    edir, eup, edn = (a[:, 0, 0].numpy() for a in (res.edir, res.eup, res.edn))
    np.testing.assert_allclose(edir[0], r_edir[0], rtol=1e-4)
    assert abs(eup[0] - r_eup[0]) / r_eup[0] < 0.05, (eup[0], r_eup[0])
    assert abs(edir[-1] - r_edir[-1]) / r_edir[-1] < 0.12, (edir[-1], r_edir[-1])
    assert abs(edn[-1] - r_edn[-1]) / max(r_edn[-1], 1.0) < 0.2, (edn[-1], r_edn[-1])
    nbg = atm.plev.size - 11
    rel = np.abs(edir[: nbg + 4] - r_edir[: nbg + 4]) / r_edir[: nbg + 4]
    assert rel.max() < 0.02, rel.max()


@pytest.mark.parametrize("backend,rname", [("ecckd", "ecckd"), ("repwvl", "repwvl")])
def test_thermal_2str_vs_reference(reference_scene, backend, rname):
    """`test_reference_results.py::test_thermal_vs_reference`'s gates."""
    z = reference_scene[3]
    res = _reference_solve(reference_scene, backend, False)
    r_eup = z[f"{rname}.lwT.swF.eup"][0, 0]
    r_edn = z[f"{rname}.lwT.swF.edn"][0, 0]
    eup, edn = res.eup[:, 0, 0].numpy(), res.edn[:, 0, 0].numpy()
    assert abs(eup[0] - r_eup[0]) / r_eup[0] < 0.03, (eup[0], r_eup[0])
    assert abs(edn[-1] - r_edn[-1]) / r_edn[-1] < 0.03, (edn[-1], r_edn[-1])


def test_thermal_lw_error_budget(reference_scene):
    """`test_reference_results.py::test_thermal_lw_error_budget` through the
    port alone: its 3_10 solve agrees with its two-stream columns within
    0.1%, stays within 0.8% of the reference's OLR, and differs from its
    16-stream DISORT by the method class's angular bias (0.5-4%)."""
    opp = OptProp(LUT.load(os.path.join(HERE, "..", "data", "luts", "LUT_3_10_production.npz"),
                           device="cpu"), device="cpu")
    rD = _reference_solve(reference_scene, "ecckd", False, solver_type="disort",
                          opts={"disort_streams": 8})
    r2 = _reference_solve(reference_scene, "ecckd", False)
    r3 = _reference_solve(reference_scene, "ecckd", False, solver_type=None, opp=opp)
    eupD, eup2, eup3 = (float(r.eup[0, 0, 0]) for r in (rD, r2, r3))
    edn2, edn3 = float(r2.edn[-1, 0, 0]), float(r3.edn[-1, 0, 0])
    assert abs(eup3 - eup2) / eup2 < 1e-3, (eup3, eup2)
    assert abs(edn3 - edn2) / edn2 < 1e-3, (edn3, edn2)
    r_eup = reference_scene[3]["ecckd.lwT.swF.eup"][0, 0, 0]
    assert abs(eup3 - r_eup) / r_eup < 0.008
    assert 0.005 < abs(eup3 - eupD) / eupD < 0.04, (eup3, eupD)
