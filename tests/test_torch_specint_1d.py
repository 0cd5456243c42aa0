"""`specint_pprts` of the port against the JAX spectral driver with the
1-D solvers and the RRTMG_SW / repwvl backends, and against the Fortran
reference's own results.

Scenes: bench.py's scene at 4x4 columns (its 39-layer z grid and cloud
boxes, `torch_specint_3_10.py`), sun (120, 40), albedo 0.15.

Gates:
  * 1-D paths (2str, DISORT) against JAX: every field within a fraction of
    its largest magnitude, 1e-5 for two-stream (measured up to 3e-6) and
    1e-4 for DISORT (measured up to 2.3e-5), with band_chunk >= ngpt (the
    JAX package solves every g-point in one call) and with chunks of 8
    (the port sums the chunks in g-point order; the rounding of the
    other order of sums is inside the same bounds);
  * 3_10 paths against JAX (`test_torch_specint_rrtmg_3_10.py`,
    `test_torch_specint_repwvl_3_10.py`, `test_torch_specint_two_spectra.py`,
    on `torch_specint_3_10.py`'s scene), the rule of
    `tests/test_torch_specint.py`: fluxes within 0.1 W/m2, absorption within
    1e-4 W/m3 (LUT-interpolated dir2dir), per-band niter within 2;
  * the port's 2str path against the Fortran reference's results at
    `tests/test_reference_results.py`'s tolerances (evidence that does
    not go through JAX).

The JAX solves are shared through module fixtures."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.convert import atmosphere_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.optprop.lut import LUT
from tenstream_tpu_torch.pprts.buildings import Buildings
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import specint_pprts
from tenstream_tpu_torch.spectral.specint import _BACKENDS

from torch_specint_3_10 import HERE, NX, NY, SUN, bench_scene, port_solver as _port_solver
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

RTOL_2STR = 1e-5
RTOL_DISORT = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, no oversubscription when test
    files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
