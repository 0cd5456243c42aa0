"""The port's `specint_pprts` against the JAX spectral driver on a small
version of `bench.py`'s scene (4x4 columns, the bench z grid of 39
layers, ecCKD 32+32, band chunks of 8, atm_collapse over the leading 16
1-D layers), and against the Fortran reference's own results.

Gates (port vs JAX): per-band niter within +-2; fluxes within 0.1 W/m2;
absorption within 1e-4 W/m3 with LUT-interpolated dir2dir, within 1e-3
W/m3 where both sides evaluate the closed-form dir2dir (the rule of
`tests/test_torch_solver.py`: the closed form's float32 cancellation).

The JAX solves are shared through module fixtures: a cold call, an
identical warm call (regrouped chunks, warm states gathered band by
band) and a perturbed warm call on the same solver, the way bench.py
steps.  The reference scene of `tests/test_reference_results.py` is
solved by the port alone and held to that file's tolerances."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.atm import Atmosphere as JAtmosphere
from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.spectral.ecckd import EcckdGasOptics as JEcckd
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.convert import atmosphere_from_arrays, lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.optprop.lut import LUT
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import specint_pprts
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
ABSO_ATOL_CLOSED_FORM = 1e-3
NX = NY = 4
K_COLLAPSE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's solves here issue thousands of small ops: one intra-op
    thread runs them as fast as many, and does not oversubscribe the CPU
    when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_scene(nx, ny, seed=7):
    """bench.py's `build_scene` at nx x ny columns (100 m layers to 2.4
    km, 16 coarse layers to 20 km; the cloud boxes scaled to the grid)."""
    z_low = np.arange(0.0, 24 * 100.0 + 1.0, 100.0)
    z_high = np.geomspace(24 * 100.0 + 250.0, 20e3, 16)
    zlev = np.concatenate([z_high[::-1], z_low[::-1][1:]])
    atm = jsetup(z_grid=zlev)
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


@pytest.fixture(scope="module")
def jlut():
    torch.backends.cuda.matmul.allow_tf32 = False
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def _solvers(jlut, analytic, cache="f32", nx=NX, ny=NY, extra=None):
    jatm, _ = bench_scene(nx, ny)
    opts = {"atm_collapse": K_COLLAPSE, "specint_cache": cache, **(extra or {})}
    dz = np.asarray(jatm.dz, np.float32)
    js = JSolver(JGrid.create(jatm.nlay, nx, ny, 100.0, 100.0, dz),
                 JOptProp(jlut, analytic_dir2dir=analytic),
                 options=JOptions(dict(opts), read_env=False))
    ts = PprtsSolver(Grid.create(jatm.nlay, nx, ny, 100.0, 100.0, dz, device="cpu"),
                     OptProp(lut_from_arrays(jlut, "cpu"), analytic_dir2dir=analytic,
                             device="cpu"),
                     options=Options(dict(opts), read_env=False))
    from tenstream_tpu.pprts.sun import sundir_from_angles as jsun

    js.set_angles(jsun(120.0, 40.0))
    ts.set_angles(sundir_from_angles(120.0, 40.0))
    return js, ts


def _steps(js, ts, lwc, n_steps, jgas, tgas, **kw):
    """Run both drivers through the same calls: the cold solve, then
    n_steps - 1 warm calls; every call after the second rolls the cloud
    field by one cell on alternating axes (bench.py's perturbed steps)."""
    jatm, _ = bench_scene(js.grid.nx, js.grid.ny)
    tatm = atmosphere_from_arrays(jatm)
    out = []
    for step in range(n_steps):
        if step >= 2:
            lwc = np.roll(lwc, 1, axis=1 + (step % 2))
        rj = jspecint(js, jatm, albedo=0.15, lthermal=True, lsolar=True, specint=jgas, lwc=lwc,
                      band_chunk=8, **kw)
        rt = specint_pprts(ts, tatm, albedo=0.15, lthermal=True, lsolar=True, specint=tgas,
                           lwc=lwc, band_chunk=8, **kw)
        out.append((tuple(None if a is None else np.asarray(a) for a in rj),
                    tuple(None if a is None else a.numpy() for a in rt),
                    _band_niters(js), _band_niters(ts)))
    return out


def _band_niters(solver):
    """{(spectrum, band): niter} of the last call, through the per-band
    (chunk key, row) map both drivers keep."""
    out = {}
    for tag, rows in solver._band_rows.items():
        for g, (key, row) in rows.items():
            sol = solver.solutions.get(key)
            if sol is not None:
                out[(tag, g)] = int(np.atleast_1d(np.asarray(sol.niter_diff))[row])
    return out


def _check(res_j, res_t, abso_atol, label):
    for name, a, b in zip(("edir", "edn", "eup"), res_j[:3], res_t[:3]):
        np.testing.assert_allclose(b, a, atol=FLUX_ATOL, err_msg=f"{label} {name}")
    np.testing.assert_allclose(res_t[3], res_j[3], atol=abso_atol, err_msg=f"{label} abso")


def _check_niters(nj, nt, label):
    assert nj.keys() == nt.keys(), label
    worst = max(abs(nj[k] - nt[k]) for k in nj)
    assert worst <= 2, f"{label}: per-band niter differs by {worst}"


@pytest.fixture(scope="module")
def interp_steps(jlut):
    """Cold, identical warm and perturbed warm calls with LUT-interpolated
    dir2dir and the f32 cache."""
    js, ts = _solvers(jlut, analytic=False)
    _, lwc = bench_scene(NX, NY)
    return _steps(js, ts, lwc, 3, JEcckd(n_gpt=32), EcckdGasOptics(n_gpt=32)), ts


def test_bench_scene_cold_matches_jax(interp_steps):
    (res_j, res_t, nj, nt), ts = interp_steps[0][0], interp_steps[1]
    assert ts.nz_solve == 39 - (K_COLLAPSE - 1)
    assert res_t[1].shape == (ts.nz_solve + 1, NX, NY)
    _check(res_j, res_t, ABSO_ATOL, "cold")
    _check_niters(nj, nt, "cold")


def test_bench_scene_warm_regrouped_matches_jax(interp_steps):
    """The second call runs on the frozen difficulty grouping: every chunk
    is regrouped and gathers its warm states band by band."""
    steps, ts = interp_steps
    res_j, res_t, nj, nt = steps[1]
    _check(res_j, res_t, ABSO_ATOL, "warm")
    _check_niters(nj, nt, "warm")
    assert set(ts._band_order) == {"solar", "thermal"}
    for tag in ("solar", "thermal"):
        assert sorted(ts._band_order[tag].tolist()) == list(range(32))
        keys = {key for key, _ in ts._band_rows[tag].values()}
        assert all(isinstance(k[1], tuple) for k in keys)  # regrouped chunk keys
    # an identical warm re-solve starts from exact f32 states
    assert max(nt.values()) <= 2


def test_bench_scene_perturbed_matches_jax(interp_steps):
    res_j, res_t, nj, nt = interp_steps[0][2]
    _check(res_j, res_t, ABSO_ATOL, "perturbed")
    _check_niters(nj, nt, "perturbed")


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
    opp = OptProp(LUT.load(os.path.join(HERE, "..", "data", "luts", "LUT_3_10_production.npz"),
                           device="cpu"), device="cpu")
    return atm, lwc, reliq, z, opp


def _reference_solve(scene, solar):
    atm, lwc, reliq, _, opp = scene
    s = PprtsSolver(Grid.create(atm.nlay, 3, 3, 100.0, 100.0, np.asarray(atm.dz, np.float32),
                                device="cpu"), opp)
    s.set_angles(sundir_from_angles(180.0, 60.0))
    return specint_pprts(s, atm, albedo=0.3 if solar else 0.1, lsolar=solar, lthermal=not solar,
                         specint="ecckd", lwc=lwc, reliq=reliq)


def test_solar_3d_vs_reference(reference_scene):
    """`test_reference_results.py::test_solar_3d_vs_reference[ecckd]`'s gates."""
    atm, _, _, z, _ = reference_scene
    res = _reference_solve(reference_scene, True)
    r_edir = z["ecckd.lwF.swT.edir"][0, 0]
    r_eup = z["ecckd.lwF.swT.eup"][0, 0]
    edir = res.edir[:, 0, 0].numpy()
    eup = res.eup[:, 0, 0].numpy()
    np.testing.assert_allclose(edir[0], r_edir[0], rtol=1e-4)
    assert abs(eup[0] - r_eup[0]) / r_eup[0] < 0.02, (eup[0], r_eup[0])
    assert abs(edir[-1] - r_edir[-1]) / r_edir[-1] < 0.08, (edir[-1], r_edir[-1])
    nbg = atm.plev.size - 11
    rel = np.abs(edir[: nbg + 4] - r_edir[: nbg + 4]) / r_edir[: nbg + 4]
    assert rel.max() < 0.01, rel.max()


def test_thermal_3d_vs_reference(reference_scene):
    """`test_reference_results.py::test_thermal_3d_vs_reference[ecckd]`'s gates."""
    z = reference_scene[3]
    res = _reference_solve(reference_scene, False)
    r_eup = z["ecckd.lwT.swF.eup"][0, 0]
    r_edn = z["ecckd.lwT.swF.edn"][0, 0]
    eup = res.eup[:, 0, 0].numpy()
    edn = res.edn[:, 0, 0].numpy()
    assert abs(eup[0] - r_eup[0]) / r_eup[0] < 0.008, (eup[0], r_eup[0])
    assert abs(edn[-1] - r_edn[-1]) / r_edn[-1] < 0.010, (edn[-1], r_edn[-1])


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,item", [
    ("rrtmg_sw", "M14"), ("repwvl", "M14"), ("cld_frac", "M13"), ("atm_cfrac", "M13"),
    ("adaptive", "M13"), ("buildings", "M10 remainder"), ("attached_buildings", "M10 remainder"),
])
def test_unported_options_name_their_roadmap_item(jlut, case, item):
    """Every backend and option of `specint_pprts` that once raised naming
    its ROADMAP item is ported now: each case runs a partial spectrum (two
    g-points) and gives finite fields (rrtmg_sw solar only: it has no
    thermal spectrum).  Their parity with JAX is held in
    `test_torch_specint_1d.py` and `test_torch_rrtmg_repwvl.py` (M14),
    `test_torch_mcica.py`, `test_torch_adaptive.py` (M13) and
    `test_torch_urban_specint.py` (M10 remainder)."""
    from tenstream_tpu_torch.pprts.buildings import Buildings

    jatm, lwc = bench_scene(2, 2)
    atm = atmosphere_from_arrays(jatm)
    ts = PprtsSolver(Grid.create(atm.nlay, 2, 2, 100.0, 100.0, np.asarray(atm.dz, np.float32),
                                 device="cpu"),
                     OptProp(lut_from_arrays(jlut, "cpu"), device="cpu"))
    ts.set_angles(sundir_from_angles(120.0, 40.0))
    kw = dict(specint="ecckd")
    solid = torch.zeros((atm.nlay, 2, 2), dtype=torch.bool)
    solid[-1, 0, 0] = True
    if case in ("rrtmg_sw", "repwvl"):
        kw["specint"] = case
    elif case == "cld_frac":
        kw["cld_frac"] = np.ones((atm.nlay, 2, 2), np.float32)
    elif case == "atm_cfrac":
        atm.cfrac = np.ones((atm.nlay, 2, 2), np.float32)
    elif case == "adaptive":
        kw.update(time=10.0, max_solution_err=1.0, max_solution_time=60.0)
    elif case == "buildings":
        kw["buildings"] = Buildings(solid=solid, albedo=0.2, temp=290.0)
    else:
        ts.set_buildings(Buildings(solid=solid, albedo=0.2, temp=290.0))
    res = specint_pprts(ts, atm, albedo=0.15, lthermal=case != "rrtmg_sw", lsolar=True, lwc=lwc,
                        bands=(0, 2), **kw)
    assert all(bool(torch.isfinite(a).all()) for a in res)
    if "buildings" in case:
        assert ts._buildings.fluxes is not None


def test_one_dimensional_solvers_name_their_roadmap_item(jlut):
    """The 1-D solver types (ROADMAP M12) once raised here; they are ported
    and run with an OptProp and without one (their parity with JAX:
    `test_torch_oned.py`, `test_torch_specint_1d.py`)."""
    opp = OptProp(lut_from_arrays(jlut, "cpu"), device="cpu")
    grid = Grid.create(4, 2, 2, 100.0, 100.0, 100.0, device="cpu")
    for st in ("2str", "disort", "schwarzschild"):
        for o in (opp, None):
            s = PprtsSolver(grid, o, solver_type=st)
            s.set_optical_properties(0.1, np.full((4, 2, 2), 1e-3, np.float32),
                                     np.full((4, 2, 2), 1e-3, np.float32),
                                     np.zeros((4, 2, 2), np.float32),
                                     planck=np.full((5, 2, 2), 100.0, np.float32))
            s.solve(True, False)
            assert all(bool(torch.isfinite(a).all()) for a in s.get_result()[1:])


def test_jax_atmosphere_converts():
    jatm, _ = bench_scene(2, 2)
    assert isinstance(jatm, JAtmosphere)
    atm = atmosphere_from_arrays(jatm)
    np.testing.assert_array_equal(atm.plev, jatm.plev)
    np.testing.assert_array_equal(atm.dz, jatm.dz)
    assert atm.gases.keys() == jatm.gases.keys()
