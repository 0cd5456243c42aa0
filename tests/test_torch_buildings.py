"""Buildings in the port against the JAX package: the `Buildings` masks,
`mask_coeffs`, `building_sources` (roofs and walls, both beam signs),
`building_incoming_from_fields`, the two-stream column solver and cold
guess, and whole solves -- `PprtsSolver` with buildings on the
scenes of `tests/test_buildings.py` (shadow and roof reflection, a solid
floor, side walls lit from one side, thermal emission from hot faces) with
`get_building_fluxes`.

Tolerances: masks are exact.  Sources and face fluxes are sums of a few
float32 products: rtol 1e-5.  Solves: fluxes within 0.1 W/m2 (the golden
regression gate).  Absorption within 1e-4 W/m3 (the golden gate) with the
interpolated dir2dir; where each side evaluates the closed-form dir2dir
itself it is held at 1e-3 W/m3, for the reason `test_torch_solver.py`
states (the closed form's float32 cancellation, ROADMAP, faults found)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.ops.twostream import delta_eddington_twostream as jtwostream
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts import buildings as jb
from tenstream_tpu.pprts import coeffs as jc
from tenstream_tpu.pprts import solver as jsolver
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.streams import get_scheme as jget
from tenstream_tpu_torch.convert import buildings_from_arrays, lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.ops.twostream import delta_eddington_twostream as ttwostream
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts import buildings as tb
from tenstream_tpu_torch.pprts import coeffs as tc
from tenstream_tpu_torch.pprts import solver as tsolver
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.streams import get_scheme as tget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
ABSO_ATOL_CLOSED_FORM = 1e-3
NZ, NX, NY = 5, 6, 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solid(seed=0):
    rng = np.random.default_rng(seed)
    solid = np.zeros((NZ, NX, NY), bool)
    solid[2:, 1:3, 2:4] = True  # a tower on the ground
    solid[1:3, 4, 5] = True  # a floating block: its floor is exposed
    solid[:, 0, 0] = True  # a column that reaches the top, wrapping neighbours
    planck = np.where(solid, 5.0 + rng.random((NZ, NX, NY)), 0.0).astype(np.float32)
    return solid, planck


def _pair(solid, albedo, planck=None, temp=None):
    j = jb.Buildings(solid=jnp.asarray(solid), albedo=albedo,
                     planck=None if planck is None else jnp.asarray(planck),
                     temp=None if temp is None else jnp.asarray(temp))
    t = buildings_from_arrays(np.asarray(j.solid), j.albedo,
                              None if j.planck is None else np.asarray(j.planck),
                              None if j.temp is None else np.asarray(j.temp), device="cpu")
    return j, t


def test_buildings_from_arrays_and_masks():
    solid, planck = _solid()
    j, t = _pair(solid, 0.3, planck, temp=np.float32(290.0))
    assert t.device == torch.device("cpu") and t.solid.dtype == torch.bool
    assert t.albedo == 0.3 and t.planck.dtype == torch.float32 and float(t.temp) == 290.0
    assert t.to("cpu").solid.equal(t.solid)
    np.testing.assert_array_equal(t.exposed_top().numpy(), np.asarray(j.exposed_top()))
    np.testing.assert_array_equal(t.exposed_bottom().numpy(), np.asarray(j.exposed_bottom()))
    jm, tm = jb.face_masks(j), tb.face_masks(t)
    assert list(jm) == list(tm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    assert tm["floor"][2, 4, 5] and tm["wall_x_low"][0, 0, 0] and not tm["roof"][3, 1, 2]


def test_mask_coeffs():
    solid, _ = _solid()
    j, t = _pair(solid, 0.3)
    rng = np.random.default_rng(1)
    dd = rng.random((3, 3, NZ, NX, NY)).astype(np.float32)
    df = rng.random((3, 10, NZ, NX, NY)).astype(np.float32)
    ff = rng.random((10, 10, NZ, NX, NY)).astype(np.float32)
    jm = jb.mask_coeffs(jc.CoeffFields(*map(jnp.asarray, (dd, df, ff))), j)
    tm = tb.mask_coeffs(tc.CoeffFields(*map(torch.as_tensor, (dd, df, ff))), t)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(tm.diff2diff[:, :, 3, 1, 2].abs().max()) == 0.0
    tm = tb.mask_coeffs(tc.CoeffFields(None, None, torch.as_tensor(ff)), t)  # thermal: no direct
    assert tm.dir2dir is None and tm.dir2diff is None
    np.testing.assert_array_equal(tm.diff2diff.numpy(), np.asarray(jm.diff2diff))


@pytest.mark.parametrize("name", ["3_10", "1_2"])
@pytest.mark.parametrize("xinc,yinc", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("with_edir,with_planck", [(True, False), (False, True), (True, True)],
                         ids=["beam", "emission", "beam+emission"])
def test_building_sources(name, xinc, yinc, with_edir, with_planck):
    js, ts = jget(name), tget(name)
    solid, planck = _solid()
    j, t = _pair(solid, 0.35, planck if with_planck else None)
    rng = np.random.default_rng(2)
    edir = (rng.random((js.ndir, NZ + 1, NX, NY)) * 1e6).astype(np.float32) if with_edir else None
    dz = (50.0 + 50.0 * rng.random((NZ, NX, NY))).astype(np.float32)
    ref = jb.building_sources(js, j, None if edir is None else jnp.asarray(edir), 1e4,
                              dz3d=jnp.asarray(dz), dx=100.0, dy=80.0, xinc=xinc, yinc=yinc)
    out = tb.building_sources(ts, t, None if edir is None else torch.as_tensor(edir), 1e4,
                              dz3d=torch.as_tensor(dz), dx=100.0, dy=80.0, xinc=xinc, yinc=yinc)
    assert tuple(out.shape) == (ts.ndiff, NZ + 1, NX, NY) and float(out.abs().max()) > 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
    # roofs only (no layer thickness given), and a per-call Planck override
    over = (2.0 * planck).astype(np.float32)
    ref = jb.building_sources(js, j, None if edir is None else jnp.asarray(edir), 1e4,
                              planck=jnp.asarray(over))
    out = tb.building_sources(ts, t, None if edir is None else torch.as_tensor(edir), 1e4,
                              planck=torch.as_tensor(over))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("xinc,yinc", [(1, 1), (0, 0), (1, 0)])
@pytest.mark.parametrize("with_edir", [True, False], ids=["solar", "thermal"])
def test_building_incoming_from_fields(xinc, yinc, with_edir):
    js, ts = jget("3_10"), tget("3_10")
    solid, _ = _solid()
    j, t = _pair(solid, 0.35)
    rng = np.random.default_rng(3)
    ediff = (rng.random((10, NZ + 1, NX, NY)) * 1e6).astype(np.float32)
    edir = (rng.random((3, NZ + 1, NX, NY)) * 1e6).astype(np.float32) if with_edir else None
    dz = (50.0 + 50.0 * rng.random((NZ, NX, NY))).astype(np.float32)
    jef, jinc = jb.building_incoming_from_fields(
        js, j, jnp.asarray(ediff), None if edir is None else jnp.asarray(edir), 8e3, 100.0, 80.0,
        jnp.asarray(dz), xinc=xinc, yinc=yinc)
    tef, tinc = tb.building_incoming_from_fields(
        ts, t, torch.as_tensor(ediff), None if edir is None else torch.as_tensor(edir), 8e3,
        100.0, 80.0, torch.as_tensor(dz), xinc=xinc, yinc=yinc)
    assert list(tef) == list(jef) and list(tinc) == list(jinc)
    for k in jinc:
        np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(tinc[k].numpy(), np.asarray(jinc[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mu0,inc,thermal", [(0.6, 1000.0, False), (0.5, 0.0, True),
                                             (0.3, 800.0, True)],
                         ids=["solar", "thermal", "both"])
def test_twostream_and_guess(mu0, inc, thermal):
    """The two-stream column solver (fluxes of O(100) W/m2, float32
    eliminations over 6 layers: rtol 2e-5, atol 1e-3) and the cold guess
    built from it."""
    rng = np.random.default_rng(4)
    nz, nx, ny = 6, 4, 5
    kabs = (1e-5 + 1e-3 * rng.random((nz, nx, ny))).astype(np.float32)
    ksca = (1e-5 + 5e-3 * rng.random((nz, nx, ny))).astype(np.float32)
    g = rng.uniform(0.0, 0.85, (nz, nx, ny)).astype(np.float32)
    alb = rng.uniform(0.05, 0.5, (nx, ny)).astype(np.float32)
    planck = (3.0 + rng.random((nz + 1, nx, ny))).astype(np.float32) if thermal else None
    srfc = (4.0 + rng.random((nx, ny))).astype(np.float32) if thermal else None
    dz = 100.0
    kext = kabs + ksca
    jn = lambda a: None if a is None else jnp.asarray(a)
    tn = lambda a: None if a is None else torch.as_tensor(a)
    ref = jtwostream(jn(kext * dz), jn(ksca / kext), jn(g), mu0, inc, jn(alb),
                     planck=jn(planck), planck_srfc=jn(srfc))
    out = ttwostream(tn(kext * dz), tn(ksca / kext), tn(g), mu0, inc, tn(alb),
                     planck=tn(planck), planck_srfc=tn(srfc))
    for a, b, name in zip(out, ref, ("S", "Edn", "Eup")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-3, err_msg=name)
    jgrid, tgrid = JGrid.create(nz, nx, ny, 100.0, 100.0, dz), Grid.create(
        nz, nx, ny, 100.0, 100.0, dz, device="cpu")
    gj = jsolver._twostream_guess(jget("3_10"), jgrid, jn(kabs), jn(ksca), jn(g), jn(alb),
                                  jnp.asarray(mu0, jnp.float32), jnp.asarray(inc, jnp.float32),
                                  planck=jn(planck), planck_srfc=jn(srfc))
    gt = tsolver._twostream_guess(tget("3_10"), tgrid, tn(kabs), tn(ksca), tn(g), tn(alb), mu0,
                                  inc, planck=tn(planck), planck_srfc=tn(srfc))
    assert tuple(gt.shape) == (10, nz + 1, nx, ny)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-5, atol=10.0)  # [W], O(1e6)


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jlut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(REPO, "tests", "data", "luts"))


def _clear_air(nz, nx, ny, kabs, ksca, g):
    full = lambda v: np.full((nz, nx, ny), v, np.float32)
    return full(kabs), full(ksca), full(g)


def _scenes():
    """name -> (grid dims, optical properties, albedo, planck, sun (phi,
    theta) or None, edirTOA, solid, building albedo, building planck,
    lthermal, lsolar, analytic dir2dir)."""
    out = {}
    solid = np.zeros((6, 12, 12), bool)
    solid[3:, 5:7, 5:7] = True  # a tower occupying the lower half
    out["shadow-roof"] = ((6, 12, 12), _clear_air(6, 12, 12, 1e-5, 1e-5, 0.0), 0.1, None,
                          (0.0, 1e-3), 1000.0, solid, 0.8, None, False, True, None)
    solid = np.zeros((5, 6, 6), bool)
    solid[4] = True  # a full solid floor
    out["solid-floor"] = ((5, 6, 6), _clear_air(5, 6, 6, 1e-4, 1e-3, 0.5), 0.2, None,
                          (30.0, 40.0), 500.0, solid, 0.3, None, False, True, False)
    solid = np.zeros((6, 12, 12), bool)
    solid[2:, 6:8, 5:7] = True  # sun at phi 90: photons travel -x onto the east wall
    out["side-wall"] = ((6, 12, 12), _clear_air(6, 12, 12, 1e-5, 1e-5, 0.0), 0.05, None,
                        (90.0, 60.0), 1000.0, solid, 0.9, None, False, True, False)
    solid = np.zeros((5, 8, 8), bool)
    solid[3:, 3:5, 3:5] = True
    out["thermal-emission"] = ((5, 8, 8), _clear_air(5, 8, 8, 1e-4, 1e-5, 0.0), 0.05,
                               np.full((6, 8, 8), 10.0, np.float32), None, 0.0, solid, 0.1,
                               np.where(solid, 20.0, 0.0).astype(np.float32), True, False, None)
    return out


def _solve_pair(jlut, scene, opts=None):
    """The scene through the JAX solver and the port; (results, face
    fluxes, solvers) of each."""
    (nz, nx, ny), (ka, ks, g), albedo, planck, sun, edir_toa, solid, b_alb, b_planck, \
        lthermal, lsolar, analytic = scene
    jsol = jsolver.PprtsSolver(JGrid.create(nz, nx, ny, 100.0, 100.0, 100.0),
                               JOptProp(jlut, analytic_dir2dir=analytic),
                               options=None if opts is None else _joptions(opts))
    tsol = tsolver.PprtsSolver(
        Grid.create(nz, nx, ny, 100.0, 100.0, 100.0, device="cpu"),
        OptProp(lut_from_arrays(jlut, "cpu"), analytic_dir2dir=analytic, device="cpu"),
        options=None if opts is None else Options(opts, read_env=False))
    jbld, tbld = (None, None) if solid is None else _pair(solid, b_alb, b_planck)
    res = []
    for solver, bld in ((jsol, jbld), (tsol, tbld)):
        solver.set_optical_properties(albedo, ka, ks, g, planck=planck)
        if sun is not None:
            solver.set_angles(sundir_from_angles(*sun))
        if bld is not None:
            solver.set_buildings(bld)
        solver.solve(lthermal=lthermal, lsolar=lsolar, edirTOA=edir_toa)
        out = [None if a is None else np.asarray(a) for a in solver.get_result()]
        fl = None
        if bld is not None:
            fl = {k: {q: np.asarray(v) for q, v in d.items()}
                  for k, d in solver.get_building_fluxes().items()}
        res.append((dict(zip(("edir", "edn", "eup", "abso"), out)), fl, solver))
    return res


def _joptions(opts):
    from tenstream_tpu.core.config import Options as JOptions

    return JOptions(opts, read_env=False)


def _check(port, ref, abso_atol):
    for k in ("edir", "edn", "eup"):
        if ref[k] is None:
            assert port[k] is None
        else:
            assert np.isfinite(port[k]).all()
            np.testing.assert_allclose(port[k], ref[k], atol=FLUX_ATOL, err_msg=k)
    np.testing.assert_allclose(port["abso"], ref["abso"], atol=abso_atol, err_msg="abso")


@pytest.fixture(scope="module")
def solved(jlut):
    """Every scene solved once by both packages (one JAX compile each; two
    scenes with the default two-level preconditioner, two with the line
    preconditioner, whose JAX compile is shorter)."""
    line = {"diff_precond": "line"}
    return {name: _solve_pair(jlut, scene, line if name in ("solid-floor", "side-wall") else None)
            for name, scene in _scenes().items()}


@pytest.mark.parametrize("name", list(_scenes()))
def test_building_scene_matches_jax(solved, name):
    (ref, jfl, _), (port, tfl, tsol) = solved[name]
    analytic = _scenes()[name][-1]
    _check(port, ref, ABSO_ATOL if analytic is False or ref["edir"] is None
           else ABSO_ATOL_CLOSED_FORM)
    sol = tsol.solutions[0]
    assert sol.diff_res <= 1.5 * sol.diff_tol
    assert isinstance(sol.ediff, torch.Tensor) and tsol._buildings.device == tsol.device
    assert list(tfl) == list(jfl)
    for k in jfl:
        for q in ("edir", "incoming", "outgoing"):
            np.testing.assert_allclose(tfl[k][q], jfl[k][q], atol=FLUX_ATOL, err_msg=f"{k} {q}")


def test_shadow_and_roof_reflection(solved):
    """The physics `tests/test_buildings.py` asserts, on the port's result."""
    _, (port, fl, _) = solved["shadow-roof"]
    edir, eup = port["edir"], port["eup"]
    assert edir[-1, 6, 6] < 1.0 and edir[-1, 0, 0] > 950.0
    assert eup[2, 6, 6] > eup[2, 0, 0] * 2.0
    roof = fl["roof"]
    assert 900.0 < roof["edir"][3, 6, 6] < 1050.0
    assert roof["incoming"][3, 6, 6] >= roof["edir"][3, 6, 6]
    np.testing.assert_allclose(roof["outgoing"][3, 6, 6], 0.8 * roof["incoming"][3, 6, 6],
                               rtol=1e-5)
    assert roof["incoming"][4, 6, 6] == 0.0 and roof["incoming"][3, 0, 0] == 0.0
    for k in ("wall_x_low", "wall_x_high", "wall_y_low", "wall_y_high"):
        assert fl[k]["incoming"].min() >= 0.0
        assert fl[k]["incoming"][3, 5, 5] < roof["incoming"][3, 6, 6]


def test_side_wall_reflection(solved):
    _, (port, _, _) = solved["side-wall"]
    edn, eup = port["edn"], port["eup"]
    west = edn[3:, 5, 5:7].mean() + eup[3:, 5, 5:7].mean()
    east = edn[3:, 9, 5:7].mean() + eup[3:, 9, 5:7].mean()
    assert east > west * 1.2 and east > 50.0


def test_thermal_emission_face_fluxes(solved):
    _, (_, fl, _) = solved["thermal-emission"]
    roof = fl["roof"]
    assert abs(roof["outgoing"][3, 4, 4]
               - (0.1 * roof["incoming"][3, 4, 4] + 0.9 * np.pi * 20.0)) < 1e-3
    assert roof["incoming"][3, 4, 4] > 0.5


def test_get_building_fluxes_needs_buildings(jlut):
    solver = tsolver.PprtsSolver(Grid.create(3, 4, 4, 100.0, 100.0, 100.0, device="cpu"),
                                 OptProp(lut_from_arrays(jlut, "cpu"), device="cpu"))
    with pytest.raises(RuntimeError, match="set_buildings"):
        solver.get_building_fluxes()
    with pytest.raises(ValueError, match="solid"):
        solver.set_buildings(buildings_from_arrays(np.zeros((2, 4, 4), bool), 0.2, device="cpu"))
    solver.set_buildings(buildings_from_arrays(np.zeros((3, 4, 4), bool), 0.2, device="cpu"))
    solver.set_buildings(None)
    assert solver._buildings is None


@pytest.mark.parametrize("opts,scene_name", [
    ({"diff_solver": "richardson", "diff_precond": "line"}, "thermal-emission"),
    ({"diff_guess_2str": True, "diff_precond": "line"}, "thermal-emission"),
    ({"pprts_coeff_bf16": True, "diff_precond": "line"}, "solid-floor"),
    ({"pprts_compress_solutions": True, "diff_precond": "line"}, "thermal-emission"),
], ids=["richardson", "guess_2str", "coeff_bf16", "compress_solutions"])
def test_solver_options_match_jax(jlut, opts, scene_name):
    """The options of the solver that ride on the buildings (dense) path.
    bf16 coefficients: both sides round the same float32 field to
    bfloat16, so the gates stay.  Compressed solutions: both sides cache
    the state in bfloat16 (three decimal digits) and `get_result` reads it
    back; a value near a rounding boundary may fall to either side, one
    bfloat16 step (0.4%) of fluxes up to ~70 W/m2: held at 0.5 W/m2, the
    absorption at 1e-3 W/m3.  The warm start from the bfloat16 state
    takes as many iterations as the JAX package's (+-2)."""
    (ref, jfl, jsol), (port, tfl, tsol) = _solve_pair(jlut, _scenes()[scene_name], opts)
    sol = tsol.solutions[0]
    if "diff_solver" in opts:
        assert sol.niter_bicgstab == 0 and sol.niter_polish > 1
        assert abs(sol.niter_diff - int(jsol.solutions[0].niter_diff)) <= 2
    if "pprts_compress_solutions" in opts:
        assert sol.ediff.dtype == torch.bfloat16 and sol.abso.dtype == torch.bfloat16
        assert jsol.solutions[0].ediff.dtype == jnp.bfloat16
        for k in ("edn", "eup"):
            np.testing.assert_allclose(port[k], ref[k], atol=0.5, err_msg=k)
        np.testing.assert_allclose(port["abso"], ref["abso"], atol=1e-3)
        cold = sol.niter_diff
        for solver in (jsol, tsol):  # warm start from the bfloat16 state
            solver.solve(lthermal=True, lsolar=False)
        warm = tsol.solutions[0]
        assert warm.ediff.dtype == torch.bfloat16 and warm.niter_diff <= cold
        assert abs(warm.niter_diff - int(jsol.solutions[0].niter_diff)) <= 2
    else:
        _check(port, ref, ABSO_ATOL)
        assert sol.diff_res <= 1.5 * sol.diff_tol
