"""The port's `PprtsSolver` on the golden scene of
`tests/test_regression_golden.py`, against the JAX solve and the
committed `tests/data/golden_3_10.npz` (read only, never regenerated).

Gates: fluxes within 0.1 W/m2 everywhere (the golden test's own gate).
Absorption within 1e-4 W/m3 (the golden test's gate) on the thermal solve,
on the solar solve with the interpolated dir2dir, and on the golden scene
when the port is handed the closed-form dir2dir blocks that the JAX
program evaluated.  Where each side evaluates the closed form itself the
golden scene's absorption is held at 1e-3 W/m3: the closed form's float32
cancellation leaves ~2e-5 in the dir2dir rows, and the JAX package's own
eager and compiled evaluations of it already move the golden absorption
by 4.9e-4 W/m3 (ROADMAP, faults found).

The JAX golden solve is compiled once per module (a fixture); its thermal
sub-solve is the JAX reference of the thermal-only case.

The solver options that ride on the same solve (dense coefficients, bf16
coefficients on them, Richardson as the primary solver, the two-stream
cold guess) are held against JAX solves with the same option, thermal
only with the line preconditioner (which keeps the JAX compile short)."""

import os

import jax
import numpy as np
import pytest
import torch

from tenstream_tpu.boxmc import direct_transmission as jdt
from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu_torch.boxmc import direct_transmission as tdt
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden_3_10.npz")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
ABSO_ATOL_CLOSED_FORM = 1e-3
NZ, NX, NY = 8, 12, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jlut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def _scene():
    rng = np.random.default_rng(1234)
    ka = (5e-5 + 5e-4 * rng.random((NZ, NX, NY))).astype(np.float32)
    ks = (5e-5 + 2e-3 * rng.random((NZ, NX, NY))).astype(np.float32)
    g = np.full((NZ, NX, NY), 0.45, np.float32)
    ks[3:5, 4:8, 4:8] += 0.02  # cloud
    ka[3:5, 4:8, 4:8] += 0.003
    planck = np.linspace(2.0, 6.0, NZ + 1)[:, None, None].astype(np.float32) * np.ones(
        (NX, NY), np.float32)
    return ka, ks, g, planck


def _result(solver, uid=0):
    return dict(zip(("edir", "edn", "eup", "abso"),
                    (None if a is None else np.asarray(a) for a in solver.get_result(uid))))


def _solve(solver, lthermal=True, lsolar=True):
    ka, ks, g, planck = _scene()
    solver.set_optical_properties(0.25, ka, ks, g, planck=planck)
    solver.set_angles(sundir_from_angles(140.0, 45.0))
    solver.solve(lthermal=lthermal, lsolar=lsolar, edirTOA=1200.0)
    return _result(solver)


def _port(jl, analytic=None, opts=None):
    return PprtsSolver(Grid.create(NZ, NX, NY, 100.0, 100.0, 100.0, device="cpu"),
                       OptProp(lut_from_arrays(jl, "cpu"), analytic_dir2dir=analytic,
                               device="cpu"),
                       options=None if opts is None else Options(opts, read_env=False))


def _jax(jl, analytic=None, opts=None):
    return JSolver(JGrid.create(NZ, NX, NY, 100.0, 100.0, 100.0),
                   JOptProp(jl, analytic_dir2dir=analytic),
                   options=None if opts is None else JOptions(opts, read_env=False))


def _check(res, ref, abso_atol):
    for k in ("edir", "edn", "eup"):
        if ref[k] is None:
            assert res[k] is None
        else:
            np.testing.assert_allclose(res[k], ref[k], atol=FLUX_ATOL, err_msg=k)
    np.testing.assert_allclose(res["abso"], ref["abso"], atol=abso_atol, err_msg="abso")


@pytest.fixture(scope="module")
def jax_golden(jlut):
    """The JAX solar+thermal solve of the golden scene (closed-form
    dir2dir): its result, its thermal sub-solve's result, and the dir2dir
    blocks its compiled program evaluated, copied to the host."""
    captured = []
    closed_form = jdt.dir2dir_analytic

    def capture(*args):
        out = closed_form(*args)
        jax.debug.callback(lambda v: captured.append(np.asarray(v)), out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdt, "dir2dir_analytic", capture)
        solver = _jax(jlut)
        res = _solve(solver)
    jax.effects_barrier()
    return res, _result(solver, (0, "thermal")), captured


def test_golden_scene(jlut, jax_golden):
    port = _solve(_port(jlut))
    gold = dict(np.load(GOLDEN))
    _check(port, gold, ABSO_ATOL_CLOSED_FORM)
    _check(port, jax_golden[0], ABSO_ATOL_CLOSED_FORM)
    assert all(np.isfinite(v).all() for v in port.values())


def test_golden_scene_same_dir2dir(jlut, jax_golden, monkeypatch):
    """Handed the dir2dir blocks of the JAX program, the port's pipeline
    downstream of them (edir, sources, the diffuse solve, absorption)
    holds the golden gates against the JAX solve."""
    ref, _, captured = jax_golden
    assert len(captured) == 1  # one solar sub-solve, one lookup
    closed_form = tdt.dir2dir_analytic

    def jax_blocks(*args):
        own = closed_form(*args)
        given = torch.from_numpy(captured[0].copy())
        assert given.shape == own.shape and given.dtype == own.dtype
        np.testing.assert_allclose(own.numpy(), captured[0], atol=5e-5)
        return given

    monkeypatch.setattr(tdt, "dir2dir_analytic", jax_blocks)
    port = _solve(_port(jlut))
    _check(port, ref, ABSO_ATOL)
    _check(port, dict(np.load(GOLDEN)), ABSO_ATOL)


@pytest.mark.parametrize("lthermal,lsolar", [(True, False), (False, True)],
                         ids=["thermal", "solar-lut-dir2dir"])
def test_sub_solves_match_jax(jlut, jax_golden, lthermal, lsolar):
    port = _solve(_port(jlut, analytic=False), lthermal, lsolar)
    if lthermal:  # a thermal sub-solve is a thermal-only solve (no dir2dir)
        ref = jax_golden[1]
    else:
        ref = _solve(_jax(jlut, analytic=False), lthermal, lsolar)
    _check(port, ref, ABSO_ATOL)


def test_warm_resolve_and_solution_cache(jlut):
    solver = _port(jlut)
    cold = _solve(solver)
    sol_cold = solver.solutions[0]
    assert sol_cold.thermal is not None and sol_cold.host_syncs > 0
    assert sol_cold.niter_diff == sol_cold.niter_bicgstab + sol_cold.niter_polish
    warm = _solve(solver)  # same properties: the warm start is already converged
    sol_warm = solver.solutions[0]
    assert sol_warm.niter_bicgstab <= 1 and sol_warm.thermal.niter_bicgstab <= 1
    for k in cold:
        np.testing.assert_allclose(warm[k], cold[k], atol=FLUX_ATOL if k != "abso" else ABSO_ATOL)


def test_dense_coefficients_match_orbit_solve(jlut, jax_golden):
    """Without buildings the dense coefficient form (kernel K3's path) is
    the same system as the orbit form (K1/K2's path): the port's dense
    golden solve holds the gates against the JAX orbit solve."""
    port = _solve(_port(jlut, opts={"pprts_orbit_coeffs": False}))
    _check(port, jax_golden[0], ABSO_ATOL_CLOSED_FORM)
    _check(port, dict(np.load(GOLDEN)), ABSO_ATOL_CLOSED_FORM)


@pytest.mark.parametrize("opts", [
    {"pprts_orbit_coeffs": False},
    {"pprts_orbit_coeffs": False, "pprts_coeff_bf16": True},
    {"pprts_orbit_coeffs": False, "diff_solver": "richardson"},
    {"diff_solver": "richardson"},
    {"diff_guess_2str": True},
    {"pprts_orbit_coeffs": False, "diff_guess_2str": True, "pprts_compress_solutions": True},
], ids=["dense", "dense-bf16", "dense-richardson", "richardson", "guess_2str",
        "dense-guess_2str-compressed"])
def test_ported_options_match_jax(jlut, opts):
    """Thermal-only solves of the golden scene with the option set on both
    sides.  bf16 coefficients: both round the same float32 field.  Cached
    bfloat16 solutions are read back by `get_result`; one bfloat16 step is
    0.4% of fluxes up to ~19 W/m2, so the flux gate stays and the
    absorption (O(1e-2) W/m3) is held at its gate too."""
    opts = dict(opts, diff_precond="line")
    jsolver, tsolver = _jax(jlut, opts=opts), _port(jlut, opts=opts)
    ref = _solve(jsolver, lthermal=True, lsolar=False)
    port = _solve(tsolver, lthermal=True, lsolar=False)
    _check(port, ref, ABSO_ATOL)
    sol = tsolver.solutions[0]
    assert abs(sol.niter_diff - int(jsolver.solutions[0].niter_diff)) <= 2
    assert (sol.niter_bicgstab == 0) == (opts.get("diff_solver") == "richardson")
    if opts.get("pprts_compress_solutions"):
        assert sol.ediff.dtype == torch.bfloat16


def test_coeff_bf16_on_orbit_coefficients_raises(jlut):
    """Kernels K1 and K2 read float32: bf16 coefficients run on the dense
    form only, and the refusal names the ROADMAP item."""
    solver = _port(jlut, opts={"pprts_coeff_bf16": True})
    ka, ks, g, planck = _scene()
    solver.set_optical_properties(0.25, ka, ks, g, planck=planck)
    with pytest.raises(NotImplementedError, match="ROADMAP K1/K2 bf16"):
        solver.solve(lthermal=True, lsolar=False)


@pytest.mark.parametrize("opts", [{"atm_collapse": 4}, {"debug_nans": True}])
def test_unported_options_raise(jlut, opts):
    """Unported options raise and name their ROADMAP item.  atm_collapse is
    ported: over this scene's 3-D layers it raises the JAX package's
    ValueError at solve time.  (pprts_geometric_coeffs, once checked here,
    is ported: `tests/test_torch_terrain.py`.)"""
    opp = OptProp(lut_from_arrays(jlut, "cpu"), device="cpu")
    grid = Grid.create(NZ, NX, NY, 100.0, 100.0, 100.0, device="cpu")
    if "atm_collapse" in opts:
        solver = PprtsSolver(grid, opp, options=Options(opts, read_env=False))
        ka, ks, g, planck = _scene()
        solver.set_optical_properties(0.25, ka, ks, g, planck=planck)
        with pytest.raises(ValueError, match="must be 1-D layers"):
            solver.solve(lthermal=True, lsolar=False)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PprtsSolver(grid, opp, options=Options(opts, read_env=False))
    with pytest.raises(ValueError, match="diff_solver"):
        PprtsSolver(grid, opp, options=Options({"diff_solver": "gmres"}, read_env=False))


def test_unported_entry_points_raise(jlut):
    """`set_mesh` (ROADMAP M19, ported: `tests/test_torch_parallel*.py`)
    raises without a torch.distributed process group, and `set_mesh(None)`
    keeps the undecomposed solve; the 1-D solver types, which raised here
    until they were ported, construct (their parity with JAX:
    `test_torch_oned.py`); bad optical properties raise."""
    opp = OptProp(lut_from_arrays(jlut, "cpu"), device="cpu")
    grid = Grid.create(NZ, NX, NY, 100.0, 100.0, 100.0, device="cpu")
    assert PprtsSolver(grid, opp, solver_type="2str").solver_type == "2str"
    solver = PprtsSolver(grid, opp)
    with pytest.raises(RuntimeError, match="process group"):
        solver.set_mesh(object())
    solver.set_mesh(None)
    assert solver.lgrid is solver.grid
    ka, ks, g, _ = _scene()
    with pytest.raises(ValueError):
        solver.set_optical_properties(0.2, -ka, ks, g)
    with pytest.raises(ValueError):
        solver.set_optical_properties(0.2, ka, ks, g + 2.0)


def test_device_mismatch_raises(jlut):
    opp = OptProp(lut_from_arrays(jlut, "cpu"), device="cpu")
    grid = Grid.create(NZ, NX, NY, 100.0, 100.0, 100.0, device="meta")
    with pytest.raises(ValueError):
        PprtsSolver(grid, opp)
    assert torch.device("cpu") == opp.device
