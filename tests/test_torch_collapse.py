"""atm_collapse and the band-batched solve of the port.

(b) The adding folds (`fold_eddington_adding`, `fold_thermal_emission`),
`onedee_blocks_collapsed` and `OrbitCoeff.set_layer0` against the JAX
functions at 1e-6; the port's collapsed solar and thermal solves against
its uncollapsed ones at `tests/test_collapse.py`'s own tolerances, and
against the JAX collapsed solves at the golden gates (fluxes 0.1 W/m2,
absorption 1e-4 W/m3, with LUT-interpolated dir2dir).

(c) A chunk of 8 bands solved as one batch (`PprtsSolver.solve_lanes`)
against the same bands solved one at a time: equal niter per lane and
fields within 1e-5 of their magnitude.  With BiCGStab the chunk holds a
lane that converges at iteration 1 (warm-started from its own solution)
beside lanes that need about 30 (the line preconditioner on clouds of
growing optical depth): a frozen lane must not move, nor change the
others."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.ops.eddington import eddington_coeff_ec as jedd
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.facade import _diff_pair_orbits as jorbits
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts import coeffs as jcoeffs
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.operators import OrbitCoeff as JOrbitCoeff
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.streams import get_scheme as jget
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts import coeffs as tcoeffs
from tenstream_tpu_torch.pprts.buildings import Buildings
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.operators import OrbitCoeff
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.streams import get_scheme as tget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
K = 8  # layers to collapse
FOLD_RTOL, FOLD_ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's solves here issue thousands of small ops: one intra-op
    thread runs them as fast as many, and does not oversubscribe the CPU
    when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jlut():
    torch.backends.cuda.matmul.allow_tf32 = False
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


# ---------------------------------------------------------------------------
# (b) folds
# ---------------------------------------------------------------------------


def _edd_stack(seed=0, k=6, shape=(5, 4)):
    rng = np.random.default_rng(seed)
    tau = (0.01 + 2.0 * rng.random((k,) + shape)).astype(np.float32)
    w0 = (0.99 * rng.random((k,) + shape)).astype(np.float32)
    g = (0.9 * rng.random((k,) + shape)).astype(np.float32)
    return [np.array(a) for a in jedd(jnp.asarray(tau), jnp.asarray(w0), jnp.asarray(g),
                                        jnp.asarray(0.6, jnp.float32))]


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=FOLD_RTOL, atol=FOLD_ATOL,
                               err_msg=msg)


def test_fold_eddington_adding_matches_jax():
    edd = _edd_stack()
    j = jcoeffs.fold_eddington_adding(*map(jnp.asarray, edd))
    t = tcoeffs.fold_eddington_adding(*map(torch.as_tensor, edd))
    for name, a, b in zip(("Ttop", "Rtop", "Tbot", "Rbot", "rdir", "sdir", "tdir"), j, t):
        _close(a, b, name)


def test_fold_thermal_emission_matches_jax():
    a11, a12 = _edd_stack(1)[:2]
    rng = np.random.default_rng(2)
    bt, bb = (rng.random(a11.shape).astype(np.float32) for _ in range(2))
    j = jcoeffs.fold_thermal_emission(*map(jnp.asarray, (a11, a12, bt, bb)))
    t = tcoeffs.fold_thermal_emission(*map(torch.as_tensor, (a11, a12, bt, bb)))
    for a, b in zip(j, t):
        _close(a, b)


def test_onedee_blocks_collapsed_and_set_layer0_match_jax():
    edd = _edd_stack(3)
    jf = jcoeffs.fold_eddington_adding(*map(jnp.asarray, edd))
    tf = tcoeffs.fold_eddington_adding(*map(torch.as_tensor, edd))
    jb = jcoeffs.onedee_blocks_collapsed(jget("3_10"), jf)
    tb = tcoeffs.onedee_blocks_collapsed(tget("3_10"), tf)
    for a, b in zip(jb, tb):
        assert tuple(b.shape) == tuple(a.shape)
        _close(a, b)
    # with a leading lane dim the blocks come out per lane
    tb2 = tcoeffs.onedee_blocks_collapsed(tget("3_10"), tuple(x[None].expand(2, *x.shape)
                                                              for x in tf))
    for a, b in zip(tb, tb2):
        assert torch.equal(b[1], a)
    idx, norb = jorbits(jget("3_10"), with_mz=False)
    orb = np.random.default_rng(4).random((norb, 3) + edd[0].shape[1:]).astype(np.float32)
    jo = JOrbitCoeff(jnp.asarray(orb), idx).set_layer0(jb[2])
    to = OrbitCoeff(torch.as_tensor(orb), idx).set_layer0(tb[2])
    _close(jo.orb, to.orb)
    # lanes: each lane's layer 0 from its own block
    to2 = OrbitCoeff(torch.as_tensor(np.stack([orb, orb])), idx).set_layer0(tb2[2])
    assert torch.equal(to2.orb[1], to.orb) and torch.equal(to2.orb[0, :, 1:], to.orb[:, 1:])


# ---------------------------------------------------------------------------
# (b) collapsed solves
# ---------------------------------------------------------------------------


def _scene(nz=16, nx=8, ny=8):
    # top K layers: thick (aspect 5 -> 1-D), below: cubic 3-D layers
    dz = np.concatenate([np.full(K, 500.0), np.full(nz - K, 100.0)]).astype(np.float32)
    rng = np.random.default_rng(5)
    ka = (1e-5 + 2e-4 * rng.random((nz, nx, ny))).astype(np.float32)
    ks = (1e-5 + 1e-4 * rng.random((nz, nx, ny))).astype(np.float32)
    g = np.full((nz, nx, ny), 0.3, np.float32)
    ks[nz - 5, 2:6, 2:6] += 0.02  # a cloud below the collapsed region
    ka[nz - 5, 2:6, 2:6] += 0.003
    planck = np.linspace(2.0, 9.0, nz + 1)[:, None, None].astype(np.float32) \
        * np.ones((nx, ny), np.float32)
    return dz, ka, ks, g, planck


def _port_solve(jl, collapse, lthermal, lsolar, analytic=None, opts=None):
    dz, ka, ks, g, planck = _scene()
    nz, nx, ny = ka.shape
    o = dict(opts or {})
    if collapse:
        o["atm_collapse"] = K
    solver = PprtsSolver(Grid.create(nz, nx, ny, 100.0, 100.0, dz, device="cpu"),
                         OptProp(lut_from_arrays(jl, "cpu"), analytic_dir2dir=analytic,
                                 device="cpu"), options=Options(o, read_env=False))
    solver.set_optical_properties(0.2, ka, ks, g, planck=planck if lthermal else None)
    solver.set_angles(sundir_from_angles(40.0, 35.0))
    solver.solve(lthermal=lthermal, lsolar=lsolar, edirTOA=1000.0 if lsolar else 0.0)
    conv = lambda a: None if a is None else a.numpy()
    return tuple(map(conv, solver.get_result())), solver


@pytest.fixture(scope="module")
def port_solves(jlut):
    return {(c, th): _port_solve(jlut, c, th, not th)[0] for c in (False, True)
            for th in (False, True)}


def test_collapse_solar_exact(port_solves):
    """`tests/test_collapse.py::test_collapse_solar_exact`'s gates."""
    edir_f, edn_f, eup_f, abso_f = port_solves[(False, False)]
    edir_c, edn_c, eup_c, abso_c = port_solves[(True, False)]
    assert edir_c.shape[0] == edir_f.shape[0] - (K - 1)
    np.testing.assert_allclose(edir_c[1:], edir_f[K:], rtol=2e-4, atol=0.05)
    np.testing.assert_allclose(edn_c[1:], edn_f[K:], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(eup_c[1:], eup_f[K:], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(eup_c[0], eup_f[0], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(abso_c[1:], abso_f[K:], rtol=2e-3, atol=1e-4)


def test_collapse_thermal(port_solves):
    """`tests/test_collapse.py::test_collapse_thermal`'s gates."""
    _, edn_f, eup_f, _ = port_solves[(False, True)]
    _, edn_c, eup_c, _ = port_solves[(True, True)]
    np.testing.assert_allclose(edn_c[1:], edn_f[K:], rtol=5e-3, atol=0.1)
    np.testing.assert_allclose(eup_c[1:], eup_f[K:], rtol=5e-3, atol=0.1)
    np.testing.assert_allclose(eup_c[0], eup_f[0], rtol=5e-3, atol=0.1)


@pytest.mark.parametrize("orbit", [True, False], ids=["orbit", "dense"])
def test_collapsed_solve_matches_jax(jlut, orbit):
    """The collapsed solar+thermal solve against the JAX one (the folded
    super-layer, its emission and the overwritten layer-0 blocks), on
    orbit and on dense coefficients."""
    # the line preconditioner keeps the JAX compile short; the collapse
    # does not depend on it
    opts = {"pprts_orbit_coeffs": orbit, "diff_precond": "line"}
    port, ts = _port_solve(jlut, True, True, True, analytic=False, opts=opts)
    dz, ka, ks, g, planck = _scene()
    nz, nx, ny = ka.shape
    js = JSolver(JGrid.create(nz, nx, ny, 100.0, 100.0, dz), JOptProp(jlut, analytic_dir2dir=False),
                 options=JOptions({"atm_collapse": K, **opts}, read_env=False))
    js.set_optical_properties(0.2, ka, ks, g, planck=planck)
    js.set_angles(jsun(40.0, 35.0))
    js.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
    ref = tuple(np.asarray(a) for a in js.get_result())
    assert js.nz_solve == ts.nz_solve
    for name, a, b in zip(("edir", "edn", "eup"), ref[:3], port[:3]):
        np.testing.assert_allclose(b, a, atol=0.1, err_msg=name)
    np.testing.assert_allclose(port[3], ref[3], atol=1e-4, err_msg="abso")


def test_collapse_refusals(jlut):
    """The JAX package's ValueErrors: a collapsed region reaching 3-D
    layers, buildings, and the two-stream cold guess."""
    dz, ka, ks, g, _ = _scene()
    nz, nx, ny = ka.shape
    opp = OptProp(lut_from_arrays(jlut, "cpu"), device="cpu")
    grid = Grid.create(nz, nx, ny, 100.0, 100.0, dz, device="cpu")
    for opts, match in (({"atm_collapse": K + 4}, "1-D layers"),
                        ({"atm_collapse": K, "diff_guess_2str": True}, "diff_guess_2str"),
                        ({"atm_collapse": K}, "buildings")):
        solver = PprtsSolver(grid, opp, options=Options(opts, read_env=False))
        if match == "buildings":
            solid = torch.zeros((nz, nx, ny), dtype=torch.bool)
            solid[-1, 0, 0] = True
            solver.set_buildings(Buildings(solid=solid))
        solver.set_optical_properties(0.2, ka, ks, g)
        solver.set_angles(sundir_from_angles(40.0, 35.0))
        with pytest.raises(ValueError, match=match):
            solver.solve(lthermal=False, lsolar=True, edirTOA=1000.0)


# ---------------------------------------------------------------------------
# (c) a batched chunk against the same bands one at a time
# ---------------------------------------------------------------------------

B, NZ, NX, NY = 8, 10, 8, 8


def _chunk():
    rng = np.random.default_rng(3)
    ka = (1e-5 + 2e-4 * rng.random((B, NZ, NX, NY))).astype(np.float32)
    ks = (1e-5 + 1e-4 * rng.random((B, NZ, NX, NY))).astype(np.float32)
    g = np.full((B, NZ, NX, NY), 0.5, np.float32)
    for i in range(B):
        ks[i, 3:7, 2:6, 2:6] += 0.01 * 4 ** (i / 2)  # cloud optical depth grows by lane
    planck = (np.linspace(2.0, 9.0, NZ + 1)[None, :, None, None]
              * (1.0 + 0.1 * np.arange(B))[:, None, None, None]
              * np.ones((1, 1, NX, NY))).astype(np.float32)
    return ka, ks, g, planck


def _lane_solver(jl, opts):
    s = PprtsSolver(Grid.create(NZ, NX, NY, 100.0, 100.0, 100.0, device="cpu"),
                    OptProp(lut_from_arrays(jl, "cpu"), device="cpu"),
                    options=Options(opts, read_env=False))
    s.set_angles(sundir_from_angles(40.0, 35.0))
    return s


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


@pytest.mark.parametrize("lthermal", [False, True], ids=["solar", "thermal"])
@pytest.mark.parametrize("solver_opt", ["bicgstab", "richardson"])
def test_batched_chunk_equals_lanes_solved_alone(jlut, lthermal, solver_opt):
    ka, ks, g, planck = _chunk()
    alb = torch.full((NX, NY), 0.2)
    toa = None if lthermal else np.linspace(100.0, 800.0, B).astype(np.float32)
    kw = dict(planck=planck if lthermal else None, edirTOA=toa)
    s = _lane_solver(jlut, {"diff_precond": "line", "diff_solver": solver_opt})
    first = s.solve_lanes(lthermal, not lthermal, ka, ks, g, alb, **kw)
    # lane 0 restarts from its own converged state, the others cold
    x0 = torch.zeros_like(first.ediff)
    x0[0] = first.ediff[0]
    om0 = [first.omega[0]] + [1.0] * (B - 1)
    chunk = s.solve_lanes(lthermal, not lthermal, ka, ks, g, alb, x0=x0, omega0=om0, **kw)
    # BiCGStab stops lane 0 at once (the polish takes its one step);
    # Richardson alone stops relative to its first residual, so it iterates
    assert max(chunk.niter) > 10, chunk.niter
    if solver_opt == "bicgstab":
        assert chunk.niter[0] == 1 and chunk.niter_bicgstab[0] == 0, chunk.niter
    for i in range(B):
        lane = lambda a: None if a is None else a[i:i + 1]
        alone = s.solve_lanes(lthermal, not lthermal, lane(ka), lane(ks), lane(g), alb,
                              planck=lane(planck) if lthermal else None,
                              edirTOA=None if toa is None else toa[i:i + 1], x0=x0[i:i + 1],
                              omega0=om0[i:i + 1])
        assert alone.niter[0] == chunk.niter[i], (i, alone.niter, chunk.niter)
        assert alone.niter_bicgstab[0] == chunk.niter_bicgstab[i]
        assert _rel(alone.ediff[0], chunk.ediff[i]) <= 1e-5, i
        assert _rel(alone.abso[0], chunk.abso[i]) <= 1e-5, i
        if not lthermal:
            assert _rel(alone.edir[0], chunk.edir[i]) <= 1e-5, i
        assert abs(alone.res[0] - chunk.res[i]) <= 1e-5 * max(chunk.tol[i], chunk.res[i])
    if solver_opt == "bicgstab":
        # the lane that converged at once kept its iterate within round-off
        assert _rel(first.ediff[0], chunk.ediff[0]) <= 1e-5
    # every lane is held to its own tolerance
    assert all(r <= 1.5 * t for r, t in zip(chunk.res, chunk.tol))
