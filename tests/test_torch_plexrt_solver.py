"""The port's structured wedge solver (`plexrt/solver.py::PlexrtSolver`)
and its NCA (`plexrt/nca.py::nca_structured`) against the JAX package, on
the committed 5_8 and 18_8 test tables.

For each scheme and both diffuse solvers (BiCGStab, the default, and the
fixed point) one solver object takes, in a row: a solar+thermal solve at
one sun, a solar solve at another sun (the wedge solvers take the sun
afresh on every solve, in both packages), a thermal solve, then NCA on the
thermal solution.  Gates (those of `tests/test_torch_solver.py`): fluxes
within 0.1 W/m2 at edirTOA 1000 W/m2, absorption within 1e-4 W/m3, niter
within 2 (BiCGStab within 8: `NITER_SLACK`).  The JAX solves run once per
module (a fixture) on a 3x3x4 mesh."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.plexrt.mesh import fish_mesh as jfish
from tenstream_tpu.plexrt.optprop import WedgeAxes as JAxes
from tenstream_tpu.plexrt.optprop import WedgeOptProp as JOptProp
from tenstream_tpu.plexrt.optprop import load_or_create_wedge_lut as jload
from tenstream_tpu.plexrt.solver import PlexrtSolver as JSolver
from tenstream_tpu_torch.convert import wedge_lut_from_arrays
from tenstream_tpu_torch.plexrt.mesh import fish_mesh
from tenstream_tpu_torch.plexrt.optprop import WedgeOptProp
from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
LUTDIR = os.path.join(HERE, "data", "luts")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
# niter within 2, but a BiCGStab solve's count moves by up to 8 in either package alone when
# its inputs change by about one float32 rounding (thermal solves; the fixed point's by none):
# tools/torch_wedge_niter_spread.py
NITER_SLACK = {"bicgstab": 8, "fixedpoint": 2}
NZ, NX, NY = 4, 3, 3
SUNS = ((30.0, 40.0), (200.0, 55.0))
CASES = ("solar+thermal", "solar, sun moved", "thermal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sundir(phi_deg, theta_deg):
    """Photon direction of a sun at azimuth phi, zenith theta (the
    convention of the JAX wedge tests)."""
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([np.sin(p) * np.sin(t), np.cos(p) * np.sin(t), -np.cos(t)])


def _jax_lut(scheme):
    if scheme == "5_8":
        return jload(n_photons=1500, basename=LUTDIR)
    axes = JAxes(tau=np.array([1e-10, 0.5, 2.0, 8.0], np.float32),
                 w0=np.array([0.0, 0.7, 0.99999], np.float32),
                 aspect=np.array([0.5, 1.0, 2.0], np.float32), g=np.array([0.0, 0.5], np.float32),
                 phi=np.linspace(0.0, 360.0, 5).astype(np.float32),
                 theta=np.array([0.0, 40.0, 75.0], np.float32))
    return jload(axes, n_photons=1000, scheme="18_8", basename=LUTDIR)


def scene():
    rng = np.random.default_rng(2024)
    shp = (NZ, 2, NX, NY)
    ka = (1e-4 + 1e-3 * rng.random(shp)).astype(np.float32)
    ks = (1e-4 + 4e-3 * rng.random(shp)).astype(np.float32)
    ks[1:3, :, 1, 1] += 0.02  # a cloud
    g = rng.uniform(0.0, 0.8, shp).astype(np.float32)
    planck = (np.linspace(2.0, 6.0, NZ + 1)[:, None, None, None]
              * np.ones((2, NX, NY))).astype(np.float32)
    return ka, ks, g, planck


def run_cases(solver, fields, as_np):
    """The three solves in a row on one solver, then NCA: {case: (edir,
    edn, eup, abso, niter)}, 'nca': W/m3."""
    ka, ks, g, planck = fields
    out = {}
    solver.set_optical_properties(0.2, ka, ks, g, planck=planck)
    solver.set_angles(sundir(*SUNS[0]))
    sol = solver.solve(lthermal=True, lsolar=True, edirTOA=1000.0)
    out[CASES[0]] = (*map(as_np, solver.get_result(sol)), int(sol.niter_diff))
    solver.set_optical_properties(0.2, ka, ks, g)
    solver.set_angles(sundir(*SUNS[1]))
    sol = solver.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
    out[CASES[1]] = (*map(as_np, solver.get_result(sol)), int(sol.niter_diff))
    solver.set_optical_properties(0.2, ka, ks, g, planck=planck)
    sol = solver.solve(lthermal=True, lsolar=False)
    out[CASES[2]] = (*map(as_np, solver.get_result(sol)), int(sol.niter_diff))
    out["nca"] = as_np(solver.nca_absorption(sol))
    return out


def _np(a):
    return None if a is None else np.asarray(a)


@pytest.fixture(scope="module")
def jax_ref():
    ref = {}
    for scheme in ("5_8", "18_8"):
        opp = JOptProp(_jax_lut(scheme))
        for mode in ("bicgstab", "fixedpoint"):
            s = JSolver(jfish(NZ, NX, NY, 100.0, 100.0, 100.0), opp, diff_solver=mode)
            ref[scheme, mode] = run_cases(s, scene(), _np)
    return ref


def port_solver(scheme, mode):
    opp = WedgeOptProp(wedge_lut_from_arrays(_jax_lut(scheme), device="cpu"))
    return PlexrtSolver(fish_mesh(NZ, NX, NY, 100.0, 100.0, 100.0), opp, diff_solver=mode)


def run_for_spread(who, scene_fn, scheme, mode):
    """{case: niter} of the test's solves (`tools/torch_wedge_niter_spread.py`)."""
    if who == "jax":
        s = JSolver(jfish(NZ, NX, NY, 100.0, 100.0, 100.0), JOptProp(_jax_lut(scheme)),
                    diff_solver=mode)
    else:
        s = port_solver(scheme, mode)
    out = run_cases(s, scene_fn(), lambda a: None)
    return {c: out[c][-1] for c in CASES}


@pytest.fixture(scope="module")
def port_ref():
    return {(scheme, mode): run_cases(port_solver(scheme, mode), scene(),
                                      lambda a: None if a is None else a.numpy())
            for scheme in ("5_8", "18_8") for mode in ("bicgstab", "fixedpoint")}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["bicgstab", "fixedpoint"])
@pytest.mark.parametrize("scheme", ["5_8", "18_8"])
def test_plexrt_solver_matches_jax(jax_ref, port_ref, scheme, mode, case):
    *want, nj = jax_ref[scheme, mode][case]
    *got, nt = port_ref[scheme, mode][case]
    assert abs(nt - nj) <= NITER_SLACK[mode], (nt, nj)
    for name, w, g in zip(("edir", "edn", "eup", "abso"), want, got):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ABSO_ATOL if name == "abso" else FLUX_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["bicgstab", "fixedpoint"])
@pytest.mark.parametrize("scheme", ["5_8", "18_8"])
def test_nca_structured_matches_jax(jax_ref, port_ref, scheme, mode):
    np.testing.assert_allclose(port_ref[scheme, mode]["nca"], jax_ref[scheme, mode]["nca"],
                               rtol=0, atol=ABSO_ATOL)


@pytest.mark.parametrize("mode", ["bicgstab", "fixedpoint"])
def test_solve_lanes_each_lane_alone(mode):
    """Three lanes of different optical depth in one `solve_lanes` call:
    each lane stops on its own (a lane that has stopped is frozen while
    the others iterate) and equals its own monochromatic solve: the same
    tolerance, niter within `NITER_SLACK`, fluxes within the solver's rtol
    of their magnitude and absorption within ABSO_ATOL (the batch around a
    lane changes only the order of float32 sums)."""
    s = port_solver("5_8", mode)
    ka, ks, g, planck = scene()
    scale = np.array([0.2, 1.0, 6.0], np.float32)[:, None, None, None, None]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    kal, ksl = t(ka[None] * scale), t(ks[None] * scale)
    s.set_angles(sundir(*SUNS[0]))
    toa = torch.tensor([1000.0, 800.0, 1200.0], dtype=torch.float64)
    lanes = s.solve_lanes(False, True, kal, ksl, t(np.broadcast_to(g, kal.shape)), 0.2,
                          edirTOA=toa)
    assert len(set(lanes.niter_diff.tolist())) > 1
    assert bool((lanes.diff_res <= lanes.diff_tol).all())
    for i in range(3):
        s.set_optical_properties(0.2, kal[i], ksl[i], g)
        one = s.solve(lthermal=False, lsolar=True, edirTOA=float(toa[i]))
        assert abs(int(lanes.niter_diff[i]) - one.niter_diff) <= NITER_SLACK[mode]
        np.testing.assert_allclose(float(lanes.diff_tol[i]), one.diff_tol, rtol=1e-6)
        for a, b in zip((lanes.edir[i], lanes.edn[i], lanes.eup[i]), (one.edir, one.edn, one.eup)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=s.diff_rtol * float(b.abs().max()))
        np.testing.assert_allclose(lanes.abso[i].numpy(), one.abso.numpy(), rtol=0,
                                   atol=ABSO_ATOL)
