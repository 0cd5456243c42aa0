"""The port's unstructured wedge solver
(`plexrt/solver_unstructured.py::PlexrtSolverIcon`) and its NCA
(`plexrt/nca.py::nca_icon`) against the JAX package, on the committed 5_8
test table: a structured triangulation (every cell the table's shape) and
an equilateral one (every cell through the param-phi azimuth map), each
with a solar solve, a thermal solve and NCA.

Gates (those of `tests/test_torch_solver.py`): fluxes within 0.1 W/m2 at
edirTOA 1000 W/m2, absorption within 1e-4 W/m3, niter within 8
(`NITER_SLACK`).  The JAX solves run once per module (a fixture) on 3x3
meshes of 4 layers.  The
port alone also keeps the open domain's energy budget with the lateral
escape counted, and rotating mesh and sun together leaves every flux the
same."""

import os
import warnings

import numpy as np
import pytest
import torch

from tenstream_tpu.plexrt import icon as jicon
from tenstream_tpu.plexrt.optprop import WedgeOptProp as JOptProp
from tenstream_tpu.plexrt.optprop import load_or_create_wedge_lut as jload
from tenstream_tpu.plexrt.solver_unstructured import PlexrtSolverIcon as JSolverIcon
from tenstream_tpu_torch.convert import wedge_lut_from_arrays
from tenstream_tpu_torch.plexrt import icon as ticon
from tenstream_tpu_torch.plexrt.optprop import WedgeOptProp
from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
LUTDIR = os.path.join(HERE, "data", "luts")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
# niter within 2, but a BiCGStab solve's count moves by up to 8 in either package alone when
# its inputs change by about one float32 rounding (thermal solves; the fixed point's by none):
# tools/torch_wedge_niter_spread.py
NITER_SLACK = {"bicgstab": 8, "fixedpoint": 2}
NZ = 4
DZ = np.full(NZ, 100.0, np.float32)
SUN = (50.0, 40.0)
MESHES = {"structured": lambda mod: mod.trimesh_from_structured(3, 3, 100.0, 100.0),
          "equilateral": lambda mod: mod.trimesh_equilateral(3, 3, 120.0)}
CASES = ("solar", "thermal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sundir(phi_deg, theta_deg):
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([np.sin(p) * np.sin(t), np.cos(p) * np.sin(t), -np.cos(t)])


def scene(mesh):
    rng = np.random.default_rng(7)
    nc = mesh.ncell
    ka = (1e-4 + 1e-3 * rng.random((NZ, nc))).astype(np.float32)
    ks = (1e-4 + 5e-3 * rng.random((NZ, nc))).astype(np.float32)
    ks[1:3, 4:8] += 0.02  # a cloud
    g = rng.uniform(0.0, 0.8, (NZ, nc)).astype(np.float32)
    planck = (np.linspace(2.0, 6.0, NZ + 1)[:, None] * np.ones(nc)).astype(np.float32)
    return ka, ks, g, planck


def run_cases(solver, fields, as_np):
    ka, ks, g, planck = fields
    out = {}
    solver.set_angles(sundir(*SUN))
    solver.set_optical_properties(0.2, ka, ks, g)
    sol = solver.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
    out["solar"] = (*map(as_np, solver.get_result(sol)), int(sol.niter_diff))
    solver.set_optical_properties(0.2, ka, ks, g, planck=planck)
    sol = solver.solve(lthermal=True, lsolar=False)
    out["thermal"] = (*map(as_np, solver.get_result(sol)), int(sol.niter_diff))
    out["nca"] = as_np(solver.nca_absorption(sol))
    return out


def _np(a):
    return None if a is None else np.asarray(a)


def _quiet(make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the equilateral cells' shape warning
        return make()


def jax_solver(kind):
    m = MESHES[kind](jicon)
    return _quiet(lambda: JSolverIcon(m, DZ, JOptProp(jload(n_photons=1500, basename=LUTDIR))))


def port_solver(kind, mesh=None):
    m = MESHES[kind](ticon) if mesh is None else mesh
    opp = WedgeOptProp(wedge_lut_from_arrays(jload(n_photons=1500, basename=LUTDIR),
                                             device="cpu"))
    return _quiet(lambda: PlexrtSolverIcon(m, DZ, opp))


def run_for_spread(who, scene_fn, kind):
    """{case: niter} of the test's solves (`tools/torch_wedge_niter_spread.py`)."""
    s = jax_solver(kind) if who == "jax" else port_solver(kind)
    out = run_cases(s, scene_fn(), lambda a: None)
    return {c: out[c][-1] for c in CASES}


@pytest.fixture(scope="module")
def jax_ref():
    return {kind: run_cases(jax_solver(kind), scene(MESHES[kind](jicon)), _np) for kind in MESHES}


@pytest.fixture(scope="module")
def port_ref():
    return {kind: run_cases(port_solver(kind), scene(MESHES[kind](ticon)),
                            lambda a: None if a is None else a.numpy()) for kind in MESHES}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_icon_solver_matches_jax(jax_ref, port_ref, kind, case):
    *want, nj = jax_ref[kind][case]
    *got, nt = port_ref[kind][case]
    assert abs(nt - nj) <= NITER_SLACK["bicgstab"], (nt, nj)
    for name, w, g in zip(("edir", "edn", "eup", "abso"), want, got):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=ABSO_ATOL if name == "abso" else FLUX_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_nca_icon_matches_jax(jax_ref, port_ref, kind):
    np.testing.assert_allclose(port_ref[kind]["nca"], jax_ref[kind]["nca"], rtol=0,
                               atol=ABSO_ATOL)


def test_param_phi_branch_taken():
    assert port_solver("equilateral")._use_param_phi
    assert not port_solver("structured")._use_param_phi


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(HERE), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_open_domain_budget_with_escape(kind):
    """Incoming = TOA up + absorbed + surface net + lateral escape, within
    1e-4 of the incoming beam (float32 sums of the budget terms), with the
    escape read off the solve as `chip_smoke.py` phase 27 reads it."""
    s = port_solver(kind)
    ka, ks, g, _ = scene(s.mesh)
    s.set_optical_properties(0.2, ka, ks, g)
    s.set_angles(sundir(*SUN))
    sol, lateral = _chip_smoke().icon_budget(s, 1000.0)
    edir, edn, eup, abso = s.get_result(sol)
    area = s._area / s._area.sum()
    vol_per_area = s._dz[:, None]
    incoming = 1000.0 * float(s._mu())
    out = float(((eup[0] + (abso * vol_per_area).sum(0) + edir[-1] + edn[-1] - eup[-1])
                 * area).sum())
    assert lateral > 0.02 * incoming  # a small open domain: the escape is not negligible
    assert abs(incoming - out - lateral) < 1e-4 * incoming, (incoming, out, lateral)


def test_rotation_invariance():
    """Rotating the mesh and the sun together leaves every flux the same
    (`tests/test_plexrt_icon.py::test_rotation_invariance`, its gates)."""
    base = ticon.trimesh_from_structured(6, 6, 100.0, 100.0)
    rot = ticon.rotate_mesh(base, 33.0)
    rng = np.random.default_rng(0)
    ka = (1e-4 + 1e-3 * rng.random((NZ, base.ncell))).astype(np.float32)
    ks = (1e-4 + 5e-3 * rng.random((NZ, base.ncell))).astype(np.float32)
    gg = np.full((NZ, base.ncell), 0.5, np.float32)
    outs = []
    for mesh, phi in ((base, 50.0), (rot, 50.0 - 33.0)):
        s = port_solver("structured", mesh)
        s.set_optical_properties(0.2, ka, ks, gg)
        s.set_angles(sundir(phi, 40.0))
        outs.append([a.numpy() for a in s.get_result(s.solve(False, True, edirTOA=1000.0))])
    (e1, _, u1, a1), (e2, _, u2, a2) = outs
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(u1, u2, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(a1, a2, rtol=2e-3, atol=1e-7)
