"""Shape-blended wedge tables in the port (`plexrt/optprop.py`:
`WedgeOptPropShaped` / `bind_cells`, and the shaped path of
`PlexrtSolverIcon`) against the JAX package, on the same four tables (the
port traces them at the corners of a distorted mesh's apex box; JAX gets
the same numpy arrays).

Gates: the blend weights and the blended coefficients within 1e-6 (as
`tests/test_plexrt_icon.py` gates them); the shaped ICON solve within 0.1
W/m2 and 1e-4 W/m3 with niter within 8 (`tests/test_torch_plexrt_icon.py`)."""

import numpy as np
import pytest
import torch

from tenstream_tpu.plexrt import icon as jicon
from tenstream_tpu.plexrt import optprop as jopt
from tenstream_tpu.plexrt.solver_unstructured import PlexrtSolverIcon as JSolverIcon
from tenstream_tpu_torch.convert import wedge_lut_from_arrays
from tenstream_tpu_torch.plexrt import icon as ticon
from tenstream_tpu_torch.plexrt import optprop as topt
from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)
from test_torch_wedge_tables import N_PHOTONS, axes, diffuse_axes

FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
NITER_SLACK = 8  # BiCGStab counts under one float32 rounding (tests/test_torch_plexrt_icon.py)
LOOKUP_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _distorted(mod, n):
    """tests/test_plexrt_icon.py's heterogeneous mesh: a structured
    triangulation with its vertices jittered by up to 18 m."""
    base = mod.trimesh_from_structured(n, n, 100.0, 100.0)
    rng = np.random.default_rng(2)
    return mod.trimesh_from_points(base.verts + rng.uniform(-18.0, 18.0, base.verts.shape),
                                   base.tris)


@pytest.fixture(scope="module")
def shaped():
    """Four tables at the corners of the distorted mesh's apex box, traced
    by the port on the CPU; JAX gets the same arrays."""
    jm, tm = _distorted(jicon, 4), _distorted(ticon, 4)
    cx, cy = topt.mesh_cell_shapes(tm)
    ta = axes(topt)
    apexes = [(float(x), float(y)) for y in (cy.min(), cy.max()) for x in (cx.min(), cx.max())]
    jluts = []
    for a in apexes:
        lut = topt.create_wedge_lut(ta, diffuse_axes(topt, ta), N_PHOTONS, seed=4, apex=a,
                                    device="cpu")
        ja = axes(jopt)
        jluts.append(jopt.WedgeLUT(ja, diffuse_axes(jopt, ja), lut.dir2dir.numpy(),
                                   lut.dir2diff.numpy(), lut.diff2diff.numpy(), "5_8", a))
    return jm, tm, jluts


def test_shaped_optprop_matches_jax(shaped):
    jm, tm, jluts = shaped
    J = jopt.WedgeOptPropShaped(jluts)
    P = topt.WedgeOptPropShaped([wedge_lut_from_arrays(l, device="cpu") for l in jluts])
    cx, cy = topt.mesh_cell_shapes(tm)
    np.testing.assert_allclose(cx, jopt.mesh_cell_shapes(jm)[0], atol=1e-12)
    J.bind_cells(*jopt.mesh_cell_shapes(jm))
    P.bind_cells(cx, cy)
    np.testing.assert_allclose(P._w.numpy(), np.asarray(J._w), atol=LOOKUP_ATOL)
    np.testing.assert_allclose(P._w.numpy().sum(0), 1.0, atol=1e-6)
    nz, nc = 3, tm.ncell
    rng = np.random.default_rng(5)
    tz, w0, gg, asp = (rng.uniform(lo, hi, (nz, nc)).astype(np.float32)
                       for lo, hi in ((0.1, 3.0), (0.5, 0.99), (0.0, 0.8), (0.5, 1.0)))
    phi = rng.uniform(0.0, 360.0, (nz, nc)).astype(np.float32)
    t = lambda a: torch.as_tensor(a)
    cf = lambda a: np.moveaxis(a.numpy(), (0, 1), (-2, -1))  # channels-first -> JAX's layout
    np.testing.assert_allclose(cf(P.diff_coeffs(t(tz), t(w0), t(gg), t(asp))),
                               np.asarray(J.diff_coeffs(tz, w0, gg, asp)), atol=LOOKUP_ATOL)
    for p, j in zip(P.dir_coeffs(t(tz), t(w0), t(gg), t(asp), t(phi), 30.0),
                    J.dir_coeffs(tz, w0, gg, asp, phi, 30.0)):
        np.testing.assert_allclose(cf(p), np.asarray(j), atol=LOOKUP_ATOL)


def _sundir(phi_deg, theta_deg):
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([np.sin(p) * np.sin(t), np.cos(p) * np.sin(t), -np.cos(t)])


def test_shaped_icon_solve_matches_jax(shaped):
    """tests/test_plexrt_icon.py::test_shaped_optprop_solver_e2e's scene in
    both packages: a solar and a thermal solve through the blended tables."""
    jm, tm, jluts = shaped
    nz = 3
    rng = np.random.default_rng(7)
    ka = (1e-4 + 1e-3 * rng.random((nz, tm.ncell))).astype(np.float32)
    ks = (1e-4 + 8e-3 * rng.random((nz, tm.ncell))).astype(np.float32)
    gg = rng.uniform(0.0, 0.8, (nz, tm.ncell)).astype(np.float32)
    planck = (np.linspace(2.0, 6.0, nz + 1)[:, None] * np.ones(tm.ncell)).astype(np.float32)
    J = JSolverIcon(jm, [90.0] * nz, jopt.WedgeOptPropShaped(jluts))
    P = PlexrtSolverIcon(tm, [90.0] * nz, topt.WedgeOptPropShaped(
        [wedge_lut_from_arrays(l, device="cpu") for l in jluts]))
    assert not P._use_param_phi and J._shaped_opp
    for s in (J, P):
        s.set_angles(_sundir(25.0, 40.0))
    for lsolar in (True, False):
        outs = []
        for s in (J, P):
            s.set_optical_properties(0.2, ka, ks, gg, planck=None if lsolar else planck)
            sol = s.solve(lthermal=not lsolar, lsolar=lsolar, edirTOA=1000.0 if lsolar else 0.0)
            res = [None if a is None else np.asarray(a) for a in s.get_result(sol)]
            outs.append((res, int(sol.niter_diff)))
        (jr, jn), (pr, pn) = outs
        assert abs(jn - pn) <= NITER_SLACK, (jn, pn)
        for a, b in zip(pr[:-1], jr[:-1]):
            if b is not None:
                np.testing.assert_allclose(a, b, atol=FLUX_ATOL)
        np.testing.assert_allclose(pr[-1], jr[-1], atol=ABSO_ATOL)
        assert np.isfinite(pr[1]).all()
