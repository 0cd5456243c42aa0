"""Shared body of `test_torch_schemes_3x.py` and `test_torch_schemes_8x.py`:
a cube scheme's `PprtsSolver` in the port against the JAX package's on the
CPU, on the scheme's committed test table (`tests/data/luts/LUT_<scheme>_*.npz`,
the table the JAX package's own scheme tests use), loaded by path.

The scene follows `tests/test_torch_8_10.py`: 5x6x6 cells of 100 m, a box
cloud, albedo 0.15, solar at two suns (the beam travelling +x/+y and
-x/-y, both at 40 degrees) and thermal.  Gates: fluxes within 0.1 W/m2, absorption within
1e-4 W/m3 (the golden gates), niter within 2, and for the solar solves
the energy balance of the JAX end-to-end tests (`tests/test_scheme_e2e_all.py`):
TOA up + column absorption + net surface flux within 6% of the incoming
beam.  The dense solve (`pprts_orbit_coeffs=False`, kernel K3 on the card)
is held to the orbit solve (K1/K2) with the same gates, solar at the -x/-y
beam 60 degrees from the zenith."""

import glob
import os

import numpy as np

from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import LUT as JLUT
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

LUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "luts")
FLUX_ATOL = 0.1  # W/m2
ABSO_ATOL = 1e-4  # W/m3
NITER_SLACK = 2
BALANCE_RTOL = 0.06  # of the incoming beam, as tests/test_scheme_e2e_all.py
NZ, NX, NY, DZ = 5, 6, 6, 100.0
EDIR_TOA = 1000.0
# (phi, theta, lthermal): the beam travelling +x/+y, the beam travelling -x/-y, thermal (no
# sun).  The JAX solves repeat the programs of the JAX package's own scheme tests on this grid
# (`tests/test_scheme_e2e_all.py`: a cold solve at (210, 40), then a warm one at (30, 40), and a
# cold thermal solve without a sun; `tests/test_scheme_3_16.py`: a cold solve at (30, 40)), so
# JAX's persistent compilation cache (`torch_jax_cache.py`) compiles each program once per run.
CASES = {"solar_beam_pos": (30.0, 40.0, False), "solar_beam_neg": (210.0, 40.0, False),
         "thermal": (None, None, True)}
E2E_ORDER = ["solar_beam_neg", "solar_beam_pos", "thermal"]  # test_scheme_e2e_all.py's order
# the dense-vs-orbit check (the port alone) takes the steep -x/-y beam: larger side-face
# fractions through K1/K2 and K3
DENSE_SOLAR = (210.0, 60.0)


def lut_path(scheme: str) -> str:
    """The scheme's committed test table (exactly one per scheme)."""
    (path,) = glob.glob(os.path.join(LUT_DIR, f"LUT_{scheme}_*.npz"))
    return path


def scene():
    ka = np.full((NZ, NX, NY), 1e-5, np.float32)
    ks = np.full((NZ, NX, NY), 2e-5, np.float32)
    g = np.zeros((NZ, NX, NY), np.float32)
    ka[1:3, 2:4, 1:4] = 2e-3
    ks[1:3, 2:4, 1:4] = 1.5e-2
    g[1:3, 2:4, 1:4] = 0.85
    T = np.linspace(250.0, 290.0, NZ + 1)
    planck = (5.670374419e-8 * T ** 4 / np.pi).astype(np.float32)[:, None, None] * np.ones(
        (NX, NY), np.float32)
    return ka, ks, g, planck


def _grid():
    return dict(nz=NZ, nx=NX, ny=NY, dx=100.0, dy=100.0, dz=DZ)


def jax_solver(jlut):
    return JSolver(JGrid.create(**_grid()), JOptProp(jlut))


def torch_solver(jlut, orbit: bool = True):
    opts = None if orbit else Options({"pprts_orbit_coeffs": False}, read_env=False)
    return PprtsSolver(Grid.create(**_grid(), device="cpu"),
                       OptProp(lut_from_arrays(jlut, "cpu"), device="cpu"), options=opts)


def run(solver, sun, lthermal):
    ka, ks, g, planck = scene()
    solver.set_optical_properties(0.15, ka, ks, g, planck=planck if lthermal else None)
    if sun is not None:
        solver.set_angles(sun)
    solver.solve(lthermal=lthermal, lsolar=not lthermal, edirTOA=EDIR_TOA)
    res = [None if a is None else np.asarray(a) for a in solver.get_result()]
    return res, int(np.asarray(solver.solutions[0].niter_diff))


def balance_error(res, theta):
    """|TOA up + column absorption + net surface flux - incoming| / incoming."""
    edir, edn, eup, abso = res
    incoming = EDIR_TOA * np.cos(np.deg2rad(theta))
    balance = (eup[0].mean() + (abso * DZ).sum(0).mean()
               + (edir[-1] + edn[-1] - eup[-1]).mean())
    return abs(balance - incoming) / incoming


def assert_close(got, ref, label):
    for name, a, b in zip(("edir", "edn", "eup"), ref[:3], got[:3]):
        if a is not None:
            np.testing.assert_allclose(b, a, atol=FLUX_ATOL, err_msg=f"{label} {name}")
    np.testing.assert_allclose(got[3], ref[3], atol=ABSO_ATOL, err_msg=f"{label} abso")


class JaxSolvers:
    """One JAX solver per scheme for a test module's solar cases (the second
    solar solve starts warm from the first); thermal solves run cold on a
    solver of their own."""

    def __init__(self):
        self._cache = {}

    def get(self, scheme):
        if scheme not in self._cache:
            jlut = JLUT.load(lut_path(scheme))
            self._cache[scheme] = (jlut, jax_solver(jlut))
        return self._cache[scheme]


def check_solve_matches_jax(solvers: JaxSolvers, scheme: str, case: str):
    phi, theta, lthermal = CASES[case]
    jlut, js = solvers.get(scheme)
    if lthermal:
        js = jax_solver(jlut)
    ts = torch_solver(jlut)
    assert ts.scheme.name == scheme and ts.opp._solver_orbit_idx is not None  # the orbit path
    ref, nj = run(js, None if lthermal else jsun(phi, theta), lthermal)
    got, nt = run(ts, None if lthermal else sundir_from_angles(phi, theta), lthermal)
    assert_close(got, ref, f"{scheme} {case}")
    assert abs(nt - nj) <= NITER_SLACK, (nt, nj)
    if not lthermal:
        for side, res in (("port", got), ("jax", ref)):
            err = balance_error(res, theta)
            assert err < BALANCE_RTOL, (scheme, side, err)
        assert got[0][-1].min() < 0.8 * got[0][-1].max()  # the cloud casts a shadow


def check_dense_matches_orbit(scheme: str):
    """The dense solve (K3's path on the card) against the orbit solve
    (K1/K2's), solar at the steep -x/-y beam (DENSE_SOLAR) and thermal."""
    jlut = JLUT.load(lut_path(scheme))
    for case in ("solar_beam_neg", "thermal"):
        lthermal = CASES[case][2]
        sun = None if lthermal else sundir_from_angles(*DENSE_SOLAR)
        outs = [run(torch_solver(jlut, orbit), sun, lthermal) for orbit in (True, False)]
        (orb, no), (dense, nd) = outs
        assert_close(dense, orb, f"{scheme} {case} dense vs orbit")
        assert abs(nd - no) <= NITER_SLACK, (case, nd, no)
