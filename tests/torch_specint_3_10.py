"""Shared body of the port's `specint_pprts` tests on bench.py's scene
with the 3_10 solver and the RRTMG_SW / repwvl backends
(`test_torch_specint_rrtmg_3_10.py`, `test_torch_specint_repwvl_3_10.py`,
`test_torch_specint_two_spectra.py`) and of `test_torch_specint_1d.py`:
the scene, the solvers and the gates.  The JAX reference of each of those
files compiles its own programs (tens of seconds), so each runs in a file
of its own, on its own pytest-xdist worker.

Scene: bench.py's scene at 4x4 columns (its 39-layer z grid and cloud
boxes), sun (120, 40), albedo 0.15, atm_collapse over the leading 16 1-D
layers, the f32 warm cache, LUT-interpolated dir2dir on the 3_10 mockup
table.  Gates (the rule of `tests/test_torch_specint.py`): fluxes within
0.1 W/m2, absorption within 1e-4 W/m3, per-band niter within 2."""

import os

import numpy as np

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
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

HERE = os.path.dirname(os.path.abspath(__file__))
NX = NY = 4
SUN = (120.0, 40.0)
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
K_COLLAPSE = 16


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


def port_solver(solver_type, nlay, dz, opp=None, opts=None):
    s = PprtsSolver(Grid.create(nlay, NX, NY, 100.0, 100.0, dz, device="cpu"), opp,
                    options=Options(dict(opts or {}), read_env=False), solver_type=solver_type)
    s.set_angles(sundir_from_angles(*SUN))
    return s


def jax_lut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def solvers_3d(jlut):
    """A JAX and a port 3_10 solver on the scene."""
    jatm, _ = bench_scene(NX, NY)
    opts = {"atm_collapse": K_COLLAPSE, "specint_cache": "f32"}
    dz = np.asarray(jatm.dz, np.float32)
    js = JSolver(JGrid.create(jatm.nlay, NX, NY, 100.0, 100.0, dz),
                 JOptProp(jlut, analytic_dir2dir=False),
                 options=JOptions(dict(opts), read_env=False))
    js.set_angles(jsun(*SUN))
    ts = port_solver(None, jatm.nlay, dz,
                     OptProp(lut_from_arrays(jlut, "cpu"), analytic_dir2dir=False, device="cpu"),
                     opts)
    return js, ts


def band_niters(solver):
    out = {}
    for tag, rows in solver._band_rows.items():
        for g, (key, row) in rows.items():
            sol = solver.solutions.get(key)
            if sol is not None:
                out[(tag, g)] = int(np.atleast_1d(np.asarray(sol.niter_diff))[row])
    return out


def check_3d(rj, rt, nj, nt, label):
    for name, a, b in zip(("edir", "edn", "eup"), rj[:3], rt[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=FLUX_ATOL,
                                   err_msg=f"{label} {name}")
    np.testing.assert_allclose(rt[3].numpy(), np.asarray(rj[3]), atol=ABSO_ATOL,
                               err_msg=f"{label} abso")
    assert nj.keys() == nt.keys(), label
    worst = max(abs(nj[k] - nt[k]) for k in nj)
    assert worst <= 2, f"{label}: per-band niter differs by {worst}"
