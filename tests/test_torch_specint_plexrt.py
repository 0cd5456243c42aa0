"""The port's `specint_plexrt` against the JAX `specint_plexrt` on both wedge
solvers: ecCKD solar and thermal with a liquid cloud, `max_gpt` = 4 and
band chunks of 2, so each spectrum runs as two chunks of 2 lanes and every
lane's iteration count is held against the JAX package's vmapped solve of
the same chunk.  The fish solver runs the default diffuse solver
(BiCGStab), the ICON solver the fixed point: the lanes' iteration
(`plexrt/solver.py::iterate_diffuse`) is the same code for both solvers,
and each JAX reference costs ~12 s of `jit(vmap)` compiles.

Gates (those of `tests/test_torch_specint.py`): fluxes within 0.1 W/m2,
absorption within 1e-4 W/m3, each lane's niter within 2 on the fixed
point.  A BiCGStab lane's niter is held within 44: on the fish mesh a
lane's count moves by up to 22 in the JAX package alone when only the
chunking around it changes (float32 reduction order;
`tools/torch_wedge_niter_spread.py`), the fixed point's by none, and the
slack is twice that move, as for the cube solvers' `NITER_SLACK` in
`chip_smoke.py`.  One JAX call per solver and diffuse solver, shared
through a module fixture; the JAX lanes' iteration counts are read with
`jax.debug.callback` from inside its `jax.vmap`."""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.plexrt import icon as jicon
from tenstream_tpu.plexrt.mesh import fish_mesh as jfish
from tenstream_tpu.plexrt.optprop import WedgeOptProp as JOptProp
from tenstream_tpu.plexrt.optprop import load_or_create_wedge_lut as jload
from tenstream_tpu.plexrt.solver import PlexrtSolver as JSolver
from tenstream_tpu.plexrt.solver_unstructured import PlexrtSolverIcon as JSolverIcon
from tenstream_tpu.spectral.specint_plexrt import specint_plexrt as jspecint
from tenstream_tpu_torch.convert import atmosphere_from_arrays, wedge_lut_from_arrays
from tenstream_tpu_torch.plexrt import icon as ticon
from tenstream_tpu_torch.plexrt.mesh import fish_mesh
from tenstream_tpu_torch.plexrt.optprop import WedgeOptProp
from tenstream_tpu_torch.plexrt.solver import PlexrtSolver
from tenstream_tpu_torch.plexrt.solver_unstructured import PlexrtSolverIcon
from tenstream_tpu_torch.spectral.specint_plexrt import specint_plexrt
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
LUTDIR = os.path.join(HERE, "data", "luts")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
NITER_SLACK = {"bicgstab": 44, "fixedpoint": 2}
N = 2  # columns per side
MAX_GPT, CHUNK = 4, 2
SUN = (20.0, 30.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sundir(phi_deg, theta_deg):
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([np.sin(p) * np.sin(t), np.cos(p) * np.sin(t), -np.cos(t)])


def setup():
    atm = jsetup(nlay=5, ztop=5e3)
    dz = np.asarray(atm.dz, np.float32)
    lwc = np.zeros((atm.nlay, 2, N, N), np.float32)
    lwc[3, :, 0, 0] = 0.3
    return atm, dz, lwc


def solvers(which, dz, diff_solver):
    """(JAX solver, port solver) of `which` on the same mesh and table."""
    jl = jload(n_photons=1500, basename=LUTDIR)
    topp = WedgeOptProp(wedge_lut_from_arrays(jl, device="cpu"))
    kw = dict(diff_solver=diff_solver)
    if which == "fish":
        return (JSolver(jfish(len(dz), N, N, 500.0, 500.0, dz), JOptProp(jl), **kw),
                PlexrtSolver(fish_mesh(len(dz), N, N, 500.0, 500.0, dz), topp, **kw))
    return (JSolverIcon(jicon.trimesh_from_structured(N, N, 500.0, 500.0), dz, JOptProp(jl), **kw),
            PlexrtSolverIcon(ticon.trimesh_from_structured(N, N, 500.0, 500.0), dz, topp, **kw))


def icon_cells(a):
    """(nz, 2, N, N) -> the ICON order c = 2 (i N + j) + o."""
    return np.ascontiguousarray(np.moveaxis(a, 1, -1).reshape(a.shape[0], -1))


def run_both(which, chunk, diff_solver):
    """Both packages' `specint_plexrt` on `which` at band chunks of
    `chunk`: (JAX result, port result, JAX lanes, port lanes), a lane
    being (niter, res, tol), in g-point order, solar then thermal."""
    atm, dz, lwc = setup()
    lwc_w = lwc if which == "fish" else icon_cells(lwc)
    js, ts = solvers(which, dz, diff_solver)
    jl, tl = [], []
    solve = js.solve

    def solve_seen(*a, **k):
        sol = solve(*a, **k)
        jax.debug.callback(lambda *v: jl.append(tuple(float(x) for x in v)), sol.niter_diff,
                           sol.diff_res, sol.diff_tol)
        return sol

    js.solve = solve_seen
    lanes = ts.solve_lanes

    def lanes_seen(*a, **k):
        sol = lanes(*a, **k)
        tl.extend(zip(*(v.tolist() for v in (sol.niter_diff, sol.diff_res, sol.diff_tol))))
        return sol

    ts.solve_lanes = lanes_seen
    for s in (js, ts):
        s.set_angles(sundir(*SUN))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jspecint(js, atm, 0.2, True, True, lwc=lwc_w, max_gpt=MAX_GPT, band_chunk=chunk)
    got = specint_plexrt(ts, atmosphere_from_arrays(atm), 0.2, True, True, lwc=lwc_w,
                         max_gpt=MAX_GPT, band_chunk=chunk)
    return want, got, _in_gpoint_order(jl, tl, chunk), tl


def _in_gpoint_order(jl, tl, chunk):
    """The JAX callbacks of one vmapped chunk come in no set lane order:
    within each chunk, give each port lane the JAX lane of the nearest
    tolerance (tol = rtol ||b|| is the lane's own)."""
    out, lo = [], 0
    for n in [min(chunk, MAX_GPT - g) for g in range(0, MAX_GPT, chunk)] * 2:
        js, ts = list(jl[lo:lo + n]), tl[lo:lo + n]
        for t in ts:
            k = min(range(len(js)), key=lambda i: abs(js[i][2] - t[2]))
            out.append(js.pop(k))
        lo += n
    return out


def lane_niters(which, chunk, diff_solver):
    """{package: [niter per lane]} (`tools/torch_wedge_niter_spread.py`)."""
    _, _, jl, tl = run_both(which, chunk, diff_solver)
    return {"jax": [int(v[0]) for v in jl], "port": [int(v[0]) for v in tl]}


@pytest.fixture(scope="module", params=[("fish", "bicgstab"), ("icon", "fixedpoint")],
                ids=lambda p: p[0])
def results(request):
    which, mode = request.param
    return (which, mode) + run_both(which, CHUNK, mode)


def test_lane_niters_match_jax(results):
    which, mode, _, _, jl, tl = results
    assert len(tl) == len(jl) == 2 * MAX_GPT, (jl, tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t[2], j[2], rtol=1e-5)  # each lane's own tolerance
        assert t[1] <= t[2] and j[1] <= j[2]  # every lane converged
    assert max(abs(j[0] - t[0]) for j, t in zip(jl, tl)) <= NITER_SLACK[mode], (jl, tl)


@pytest.mark.parametrize("field", ["edir", "edn", "eup", "abso"])
def test_specint_plexrt_matches_jax(results, field):
    which, mode, want, got, _, _ = results
    w = np.asarray(getattr(want, field))
    g = getattr(got, field).numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=ABSO_ATOL if field == "abso" else FLUX_ATOL)
    assert np.isfinite(g).all()
