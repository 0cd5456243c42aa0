"""(iii) The port's `PprtsSolver` decomposed over gloo groups of 2 x 1 and
2 x 2 CPU processes (`set_mesh`, each rank feeding and reading its block)
on the scene of `tests/test_parallel.py`, solar + thermal, held to the JAX
package's sharded solve (`PprtsSolver.set_mesh` on a mesh of 2 and 4
virtual CPU devices) and to the port's undecomposed solve.

Gates: against JAX, those `tests/test_torch_solver.py` holds the port's
undecomposed solve to against JAX's (fluxes 0.1 W/m2; absorption 1e-3
W/m3, where each side evaluates the closed-form dir2dir itself); against
the port's own one-rank solve, those `tests/test_parallel.py` holds JAX's
sharded solve to against its single-device one (edir rtol 2e-4 atol 1e-2,
diffuse fluxes rtol 5e-4 atol 5e-5 W/m2 -- its 0.5 W on 1e4 m2 faces --,
absorption rtol 2e-3 atol 1e-5), with every sub-solve's iteration count
within 2 of the one-rank solve's."""

import jax
import numpy as np
import pytest
import torch

from tenstream_tpu.parallel.mesh import make_mesh as jmake_mesh
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)
from torch_mesh_ranks import assemble, run_ranks

NZ, NX, NY = 6, 16, 16
SUN = (25.0, 35.0)
ALBEDO, TOA = 0.2, 800.0
FLUX_ATOL, ABSO_ATOL_JAX = 0.1, 1e-3
NITER_SLACK = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    """`tests/test_parallel.py`'s scene."""
    rng = np.random.default_rng(5)
    ka = (1e-4 + 1e-3 * rng.random((NZ, NX, NY))).astype(np.float32)
    ks = (1e-4 + 4e-3 * rng.random((NZ, NX, NY))).astype(np.float32)
    gg = np.full((NZ, NX, NY), 0.4, np.float32)
    planck = (np.linspace(2.0, 5.0, NZ + 1)[:, None, None] * np.ones((NX, NY))).astype(np.float32)
    return ka, ks, gg, planck


def _fluxes(solver):
    return [np.asarray(a) for a in solver.get_result()]


@pytest.fixture(scope="module")
def lut_file(opp_small, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lut") / "lut_3_10_mockup.npz")
    lut_from_arrays(opp_small.lut, "cpu").save(path)
    return path


@pytest.fixture(scope="module")
def one_rank(lut_file):
    """The port's undecomposed solve: fluxes and (solar, thermal) niter."""
    from tenstream_tpu_torch.optprop.lut import LUT

    solver = PprtsSolver(Grid.create(NZ, NX, NY, 100.0, 100.0, 100.0, device="cpu"),
                         OptProp(LUT.load(lut_file, device="cpu"), device="cpu"))
    ka, ks, gg, planck = _scene()
    solver.set_optical_properties(ALBEDO, ka, ks, gg, planck=planck)
    solver.set_angles(sundir_from_angles(*SUN))
    sol = solver.solve(lthermal=True, lsolar=True, edirTOA=TOA)
    return _fluxes(solver), (sol.niter_diff, sol.thermal.niter_diff)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=lambda v: f"{v[0]}x{v[1]}")
def test_decomposed_solve(layout, opp_small, lut_file, one_rank, tmp_path):
    ka, ks, gg, planck = _scene()
    res = run_ranks("solve", layout, dict(shape=np.array([NZ, NX, NY]), dx=100.0, lut=lut_file,
                                          ka=ka, ks=ks, g=gg, planck=planck, albedo=ALBEDO,
                                          sun=np.array(SUN), toa=TOA), tmp_path)
    got = [assemble([r[k] for r in res], layout) for k in ("edir", "edn", "eup", "abso")]
    for r in res:  # the global field on every rank
        np.testing.assert_array_equal(r["edn_global"], got[1])
    niters = {tuple(r["niter"]) for r in res}
    assert len(niters) == 1, niters  # every rank ran the same iterations
    want, want_iters = one_rank
    for a, b in zip(next(iter(niters)), want_iters):
        assert abs(int(a) - int(b)) <= NITER_SLACK, (niters, want_iters)
    for k, (g, w, rtol, atol) in enumerate(zip(got, want, (2e-4, 5e-4, 5e-4, 2e-3),
                                               (1e-2, 5e-5, 5e-5, 1e-5))):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"one rank, field {k}")

    nxp, nyp = layout
    jsolver = JSolver(JGrid.create(NZ, NX, NY, 100.0, 100.0, 100.0), opp_small)
    jsolver.set_mesh(jmake_mesh(jax.devices()[:nxp * nyp], nxproc=nxp, nyproc=nyp))
    jsolver.set_optical_properties(ALBEDO, ka, ks, gg, planck=planck)
    jsolver.set_angles(jsun(*SUN))
    jsolver.solve(lthermal=True, lsolar=True, edirTOA=TOA)
    jres = _fluxes(jsolver)
    for k, (g, w) in enumerate(zip(got, jres)):
        np.testing.assert_allclose(g, w, atol=ABSO_ATOL_JAX if k == 3 else FLUX_ATOL,
                                   err_msg=f"JAX sharded, field {k}")
