"""(iv) The dense path decomposed: a solar + thermal solve with buildings
(dense coefficients: K3's plain version in halo mode, the face masks and
the wall sources across block edges) on a 2 x 2 gloo group of CPU
processes against the port's undecomposed solve, with the per-face
building fluxes.  The buildings straddle the blocks' edges, so walls,
roofs and their shadows cross from one rank to the next.

Gates: those `tests/test_parallel.py` holds JAX's sharded solve to
against its single-device one (edir rtol 2e-4 atol 1e-2, diffuse fluxes
and face fluxes rtol 5e-4 atol 5e-5 W/m2, absorption rtol 2e-3 atol 1e-5
W/m3), every sub-solve's iteration count within 2."""

import numpy as np
import pytest
import torch

from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.optprop.lut import LUT
from tenstream_tpu_torch.pprts.buildings import Buildings
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from torch_mesh_ranks import assemble, run_ranks

NZ, NX, NY = 6, 16, 16
SUN = (200.0, 40.0)
ALBEDO, TOA, BALBEDO = 0.15, 1000.0, 0.4
NITER_SLACK = 2
GATES = dict(edir=(2e-4, 1e-2), edn=(5e-4, 5e-5), eup=(5e-4, 5e-5), abso=(2e-3, 1e-5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    rng = np.random.default_rng(8)
    ka = (5e-5 + 5e-4 * rng.random((NZ, NX, NY))).astype(np.float32)
    ks = (5e-5 + 2e-3 * rng.random((NZ, NX, NY))).astype(np.float32)
    g = np.full((NZ, NX, NY), 0.3, np.float32)
    planck = (np.linspace(60.0, 120.0, NZ + 1)[:, None, None] * np.ones((NX, NY))).astype(
        np.float32)
    solid = np.zeros((NZ, NX, NY), bool)
    solid[-3:, 6:10, 2:5] = True  # across the x edge of the blocks
    solid[-2:, 11:14, 7:10] = True  # across the y edge
    solid[-4:, 15:16, 15:16] = True  # a corner column at the periodic edge
    solid[-1:, 0:2, 14:16] = True
    bplanck = np.where(solid, 140.0, 0.0).astype(np.float32)
    return ka, ks, g, planck, solid, bplanck


def test_decomposed_buildings(opp_small, tmp_path):
    lut_path = str(tmp_path / "lut.npz")
    lut_from_arrays(opp_small.lut, "cpu").save(lut_path)
    ka, ks, g, planck, solid, bplanck = _scene()
    solver = PprtsSolver(Grid.create(NZ, NX, NY, 100.0, 100.0, 100.0, device="cpu"),
                         OptProp(LUT.load(lut_path, device="cpu"), device="cpu"))
    solver.set_buildings(Buildings(solid=solid, albedo=BALBEDO, planck=bplanck))
    solver.set_optical_properties(ALBEDO, ka, ks, g, planck=planck)
    solver.set_angles(sundir_from_angles(*SUN))
    sol = solver.solve(lthermal=True, lsolar=True, edirTOA=TOA)
    want = dict(zip(("edir", "edn", "eup", "abso"), (a.numpy() for a in solver.get_result())))
    faces = {k: d["incoming"].numpy() for k, d in solver.get_building_fluxes().items()}
    iters = (sol.niter_diff, sol.thermal.niter_diff)

    layout = (2, 2)
    res = run_ranks("buildings", layout, dict(
        shape=np.array([NZ, NX, NY]), dx=100.0, lut=lut_path, ka=ka, ks=ks, g=g, planck=planck,
        solid=solid, bplanck=bplanck, balbedo=BALBEDO, albedo=ALBEDO, sun=np.array(SUN),
        toa=TOA), tmp_path)
    for r in res:
        np.testing.assert_array_equal(r["niter"], res[0]["niter"])
        assert all(abs(int(a) - b) <= NITER_SLACK for a, b in zip(r["niter"], iters))
    for name, (rtol, atol) in GATES.items():
        np.testing.assert_allclose(assemble([r[name] for r in res], layout), want[name],
                                   rtol=rtol, atol=atol, err_msg=name)
    for kind, w in faces.items():
        assert np.abs(w).max() > 0.0, kind  # every face kind is lit somewhere
        np.testing.assert_allclose(assemble([r[f"bf_{kind}"] for r in res], layout), w,
                                   rtol=5e-4, atol=5e-5, err_msg=kind)
