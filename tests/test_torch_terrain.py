"""Terrain in the port against the JAX package: the geometric direct
coefficients of tilted cells (`pprts/geometric.py`), a hill solve with
`pprts_geometric_coeffs` through `PprtsSolver.set_terrain`, the
post-processing of `pprts/postprocess.py` (the `examples/ex_pprts_hill.py`
flow) and the vegetation data module.

Gates: `dir2dir_geometric` within 1e-5 per coefficient (the same float32
march, exp and the mean of 36 samples summed in another order),
`zlev_from_dz` within 1e-5 relative (a float32 cumulative sum); the hill
solve within the golden gates, fluxes 0.1 W/m2 and absorption 1e-4 W/m3,
niter within 2; the post-processing within 1e-5 relative; the vegetation
functions exactly (the same numpy code)."""

import os
import sys

import numpy as np
import pytest
import torch

from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts import geometric as jgeo
from tenstream_tpu.pprts import postprocess as jpost
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.spectral import vegetation as jveg
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts import geometric as tgeo
from tenstream_tpu_torch.pprts import postprocess as tpost
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import vegetation as tveg
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "examples"))
from ex_pprts_hill import gaussian_hill_grid  # noqa: E402

FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
COEFF_ATOL = 1e-5
NZ, NX, NY, DX = 6, 12, 10, 100.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hill():
    """Layers of 117-167 m over columns of 100 m: every layer is 3-D."""
    dz3d, h, hx, hy = gaussian_hill_grid(NZ, NX, NY, DX, ztop=1000.0, hill_height=300.0,
                                         hill_sigma=300.0)
    return dz3d.astype(np.float32), h.astype(np.float32), hx, hy


@pytest.mark.parametrize("phi,theta", [(90.0, 50.0), (270.0, 30.0), (200.0, 60.0), (0.0, 0.0)])
def test_dir2dir_geometric_equals_jax(phi, theta):
    dz3d, h, _, _ = _hill()
    kext = np.random.default_rng(1).uniform(1e-4, 3e-3, (NZ, NX, NY)).astype(np.float32)
    zj = np.asarray(jgeo.zlev_from_dz(dz3d, h))
    zt = tgeo.zlev_from_dz(torch.as_tensor(dz3d), torch.as_tensor(h))
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-5)
    np.testing.assert_allclose(tgeo.zlev_from_dz(torch.as_tensor(dz3d)).numpy(),
                               np.asarray(jgeo.zlev_from_dz(dz3d)), rtol=1e-5)
    sundir = sundir_from_angles(phi, theta)
    ref = np.asarray(jgeo.dir2dir_geometric(zj, DX, DX, jsun(phi, theta), kext))
    got = tgeo.dir2dir_geometric(zt, DX, DX, sundir, torch.as_tensor(kext))
    assert got.shape == ref.shape == (3, 3, NZ, NX, NY)
    np.testing.assert_allclose(got.numpy(), ref, atol=COEFF_ATOL)
    # a lane dim on kext: each lane equals its own call
    lanes = torch.stack([torch.as_tensor(kext), torch.as_tensor(kext) * 3.0])
    both = tgeo.dir2dir_geometric(zt, DX, DX, sundir, lanes)
    assert both.shape == (2, 3, 3, NZ, NX, NY)
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), atol=1e-7)
    one = tgeo.dir2dir_geometric(zt, DX, DX, sundir, lanes[1])
    np.testing.assert_allclose(both[1].numpy(), one.numpy(), atol=1e-7)


@pytest.fixture(scope="module")
def jlut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def _hill_solve(solver, sun, h):
    ka = np.full((NZ, NX, NY), 5e-5, np.float32)
    ks = np.full((NZ, NX, NY), 2e-4, np.float32)
    ks[2:4, 3:6, 2:5] = 5e-3  # a cloud over the hill's flank
    g = np.full((NZ, NX, NY), 0.4, np.float32)
    solver.set_optical_properties(0.2, ka, ks, g)
    solver.set_terrain(h)
    solver.set_angles(sun)
    solver.solve(lthermal=False, lsolar=True, edirTOA=1364.0)
    return ([np.asarray(a) for a in solver.get_result()],
            int(np.asarray(solver.solutions[0].niter_diff)))


@pytest.mark.parametrize("geometric", [True, False], ids=["geometric", "lut"])
def test_hill_solve_matches_jax(jlut, geometric):
    """`examples/ex_pprts_hill.py`'s scene (smaller), sun from +x."""
    dz3d, h, hx, hy = _hill()
    opts = {"pprts_geometric_coeffs": True} if geometric else {}
    js = JSolver(JGrid.create(NZ, NX, NY, DX, DX, dz3d), JOptProp(jlut),
                 options=JOptions(dict(opts), read_env=False))
    ts = PprtsSolver(Grid.create(NZ, NX, NY, DX, DX, dz3d, device="cpu"),
                     OptProp(lut_from_arrays(jlut, "cpu"), device="cpu"),
                     options=Options(dict(opts), read_env=False))
    ref, nj = _hill_solve(js, jsun(90.0, 50.0), h)
    got, nt = _hill_solve(ts, sundir_from_angles(90.0, 50.0), h)
    for name, a, b in zip(("edir", "edn", "eup"), ref[:3], got[:3]):
        np.testing.assert_allclose(b, a, atol=FLUX_ATOL, err_msg=name)
    np.testing.assert_allclose(got[3], ref[3], atol=ABSO_ATOL, err_msg="abso")
    assert abs(nt - nj) <= 2, (nt, nj)
    # the slope-corrected surface beam brightens the flank facing the sun
    sun = sundir_from_angles(90.0, 50.0)
    corr_j = np.asarray(jpost.slope_correction_srfc_edir(ref[0][-1], hx, hy, jsun(90.0, 50.0)))
    corr_t = tpost.slope_correction_srfc_edir(torch.as_tensor(got[0][-1]), hx, hy, sun).numpy()
    np.testing.assert_allclose(corr_t, corr_j, atol=FLUX_ATOL)
    mid = NY // 2
    assert corr_t[NX - 3, mid] > 1.05 * got[0][-1][NX - 3, mid]


def test_geometric_coefficients_change_the_solve(jlut):
    """On the hill, the tilted cells move the surface beam: the geometric
    and the LUT solve differ somewhere by more than 1 W/m2."""
    dz3d, h, _, _ = _hill()
    out = []
    for geometric in (True, False):
        ts = PprtsSolver(Grid.create(NZ, NX, NY, DX, DX, dz3d, device="cpu"),
                         OptProp(lut_from_arrays(jlut, "cpu"), device="cpu"),
                         options=Options({"pprts_geometric_coeffs": geometric}, read_env=False))
        out.append(_hill_solve(ts, sundir_from_angles(90.0, 50.0), h)[0][0][-1])
    assert np.abs(out[0] - out[1]).max() > 1.0


def test_slope_correction_and_smoothing_equal_jax():
    _, _, hx, hy = _hill()
    field = np.random.default_rng(2).uniform(0.0, 800.0, (NX, NY)).astype(np.float32)
    for phi, theta in ((90.0, 50.0), (300.0, 20.0)):
        ref = np.asarray(jpost.slope_correction_srfc_edir(field, hx, hy, jsun(phi, theta)))
        got = tpost.slope_correction_srfc_edir(torch.as_tensor(field), hx, hy,
                                               sundir_from_angles(phi, theta))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    for it in (1, 3):
        ref = np.asarray(jpost.convolve_srfc_5pt(field[None], iterations=it))
        got = tpost.convolve_srfc_5pt(torch.as_tensor(field[None]), iterations=it)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
@pytest.mark.parametrize("veg", ["bark", "grass", "leaf"])


def test_vegetation_albedo_and_mixing_equal_jax(veg):
    for lo, hi in ((0.3, 0.7), (0.7, 5.0), (0.45, 0.46), (0.1, 0.2), (2.0, 2.9)):
        assert tveg.get_albedo_for_range(veg, lo, hi) == jveg.get_albedo_for_range(veg, lo, hi)
    with pytest.raises(ValueError):
        tveg.get_albedo_for_range(veg, 1.0, 0.5)
    rng = np.random.default_rng(4)
    t0, w0, ta, wa = (rng.uniform(0.0, 1.0, 6) for _ in range(4))
    t0[0] = ta[0] = 0.0
    for a, b in zip(tveg.mix_material(t0, w0, ta, wa), jveg.mix_material(t0, w0, ta, wa)):
        np.testing.assert_array_equal(a, np.asarray(b))
