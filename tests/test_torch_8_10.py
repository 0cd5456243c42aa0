"""The 8_10 scheme in the port, and the options the port refuses.

- An 8_10 `PprtsSolver` solve against the JAX package's on the committed
  `data/luts/LUT_8_10_production.npz`: a 5x6x6 scene with a box cloud,
  solar at two suns (the beam travelling +x/+y and -x/-y) and thermal.
  Gates: fluxes within 0.1 W/m2 and absorption within 1e-4 W/m3 (the
  golden gates; LUT-interpolated dir2dir on both sides), niter within 2.
- K1 and K2 find their instantiation by the scheme's tables, not by its
  name: 8_10, whose diffuse orbits, shifts and surface closure equal
  3_10's, runs on 3_10's; every compiled table set is accepted, and tables
  that match none (a reversed orbit table, moved shifts) raise.  (The
  kernels on the card: `tests/test_torch_cuda.py`.)
- `debug_nans` and an explicit `pprts_assembly_z_slab` raise and name
  their ROADMAP item."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import LUT as JLUT
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu_torch.convert import lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp, diff_pair_orbits
from tenstream_tpu_torch.pprts import cuda_ops
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.streams import get_scheme
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT_8_10 = os.path.join(REPO, "data", "luts", "LUT_8_10_production.npz")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
NZ, NX, NY = 5, 6, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
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


@pytest.fixture(scope="module")
def jlut():
    return JLUT.load(LUT_8_10)


def _run(solver, sun, lthermal):
    ka, ks, g, planck = _scene()
    solver.set_optical_properties(0.15, ka, ks, g, planck=planck if lthermal else None)
    solver.set_angles(sun)
    solver.solve(lthermal=lthermal, lsolar=not lthermal, edirTOA=1000.0)
    res = [None if a is None else np.asarray(a) for a in solver.get_result()]
    return res, int(np.asarray(solver.solutions[0].niter_diff))


@pytest.mark.parametrize("phi,theta,lthermal", [(30.0, 40.0, False), (210.0, 60.0, False),
                                                (30.0, 40.0, True)],
                         ids=["solar_beam_pos", "solar_beam_neg", "thermal"])
def test_8_10_solve_matches_jax(jlut, phi, theta, lthermal):
    grid = dict(nz=NZ, nx=NX, ny=NY, dx=100.0, dy=100.0, dz=100.0)
    js = JSolver(JGrid.create(**grid), JOptProp(jlut, analytic_dir2dir=False))
    ts = PprtsSolver(Grid.create(**grid, device="cpu"),
                     OptProp(lut_from_arrays(jlut, "cpu"), analytic_dir2dir=False, device="cpu"))
    assert ts.scheme.name == "8_10" and ts.scheme.ndir == 8
    ref, nj = _run(js, jsun(phi, theta), lthermal)
    got, nt = _run(ts, sundir_from_angles(phi, theta), lthermal)
    for name, a, b in zip(("edir", "edn", "eup"), ref[:3], got[:3]):
        if a is not None:
            np.testing.assert_allclose(b, a, atol=FLUX_ATOL, err_msg=name)
    np.testing.assert_allclose(got[3], ref[3], atol=ABSO_ATOL, err_msg="abso")
    assert abs(nt - nj) <= 2, (nt, nj)
    if not lthermal:  # the cloud casts a shadow
        assert got[0][-1].min() < 0.8 * got[0][-1].max()


def test_k1_refusal_is_by_tables_not_by_name():
    k_idx, k_norb = diff_pair_orbits(get_scheme("3_10"), with_mz=False)
    idx, norb = diff_pair_orbits(get_scheme("8_10"), with_mz=False)
    # 8_10 runs on 3_10's instantiation; every compiled table set is accepted
    assert cuda_ops._orbit_instantiation(get_scheme("8_10"), np.asarray(idx, np.int64), norb) == 0
    for q, name in enumerate(cuda_ops.ORBIT_SCHEMES):
        o_idx, o_norb = diff_pair_orbits(get_scheme(name), with_mz=False)
        assert cuda_ops._orbit_instantiation(get_scheme(name), np.asarray(o_idx, np.int64),
                                             o_norb) == q
    # 8_10's orbit table, but tables of another layout: refused
    with pytest.raises(ValueError, match="matches none"):
        cuda_ops._orbit_instantiation(get_scheme("3_6"), np.asarray(idx, np.int64), norb)
    with pytest.raises(ValueError, match="matches none"):
        cuda_ops._orbit_instantiation(get_scheme("8_10"), np.asarray(idx, np.int64)[::-1], norb)
    assert np.array_equal(idx, k_idx) and norb == k_norb


def test_k1_refuses_a_scheme_whose_shift_tables_differ(monkeypatch):
    """Equal orbit tables, other shift tables: the check reads the shifts."""
    idx, norb = diff_pair_orbits(get_scheme("8_10"), with_mz=False)
    cshift, gshift = cuda_ops._shift_tables(get_scheme("8_10"))
    for name in cuda_ops.ORBIT_SCHEMES:  # the compiled sets' tables, before the patch
        cuda_ops._k1_tables(name)
    moved = (cshift, (gshift[1],) + gshift[:1] + gshift[2:])
    monkeypatch.setattr(cuda_ops, "_shift_tables", lambda scheme: moved)
    with pytest.raises(ValueError, match="matches none"):
        cuda_ops._orbit_instantiation(get_scheme("8_10"), np.asarray(idx, np.int64), norb)


def test_8_10_dense_tables_accepted():
    """K3 is instantiated by diffuse dof count and takes the shifts at run
    time: 8_10 has 3_10's 10 dofs and shifts; every cube scheme's dof count
    is accepted, 1_2's 2 are not."""
    assert cuda_ops._dense_tables(get_scheme("8_10")) == cuda_ops._dense_tables(get_scheme("3_10"))
    for name in cuda_ops.ORBIT_SCHEMES + ("8_16",):
        ts = get_scheme(name)
        assert len(cuda_ops._dense_tables(ts)) == 1 + 6 * ts.ndiff
    with pytest.raises(ValueError, match="K3 is instantiated for"):
        cuda_ops._dense_tables(get_scheme("1_2"))


@pytest.mark.parametrize("opts,item", [({"debug_nans": True}, "M4 remainder"),
                                       ({"pprts_assembly_z_slab": 0}, "M4 remainder"),
                                       ({"pprts_assembly_z_slab": 4}, "M4 remainder")])
def test_unread_options_raise(jlut, opts, item):
    grid = Grid.create(3, 2, 2, 100.0, 100.0, 100.0, device="cpu")
    lut = lut_from_arrays(jlut, "cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        PprtsSolver(grid, OptProp(lut, device="cpu"), options=Options(opts, read_env=False))
    # set after construction: refused at the solve
    s = PprtsSolver(grid, OptProp(lut, device="cpu"))
    for k, v in opts.items():
        s.options.set(k, v)
    s.set_optical_properties(0.1, *(np.full((3, 2, 2), 1e-4, np.float32),) * 2,
                             np.zeros((3, 2, 2), np.float32))
    s.set_angles(sundir_from_angles(0.0, 30.0))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        s.solve(lthermal=False, lsolar=True, edirTOA=1.0)


def test_unset_and_off_options_are_accepted(jlut):
    grid = Grid.create(3, 2, 2, 100.0, 100.0, 100.0, device="cpu")
    PprtsSolver(grid, OptProp(lut_from_arrays(jlut, "cpu"), device="cpu"),
                options=Options({"debug_nans": False}, read_env=False))
