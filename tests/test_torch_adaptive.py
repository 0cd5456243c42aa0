"""The adaptive spectral skip in the port against the JAX package.

- `SolutionErrorTracker.need_new_solution` and `abso_change_maxnorm`
  against JAX's on the same (time, error) histories.
- A three-step `specint_pprts` run with the skip on (after
  `tests/test_adaptive_specint.py`: 10 layers of a 25 km standard
  atmosphere, 4x4 columns of 500 m, the mockup LUT; here ecCKD 32+32 in
  chunks of 8), then a step after the solutions have aged: the skip
  counts of every step equal JAX's, and the fields hold the gates of
  `test_torch_specint.py` (fluxes 0.1 W/m2, absorption 1e-4 W/m3).  A
  second sequence steps a changing scene, where some chunks skip and
  others re-solve."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts import adaptive as jadaptive
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.convert import atmosphere_from_arrays, lut_from_arrays
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts import adaptive as tadaptive
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import specint_pprts
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

HERE = os.path.dirname(os.path.abspath(__file__))
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4
NLAY, NX, NY = 10, 4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HISTORIES = [
    ([], []),
    ([0.0], [0.0]),
    ([0.0, 60.0], [0.0, 1e-3]),
    ([0.0, 60.0, 120.0], [0.0, 1.0, 4.0]),
    ([0.0, 60.0, 120.0, 180.0], [5.0, 4.0, 3.0, 2.5]),
    ([0.0, 60.0, 120.0], [0.0, 0.0, 0.0]),
    ([10.0, 10.0], [1.0, 2.0]),  # a degenerate fit
]


@pytest.mark.parametrize("times,errors", HISTORIES)
def test_error_tracker_equals_jax(times, errors):
    jt, tt = jadaptive.SolutionErrorTracker(), tadaptive.SolutionErrorTracker()
    for t, e in zip(times, errors):
        jt.record(t, e)
        tt.record(t, e)
    assert (tt.times, tt.errors) == (jt.times, jt.errors)
    for now in (None, 0.0, 100.0, 150.0, 240.0, 1e5):
        for err, age in ((0.5, 3600.0), (10.0, 3600.0), (10.0, 30.0)):
            assert tt.need_new_solution(now, err, age) == jt.need_new_solution(now, err, age), (
                now, err, age)


def test_abso_change_maxnorm_equals_jax():
    rng = np.random.default_rng(0)
    a, b = rng.random((3, 4, 5), dtype=np.float32), rng.random((3, 4, 5), dtype=np.float32)
    assert tadaptive.abso_change_maxnorm(a, b) == jadaptive.abso_change_maxnorm(a, b)


@pytest.fixture(scope="module")
def jlut():
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def _pair(jlut):
    jatm = jsetup(nlay=NLAY, ztop=25e3)
    dz = jatm.dz.astype(np.float32)
    js = JSolver(JGrid.create(NLAY, NX, NY, 500.0, 500.0, dz), JOptProp(jlut))
    ts = PprtsSolver(Grid.create(NLAY, NX, NY, 500.0, 500.0, dz, device="cpu"),
                     OptProp(lut_from_arrays(jlut, "cpu"), device="cpu"))
    js.set_angles(jsun(20.0, 30.0))
    ts.set_angles(sundir_from_angles(20.0, 30.0))
    return js, ts, jatm, atmosphere_from_arrays(jatm)


def _check(rj, rt, label):
    for name, a, b in zip(("edir", "edn", "eup"), rj[:3], rt[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=FLUX_ATOL,
                                   err_msg=f"{label} {name}")
    np.testing.assert_allclose(rt[3].numpy(), np.asarray(rj[3]), atol=ABSO_ATOL,
                               err_msg=f"{label} abso")


def _reset_skip_state(solver):
    solver._spectral_cache, solver._spectral_trackers, solver._spectral_skips = {}, {}, 0


@pytest.fixture(scope="module")
def skip_runs(jlut):
    """Both sequences on one solver pair (one set of JAX compiles): an
    identical scene at times 0, 60, 120 and after the solutions have aged;
    then, from a fresh skip state, a surface layer that warms by 0.5 K a
    step.  Per call: (JAX result, port result, JAX skips, port skips)."""
    js, ts, jatm, tatm = _pair(jlut)
    kw = dict(albedo=0.2, lthermal=True, lsolar=True, specint="ecckd", band_chunk=8,
              max_solution_time=3600.0)
    runs = {"identical": [], "warming": []}
    for t in (0.0, 60.0, 120.0, 99999.0):
        rj = jspecint(js, jatm, time=t, max_solution_err=10.0, **kw)
        rt = specint_pprts(ts, tatm, time=t, max_solution_err=10.0, **kw)
        runs["identical"].append((rj, rt, getattr(js, "_spectral_skips", 0), ts._spectral_skips))
    for solver in (js, ts):
        _reset_skip_state(solver)
    for step, t in enumerate((0.0, 60.0, 120.0, 180.0)):
        for atm in (jatm, tatm):
            atm.tlev = atm.tlev.copy()
            atm.tlev[-1] = 288.0 + 0.5 * step
        rj = jspecint(js, jatm, time=t, max_solution_err=5e-4, **kw)
        rt = specint_pprts(ts, tatm, time=t, max_solution_err=5e-4, **kw)
        runs["warming"].append((rj, rt, getattr(js, "_spectral_skips", 0), ts._spectral_skips))
    return runs, ts


def test_adaptive_skip_counts_and_fields_equal_jax(skip_runs):
    """An identical scene: the history is too short for two steps, then
    every chunk skips (4 solar + 4 thermal); a step after
    max_solution_time re-solves them all."""
    runs, ts = skip_runs
    counts = [(nj, nt) for _, _, nj, nt in runs["identical"]]
    assert [c[1] for c in counts] == [c[0] for c in counts], counts
    assert [c[1] for c in counts] == [0, 0, 8, 8], counts
    for (rj, rt, _, _), t in zip(runs["identical"], (0.0, 60.0, 120.0, 99999.0)):
        _check(rj, rt, f"time {t}")
    # the skip turns the difficulty regroup off: natural chunk keys only
    assert not ts._band_order


def test_adaptive_skip_on_a_changing_scene_equals_jax(skip_runs):
    """A warming surface layer: the chunks whose extrapolated absorption
    change stays below the threshold skip, the others re-solve; the counts
    of each step equal JAX's."""
    runs, ts = skip_runs
    counts = [(nj, nt) for _, _, nj, nt in runs["warming"]]
    assert [c[1] for c in counts] == [c[0] for c in counts], counts
    skipped = counts[-1][1] - counts[-2][1]
    assert 0 < skipped < 8, counts  # some skip, some re-solve
    for step, (rj, rt, _, _) in enumerate(runs["warming"]):
        _check(rj, rt, f"step {step}")
