"""The port's spectral warm-start machinery against the JAX driver on the
same sequence of calls: the cache modes (f32, bf16, off, host), the
difficulty regroup with its band-by-band warm gather, `bands=`, the
time-stepping extrapolation and the cross-band seed.

A small scene (2x2 columns of bench.py's z grid, ecCKD 16+16, chunks of
8, atm_collapse over 16 layers) keeps the JAX calls cheap; one JAX solver
serves every case (its state is reset between cases, its compiled
programs stay), so the file compiles the JAX solve programs once.

Gates as in `tests/test_torch_specint.py`: fluxes within 0.1 W/m2,
absorption within 1e-4 W/m3 (LUT-interpolated dir2dir), per-band niter
within +-2."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.core.config import Options as JOptions
from tenstream_tpu.optprop.facade import OptProp as JOptProp
from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles as jsun
from tenstream_tpu.spectral.ecckd import EcckdGasOptics as JEcckd
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.convert import atmosphere_from_arrays, lut_from_arrays
from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
from tenstream_tpu_torch.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.spectral import specint_pprts
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics

import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)
from test_torch_specint import (  # noqa: E402,F401 (_one_torch_thread is an autouse fixture)
    ABSO_ATOL,
    K_COLLAPSE,
    _band_niters,
    _check,
    _check_niters,
    bench_scene,
    _one_torch_thread,
)

HERE = os.path.dirname(os.path.abspath(__file__))
N = 2
BASE = {"atm_collapse": K_COLLAPSE}
DEFAULTS = {"specint_cache": "auto", "specint_warm_extrapolate": False,
            "specint_band_seed": False, "specint_band_group": True}


@pytest.fixture(scope="module")
def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    jlut = load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))
    jatm, lwc = bench_scene(N, N, seed=3)
    lwc[:, 0, 0] = 0.0  # one clear column
    dz = np.asarray(jatm.dz, np.float32)
    js = JSolver(JGrid.create(jatm.nlay, N, N, 100.0, 100.0, dz),
                 JOptProp(jlut, analytic_dir2dir=False),
                 options=JOptions(dict(BASE), read_env=False))
    js.set_angles(jsun(120.0, 40.0))
    topp = OptProp(lut_from_arrays(jlut, "cpu"), analytic_dir2dir=False, device="cpu")
    return js, topp, jatm, lwc


def _run_case(setup, opts, calls):
    """Reset the JAX solver's state, set `opts` on both, and run `calls`
    (a list of (lwc roll, specint kwargs)) through both drivers."""
    js, topp, jatm, lwc0 = setup
    js.solutions.clear()
    js._pending_convergence.clear()
    for attr in ("_band_order", "_band_rows", "_extrap_states", "_spectral_cache"):
        if hasattr(js, attr):
            delattr(js, attr)
    for k, v in opts.items():
        js.options.set(k, v)
    ts = PprtsSolver(Grid.create(jatm.nlay, N, N, 100.0, 100.0, np.asarray(jatm.dz, np.float32),
                                 device="cpu"), topp,
                     options=Options({**BASE, **opts}, read_env=False))
    ts.set_angles(sundir_from_angles(120.0, 40.0))
    tatm = atmosphere_from_arrays(jatm)
    out = []
    try:
        for roll, kw in calls:
            lwc = np.roll(lwc0, roll, axis=1)
            rj = jspecint(js, jatm, albedo=0.15, lthermal=True, lsolar=True,
                          specint=JEcckd(n_gpt=16), lwc=lwc, band_chunk=8, **kw)
            rt = specint_pprts(ts, tatm, albedo=0.15, lthermal=True, lsolar=True,
                               specint=EcckdGasOptics(n_gpt=16), lwc=lwc, band_chunk=8, **kw)
            out.append((tuple(np.asarray(a) for a in rj), tuple(a.numpy() for a in rt),
                        _band_niters(js), _band_niters(ts)))
    finally:
        for k in opts:
            js.options.set(k, DEFAULTS[k])
    return out, ts


@pytest.mark.parametrize("mode", ["f32", "bf16", "off", "host"])
def test_cache_modes_match_jax(setup, mode):
    """A cold call, then two perturbed warm calls (regrouped, gathered)."""
    out, ts = _run_case(setup, {"specint_cache": mode}, [(0, {}), (1, {}), (2, {})])
    for i, (rj, rt, nj, nt) in enumerate(out):
        _check(rj, rt, ABSO_ATOL, f"{mode} call {i}")
        _check_niters(nj, nt, f"{mode} call {i}")
    cached = [s.ediff for s in ts.solutions.values()]
    if mode == "off":
        assert all(e is None for e in cached)
    else:
        want = {"f32": torch.float32, "bf16": torch.bfloat16, "host": torch.float32}[mode]
        assert cached and all(e.dtype == want and e.device.type == "cpu" for e in cached)


def test_bands_subset_then_full_spectrum(setup):
    """`bands=(lo, hi)` solves a partial spectrum; a later full call
    appends the bands outside the frozen order in natural order."""
    out, ts = _run_case(setup, {"specint_cache": "f32"},
                        [(0, {"bands": (8, 16)}), (0, {}), (1, {})])
    assert set(out[0][3]) == {(t, g) for t in ("solar", "thermal") for g in range(8, 16)}
    for i, (rj, rt, nj, nt) in enumerate(out):
        _check(rj, rt, ABSO_ATOL, f"bands call {i}")
        _check_niters(nj, nt, f"bands call {i}")


def test_warm_extrapolation_matches_jax(setup):
    """x0 = 2 x(t-1) - x(t-2) from the third call on."""
    out, ts = _run_case(setup, {"specint_cache": "f32", "specint_warm_extrapolate": True},
                        [(0, {}), (1, {}), (2, {}), (3, {})])
    assert ts._extrap_states
    for i, (rj, rt, nj, nt) in enumerate(out):
        _check(rj, rt, ABSO_ATOL, f"extrapolated call {i}")
        _check_niters(nj, nt, f"extrapolated call {i}")


def test_band_seed_and_no_grouping_match_jax(setup):
    """Cold chunks seeded from the previous chunk's states, with the
    difficulty grouping off (natural chunk keys throughout)."""
    out, ts = _run_case(setup, {"specint_cache": "f32", "specint_band_seed": True,
                                "specint_band_group": False}, [(0, {}), (1, {})])
    assert all(isinstance(k[1], int) for k in ts.solutions)
    for i, (rj, rt, nj, nt) in enumerate(out):
        _check(rj, rt, ABSO_ATOL, f"seeded call {i}")
        _check_niters(nj, nt, f"seeded call {i}")
