"""`test_torch_specint.py`'s bench scene (4x4 columns, ecCKD 32+32, band
chunks of 8, atm_collapse 16) with the closed-form dir2dir (the default) on
both sides: its own JAX programs, compiled in a file of its own so that
another pytest-xdist worker runs them.  Gates: fluxes within 0.1 W/m2,
absorption within 1e-3 W/m3 (the closed form's float32 cancellation,
`tests/test_torch_solver.py`), per-band niter within 2, TOA edir the solar
weights times mu."""

import os

import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.lut import load_or_create_lut, mockup_axes
from tenstream_tpu.spectral.ecckd import EcckdGasOptics as JEcckd
from tenstream_tpu_torch.convert import atmosphere_from_arrays
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
from test_torch_specint import (ABSO_ATOL_CLOSED_FORM, HERE, NX, NY, _check, _check_niters,
                                _solvers, _steps, bench_scene)
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, no oversubscription when test
    files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jlut():
    torch.backends.cuda.matmul.allow_tf32 = False
    return load_or_create_lut("3_10", mockup_axes(True), mockup_axes(False), n_photons=2000,
                              basename=os.path.join(HERE, "data", "luts"))


def test_bench_scene_closed_form_dir2dir(jlut):
    """Both sides evaluate the closed-form dir2dir (the default)."""
    js, ts = _solvers(jlut, analytic=None)
    _, lwc = bench_scene(NX, NY)
    (res_j, res_t, nj, nt), = _steps(js, ts, lwc, 1, JEcckd(n_gpt=32), EcckdGasOptics(n_gpt=32))
    _check(res_j, res_t, ABSO_ATOL_CLOSED_FORM, "closed form")
    _check_niters(nj, nt, "closed form")
    # TOA direct irradiance = the solar weights times mu
    mu = float(np.cos(np.deg2rad(40.0)))
    w = EcckdGasOptics(n_gpt=32).solar(atmosphere_from_arrays(bench_scene(NX, NY)[0])).weight
    np.testing.assert_allclose(res_t[0][0], float(w.sum()) * mu, rtol=1e-5)
