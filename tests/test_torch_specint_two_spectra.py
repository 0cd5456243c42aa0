"""One 3_10 solver that sees two solar spectra, ecCKD and then RRTMG_SW,
through the port's `specint_pprts` against the JAX spectral driver, on
bench.py's scene at 4x4 columns (`torch_specint_3_10.py` has the scene,
the solvers and the gates: fluxes 0.1 W/m2, absorption 1e-4 W/m3, per-band
niter within 2)."""

import numpy as np
import pytest
import torch

import torch_specint_3_10 as sc
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.convert import atmosphere_from_arrays
from tenstream_tpu_torch.spectral import specint_pprts
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, no oversubscription when test
    files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_3_10_solver_two_solar_spectra_matches_jax():
    """One solver sees ecCKD's 32 solar g-points and then RRTMG_SW's 112:
    the warm cache and the frozen regroup order are keyed by "solar" only,
    so in both packages RRTMG's g-points 0-31 run in ecCKD's frozen order,
    warm from ecCKD's states of the same index, and 32-111 follow cold in
    natural order; the order stays ecCKD's.  Both converge to the same
    fields (reference behaviour, ROADMAP section 3)."""
    js, ts = sc.solvers_3d(sc.jax_lut())
    jatm, lwc = sc.bench_scene(sc.NX, sc.NY)
    tatm = atmosphere_from_arrays(jatm)
    kw = dict(albedo=0.15, lthermal=False, lsolar=True, lwc=lwc, band_chunk=16)
    for backend in ("ecckd", "rrtmg_sw"):
        rj = jspecint(js, jatm, specint=backend, **kw)
        rt = specint_pprts(ts, tatm, specint=backend, **kw)
        sc.check_3d(rj, rt, sc.band_niters(js), sc.band_niters(ts), f"two spectra, {backend}")
    order = ts._band_order["solar"]
    np.testing.assert_array_equal(order, np.asarray(js._band_order["solar"]))
    assert sorted(order.tolist()) == list(range(32))
