"""`specint_pprts` with the repwvl (solar and thermal) backend on a 3_10 solver against the
JAX spectral driver, on bench.py's scene at 4x4 columns
(`torch_specint_3_10.py` has the scene, the solvers and the gates: fluxes
0.1 W/m2, absorption 1e-4 W/m3, per-band niter within 2)."""

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


@pytest.mark.parametrize("backend,lthermal,chunk", [("repwvl", True, 15)])
def test_specint_3_10_gas_optics_match_jax(backend, lthermal, chunk):
    js, ts = sc.solvers_3d(sc.jax_lut())
    jatm, lwc = sc.bench_scene(sc.NX, sc.NY)
    kw = dict(albedo=0.15, lthermal=lthermal, lsolar=True, specint=backend, lwc=lwc,
              band_chunk=chunk)
    rj = jspecint(js, jatm, **kw)
    rt = specint_pprts(ts, atmosphere_from_arrays(jatm), **kw)
    sc.check_3d(rj, rt, sc.band_niters(js), sc.band_niters(ts), backend)
    assert ts.nz_solve == jatm.nlay - (sc.K_COLLAPSE - 1)
