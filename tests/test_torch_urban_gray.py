"""Buildings inside the port's `specint_pprts` with the gray spectrum
against the JAX spectral driver, on `test_torch_urban_specint.py`'s urban
box (its scene, solvers and gates: fluxes 0.1 W/m2, absorption 1e-4 W/m3,
solid cells 1e-4 of their value, face fluxes), in a file of its own so that
another pytest-xdist worker runs its JAX compiles: a solar call, and the
thermal gray call refused with the JAX package's message."""

import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.lut import LUT as JLUT
from tenstream_tpu.spectral.specint import specint_pprts as jspecint
from tenstream_tpu_torch.convert import atmosphere_from_arrays
from tenstream_tpu_torch.spectral import specint_pprts
from test_torch_urban_specint import LUT_PATH, _check, _check_faces, _fluxes, _solvers
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
    return JLUT.load(LUT_PATH)


def test_urban_gray_solar_matches_jax(jlut):
    js, ts, jbld, tbld, jatm, solid = _solvers(jlut)
    rj = jspecint(js, jatm, albedo=0.15, lthermal=False, lsolar=True, specint="gray",
                  band_chunk=8, buildings=jbld)
    rt = specint_pprts(ts, atmosphere_from_arrays(jatm), albedo=0.15, lthermal=False,
                       lsolar=True, specint="gray", band_chunk=8, buildings=tbld)
    _check([np.asarray(a) for a in rj], [a.numpy() for a in rt], solid, "gray solar")
    _check_faces(_fluxes(jbld.fluxes, np.asarray), _fluxes(tbld.fluxes, lambda t: t.numpy()),
                 "gray solar")


def test_urban_gray_thermal_raises_as_jax(jlut):
    js, ts, jbld, tbld, jatm, _ = _solvers(jlut)
    with pytest.raises(NotImplementedError, match="planck_at") as ej:
        jspecint(js, jatm, albedo=0.15, lthermal=True, lsolar=False, specint="gray",
                 buildings=jbld)
    with pytest.raises(NotImplementedError, match="planck_at") as et:
        specint_pprts(ts, atmosphere_from_arrays(jatm), albedo=0.15, lthermal=True,
                      lsolar=False, specint="gray", buildings=tbld)
    assert str(ej.value) == str(et.value)
