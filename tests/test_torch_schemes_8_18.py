"""The 8_18 cube scheme in the port against the JAX package, through
`PprtsSolver` on the CPU: the two solar solves.  `tests/torch_scheme_parity.py` has the
scene and the gates (fluxes 0.1 W/m2, absorption 1e-4 W/m3, niter within 2,
the JAX end-to-end energy balance within 6%).  On the card these schemes run
through K1/K2/K3 instantiations built for their tables
(`tests/test_torch_cuda.py`, `chip_smoke.py` phases 21-24).  The JAX
reference compiles one program per case (10-30 s each), so each of the
larger schemes' four tests sit two to a file (`test_torch_schemes_8_18.py` and `test_torch_schemes_8_18_thermal.py`), for two pytest-xdist
workers."""

import pytest
import torch

import torch_scheme_parity as parity

SCHEMES = ["8_18"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_solvers():
    return parity.JaxSolvers()


@pytest.mark.parametrize("case", parity.E2E_ORDER[:2])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_8x_solve_matches_jax(jax_solvers, scheme, case):
    parity.check_solve_matches_jax(jax_solvers, scheme, case)
