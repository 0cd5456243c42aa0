"""The diffuse solvers and preconditioners of the port against the JAX
package on one system (3_10 orbit coefficients, surface albedo).

Tolerances: the solvers iterate in float32 in another summation order
and the port takes its stop decisions on the host in float64, so
iteration counts may differ by a step or two (+-2) and solutions agree to
the solve's own accuracy (rtol 1e-6 residual -> atol 1e-4 on O(1)
fields).  Preconditioner applies are one pass of float32 arithmetic
(complex64 for the coarse solve): atol 2e-5 of the O(1) result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.optprop.facade import _diff_pair_orbits
from tenstream_tpu.pprts import ediff as jediff
from tenstream_tpu.pprts import precond as jprecond
from tenstream_tpu.pprts.operators import OrbitCoeff as JOrbitCoeff
from tenstream_tpu.streams import get_scheme as jget
from tenstream_tpu_torch.pprts import ediff as tediff
from tenstream_tpu_torch.pprts import precond as tprecond
from tenstream_tpu_torch.pprts.operators import OrbitCoeff
from tenstream_tpu_torch.streams import get_scheme as tget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

NZ, NX, NY = 6, 16, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(seed=0):
    idx, norb = _diff_pair_orbits(jget("3_10"), with_mz=False)
    rng = np.random.default_rng(seed)
    orb = (rng.random((norb, NZ, NX, NY)) * 0.09).astype(np.float32)
    b = rng.random((10, NZ + 1, NX, NY)).astype(np.float32)
    alb = (rng.random((NX, NY)) * 0.5).astype(np.float32)
    jc = JOrbitCoeff(jnp.asarray(orb), idx)
    tc = OrbitCoeff(torch.as_tensor(orb), idx)
    return jc, tc, b, alb


@pytest.mark.parametrize("precond", ["none", "line", "two_level"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_bicgstab_matches_jax(precond, warm):
    jc, tc, b, alb = _system()
    x0 = 0.7 * b if warm else None
    xj, nj, rj = jediff.solve_bicgstab(
        jget("3_10"), jc, jnp.asarray(b), jnp.asarray(alb),
        x0=None if x0 is None else jnp.asarray(x0), rtol=1e-6, atol=1e-10, maxiter=200,
        precond=precond)
    xt, nt, rt, syncs = tediff.solve_bicgstab(
        tget("3_10"), tc, torch.as_tensor(b), torch.as_tensor(alb),
        x0=None if x0 is None else torch.as_tensor(x0), rtol=1e-6, atol=1e-10, maxiter=200,
        precond=precond)
    assert abs(nt - int(nj)) <= 2
    assert syncs == nt + 1  # one host sync per iteration plus the setup
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    assert rt <= 1e-6 * np.linalg.norm(b) and float(rj) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("precond", ["none", "two_level"])
def test_richardson_matches_jax(precond):
    jc, tc, b, alb = _system(1)
    xj, nj, _, rj = jediff.solve_richardson(jget("3_10"), jc, jnp.asarray(b), jnp.asarray(alb),
                                            rtol=1e-6, atol=1e-10, max_iter=300, precond=precond)
    xt, nt, _, rt, syncs = tediff.solve_richardson(
        tget("3_10"), tc, torch.as_tensor(b), torch.as_tensor(alb), rtol=1e-6, atol=1e-10,
        max_iter=300, precond=precond)
    assert abs(nt - int(nj)) <= 2 and syncs == nt
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    # both stop at rtol * first residual; the last digits are float32 noise
    np.testing.assert_allclose(rt, float(rj), rtol=1e-2)


def test_richardson_polish_of_converged_iterate():
    """With an absolute tol already met, the polish takes exactly one step."""
    jc, tc, b, alb = _system(2)
    x, _, _, _ = tediff.solve_bicgstab(tget("3_10"), tc, torch.as_tensor(b),
                                       torch.as_tensor(alb), rtol=1e-6, atol=1e-10,
                                       precond="two_level")
    tol = 1e-5 * float(np.linalg.norm(b))
    _, n, _, res, syncs = tediff.solve_richardson(tget("3_10"), tc, torch.as_tensor(b),
                                                  torch.as_tensor(alb), x0=x, tol=tol,
                                                  precond="two_level")
    _, nj, _, _ = jediff.solve_richardson(jget("3_10"), jc, jnp.asarray(b), jnp.asarray(alb),
                                          x0=jnp.asarray(x.numpy()), tol=jnp.asarray(tol),
                                          precond="two_level")
    assert n == int(nj) == 1 and syncs == 1 and res < tol


def test_line_pc_matches_jax_and_unfactored():
    jc, tc, b, alb = _system(3)
    r = np.random.default_rng(4).standard_normal(b.shape).astype(np.float32)
    Mt = tediff.make_line_pc(tget("3_10"), tc, torch.as_tensor(alb))(torch.as_tensor(r))
    Mj = jediff.make_line_pc(jget("3_10"), jc, jnp.asarray(alb))(jnp.asarray(r))
    Vt = tediff.vertical_line_solve(tget("3_10"), tc, torch.as_tensor(r), torch.as_tensor(alb))
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=2e-5)
    np.testing.assert_allclose(Vt.numpy(), Mt.numpy(), atol=2e-5)


@pytest.mark.parametrize("cf", [1, 4])
def test_two_level_pc_matches_jax(cf):
    import jax

    jc, tc, b, alb = _system(5)
    r = np.random.default_rng(6).standard_normal(b.shape).astype(np.float32)
    Mt = tprecond.make_two_level_pc(tget("3_10"), tc, torch.as_tensor(alb), cf=cf)
    Mj = jax.jit(lambda orb, a, rr: jprecond.make_two_level_pc(
        jget("3_10"), JOrbitCoeff(orb, jc.idx), a, cf=cf)(rr))
    np.testing.assert_allclose(Mt(torch.as_tensor(r)).numpy(),
                               np.asarray(Mj(jc.orb, jnp.asarray(alb), jnp.asarray(r))),
                               atol=2e-5 * np.abs(r).max())


@pytest.mark.parametrize("ncx,ncy", [(4, 4), (5, 3), (1, 6)])
def test_hermitian_modes_and_coarse_factor(ncx, ncy):
    for a, b in zip(tprecond._hermitian_modes(ncx, ncy), jprecond._hermitian_modes(ncx, ncy)):
        np.testing.assert_array_equal(a, b)
    assert tprecond.auto_coarse_factor(4 * ncx, 8 * ncy, 4) == \
        jprecond.auto_coarse_factor(4 * ncx, 8 * ncy, 4)
