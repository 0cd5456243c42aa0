"""`solve_edir` of the port against the JAX direct-beam solver on the same
coefficient field, across the four sun octants and the inner-pass
policies; and the port's log-depth affine scan against a sequential loop.
The JAX scan reference runs compiled (`jax.jit`), as the JAX solver runs it.

Tolerance: both solve the same recurrences in float32 in another order
(the port's Hillis-Steele scan against `lax.associative_scan`), so the
fields agree to rtol 1e-5 of the field maximum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.pprts import edir as jedir
from tenstream_tpu.streams import get_scheme as jget
from tenstream_tpu_torch.pprts import edir as tedir
from tenstream_tpu_torch.streams import get_scheme as tget
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread runs them as fast as many
    and does not oversubscribe the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dir2dir(nd, nz, nx, ny, seed):
    """Random [src, dst] blocks whose rows transmit at most 95%."""
    rng = np.random.default_rng(seed)
    c = rng.random((nd, nd, nz, nx, ny)).astype(np.float32)
    c /= c.sum(axis=1, keepdims=True)
    return (c * rng.uniform(0.5, 0.95, (nd, 1, nz, nx, ny))).astype(np.float32)


@pytest.mark.parametrize("xinc,yinc,policy", [
    (1, 1, (4, True, True)), (0, 1, (7, True, True)), (1, 0, (8, False, True)),
    (0, 0, (4, True, True))], ids=["+x+y-4aitken", "-x+y-7aitken", "+x-y-plain8", "-x-y-4aitken"])
def test_solve_edir_matches_jax(xinc, yinc, policy):
    n_inner, aitken, cleanup = policy
    nz, nx, ny = 4, 6, 5
    c = _dir2dir(3, nz, nx, ny, seed=xinc + 2 * yinc)
    inc = np.random.default_rng(9).uniform(5e5, 1e6, (1, nx, ny)).astype(np.float32)
    j = jedir.solve_edir(jget("3_10"), jnp.asarray(c), jnp.asarray(inc), xinc, yinc,
                         n_inner=n_inner, aitken=aitken, cleanup=cleanup)
    t = tedir.solve_edir(tget("3_10"), torch.as_tensor(c), torch.as_tensor(inc), xinc, yinc,
                         n_inner=n_inner, aitken=aitken, cleanup=cleanup)
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("theta", [10.0, 55.0, 80.0])
def test_inner_iter_policy(theta):
    assert tedir.inner_iter_policy(theta) == jedir.inner_iter_policy(theta)


@pytest.mark.parametrize("ds,n", [(1, 7), (2, 16), (2, 5)])
def test_affine_scan_and_cyclic_closure(ds, n):
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.uniform(0, 0.6, (ds, ds, n, 3)).astype(np.float32))
    B = torch.as_tensor(rng.random((ds, n, 3)).astype(np.float32))
    X = tedir.cyclic_affine_solve(A, B, axis=0)
    # the periodic recurrence X[i+1] = A[i] X[i] + B[i] holds at every i
    for i in range(n):
        nxt = torch.einsum("ab...,b...->a...", A[:, :, i], X[:, i]) + B[:, i]
        np.testing.assert_allclose(X[:, (i + 1) % n].numpy(), nxt.numpy(), rtol=2e-5, atol=1e-6)
    jX = jax.jit(jedir._cyclic_affine_solve, static_argnums=2)(
        jnp.asarray(A.numpy()), jnp.asarray(B.numpy()), 0)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=2e-5, atol=1e-6)
