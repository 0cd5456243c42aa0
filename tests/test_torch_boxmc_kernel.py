"""K4's plain PyTorch version (`boxmc/cuda_tracer.py::boxmc_trace_plain`)
against the JAX package's Pallas photon tracer, run in interpret mode on
the CPU as `tests/test_pallas_tracer.py` runs it.

Both trace the same photons: the counter hash is bit-exact, and each
photon's walk draws from (lane, seed and launch row, step, salt) only.
What remains is float32 roundoff of the transcendentals (XLA's and
torch's log/exp/sin/cos differ by ulps) and the exited photons that the
lockstep TPU kernel keeps "moving" by ~0 (ulps of their weights), so
every tally is held at 1e-5.  No case here needs more: no photon's walk
flips a comparison.  The plain version sums its photons' records in K4's
order (`reduce_records`), held here against a float64 sum within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tenstream_tpu.boxmc import pallas_tracer as jpt
from tenstream_tpu_torch.boxmc import cuda_tracer as ct
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

ATOL = 1e-5

# tauz, w0, aspect, g, phi, theta
ENTRIES = np.array([
    [1e-10, 0.5, 1.0, 0.0, 0.0, 0.0],  # transparent
    [2.0, 0.0, 1.0, 0.0, 30.0, 40.0],  # purely absorbing
    [1.0, 0.9, 1.0, 0.0, 30.0, 40.0],  # isotropic scattering
    [1.0, 0.9, 1.0, 0.85, 30.0, 40.0],  # forward scattering
    [20.0, 0.99999, 1.0, 0.85, 30.0, 40.0],  # thick, conservative
    [0.5, 0.9, 0.02, 0.5, 10.0, 85.0],  # flat box, sun at 85 degrees
    [0.5, 0.9, 7.45, 0.0, 60.0, 20.0],  # tall box
    [3.0, 0.7, 0.5, 0.3, 75.0, 55.0],
], np.float32)
MAX_ITER = 400


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain tracers issue thousands of small ops: one intra-op thread
    runs them as fast as many, and does not oversubscribe the CPU when
    test files run in parallel (where many threads made them 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = ([("3_10", s, True, 3) for s in range(3)] + [("3_10", 1, True, 41)]
         + [("3_10", s, False, 3) for s in range(10)] + [("3_10", 2, False, 41)]
         + [("3_6", s, False, 3) for s in range(6)] + [("1_2", s, False, 3) for s in range(2)]
         + [("8_10", s, False, 3) for s in (0, 3, 6, 9)])


_JAX_HASH = jax.jit(jpt._hash_uniform)


def _jax_kernel(scheme, src, ldir, seed):
    with pltpu.force_tpu_interpret_mode():
        T, S = jpt.run_boxmc_pallas(jnp.asarray(ENTRIES), scheme, src, ldir, max_iter=MAX_ITER,
                                    seed=seed)
    return np.asarray(T), np.asarray(S)


@pytest.mark.parametrize("scheme,src,ldir,seed", CASES)
def test_plain_matches_jax_kernel(scheme, src, ldir, seed):
    Tj, Sj = _jax_kernel(scheme, src, ldir, seed)
    T, S = ct.run_boxmc_cuda(ENTRIES, scheme, src, ldir, max_iter=MAX_ITER, seed=seed,
                             device="cpu")
    np.testing.assert_allclose(T.numpy(), Tj, atol=ATOL)
    np.testing.assert_allclose(S.numpy(), Sj, atol=ATOL)
    out, steps = ct.boxmc_trace(ct.entry_rows(ENTRIES, scheme, src, ldir, seed, "cpu"), scheme,
                                ldir, MAX_ITER)
    assert torch.equal(out, torch.cat([T, S], 1))
    # transparent and purely absorbing boxes: every photon exits in one step
    assert steps[:2].tolist() == [ct.PHOTONS, ct.PHOTONS]
    assert (steps[2:] > ct.PHOTONS).all()
    assert (T.sum(1) + S.sum(1)).max().item() <= 1.0 + 1e-5


@pytest.mark.parametrize("base", [1, 0x2C9277B5, -5, 2 ** 31 - 1, -2 ** 31 + 1,
                                  ct._i32(747796405 * 4194303 + 4095) | 1])
def test_hash_bit_exact(base):
    lane = np.arange(ct.PHOTONS, dtype=np.int32)
    for ctr in (0, 1, 2, 17, 999, 3000):
        for salt in range(4):
            want = np.asarray(_JAX_HASH(jnp.asarray(lane), jnp.int32(base), jnp.int32(ctr),
                                        jnp.int32(salt)))
            got = ct.hash_uniform(torch.from_numpy(lane), torch.tensor(base, dtype=torch.int32),
                                  ctr, salt).numpy()
            np.testing.assert_array_equal(got, want)


def test_plain_batching_changes_no_row():
    """A row's tallies depend on its launch row and seed, not on the rows
    beside it (the lockstep loop runs to the longest walk of the batch)."""
    rows = ct.entry_rows(ENTRIES, "3_10", 0, False, 9, "cpu")
    full, steps = ct.boxmc_trace_plain(rows, "3_10", False, MAX_ITER)
    thin = rows.clone()
    thin[1:, :] = rows[0]  # every other row transparent: walks of one step
    thin[1:, 6] = rows[1:, 6]
    part, psteps = ct.boxmc_trace_plain(thin, "3_10", False, MAX_ITER)
    assert torch.equal(full[0], part[0]) and steps[0] == psteps[0]
    lone, _ = ct.boxmc_trace_plain(rows[:1], "3_10", False, MAX_ITER)
    assert torch.equal(full[0], lone[0])


def test_entry_rows_as_the_tpu_kernel_builds_them():
    rows = ct.entry_rows(ENTRIES[:, :4], "3_10", 7, False, 2 ** 22 + 5, "cpu").numpy()
    assert rows.shape == (8, 9)
    np.testing.assert_array_equal(rows[:, :4], ENTRIES[:, :4])
    assert (rows[:, 4:6] == 0).all()
    assert (rows[:, 6] == (5 + 977 * 7) % 2 ** 22).all()
    assert (rows[:, 7] == 4).all() and (rows[:, 8] == -1).all()  # YMIN, down hemisphere
    rows = ct.entry_rows(ENTRIES, "3_10", 2, True, 0, "cpu").numpy()
    assert (rows[:, 7] == 4).all() and (rows[:, 8] == 0).all()  # YMIN direct source
    with pytest.raises(ValueError, match="launch size"):
        ct.run_boxmc_cuda(np.zeros((ct.MAX_BATCH + 1, 6), np.float32), "3_10", 0, True,
                          device="cpu")


@pytest.mark.parametrize("scheme,ldir", [("3_16", False), ("3_16", True), ("8_16", False),
                                         ("8_10", True), ("3_24", False), ("3_30", True),
                                         ("8_18", False), ("8_12", False)])
def test_refuses_what_it_cannot_represent(scheme, ldir):
    assert ct.kernel_refusal(scheme, ldir)
    with pytest.raises(ValueError, match="K4 cannot trace"):
        ct.run_boxmc_cuda(ENTRIES, scheme, 0, ldir, device="cpu")
    rows = torch.zeros((1, ct.NPARAM))
    with pytest.raises(ValueError, match="K4 cannot trace"):
        ct.boxmc_trace(rows, scheme, ldir)


@pytest.mark.parametrize("scheme,ldir", [("1_2", True), ("3_6", True), ("3_10", True),
                                         ("3_10", False), ("8_10", False)])
def test_supports_the_full_face_schemes(scheme, ldir):
    assert ct.kernel_refusal(scheme, ldir) is None


@pytest.mark.parametrize("ndir,ndiff", [(3, 10), (1, 2), (8, 10)])
def test_ordered_reduction_matches_float64_sum(ndir, ndiff):
    """`reduce_records` (K4's order of float32 adds) against a float64 sum of
    the same per-photon records, with codes tallied nowhere (-1) and photons
    still walking at max_iter among them."""
    rng = np.random.default_rng(ndir + ndiff)
    B, N, nc = 5, ct.PHOTONS, ndir + ndiff
    code = rng.integers(-1, nc, (B, N))
    w = rng.random((B, N)).astype(np.float32)
    walking = rng.random((B, N)) < 0.05
    code[walking] = -1
    left = np.where(walking, w, 0.0).astype(np.float32)
    w = np.where(walking, 0.0, w).astype(np.float32)
    out = ct.reduce_records(torch.as_tensor(code), torch.as_tensor(w), torch.as_tensor(left),
                            ndir, nc).numpy()
    tally = np.stack([np.where(code == c, w.astype(np.float64), 0.0).sum(1) for c in range(nc)], 1)
    mass = tally[:, ndir:].sum(1)
    scale = 1.0 + left.astype(np.float64).sum(1) / mass
    want = np.concatenate([tally[:, :ndir], tally[:, ndir:] * scale[:, None]], 1) / N
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    assert out.dtype == np.float32


def test_plain_reduces_its_records_in_kernel_order():
    """The plain version's tallies are `reduce_records` of its photons'
    records, and those agree with a float64 sum of the same records."""
    rows = ct.entry_rows(ENTRIES[2:6], "3_10", 1, True, 4, "cpu")
    out, steps = ct.boxmc_trace_plain(rows, "3_10", True, MAX_ITER)
    code, w, left, nstep = ct.photon_records_plain(rows, "3_10", True, MAX_ITER)
    assert torch.equal(out, ct.reduce_records(code, w, left, 3, 13))
    assert torch.equal(steps, nstep.sum(1))
    c, wd, ld = code.numpy(), w.double().numpy(), left.double().numpy()
    tally = np.stack([np.where(c == k, wd, 0.0).sum(1) for k in range(13)], 1)
    scale = 1.0 + ld.sum(1) / tally[:, 3:].sum(1)
    want = np.concatenate([tally[:, :3], tally[:, 3:] * scale[:, None]], 1) / ct.PHOTONS
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)


def test_launch_order_takes_long_walks_first():
    """K4's queue order: a permutation of the rows, thick conservative boxes
    before thin or absorbing ones (it changes no result, only the schedule)."""
    rows = ct.entry_rows(ENTRIES, "3_10", 0, False, 0, "cpu")
    order = ct.launch_order(rows)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(len(ENTRIES)))
    assert order[0].item() == 4  # tau 20, w0 0.99999
    assert order.tolist().index(0) > order.tolist().index(3)  # transparent after forward-scattering
    assert order.tolist().index(1) > order.tolist().index(7)  # w0 0: one step
