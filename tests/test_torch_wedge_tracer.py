"""The port's wedge photon tracer (`plexrt/wedge_boxmc.py`) and the key
functions it draws with (`core/prng.py`: `split`, `fold_in` and bounded
`uniform` on scalar and batched keys) against the JAX package.

Gates: the draws bit for bit; `run_wedge_boxmc` under the same keys, for
5_8, 5_5 and 18_8, direct and diffuse, on the canonical triangle and at
one apex, at 2000 photons: every coefficient within 2 photons' weight
(2 / n_photons) + 1e-5 and at least 95% of them within 1e-5 (equal draws:
only float32 rounding can move a photon's path, and rarely flip one of
its branches); a batch of entries, and several sources in one photon
loop, equal to each entry traced alone.  The table grid's tracing and its
checkpoints are held in `test_torch_wedge_tables.py`.  JAX compiles once per static
configuration (scheme, direct, apex, source), vmapped over the entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.plexrt import optprop as jopt
from tenstream_tpu.plexrt import wedge_boxmc as jw
from tenstream_tpu_torch.core import prng
from tenstream_tpu_torch.plexrt import optprop as topt
from tenstream_tpu_torch.plexrt import wedge_boxmc as tw
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

N_PHOTONS = 2000
APEX = (0.5, 0.866)  # a near-equilateral cell
# (tauz, w0, g, aspect, phi, theta): thin, a thick conservative cloud, a
# vertical beam, an absorbing layer
ENTRIES = np.array([(1.5, 0.9, 0.5, 1.0, 30.0, 40.0), (15.0, 0.99999, 0.85, 0.4, 200.0, 75.0),
                    (0.1, 0.5, 0.0, 2.5, 100.0, 0.0), (4.0, 0.0, 0.5, 1.0, 300.0, 40.0)],
                   np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(keys) -> torch.Tensor:
    return torch.as_tensor(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "batched"])
def test_split_fold_in_and_bounded_uniform_bit_for_bit(batched):
    base = jax.random.PRNGKey(712)
    if batched:
        jkeys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(7))
        pkeys = prng.fold_in_keys(prng.Threefry.from_seed(712).words(), torch.arange(7))
        assert torch.equal(pkeys, _words(jkeys))
        js = jax.vmap(lambda k: jax.random.split(k, 5))(jkeys)
        assert torch.equal(prng.split_keys(pkeys, 5), _words(js))
        ctr = torch.arange(300)[None]
        for lo, hi in ((0.0, 1.0), (1e-12, 1.0), (-2.0, 3.0), (0.1, 0.7)):
            ju = jax.vmap(lambda k: jax.random.uniform(k, (300,), minval=lo, maxval=hi))(jkeys)
            pu = prng.uniform_keys(pkeys[:, None, :], ctr, minval=lo, maxval=hi)
            assert np.array_equal(np.asarray(ju), pu.numpy()), (lo, hi)
    else:
        key = prng.Threefry.from_seed(712)
        for n in (2, 3, 5):
            assert [list(k.key) for k in key.split(n)] == np.asarray(
                jax.random.split(base, n)).astype(np.int64).tolist()
        assert key.fold_in(9).key == tuple(np.asarray(jax.random.fold_in(base, 9)).tolist())
        rng = np.random.default_rng(0)
        bounds = [(0.0, 1.0), (1e-12, 1.0), (-2.0, 3.0), (5.0, 1e4)]
        bounds += [tuple(sorted(rng.normal(size=2) * 10)) for _ in range(6)]
        for lo, hi in bounds:
            ju = jax.random.uniform(base, (20000,), minval=lo, maxval=hi)
            pu = key.uniform((20000,), device="cpu", minval=lo, maxval=hi)
            assert np.array_equal(np.asarray(ju), pu.numpy()), (lo, hi)


def _cases():
    for scheme, (ndir, ndiff) in jw.WEDGE_SCHEMES.items():
        nsrc_dir = 15 if scheme == "18_8" else 4
        for ldir in (True, False):
            for apex in (None, APEX):
                # the first source on the canonical shape, the last at the apex
                src = 0 if apex is None else (nsrc_dir if ldir else ndiff) - 1
                yield pytest.param(scheme, ldir, apex, src,
                                   id=f"{scheme}-{'dir' if ldir else 'diff'}-"
                                      f"{'canonical' if apex is None else 'apex'}")


def _jax_trace(scheme, ldir, apex, src, keys):
    fn = jax.jit(jax.vmap(lambda k, t, w, g, a, ph, th: jw.run_wedge_boxmc(
        k, src, ldir, t, w, g, a, ph, th, n_photons=N_PHOTONS, scheme=scheme, apex=apex)))
    T, S = fn(keys, *(jnp.asarray(ENTRIES[:, i]) for i in range(6)))
    return np.asarray(T), np.asarray(S)


def _assert_within_photons(got, want, n):
    d = np.abs(np.concatenate([a.ravel() for a in got]) - np.concatenate([a.ravel() for a in want]))
    assert d.max() <= 2.0 / n + 1e-5, d.max()
    assert (d <= 1e-5).mean() >= 0.95, (d <= 1e-5).mean()


@pytest.mark.parametrize("scheme,ldir,apex,src", list(_cases()))
def test_run_wedge_boxmc_matches_jax(scheme, ldir, apex, src):
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(100 + src), i))(
        jnp.arange(len(ENTRIES)))
    JT, JS = _jax_trace(scheme, ldir, apex, src, jkeys)
    PT, PS = tw.run_wedge_boxmc(_words(jkeys), src, ldir, *ENTRIES.T, n_photons=N_PHOTONS,
                                scheme=scheme, apex=apex, device="cpu")
    assert PT.shape == JT.shape and PS.shape == JS.shape
    _assert_within_photons((PT.numpy(), PS.numpy()), (JT, JS), N_PHOTONS)
    s = PT.sum(-1) + PS.sum(-1)
    assert (s <= 1.0 + 1e-5).all() and (s[ENTRIES[:, 1] > 0.9999] >= 0.999).all()


def test_a_batch_equals_its_entries_traced_alone():
    """Entries, and sources, share one photon loop; each entry's result is
    its own (draws under its own key, its own tallies)."""
    keys = prng.fold_in_keys(prng.Threefry.from_seed(5).words(), torch.arange(len(ENTRIES)))
    t = lambda i: torch.as_tensor(ENTRIES[:, i])
    groups = [tw.WedgeGroup(keys, 1, True, t(0), t(1), t(2), t(3), t(4), t(5)),
              tw.WedgeGroup(keys.flip(0), 3, False, t(0), t(1), t(2), t(3), t(4), t(5))]
    together = tw.trace_wedge(groups, 500, scheme="5_8")
    for (T, S), grp in zip(together, groups):
        for e in range(len(ENTRIES)):
            T1, S1 = tw.run_wedge_boxmc(grp.keys[e], grp.src, grp.ldir, *ENTRIES[e],
                                        n_photons=500, device="cpu")
            assert torch.equal(T[e], T1) and torch.equal(S[e], S1), (grp.src, e)


def test_max_iter_spreads_the_leftover_over_the_diffuse_exits():
    """Walks cut at max_iter keep energy: their weight goes to the diffuse
    exits in proportion, as in JAX (a conservative thick cloud, cut early)."""
    key = jax.random.PRNGKey(3)
    args = (15.0, 0.99999, 0.0, 1.0, 0.0, 0.0)
    JT, JS = jw.run_wedge_boxmc(key, 0, False, *args, n_photons=N_PHOTONS, max_iter=5)
    PT, PS = tw.run_wedge_boxmc(_words(key), 0, False, *args, n_photons=N_PHOTONS, max_iter=5,
                                device="cpu")
    _assert_within_photons((PT.numpy(), PS.numpy()), (np.asarray(JT), np.asarray(JS)), N_PHOTONS)
    assert abs(float(PS.sum()) - 1.0) < 1e-4
