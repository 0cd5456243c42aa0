"""The port's ANN coefficient backend (`optprop/ann.py`) against the JAX
package's.

Gates:
- the port's `normal` within 1e-6 of `jax.random.normal`, the init of
  `_mlp_init` within 1e-6 of JAX's, and `jax.random.permutation` (one and
  two sort rounds) equal;
- training: 20 full-batch epochs of `_fit` from JAX's init on
  `opp_small`'s tables, and 3 shuffled minibatch epochs with cosine decay,
  against JAX's `_train` from the same key: losses within 1e-4 relative,
  params within 1e-4; a net the port trains (600 epochs, the settings of
  `tests/test_ann.py`'s fixture) below that test's bar, mean |err| < 0.02
  against the LUT facade;
- the committed production net in both packages on
  `test_production_ann_committed`'s 512 draws: diff2diff and dir2diff
  within 1e-5, dir2dir within 2e-5 (the closed forms of the two packages
  differ by up to 1.9e-5), and against the port's LUT facade the JAX test's
  bars; the sun-octant permutations at 1e-6; a port `save` read by JAX's
  `load` and the reverse give the same outputs;
- `test_solver_runs_with_ann`'s 5 x 6 x 6 solve on the port against JAX's,
  the same net in both (`convert.ann_from_arrays`): fluxes within 0.1
  W/m2, absorption within 1e-4 W/m3 (`tests/test_torch_solver.py`'s)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenstream_tpu.optprop import ann as jann
from tenstream_tpu.pprts.grid import Grid as JGrid
from tenstream_tpu.pprts.solver import PprtsSolver as JSolver
from tenstream_tpu.pprts.sun import sundir_from_angles
from tenstream_tpu_torch.convert import ann_from_arrays, lut_from_arrays
from tenstream_tpu_torch.core import prng
from tenstream_tpu_torch.optprop import ann as pann
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.optprop.lut import LUT
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.solver import PprtsSolver
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ANN_PATH = os.path.join(REPO, "data", "ann", "ANN_3_10_production.npz")
LUT_PATH = os.path.join(REPO, "data", "luts", "LUT_3_10_production.npz")
FLUX_ATOL = 0.1
ABSO_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close_params(got, want, atol):
    assert len(got) == len(want)
    for (w, b), (jw, jb) in zip(got, want):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=atol)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=atol)


def test_normal_and_init_match_jax():
    for seed, shape in ((0, (1000, 77)), (11, (300_000,)), (5, (4, 128))):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.Threefry.from_seed(seed).normal(shape, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sizes = (6, 128, 128, 39)
    want = jann._mlp_init(jax.random.PRNGKey(4), sizes)
    _close_params(pann._mlp_init(prng.Threefry.from_seed(4), sizes, "cpu"), want, 1e-6)


@pytest.mark.parametrize("n", [1440, 5000], ids=["one-round", "two-rounds"])
def test_permutation_matches_jax(n):
    for seed in (0, 9):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.permutation(key, n))
        got = pann._permutation(prng.Threefry.from_seed(seed), n, "cpu").numpy()
        assert np.array_equal(got, want)


def _table_xy(lut, direct):
    """The training rows of a JAX LUT, features from JAX's `_features`."""
    s = jann.get_scheme(lut.scheme)
    nd, nf = s.ndir, s.ndiff
    ax = lut.dir_axes if direct else lut.diff_axes
    axes = [ax.tau, ax.w0, ax.aspect, ax.g] + ([ax.phi, ax.theta] if direct else [])
    grids = np.meshgrid(*axes, indexing="ij")
    X = np.asarray(jann._features(*[jnp.asarray(g.ravel(), jnp.float32) for g in grids]))
    if direct:
        Y = np.concatenate([np.asarray(lut.dir2dir).reshape(-1, nd * nd),
                            np.asarray(lut.dir2diff).reshape(-1, nd * nf)], axis=-1)
    else:
        Y = np.asarray(lut.diff2diff).reshape(-1, nf * nf)
    return X, Y.astype(np.float32)


@pytest.mark.parametrize("case", ["full-batch-dir", "full-batch-diff", "minibatch-dir"])
def test_training_matches_jax(opp_small, case):
    direct = case.endswith("dir")
    X, Y = _table_xy(opp_small.lut, direct)
    epochs, batch = (20, None) if case.startswith("full") else (3, 256)
    hidden = (64, 64)
    key = jax.random.PRNGKey(2)
    jparams, jloss = jann._train(key, jnp.asarray(X), jnp.asarray(Y), hidden, epochs, batch=batch)
    _, kinit = jax.random.split(key)
    init = jann._mlp_init(kinit, [X.shape[-1], *hidden, Y.shape[-1]])
    pkey = prng.Threefry.from_seed(2).split()[0]
    params, loss = pann._fit([(_t(w), _t(b)) for w, b in init], _t(X), _t(Y), epochs,
                             batch=batch, key=pkey)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss), (loss, jloss)
    _close_params(params, jparams, 1e-4)


@pytest.fixture(scope="module")
def port_trained(opp_small):
    """tests/test_ann.py's fixture, trained by the port."""
    return pann.AnnOptProp(lut_from_arrays(opp_small.lut, "cpu"), epochs=600, seed=1,
                           device="cpu")


def test_port_trained_net_matches_lut(port_trained, opp_small):
    rng = np.random.default_rng(0)
    n = 200
    tau = 10 ** rng.uniform(-4, 1, n).astype(np.float32)
    w0 = rng.uniform(0, 0.99, n).astype(np.float32)
    g = rng.uniform(0, 0.5, n).astype(np.float32)
    asp = rng.uniform(0.15, 1.8, n).astype(np.float32)
    opp = OptProp(lut_from_arrays(opp_small.lut, "cpu"), device="cpu")
    args = [_t(a) for a in (tau, w0, g, asp)]
    err = (opp.diff_coeffs(*args) - port_trained.diff_coeffs(*args)).abs().mean()
    assert float(err) < 0.02, float(err)
    assert np.isfinite(port_trained.dir_loss) and np.isfinite(port_trained.diff_loss)


def _draws(fa, n=512):
    """test_production_ann_committed's draws."""
    rng = np.random.default_rng(11)
    tau = np.exp(rng.uniform(np.log(fa.tau[0] + 1e-12), np.log(fa.tau[-1]), n)).astype(np.float32)
    w0 = rng.uniform(fa.w0[0], fa.w0[-1], n).astype(np.float32)
    asp = np.exp(rng.uniform(np.log(fa.aspect[0]), np.log(fa.aspect[-1]), n)).astype(np.float32)
    g = rng.uniform(fa.g[0], fa.g[-1], n).astype(np.float32)
    return tau, w0, g, asp


@pytest.fixture(scope="module")
def production():
    lut = LUT.load(LUT_PATH, device="cpu")
    return (jann.AnnOptProp.load(ANN_PATH), pann.AnnOptProp.load(ANN_PATH, device="cpu"),
            OptProp(lut, device="cpu"), _draws(lut.diff_axes))


def test_production_net_matches_jax_and_lut(production):
    jnet, net, opp, draws = production
    args = [_t(a) for a in draws]
    c = net.diff_coeffs(*args)
    np.testing.assert_allclose(c.numpy(), np.asarray(jnet.diff_coeffs(*draws)), rtol=0,
                               atol=1e-5)
    dd, df = net.dir_coeffs(*args, 25.0, 45.0)
    jdd, jdf = map(np.asarray, jnet.dir_coeffs(*draws, 25.0, 45.0))
    np.testing.assert_allclose(df.numpy(), jdf, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dd.numpy(), jdd, rtol=0, atol=2e-5)
    # the JAX test's bars, against the port's LUT facade
    assert float((opp.diff_coeffs(*args) - c).abs().mean()) < 0.01
    t_lut, s_lut = opp.dir_coeffs(*args, 25.0, 45.0)
    np.testing.assert_allclose(dd.numpy(), t_lut.numpy(), rtol=0, atol=1e-5)
    assert float((s_lut - df).abs().mean()) < 0.01


def test_octant_perms_match_facade(production):
    """tests/test_ann.py::test_ann_octant_perms_match_facade on the port."""
    _, net, opp, _ = production
    n = 32
    rng = np.random.default_rng(3)
    tau = 10 ** rng.uniform(-3, 0.5, n).astype(np.float32)
    w0 = rng.uniform(0, 0.9, n).astype(np.float32)
    g = rng.uniform(0, 0.5, n).astype(np.float32)
    asp = rng.uniform(0.2, 1.5, n).astype(np.float32)
    args = [_t(a) for a in (tau, w0, g, asp)]
    dd0, df0 = (a.numpy() for a in net.dir_coeffs(*args, 30.0, 40.0))
    for sx, sy in ((True, False), (False, True), (True, True)):
        dd, df = (a.numpy() for a in net.dir_coeffs(*args, 30.0, 40.0, switch_x=sx,
                                                     switch_y=sy))
        q = np.asarray(net.scheme.diff_switch_perm(sx, sy))
        p = np.asarray(net.scheme.dir_switch_perm(sx, sy))
        np.testing.assert_allclose(dd, dd0[p][:, p], atol=1e-6)
        np.testing.assert_allclose(df, df0[p][:, q], atol=1e-6)
    dd_lut, _ = opp.dir_coeffs(*args, 30.0, 40.0, switch_x=True)
    dd_ann, _ = net.dir_coeffs(*args, 30.0, 40.0, switch_x=True)
    np.testing.assert_allclose(dd_ann.numpy(), dd_lut.numpy(), atol=5e-3)


def test_save_load_across_packages(production, port_trained, tmp_path):
    jnet, _, _, draws = production
    args = [_t(a) for a in draws]
    # a port-trained net read by JAX
    path = str(tmp_path / "port.npz")
    port_trained.save(path)
    back = jann.AnnOptProp.load(path)
    np.testing.assert_allclose(np.asarray(back.diff_coeffs(*draws)),
                               port_trained.diff_coeffs(*args).numpy(), rtol=0, atol=1e-5)
    _, jdf = back.dir_coeffs(*draws, 25.0, 45.0)
    _, df = port_trained.dir_coeffs(*args, 25.0, 45.0)
    np.testing.assert_allclose(np.asarray(jdf), df.numpy(), rtol=0, atol=1e-5)
    assert back.dir_loss == port_trained.dir_loss and back.diff_loss == port_trained.diff_loss
    # a JAX-written net read by the port
    path = str(tmp_path / "jax.npz")
    jnet.save(path)
    net = pann.AnnOptProp.load(path, device="cpu")
    np.testing.assert_allclose(net.diff_coeffs(*args).numpy(),
                               np.asarray(jnet.diff_coeffs(*draws)), rtol=0, atol=1e-5)
    assert net.scheme.name == jnet.scheme.name and net.dir_loss == jnet.dir_loss


def test_ann_solve_matches_jax(production):
    jnet = production[0]
    nz, nx, ny = 5, 6, 6
    ka = np.full((nz, nx, ny), 2e-4, np.float32)
    ks = np.full((nz, nx, ny), 1e-3, np.float32)
    g = np.full((nz, nx, ny), 0.4, np.float32)
    sun = sundir_from_angles(20.0, 30.0)
    out = {}
    for name, solver in (
            ("jax", JSolver(JGrid.create(nz, nx, ny, 100.0, 100.0, 100.0), jnet)),
            ("port", PprtsSolver(Grid.create(nz, nx, ny, 100.0, 100.0, 100.0, device="cpu"),
                                 ann_from_arrays(jnet, "cpu")))):
        solver.set_optical_properties(0.2, ka, ks, g)
        solver.set_angles(sun)
        solver.solve(lthermal=False, lsolar=True, edirTOA=1000.0)
        out[name] = [np.asarray(a) for a in solver.get_result()]
    for k, (a, b) in enumerate(zip(out["port"], out["jax"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=ABSO_ATOL if k == 3 else FLUX_ATOL)
    edir = out["port"][0]
    assert np.isfinite(out["port"][3]).all() and edir[0].mean() > edir[-1].mean() > 0


def test_train_ann_tool_writes_a_net_jax_reads(opp_small, tmp_path):
    """`python -m tenstream_tpu_torch.tools.train_ann` on the CPU: a short run on
    `opp_small`'s table writes a net the JAX package loads and evaluates alike."""
    from tenstream_tpu_torch.tools import train_ann

    lut_path, out = str(tmp_path / "lut.npz"), str(tmp_path / "ann" / "net.npz")
    lut_from_arrays(opp_small.lut, "cpu").save(lut_path)
    train_ann.main(["--lut", lut_path, "--out", out, "--hidden", "16,16", "--epochs", "3",
                    "--batch", "256", "--device", "cpu"])
    net, jnet = pann.AnnOptProp.load(out, device="cpu"), jann.AnnOptProp.load(out)
    assert [w.shape[1] for w, _ in net._dir_params] == [16, 16, 39]
    draws = _draws(opp_small.lut.diff_axes, 64)
    np.testing.assert_allclose(net.diff_coeffs(*[_t(a) for a in draws]).numpy(),
                               np.asarray(jnet.diff_coeffs(*draws)), rtol=0, atol=1e-5)
