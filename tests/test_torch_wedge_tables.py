"""Wedge table creation in the port (`plexrt/optprop.py::create_wedge_lut`,
`_trace_jobs`) against the JAX package, on a grid of two values per axis
(three phi) at 400 photons.

Gates: at one apex, the table within 2 / n_photons + 1e-5 of JAX's under
the same seed, at least 95% of the coefficients within 1e-5.  On the
canonical shape, JAX's `create_wedge_lut` run on the port's traces of its
sources (its `_trace_grid` replaced) gives the port's table bit for bit:
the downwind sanitizing, the mirror symmetrization and the periodic phi
are JAX's; the traces themselves are held to JAX's at the canonical shape
in `test_torch_wedge_tracer.py` (JAX compiles one program per source and
shape, so the canonical table is not traced by JAX twice).  Checkpoints in
JAX's layout resume across a cut and across the two packages at the apex,
on the programs the apex table compiled."""

import numpy as np
import pytest
import torch

from tenstream_tpu.plexrt import optprop as jopt
from tenstream_tpu_torch.plexrt import optprop as topt
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

N_PHOTONS = 400
APEX = (0.5, 0.866)


def axes(mod):
    """Two values per axis, three phi (`chip_smoke.py` phase 28 (a))."""
    f = lambda *v: np.array(v, np.float32)
    return mod.WedgeAxes(f(0.5, 4.0), f(0.5, 0.99), f(0.5, 1.0), f(0.0, 0.85),
                         np.linspace(0.0, 360.0, 3).astype(np.float32), f(20.0, 60.0))


def diffuse_axes(mod, a):
    return mod.WedgeAxes(a.tau, a.w0, a.aspect, a.g)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_within_photons(got, want, n):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).ravel()
    assert d.max() <= 2.0 / n + 1e-5, d.max()
    assert (d <= 1e-5).mean() >= 0.95, (d <= 1e-5).mean()


def _port_trace_grid(axes, src, ldir, n_photons, seed, scheme="5_8", apex=None, max_iter=3000,
                     **_):
    """JAX's `_trace_grid` interface on the port's tracer."""
    ta = topt.WedgeAxes(*(None if v is None else np.asarray(v) for v in (
        axes.tau, axes.w0, axes.aspect, axes.g, axes.phi, axes.theta)))
    (T, S), = topt._trace_jobs([(ta, src, ldir, seed)], n_photons, scheme, apex=apex,
                               max_iter=max_iter, device="cpu")
    grids = [ta.tau, ta.w0, ta.aspect, ta.g] + ([ta.phi, ta.theta] if ldir else [])
    shp = tuple(len(g) for g in grids)
    return T.reshape(shp + (T.shape[-1],)), S.reshape(shp + (S.shape[-1],))


@pytest.mark.parametrize("apex", [None, APEX], ids=["canonical", "apex"])
def test_create_wedge_lut_matches_jax(apex, monkeypatch):
    ja, ta = axes(jopt), axes(topt)
    P = topt.create_wedge_lut(ta, diffuse_axes(topt, ta), N_PHOTONS, seed=3, apex=apex,
                              device="cpu")
    if apex is None:
        monkeypatch.setattr(jopt, "_trace_grid", _port_trace_grid)
    J = jopt.create_wedge_lut(ja, diffuse_axes(jopt, ja), N_PHOTONS, seed=3, apex=apex)
    for k in ("dir2dir", "dir2diff", "diff2diff"):
        assert getattr(P, k).shape == np.asarray(getattr(J, k)).shape, k
        if apex is None:
            np.testing.assert_array_equal(getattr(P, k).numpy(), getattr(J, k), err_msg=k)
        else:
            _assert_within_photons(getattr(P, k).numpy(), getattr(J, k), N_PHOTONS)
    assert P.apex == J.apex and P.scheme == J.scheme
    f2f = P.diff2diff.numpy()
    if apex is None:  # the mirror about the axis through B is exact
        perm = [0, 3, 4, 1, 2, 5, 6, 7]
        np.testing.assert_array_equal(f2f, f2f[..., perm, :][..., :, perm])
    d = P.dir2dir.numpy()
    np.testing.assert_array_equal(d[..., -1, :, :, :], d[..., 0, :, :, :])  # periodic phi


def test_trace_jobs_resume_from_checkpoints_of_either_package(tmp_path, monkeypatch):
    """Checkpoints in JAX's layout (`dir_<src>.npz` / `diff_<src>.npz`: T, S,
    done_lo), several sources in one loop, at the apex.  A run cut after
    three chunks resumes to the same tables as one that was not cut; a JAX
    checkpoint of a source's first rows is kept bit for bit and the port
    traces the rest; JAX resumes a port checkpoint the same way."""
    ja, ta = axes(jopt), axes(topt)
    fa = diffuse_axes(topt, ta)
    jobs = [(ta, 1, True, 11), (ta, 3, True, 13), (fa, 2, False, 102)]
    trace = lambda ckpt: topt._trace_jobs(jobs, N_PHOTONS, chunk=25, apex=APEX, ckpt_dir=ckpt,
                                          device="cpu")
    whole = trace(None)

    # JAX traced source 1's first k rows before it was cut
    jdir = tmp_path / "jax"
    jdir.mkdir()
    JT, JS = (a.reshape(-1, a.shape[-1]) for a in
              jopt._trace_grid(ja, 1, True, N_PHOTONS, 11, apex=APEX,
                                ckpt_path=str(jdir / "dir_1.npz")))
    k = 40
    pdir = tmp_path / "port"
    pdir.mkdir()
    np.savez(pdir / "dir_1.npz", T=JT[:k], S=JS[:k], done_lo=k)

    # the port's run is cut after three chunks, with a checkpoint after every chunk
    monkeypatch.setattr(topt, "_CKPT_EVERY", 1)
    calls = []
    real = topt.trace_wedge

    def cut(*a, **kw):
        if len(calls) == 3:
            raise KeyboardInterrupt
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(topt, "trace_wedge", cut)
    with pytest.raises(KeyboardInterrupt):
        trace(str(pdir))
    z = np.load(pdir / "dir_3.npz")
    cut_at = int(z["done_lo"])
    assert 0 < cut_at < len(whole[1][0])  # source 3 was cut part way
    partial = {f: dict(np.load(pdir / f)) for f in ("dir_1.npz", "dir_3.npz")}
    monkeypatch.setattr(topt, "trace_wedge", real)
    resumed = trace(str(pdir))

    (PT, PS), rest = resumed[0], resumed[1:]
    np.testing.assert_array_equal(PT[:k], JT[:k])
    np.testing.assert_array_equal(PS[:k], JS[:k])
    np.testing.assert_array_equal(PT[k:], whole[0][0][k:])
    np.testing.assert_array_equal(PS[k:], whole[0][1][k:])
    _assert_within_photons(np.concatenate([PT.ravel(), PS.ravel()]),
                           np.concatenate([JT.ravel(), JS.ravel()]), N_PHOTONS)
    for (T, S), (T0, S0) in zip(rest, whole[1:]):
        np.testing.assert_array_equal(T, T0)
        np.testing.assert_array_equal(S, S0)
    for (T, S), (_, src, ldir, _) in zip(resumed, jobs):
        z = np.load(pdir / f"{'dir' if ldir else 'diff'}_{src}.npz")
        assert int(z["done_lo"]) == len(T)
        np.testing.assert_array_equal(z["T"], T)
        np.testing.assert_array_equal(z["S"], S)

    # JAX resumes the port's cut checkpoint of source 3 and keeps its rows
    np.savez(jdir / "dir_3.npz", **partial["dir_3.npz"])
    J3 = [a.reshape(-1, a.shape[-1]) for a in
          jopt._trace_grid(ja, 3, True, N_PHOTONS, 13, apex=APEX,
                           ckpt_path=str(jdir / "dir_3.npz"))]
    for j, p in zip(J3, whole[1]):
        np.testing.assert_array_equal(j[:cut_at], p[:cut_at])
        _assert_within_photons(j[cut_at:], p[cut_at:], N_PHOTONS)
