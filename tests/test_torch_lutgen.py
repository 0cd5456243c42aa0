"""LUT generation in the port (`optprop/lut.py`) against the JAX package's.

The host logic (presets, cache keys, entry grids, symmetrization, source
orbits, the adaptive rounds with their Welford statistics and row
criterion, the production assembly with its phi-mirror fill,
conservation clamp and gate, and the composition from checkpoints) is
numpy in both packages.  With the tracer replaced by one deterministic
numpy stub in both modules (monkeypatched in these tests only), the two
must give the same tables and meta (rtol 1e-6).  The closed-form dir2dir
block is handed over from the JAX function where both assemble a
production table: the two closed forms differ by up to 5e-5
(`tests/test_torch_boxmc_tracer.py`, ROADMAP faults found).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tenstream_tpu.boxmc import direct_transmission as jdt
from tenstream_tpu.boxmc import pallas_tracer as jpt
from tenstream_tpu.boxmc.schemes import get_box_scheme
from tenstream_tpu.optprop import lut as jlut
from tenstream_tpu_torch.optprop import lut as tlut
from tenstream_tpu_torch.tools import create_lut as tool
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain tracers issue thousands of small ops: one intra-op thread
    runs them as fast as many, and does not oversubscribe the CPU when
    test files run in parallel (where many threads made them 100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubTracer:
    """A deterministic stand-in for `_trace_entries`: tallies that depend
    on the entries, the source and the call count, with entry-dependent
    noise so that entries converge after different numbers of rounds."""

    def __init__(self, fail_at=None, by_seed=False):
        self.calls, self.fail_at, self.by_seed = 0, fail_at, by_seed

    def __call__(self, scheme, entries, src, ldir, n_photons, seed_or_key=None, *a, **k):
        self.calls += 1
        if self.fail_at is not None and self.calls >= self.fail_at:
            raise KeyboardInterrupt("stub interrupted")
        box = get_box_scheme(scheme)
        key = [int(seed_or_key)] if self.by_seed else [self.calls, src, int(ldir)]
        rng = np.random.default_rng(key)
        n = entries.shape[0]
        tau, w0 = entries[:, 0].astype(np.float64), entries[:, 1].astype(np.float64)
        T = np.zeros((n, box.ndir))
        if ldir:
            T = rng.dirichlet(np.ones(box.ndir), n) * np.exp(-np.minimum(tau, 50.0))[:, None] * 0.6
        p = np.linspace(1.0, 2.0, box.ndiff)
        p /= p.sum()
        amp = np.where(tau > 0.1, 0.6, 0.02) * (1.0 + entries[:, 2])
        noise = 1.0 + amp[:, None] * (rng.random((n, box.ndiff)) - 0.5)
        S = ((1.0 - T.sum(1)) * w0 * 0.6)[:, None] * p * noise
        return T.astype(np.float32), S.astype(np.float32)


def _stub_both(monkeypatch, **kw):
    js, ts = StubTracer(**kw), StubTracer(**kw)
    monkeypatch.setattr(jlut, "_trace_entries", js)
    monkeypatch.setattr(tlut, "_trace_entries", ts)
    return js, ts


def _assert_lut_equal(t, j, rtol=RTOL):
    assert t.scheme == j.scheme
    for k in ("dir2dir", "dir2diff", "diff2diff"):
        got = getattr(t, k)
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_allclose(got, np.asarray(getattr(j, k)), rtol=rtol, atol=0, err_msg=k)
    for a, b in ((t.dir_axes, j.dir_axes), (t.diff_axes, j.diff_axes)):
        for f in ("tau", "w0", "aspect", "g", "phi", "theta"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _assert_meta_equal(tm, jm):
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        if isinstance(v, float):
            np.testing.assert_allclose(tm[k], v, rtol=RTOL, err_msg=k)
        else:
            assert tm[k] == v, k


# ---------------------------------------------------------------------------
# presets, axes, keys, grids, symmetrization, orbits: exactly equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["PRESET_TAU15", "PRESET_W010", "PRESET_ASPECT13", "PRESET_G4",
                                  "PRESET_PHI7", "PRESET_THETA10", "PRESET_TAU31",
                                  "PRESET_TAU20", "PRESET_W020", "PRESET_ASPECT23", "PRESET_G6",
                                  "PRESET_PHI19", "PRESET_THETA19"])
def test_presets_equal(name):
    a, b = getattr(tlut, name), getattr(jlut, name)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _jax_bench_axes(monkeypatch):
    """`bench.py::bench_lut_axes`.  Importing bench.py sets two JAX cache
    variables and a sys.path entry; monkeypatch undoes both."""
    import importlib.util

    for k in ("JAX_COMPILATION_CACHE_DIR", "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("_bench", os.path.join(repo, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bench_lut_axes()


@pytest.mark.parametrize("fn", ["default_axes", "production_axes", "mockup_axes", "bench_axes"])
@pytest.mark.parametrize("direct", [True, False])
def test_axes_keys_and_grids_equal(fn, direct, monkeypatch):
    if fn == "bench_axes":  # the tool's copy of bench.py's axes (--preset bench)
        a, b = tool.bench_axes()[1 - direct], _jax_bench_axes(monkeypatch)[1 - direct]
    else:
        a, b = getattr(tlut, fn)(direct), getattr(jlut, fn)(direct)
    for f in ("tau", "w0", "aspect", "g", "phi", "theta"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    for scheme, kind, n in (("3_10", "dir", 10000), ("3_16", "diff", 2000), ("8_10", "dir", 5120)):
        assert a.cache_key(scheme, kind, n) == b.cache_key(scheme, kind, n)
    if fn != "production_axes" or not direct:
        ga, gb = tlut._entry_grid(a, direct), jlut._entry_grid(b, direct)
        assert ga.dtype == gb.dtype == np.float32
        np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("scheme", ["1_2", "3_6", "3_10", "8_10", "3_16", "3_24", "8_12",
                                    "not_a_stream_scheme"])
def test_symmetrize_tables_equal(scheme):
    box = get_box_scheme("3_10" if scheme == "not_a_stream_scheme" else scheme)
    rng = np.random.default_rng(3)
    phi = np.array([0.0, 45.0, 90.0], np.float32)
    dd = rng.random((2, 2, 2, 1, 3, 2, box.ndir, box.ndir)).astype(np.float32)
    df = rng.random((2, 2, 2, 1, 3, 2, box.ndir, box.ndiff)).astype(np.float32)
    ff = rng.random((2, 2, 2, 1, box.ndiff, box.ndiff)).astype(np.float32)
    for ph in (phi, np.array([0.0, 30.0], np.float32)):
        got = tlut.symmetrize_tables(scheme, dd, df, ff, ph)
        want = jlut.symmetrize_tables(scheme, dd, df, ff, ph)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scheme", ["1_2", "3_6", "3_10", "8_10", "3_16", "8_16", "3_24", "3_30",
                                    "8_18", "8_12"])
def test_diff_orbits_equal(scheme):
    treps, tassign = tlut._diff_orbits(scheme)
    jreps, jassign = jlut._diff_orbits(scheme)
    assert treps == jreps
    for s in jassign:
        assert tassign[s][0] == jassign[s][0]
        np.testing.assert_array_equal(tassign[s][1], jassign[s][1])


def test_seed_rule():
    assert tlut.fold(12345, 0) != tlut.fold(12345, 1) != tlut.fold(12346, 1)
    assert tlut.fold(12345, 7) == tlut.fold(12345 + 2 ** 32, 7 + 2 ** 32)  # mod 2^32 inputs
    assert all(0 <= tlut.fold(s, d) < 2 ** 31 for s in (0, 1, 2 ** 40) for d in (0, 99, -1))


# ---------------------------------------------------------------------------
# host logic with one stub tracer in both modules
# ---------------------------------------------------------------------------


def test_create_lut_equal(monkeypatch):
    _stub_both(monkeypatch)
    j = jlut.create_lut("3_10", jlut.mockup_axes(True), jlut.mockup_axes(False), n_photons=100)
    t = tlut.create_lut("3_10", tlut.mockup_axes(True), tlut.mockup_axes(False), n_photons=100,
                        device="cpu")
    assert t.device.type == "cpu"
    _assert_lut_equal(t, j)


@pytest.mark.parametrize("ldir,conv", [(False, None), (True, slice(3, None)), (True, None)])
def test_trace_adaptive_equal(monkeypatch, ldir, conv):
    js, ts = _stub_both(monkeypatch)
    entries = jlut._entry_grid(jlut.mockup_axes(ldir), ldir)
    kw = dict(stddev_atol=3e-3 if ldir else 5e-4, stddev_rtol=5e-2, max_rounds=9,
              conv_cols=conv)
    want = jlut._trace_adaptive("3_10", entries, 1, ldir, jax.random.PRNGKey(0), **kw)
    got = tlut._trace_adaptive("3_10", entries, 1, ldir, 5, device="cpu", **kw)
    assert js.calls == ts.calls > 4  # rounds beyond min_rounds: some entries converge later
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
    assert 4 <= got[2].min() < got[2].max() <= 9


@pytest.fixture(scope="module")
def production_pair(tmp_path_factory):
    """create_production_lut of both packages on mockup axes with the stub,
    each with its own checkpoint directory."""
    mp = pytest.MonkeyPatch()
    try:
        _stub_both(mp)
        mp.setattr(tlut, "dir2dir_table", lambda *a: np.asarray(jdt.dir2dir_table(*a)))
        d = tmp_path_factory.mktemp("prod")
        kw = dict(max_rounds=6, dir_max_rounds=6, verbose=False)
        j = jlut.create_production_lut("3_10", jlut.mockup_axes(True), jlut.mockup_axes(False),
                                       checkpoint_dir=str(d / "jax"), **kw)
        t = tlut.create_production_lut("3_10", tlut.mockup_axes(True), tlut.mockup_axes(False),
                                       checkpoint_dir=str(d / "port"), device="cpu", **kw)
    finally:
        mp.undo()
    return j, t, d


def test_create_production_lut_equal(production_pair):
    (j, jm), (t, tm), _ = production_pair
    _assert_lut_equal(t, j)
    _assert_meta_equal(tm, jm)
    assert tm["dir2dir_source"] == "closed_form" and tm["diff_rounds_mean"] > 4


def test_compose_production_lut_equal(production_pair, monkeypatch):
    (j, jm), (t, tm), d = production_pair
    donor = str(d / "donor.npz")
    t.save(donor, meta=tm)
    monkeypatch.setattr(tlut, "dir2dir_table", lambda *a: np.asarray(jdt.dir2dir_table(*a)))
    jc, jcm = jlut.compose_production_lut("3_10", donor, str(d / "jax"),
                                          diff_axes=jlut.mockup_axes(False))
    tc, tcm = tlut.compose_production_lut("3_10", donor, str(d / "port"),
                                          diff_axes=tlut.mockup_axes(False), device="cpu")
    _assert_lut_equal(tc, jc)
    _assert_meta_equal(tcm, jcm)


def test_save_load_both_ways(production_pair, tmp_path):
    (j, jm), (t, tm), _ = production_pair
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t.save(p_port, meta=tm)
    j.save(p_jax, meta=jm)
    _assert_lut_equal(t, jlut.LUT.load(p_port), rtol=0)  # the port's file in the JAX package
    _assert_lut_equal(tlut.LUT.load(p_jax, device="cpu"), j, rtol=0)
    assert json.loads(str(np.load(p_port)["meta_json"])) == tm
    assert sorted(np.load(p_port).files) == sorted(np.load(p_jax).files)


# ---------------------------------------------------------------------------
# checkpoints and the lock
# ---------------------------------------------------------------------------


def _adaptive(path, stub, monkeypatch):
    monkeypatch.setattr(tlut, "_trace_entries", stub)
    entries = tlut._entry_grid(tlut.mockup_axes(False), False)
    return tlut._trace_adaptive("3_10", entries, 0, False, 99, stddev_atol=5e-4,
                                stddev_rtol=5e-2, max_rounds=8, checkpoint_path=path,
                                device="cpu")


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch):
    whole = _adaptive(str(tmp_path / "a.npz"), StubTracer(by_seed=True), monkeypatch)
    path = str(tmp_path / "b.npz")
    with pytest.raises(KeyboardInterrupt):
        _adaptive(path, StubTracer(fail_at=6, by_seed=True), monkeypatch)
    assert np.load(path)["rounds"].max() == 5 and not os.path.exists(path + ".lock")
    resumed = _adaptive(path, StubTracer(by_seed=True), monkeypatch)
    for a, b in zip(whole, resumed):
        np.testing.assert_array_equal(a, b)
    again = StubTracer(by_seed=True)
    _adaptive(path, again, monkeypatch)
    assert again.calls == 0  # a finished checkpoint traces nothing


def test_lock_refuses_live_pid_and_takes_stale(tmp_path, monkeypatch):
    path = str(tmp_path / "c.npz")
    with open(path + ".lock", "w") as f:
        f.write(str(os.getpid()))
    with pytest.raises(RuntimeError, match="locked by live pid"):
        _adaptive(path, StubTracer(), monkeypatch)
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    with open(path + ".lock", "w") as f:
        f.write(str(dead.pid))
    _adaptive(path, StubTracer(), monkeypatch)
    assert not os.path.exists(path + ".lock")


# ---------------------------------------------------------------------------
# the real tracers behind _trace_entries and create_lut
# ---------------------------------------------------------------------------


def test_trace_entries_k4_route_matches_jax_kernel():
    """Chunks of the K4 route: seed + lo per chunk, rows within the chunk;
    and `max_iter` is not handed to the tracer, in either package (the
    reference's quirk, ROADMAP faults found): asked for 2 steps, both walk
    to the tracer's default of 3000."""
    entries = tlut._entry_grid(tlut.mockup_axes(True), True)[::97][:8]
    T, S = tlut._trace_entries("3_10", entries, 1, True, 0, 1234, chunk=4, max_iter=2,
                               device="cpu")
    key = jax.random.PRNGKey(4)
    with pltpu.force_tpu_interpret_mode():
        jT, jS = jlut._trace_entries("3_10", entries, 1, True, 0, key, chunk=4, use_pallas=True,
                                     max_iter=2)
        jseed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
        for lo in (0, 4):
            params = jax.numpy.asarray(np.pad(entries[lo:lo + 4], ((0, 0), (0, 2))))
            Tj, Sj = jpt.run_boxmc_pallas(params, "3_10", 1, True, seed=1234 + lo)
            np.testing.assert_allclose(T[lo:lo + 4], np.asarray(Tj), atol=1e-5)
            np.testing.assert_allclose(S[lo:lo + 4], np.asarray(Sj), atol=1e-5)
            Tj, Sj = jpt.run_boxmc_pallas(params, "3_10", 1, True, seed=jseed + lo)
            np.testing.assert_array_equal(jT[lo:lo + 4], np.asarray(Tj))
            np.testing.assert_array_equal(jS[lo:lo + 4], np.asarray(Sj))
    # walks cut after 2 steps would give other tallies
    _, S2 = tlut.run_boxmc_cuda(np.pad(entries[4:], ((0, 0), (0, 2))), "3_10", 1, True,
                                max_iter=2, seed=1238, device="cpu")
    assert np.abs(S2.numpy() - S[4:]).max() > 1e-4


TINY = (tlut.LUTAxes(np.array([0.1, 2.0], np.float32), np.array([0.5, 0.99], np.float32),
                     np.array([1.0], np.float32), np.array([0.5], np.float32),
                     np.array([0.0, 90.0], np.float32), np.array([20.0], np.float32)),
        tlut.LUTAxes(np.array([0.1, 2.0], np.float32), np.array([0.5, 0.99], np.float32),
                     np.array([1.0], np.float32), np.array([0.5], np.float32)))


def test_create_lut_on_the_cpu_and_in_both_packages(tmp_path, monkeypatch):
    """The command-line tool makes a tiny table with plain K4 on the CPU;
    the JAX package's `load_or_create_lut` finds it under the same cache
    key and loads it without tracing anything."""
    monkeypatch.setattr(tlut, "mockup_axes", lambda direct: TINY[0 if direct else 1])
    tool.main(["3_10", "--preset", "mockup", "--out", str(tmp_path), "--device", "cpu"])
    (name,) = os.listdir(tmp_path)
    lut = tlut.LUT.load(str(tmp_path / name), device="cpu")
    dsum = (lut.dir2dir.sum(-1) + lut.dir2diff.sum(-1)).max().item()
    assert dsum <= 1.0 + 1e-3 and lut.diff2diff.sum(-1).max().item() <= 1.0 + 1e-3
    assert lut.diff2diff.min().item() >= 0 and lut.diff2diff[1, 1].sum().item() > 0.9
    monkeypatch.setattr(jlut, "create_lut", None)  # would raise if it tried to generate
    j = jlut.load_or_create_lut("3_10", jlut.LUTAxes(*(getattr(TINY[0], f) for f in (
        "tau", "w0", "aspect", "g", "phi", "theta"))), jlut.LUTAxes(
        TINY[1].tau, TINY[1].w0, TINY[1].aspect, TINY[1].g), basename=str(tmp_path))
    _assert_lut_equal(lut, j, rtol=0)
    # wedge_5_8 --preset mockup traces the wedge test axes (made tiny here) into the same dir
    from tenstream_tpu.plexrt import optprop as jopt
    from tenstream_tpu_torch.plexrt import optprop as topt

    tiny = lambda m: m.WedgeAxes(*(np.array(v, np.float32) for v in (
        (1e-10, 1.0), (0.0, 0.9), (1.0,), (0.0,), (0.0, 360.0), (0.0,))))
    monkeypatch.setattr(topt, "test_axes", lambda: tiny(topt))
    tool.main(["wedge_5_8", "--preset", "mockup", "--out", str(tmp_path), "--device", "cpu",
               "--photons", "100"])
    monkeypatch.setattr(jopt, "create_wedge_lut", None)
    w = jopt.load_or_create_wedge_lut(tiny(jopt), n_photons=100, basename=str(tmp_path))
    assert np.asarray(w.dir2dir).shape == (2, 2, 1, 1, 2, 1, 4, 5)
