"""The port's utilities against the JAX package's (M20): scene dumps and
replay archives written by either package load in the other, XDMF export
writes the same files, `EventLog` counts its scopes, `Deadline` and
`Heartbeat` work on the CPU, and `probe_chip` without CUDA fails at once
without probing the CPU instead."""

import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tenstream_tpu.atm import setup_standard_atmosphere as jsetup
from tenstream_tpu.utils import io as jio
from tenstream_tpu_torch.atm import setup_standard_atmosphere as tsetup
from tenstream_tpu_torch.core.log import GLOBAL_LOG, EventLog
from tenstream_tpu_torch.utils import chip
from tenstream_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(kabs=rng.random((3, 4, 5)).astype(np.float32), albedo=np.float32(0.2),
                sundir=np.array([0.1, 0.2, -0.9]), nlev=np.int32(7))


@pytest.mark.parametrize("writer,reader", [(jio, tio), (tio, jio)], ids=["jax->port", "port->jax"])
def test_scene_dumps_load_in_the_other_package(writer, reader, tmp_path):
    a = _arrays()
    path = str(tmp_path / "scene.npz")
    writer.dump_scene(path, **a, skipped=None)
    got = reader.load_scene(path)
    assert sorted(got) == sorted(a)
    for k, v in a.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == np.asarray(v).dtype


def test_port_dumps_tensors(tmp_path):
    """The port's dump takes tensors as they are (here on the CPU)."""
    path = str(tmp_path / "t.npz")
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tio.dump_scene(path, field=t)
    np.testing.assert_array_equal(jio.load_scene(path)["field"], t.numpy())
    np.save(str(tmp_path / "plain.npy"), np.zeros(2))
    with pytest.raises(ValueError, match="archive"):
        tio.load_scene(str(tmp_path / "plain.npy"))


def _atm_equal(a, b):
    for k in ("plev", "tlev", "zlev", "lwc", "reliq", "iwc", "reice", "cfrac", "skin_temperature"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)
    assert sorted(a.gases) == sorted(b.gases)
    for k in a.gases:
        np.testing.assert_array_equal(np.asarray(a.gases[k]), np.asarray(b.gases[k]), err_msg=k)


@pytest.mark.parametrize("which", ["jax->port", "port->jax"])
def test_specint_input_dumps_load_in_the_other_package(which, tmp_path):
    zlev = np.linspace(20e3, 0.0, 9)
    lwc = np.zeros((8, 3, 2), np.float32)
    lwc[-3] = 0.2
    writer, reader, setup = (jio, tio, jsetup) if which == "jax->port" else (tio, jio, tsetup)
    atm = setup(z_grid=zlev)
    atm.lwc = lwc
    path = str(tmp_path / "specint.npz")
    writer.dump_specint_input(path, atm, sundir=np.array([0.3, 0.1, -0.95]), albedo=0.15,
                              edirTOA=1361.0)
    got, params = reader.load_specint_input(path)
    _atm_equal(got, atm)
    assert sorted(params) == ["albedo", "edirTOA", "sundir"]
    np.testing.assert_array_equal(params["sundir"], [0.3, 0.1, -0.95])
    assert float(params["albedo"]) == 0.15


def test_xdmf_export_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    fields = dict(edn=rng.random((4, 5)).astype(np.float32),
                  abso=rng.random((3, 4, 5)).astype(np.float32))
    xj = jio.write_xdmf_grid(str(tmp_path / "jax" / "out"), fields, dx=100.0, dy=50.0, dz=10.0)
    xt = tio.write_xdmf_grid(str(tmp_path / "port" / "out"),
                             {k: torch.as_tensor(v) for k, v in fields.items()},
                             dx=100.0, dy=50.0, dz=10.0)
    with open(xj) as fj, open(xt) as ft:
        assert fj.read() == ft.read()
    for name, v in fields.items():
        raw = np.fromfile(str(tmp_path / "port" / f"out_{name}.bin"), np.float32)
        np.testing.assert_array_equal(raw.reshape(v.shape), v)


def test_event_log_counts_scopes():
    log = EventLog()
    for _ in range(3):
        with log.scope("solve"):
            with log.scope("edir", sync=True):
                time.sleep(0.001)
    with pytest.raises(RuntimeError):
        with log.scope("failed"):
            raise RuntimeError("counted all the same")
    counts = log.counts()
    assert {k: n for k, (n, _) in counts.items()} == {"solve": 3, "edir": 3, "failed": 1}
    assert counts["solve"][1] >= counts["edir"][1] >= 0.003
    table = log.view().splitlines()
    assert table[0].split()[:2] == ["event", "count"] and len(table) == 4
    assert table[1].split()[0] == "solve"  # the longest total first
    log.reset()
    assert log.counts() == {}
    assert isinstance(GLOBAL_LOG, EventLog)


def test_event_log_scopes_show_in_the_profiler():
    log = EventLog()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with log.scope("ts_phase"):
            torch.ones(8) + 1
    assert any(e.key == "ts_phase" for e in prof.key_averages())


def test_heartbeat_stamps_phases():
    out = io.StringIO()
    hb = chip.Heartbeat(interval_s=0.02, stream=out).start()
    hb.phase("setup")
    time.sleep(0.1)
    hb.stop()
    text = out.getvalue()
    assert "phase=setup" in text and "heartbeat phase=setup" in text


def test_deadline_exits_with_its_code():
    code = ("import time; from tenstream_tpu_torch.utils.chip import Deadline; "
            "Deadline(0.3, on_fire=lambda: print('PARTIAL', flush=True)).start(); "
            "time.sleep(30)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                       cwd=REPO)
    assert r.returncode == chip.RC_DEADLINE == 4
    assert "DEADLINE" in r.stderr and "PARTIAL" in r.stdout
    d = chip.Deadline(0.05).start()
    d.cancel()
    time.sleep(0.1)  # a cancelled watchdog never fires (the test process goes on)
    assert d.remaining() < 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the probe where there is no CUDA")
def test_probe_chip_without_cuda_fails_loudly():
    out = io.StringIO()
    t0 = time.time()
    assert chip.probe_chip(timeout_s=120.0, retries=2, stream=out) is False
    text = out.getvalue()
    # one attempt: no retry of a missing device, and no matmul on the CPU instead
    assert text.count("# chip probe (attempt") == 1
    assert "FAILED" in text and "PROBE_NO_CUDA" in text and "PROBE_OK" not in text
    assert time.time() - t0 < 120.0
    assert chip.RC_PROBE_FAILED == 3
