"""Session hygiene for long runs on the card (port of
`tenstream_tpu/utils/chip.py`): a benchmark or a table generation must run
unattended and, where the device or the run goes wrong, say so before an
outer timeout kills it without a word.

  * `probe_chip()` -- a CUDA matmul in a SUBPROCESS under a hard timeout
    (its process group is killed when it hangs), so a wedged device shows
    in seconds instead of hanging the caller.  It fails loudly where
    `torch.cuda.is_available()` is false and never runs on the CPU instead.
  * `Heartbeat` -- a daemon thread stamping `# [t+XXXs] phase=...` on
    stderr, so the captured tail of a run shows where its time went.
  * `Deadline` -- a watchdog that force-exits the process with its own
    exit code before an outer timeout can strike.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

# exit codes that name the failure (the JAX package's)
RC_PROBE_FAILED = 3  # the device probe hung or failed
RC_DEADLINE = 4  # the watchdog fired before the outer timeout

_PROBE_SRC = r"""
import sys, time
t0 = time.time()
import torch
if not torch.cuda.is_available():
    print("PROBE_NO_CUDA: torch.cuda.is_available() is false", flush=True)
    sys.exit(3)
x = torch.ones((128, 128), device="cuda")
y = x @ x
torch.cuda.synchronize()
print("PROBE_OK device=%s count=%d sum=%.0f claim_s=%.1f" % (
    torch.cuda.get_device_name(0), torch.cuda.device_count(), float(y.sum()), time.time() - t0))
"""


def probe_chip(timeout_s: float = 180.0, retries: int = 1, stream=None) -> bool:
    """Probe the card with a 128 x 128 matmul in a fresh interpreter under
    a hard timeout; on a timeout the probe's whole process group is killed.
    True when the card answered, False after every attempt failed (no
    CUDA fails at once, without retries).  Progress goes to `stream`
    (default stderr)."""
    stream = stream or sys.stderr
    for attempt in range(retries + 1):
        t0 = time.time()
        print(f"# chip probe (attempt {attempt + 1}/{retries + 1}, timeout {timeout_s:.0f}s)...",
              file=stream, flush=True)
        proc = subprocess.Popen([sys.executable, "-c", _PROBE_SRC], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()
            print(f"# chip probe HUNG past {timeout_s:.0f}s (killed its process group): the "
                  "device looks wedged", file=stream, flush=True)
            continue
        ok = proc.returncode == 0 and "PROBE_OK" in out
        tail = [ln for ln in out.strip().splitlines() if ln.strip()][-1:] or [""]
        print(f"# chip probe {'OK' if ok else 'FAILED'} in {time.time() - t0:.1f}s: {tail[0]}",
              file=stream, flush=True)
        if ok:
            return True
        if "PROBE_NO_CUDA" in out:
            return False
    return False


class Heartbeat:
    """A daemon thread stamping the phase and the elapsed time on stderr
    every `interval_s`."""

    def __init__(self, interval_s: float = 30.0, stream=None):
        self.interval_s = interval_s
        self.stream = stream or sys.stderr
        self.t0 = time.time()
        self._phase = "init"
        self._phase_t0 = self.t0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def phase(self, name: str):
        now = time.time()
        print(f"# [t+{now - self.t0:7.1f}s] phase={name} (prev took {now - self._phase_t0:.1f}s)",
              file=self.stream, flush=True)
        self._phase, self._phase_t0 = name, now

    def _run(self):
        while not self._stop.wait(self.interval_s):
            now = time.time()
            print(f"# [t+{now - self.t0:7.1f}s] heartbeat phase={self._phase} "
                  f"({now - self._phase_t0:.1f}s in phase)", file=self.stream, flush=True)

    def stop(self):
        self._stop.set()


class Deadline:
    """A watchdog that exits with RC_DEADLINE and a loud message on stderr
    when `deadline_s` has passed; `on_fire` (if given) runs first, e.g. to
    print a partial result."""

    def __init__(self, deadline_s: float, stream=None, on_fire=None):
        self.deadline_s = deadline_s
        self.stream = stream or sys.stderr
        self.on_fire = on_fire
        self.t0 = time.time()
        self._cancelled = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def remaining(self) -> float:
        return self.deadline_s - (time.time() - self.t0)

    def _run(self):
        if self._cancelled.wait(self.deadline_s):
            return
        print(f"# DEADLINE: exceeded the internal budget of {self.deadline_s:.0f}s; exiting "
              f"before the outer timeout (rc {RC_DEADLINE})", file=self.stream, flush=True)
        if self.on_fire is not None:
            try:
                self.on_fire()
            except Exception as e:  # a partial report must not stop the exit
                print(f"# on_fire handler failed: {e}", file=self.stream, flush=True)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(RC_DEADLINE)

    def cancel(self):
        self._cancelled.set()
