"""Named timing scopes and a summary table (port of
`tenstream_tpu/core/log.py`; reference `src/tenstream_log.F90:67-186`, the
PETSc log events around every solver phase, and `ts_log_view`).

Every scope also enters `torch.profiler.record_function`, so the phases
show in profiler traces.  CUDA runs asynchronously: without `sync` a
scope measures what the host spent launching; `scope(name, sync=True)`
calls `torch.cuda.synchronize()` on entry and exit for the device time
too (the JAX package's `block=True`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Tuple

import torch


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class EventLog:
    def __init__(self) -> None:
        self._acc: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))

    @contextlib.contextmanager
    def scope(self, name: str, sync: bool = False):
        with torch.profiler.record_function(name):
            if sync:
                _synchronize()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync:
                    _synchronize()
                dt = time.perf_counter() - t0
                n, tot = self._acc[name]
                self._acc[name] = (n + 1, tot + dt)

    def counts(self) -> Dict[str, Tuple[int, float]]:
        """name -> (entries, total seconds)."""
        return dict(self._acc)

    def view(self) -> str:
        """Summary table like `ts_log_view`, longest total first."""
        lines = [f"{'event':40s} {'count':>8s} {'total[s]':>12s} {'mean[ms]':>12s}"]
        for name, (n, tot) in sorted(self._acc.items(), key=lambda kv: -kv[1][1]):
            mean_ms = 1e3 * tot / max(n, 1)
            lines.append(f"{name:40s} {n:8d} {tot:12.4f} {mean_ms:12.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._acc.clear()


GLOBAL_LOG = EventLog()
