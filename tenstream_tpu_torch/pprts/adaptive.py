"""Adaptive re-solve skipping by error-growth extrapolation (port of
`tenstream_tpu/pprts/adaptive.py`; reference
`src/adaptive_spectral_integration.F90`, `need_new_solution`:38-183).

Per band chunk, a short history of (time, absorption-change maxnorm) is
kept; a polynomial (order <= 2) fitted to the error growth decides whether
the chunk is re-solved: it is skipped while the extrapolated error stays
below `max_solution_err` and the solution is younger than
`max_solution_time`.  Host numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_HIST = 3  # the reference keeps a 3-deep (time, err) history


@dataclass
class SolutionErrorTracker:
    times: List[float] = field(default_factory=list)
    errors: List[float] = field(default_factory=list)  # absorption-change maxnorm

    def record(self, time: float, err: float) -> None:
        self.times.append(float(time))
        self.errors.append(float(err))
        if len(self.times) > _HIST:
            self.times.pop(0)
            self.errors.pop(0)

    def need_new_solution(self, time: Optional[float], max_solution_err: float,
                          max_solution_time: float) -> bool:
        """True if the chunk should be re-solved at `time`."""
        if time is None or not self.times:
            return True
        if time - self.times[-1] >= max_solution_time:
            return True
        if len(self.times) < 2:
            return True
        order = min(len(self.times) - 1, 2)
        try:
            est = float(np.polyval(np.polyfit(self.times, self.errors, order), time))
        except (np.linalg.LinAlgError, ValueError):
            return True
        return abs(est) >= max_solution_err


def abso_change_maxnorm(abso_new, abso_old, mesh=None) -> float:
    """Inf-norm of the absorption change (reference `restore_solution`,
    `src/pprts.F90:4037-4050`); host arrays.  With a `mesh` (the arrays
    are the rank's block) the global max, so every rank decides alike."""
    m = float(np.max(np.abs(np.asarray(abso_new) - np.asarray(abso_old))))
    if mesh is None:
        return m
    import torch

    return float(mesh.all_reduce(torch.tensor([m], dtype=torch.float64), "max")[0])
