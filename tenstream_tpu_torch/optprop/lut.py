"""Lookup tables of transfer coefficients (port of the loading half of
`tenstream_tpu/optprop/lut.py`: `LUTAxes` and `LUT.load`).

The npz format is the JAX package's (`LUT.save`).  Tables live on the
caller's `device` as float32 tensors; the axes stay numpy (they are tiny
and read on the host).  Generating tables is not ported yet (ROADMAP M16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class LUTAxes:
    tau: np.ndarray
    w0: np.ndarray
    aspect: np.ndarray
    g: np.ndarray
    phi: Optional[np.ndarray] = None  # direct tables only
    theta: Optional[np.ndarray] = None


@dataclass
class LUT:
    """One table pair for a scheme: direct (T & S) and diffuse (S).

    dir2dir: (ntau, nw0, nasp, ng, nphi, ntheta, ndir, ndir) [src, dst]
    dir2diff: (..., ndir, ndiff); diff2diff: (ntau, nw0, nasp, ng, ndiff, ndiff)
    """

    scheme: str
    dir_axes: LUTAxes
    diff_axes: LUTAxes
    dir2dir: torch.Tensor
    dir2diff: torch.Tensor
    diff2diff: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.diff2diff.device

    @staticmethod
    def load(path: str, device="cuda") -> "LUT":
        z = np.load(path, allow_pickle=False)
        dir_axes = LUTAxes(z["dir_tau"], z["dir_w0"], z["dir_aspect"], z["dir_g"],
                           z["dir_phi"], z["dir_theta"])
        diff_axes = LUTAxes(z["diff_tau"], z["diff_w0"], z["diff_aspect"], z["diff_g"])
        t = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
        return LUT(
            scheme=str(z["scheme"]),
            dir_axes=dir_axes,
            diff_axes=diff_axes,
            dir2dir=t("dir2dir"),
            dir2diff=t("dir2diff"),
            diff2diff=t("diff2diff"),
        )


def perm_group(perms):
    """Closure of the given permutations under composition."""
    n = len(perms[0])
    group = {tuple(range(n))}
    frontier = [tuple(p) for p in perms]
    while frontier:
        new = []
        for p in frontier:
            if p in group:
                continue
            group.add(p)
            for q in list(group):
                for a, b in ((p, q), (q, p)):
                    c = tuple(a[i] for i in b)
                    if c not in group:
                        new.append(c)
        frontier = new
    return [np.asarray(p) for p in sorted(group)]
