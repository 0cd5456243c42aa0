"""Effective Planck emission across a layer (port of `b_eff_mu` / `b_eff`
from `tenstream_tpu/ops/planck.py`; reference `src/schwarzschild.F90:36-66`).
"""

from __future__ import annotations

import numpy as np
import torch


def gauss_legendre_01(n: int):
    """Gauss-Legendre nodes/weights on (0, 1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def b_eff_mu(b_far, b_near, tau, mu: float):
    """Effective Planck emission along a slanted path."""
    dtau = tau / mu
    thin = dtau < 1e-3
    one = torch.ones_like(dtau)
    dtau_safe = torch.where(thin, one, dtau)
    tau_safe = torch.where(thin, one, tau)
    tm1 = torch.expm1(-dtau_safe)
    full = (-b_near + b_far * (tm1 + 1.0)) / tm1 + (b_far - b_near) * mu / tau_safe
    lin = 0.5 * (b_far + b_near)
    return torch.where(thin, lin, full)


def b_eff(b_far, b_near, tau, nmu: int = 2):
    """Angle-integrated effective Planck emission of a layer: the
    isotropic value B such that B * (1 - T) integrates the source."""
    pts, wts = gauss_legendre_01(nmu)
    b = torch.zeros(torch.broadcast_shapes(b_far.shape, b_near.shape, tau.shape),
                    dtype=tau.dtype, device=tau.device)
    for mu, w in zip(pts, wts):
        mu32, w32 = float(np.float32(mu)), float(np.float32(w))
        b = b + b_eff_mu(b_far, b_near, tau, mu32) * mu32 * w32
    return b * 2.0
