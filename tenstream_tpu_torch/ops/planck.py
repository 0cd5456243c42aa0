"""Planck emission (port of `tenstream_tpu/ops/planck.py`: `b_eff_mu`,
`b_eff`, `schwarzschild_radiance_step`, `planck_radiance_wavenumber` and
`stefan_boltzmann_radiance`; reference `src/schwarzschild.F90:36-79`).
"""

from __future__ import annotations

import numpy as np
import torch

from tenstream_tpu_torch.core.types import (
    C_SPEED_OF_LIGHT,
    H_PLANCK,
    K_BOLTZMANN,
    PI,
    STEFAN_BOLTZMANN,
    ireals,
)


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


def planck_radiance_wavenumber(wvn_lo_cm: float, wvn_hi_cm: float, T, n_quad: int = 16):
    """Band-integrated Planck radiance [W/m2/sr] between two wavenumbers
    [1/cm] by Gauss-Legendre quadrature over wavenumber, in float32 like
    the JAX function (the nodes and weights are float64 on the host)."""
    T = torch.as_tensor(T, dtype=ireals)
    nu_lo, nu_hi = wvn_lo_cm * 100.0, wvn_hi_cm * 100.0  # [1/m]
    x, w = np.polynomial.legendre.leggauss(n_quad)
    nu = 0.5 * (nu_hi + nu_lo) + 0.5 * (nu_hi - nu_lo) * x
    wq = 0.5 * (nu_hi - nu_lo) * w
    c1 = 2.0 * H_PLANCK * C_SPEED_OF_LIGHT ** 2
    c2 = H_PLANCK * C_SPEED_OF_LIGHT / K_BOLTZMANN
    out = torch.zeros_like(T)
    for nui, wi in zip(nu, wq):
        # B_nu = c1 nu^3 / (exp(c2 nu / T) - 1)
        out = out + float(np.float32(wi * c1 * nui ** 3)) / torch.expm1(
            float(np.float32(c2 * nui)) / T)
    return out


def schwarzschild_radiance_step(L, tau, b_near, b_far):
    """Radiance L after a layer of slant optical depth tau; b_near is the
    Planck value at the entry side, b_far at the exit side (reference
    `schwarzschild_radiance`, `src/schwarzschild.F90:69-79`)."""
    thin = tau < 1e-3
    tau_safe = torch.where(thin, torch.ones_like(tau), tau)
    tm1 = torch.expm1(-tau_safe)
    full = L * (tm1 + 1.0) + (b_far - b_near) - (b_near - (b_far - b_near) / tau_safe) * tm1
    lin = 0.5 * (b_near + b_far) * tau + L * (1.0 - tau)
    return torch.where(thin, lin, full)


def stefan_boltzmann_radiance(T):
    """Total blackbody radiance sigma T^4 / pi [W/m2/sr]."""
    T = torch.as_tensor(T, dtype=ireals)
    return STEFAN_BOLTZMANN * T ** 4 / PI
