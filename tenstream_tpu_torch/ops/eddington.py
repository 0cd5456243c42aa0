"""Analytic delta-Eddington two-stream layer coefficients (port of
`tenstream_tpu/ops/eddington.py::eddington_coeff_ec`, the production
variant, reference `src/eddington.F90:184-242`).

Returns (a11, a12, a13, a23, a33): diffuse transmission, diffuse
reflection, direct->diffuse up, direct->diffuse down, direct
transmission; elementwise over broadcast inputs.
"""

from __future__ import annotations

import torch

from tenstream_tpu_torch.core.types import EPS, TINY, ireals

_MAX_EXP = 80.0


def eddington_coeff_ec(dtau, w0, g, mu0):
    dev = next(t.device for t in (dtau, w0, g, mu0) if isinstance(t, torch.Tensor))
    dtau, w0, g, mu0 = torch.broadcast_tensors(
        *(torch.as_tensor(t, dtype=ireals, device=dev) for t in (dtau, w0, g, mu0)))
    w0 = torch.clamp(w0, 0.0, 1.0 - 1e-6)

    f = 0.75 * g
    g1 = 2.0 - w0 * (1.25 + f)
    g2 = w0 * (0.75 - f)
    g3 = 0.5 - mu0 * f
    g4 = 1.0 - g3

    mu0_safe = torch.clamp(mu0, min=TINY ** 0.5)
    dtau_slant = torch.clamp(dtau / mu0_safe, min=0.0)
    thick = dtau_slant > 1e-6

    alpha1 = g1 * g4 + g2 * g3
    alpha2 = g1 * g3 + g2 * g4
    A = torch.sqrt(torch.clamp((g1 - g2) * (g1 + g2), min=1e-12))
    k_mu0 = A * mu0
    k_mu0 = torch.where(torch.abs(k_mu0 - 1.0) < 10 * EPS,
                        torch.full_like(k_mu0, 1.0 - 10 * EPS), k_mu0)
    k_g3 = A * g3
    k_g4 = A * g4

    e0 = torch.exp(-torch.clamp(dtau_slant, max=_MAX_EXP))
    e = torch.exp(-torch.clamp(A * dtau, max=_MAX_EXP))
    e2 = e * e
    k_2_e = 2.0 * A * e

    beta = 1.0 / (A + g1 + (A - g1) * e2)
    r_thick = g2 * (1.0 - e2) * beta
    t_thick = k_2_e * beta

    beta_dir = w0 * beta / (1.0 - k_mu0 * k_mu0)
    sdir_thick = beta_dir * (
        k_2_e * (g4 + alpha1 * mu0)
        - e0 * ((1.0 + k_mu0) * (alpha1 + k_g4) - (1.0 - k_mu0) * (alpha1 - k_g4) * e2)
    )
    rdir_thick = beta_dir * (
        (1.0 - k_mu0) * (alpha2 + k_g3)
        - (1.0 + k_mu0) * (alpha2 - k_g3) * e2
        - k_2_e * (g3 - alpha2 * mu0) * e0
    )

    t_thin = 1.0 - g1 * dtau
    r_thin = g2 * dtau
    sdir_thin = (1.0 - g3) * w0 * dtau
    rdir_thin = g3 * w0 * dtau
    e0_thin = 1.0 - dtau_slant

    a11 = torch.clamp(torch.where(thick, t_thick, t_thin), 0.0, 1.0)
    a12 = torch.clamp(torch.where(thick, r_thick, r_thin), 0.0, 1.0)
    a13 = torch.clamp(torch.where(thick, rdir_thick, rdir_thin), min=0.0)
    a23 = torch.clamp(torch.where(thick, sdir_thick, sdir_thin), min=0.0)
    a33 = torch.clamp(torch.where(thick, e0, e0_thin), 0.0, 1.0)

    # energy inequalities, strictly (f32 noise at w0 -> 1, tiny tau)
    norm = torch.clamp(1.0 / torch.clamp(a11 + a12, min=TINY), max=1.0)
    a11 = a11 * norm
    a12 = a12 * norm
    normd = torch.clamp((1.0 - a33) / torch.clamp(a13 + a23, min=TINY), max=1.0)
    a13 = a13 * normd
    a23 = a23 * normd

    sun_up = mu0 > EPS
    zero = torch.zeros_like(a13)
    a13 = torch.where(sun_up, a13, zero)
    a23 = torch.where(sun_up, a23, zero)
    a33 = torch.where(sun_up, a33, zero)
    return a11, a12, a13, a23, a33
