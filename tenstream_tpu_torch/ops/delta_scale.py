"""Delta scaling of optical properties (port of
`tenstream_tpu/ops/delta_scale.py`; reference
`src/helper_functions.fypp:1622-1666`).  Forward-peak fraction f = g**2.
"""

from __future__ import annotations

import torch

from tenstream_tpu_torch.core.types import EPS, TINY


def delta_scale_optprop(dtau, w0, g, f):
    """Scale (dtau, w0, g) with forward fraction f."""
    g_is_one = g >= 1.0 - 10 * EPS
    zero = torch.zeros_like(g)
    dtau_s = torch.where(g_is_one, dtau * (1.0 - w0), dtau * (1.0 - w0 * f))
    g_s = torch.where(g_is_one, zero, (g - f) / (1.0 - f))
    w0_s = torch.where(g_is_one, zero, w0 * (1.0 - f) / (1.0 - f * w0))
    return dtau_s, w0_s, g_s


def delta_scale(kabs: torch.Tensor, ksca: torch.Tensor, g: torch.Tensor):
    """Delta-scale extinction fields; returns (kabs', ksca', g')."""
    ff = g ** 2
    dtau = kabs + ksca
    skip = dtau < EPS
    w0 = ksca / torch.clamp(dtau, min=TINY)
    dtau_s, w0_s, g_s = delta_scale_optprop(dtau, w0, g, ff)
    kabs_s = dtau_s * (1.0 - w0_s)
    ksca_s = dtau_s * w0_s
    return (torch.where(skip, kabs, kabs_s), torch.where(skip, ksca, ksca_s),
            torch.where(skip, g, g_s))
