"""No-scattering thermal radiance integration, the Schwarzschild equation
(port of `tenstream_tpu/ops/schwarzschild.py`; reference
`src/schwarzschild.F90:81-171`).

Downward and upward radiances are integrated over nmu Gauss-Legendre
angles and accumulated into fluxes.  Every column solves at once through
trailing batch dimensions; the JAX package's `lax.scan` over z is a loop
over the layers here, the upward pass running from the surface up.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.types import PI, ireals
from tenstream_tpu_torch.ops.planck import gauss_legendre_01, schwarzschild_radiance_step


def schwarzschild(dtau: torch.Tensor, albedo, planck: torch.Tensor, nmu: int = 2,
                  srfc_emission: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thermal fluxes for all columns.

    dtau: (Nz, *batch) absorption optical depth per layer; albedo: scalar
    or (*batch,); planck: (Nz+1, *batch) Planck radiance at the levels
    [W/m2/sr]; nmu Gauss angles; srfc_emission: optional surface Planck
    override.  Returns (Edn, Eup), each (Nz+1, *batch) [W/m2]."""
    dev = dtau.device
    dtau = dtau.to(ireals)
    planck = torch.as_tensor(planck, dtype=ireals, device=dev)
    nz = dtau.shape[0]
    batch = tuple(dtau.shape[1:])
    bc = lambda v: torch.broadcast_to(torch.as_tensor(v, dtype=ireals, device=dev), batch)
    albedo = bc(albedo)
    bsrfc = planck[-1] if srfc_emission is None else bc(srfc_emission)
    pts, wts = gauss_legendre_01(nmu)
    f32 = lambda v: float(np.float32(v))

    Edn = torch.zeros((nz + 1,) + batch, dtype=ireals, device=dev)
    for mu, w in zip(pts, wts):
        L = torch.zeros(batch, dtype=ireals, device=dev)
        for k in range(nz):
            L = schwarzschild_radiance_step(L, dtau[k] / f32(mu), planck[k], planck[k + 1])
            Edn[k + 1] += L * f32(mu * w)

    # surface boundary radiance: emission and the reflected downwelling
    # (reference :125)
    Eup = torch.zeros_like(Edn)
    Lup0 = bsrfc * (1.0 - albedo) + albedo * Edn[-1] * 2.0
    for mu, w in zip(pts, wts):
        L = Lup0
        for k in range(nz - 1, -1, -1):
            L = schwarzschild_radiance_step(L, dtau[k] / f32(mu), planck[k + 1], planck[k])
            Eup[k] += L * f32(mu * w)
        Eup[-1] += Lup0 * f32(mu * w)
    return Edn * 2.0 * PI, Eup * 2.0 * PI
