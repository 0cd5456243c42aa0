"""Delta-Eddington two-stream column solver, batched over columns (port of
`tenstream_tpu/ops/twostream.py`; reference `src/twostream.F90:50-184`).

The block-tridiagonal system of interleaved (Eup, Edn) levels is solved
exactly by an O(Nz) backward elimination and forward substitution (the
JAX package's two `lax.scan`s are Python loops over the layers here).  All
operations carry trailing batch dimensions, so the whole (Nx, Ny) grid of
columns solves at once.

System per column (k = 0..Nz-1 layers, levels 0..Nz):
    Edn[0]    = 0
    Eup[k]    = a11[k] Eup[k+1] + a12[k] Edn[k]   + b_up[k]
    Edn[k+1]  = a11[k] Edn[k]   + a12[k] Eup[k+1] + b_dn[k]
    Eup[Nz]   = albedo Edn[Nz] + b_sfc
with solar sources b_up = S a13, b_dn = S a23 and thermal sources from
B_eff emission.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tenstream_tpu_torch.core.types import PI, ireals
from tenstream_tpu_torch.ops.eddington import eddington_coeff_ec
from tenstream_tpu_torch.ops.planck import b_eff


def delta_eddington_twostream(
    dtau: torch.Tensor,
    w0: torch.Tensor,
    g: torch.Tensor,
    mu0,
    incSolar,
    albedo,
    planck=None,
    planck_srfc=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve the two-stream system for all columns at once.

    dtau, w0, g: (Nz, *batch) layer optical properties; mu0, incSolar
    (direct irradiance on the tilted plane at TOA), albedo: scalars or
    (*batch,); planck: optional (Nz+1, *batch) Planck radiance at levels;
    planck_srfc: optional (*batch,) surface override.  Returns (S, Edn,
    Eup), each (Nz+1, *batch); S is the direct beam."""
    dev = dtau.device
    nz = dtau.shape[0]
    batch = tuple(dtau.shape[1:])
    bc = lambda v: torch.broadcast_to(torch.as_tensor(v, dtype=ireals, device=dev), batch)
    mu0, incSolar, albedo = bc(mu0), bc(incSolar), bc(albedo)

    a11, a12, a13, a23, a33 = eddington_coeff_ec(dtau, w0, g, mu0[None])

    # direct beam: S[k+1] = S[k] * a33[k]
    S = torch.cat([torch.ones((1,) + batch, dtype=ireals, device=dev),
                   torch.cumprod(a33, dim=0)], dim=0)
    S = S * torch.where(mu0 > 0, incSolar, torch.zeros_like(incSolar))[None]

    b_up = S[:-1] * a13
    b_dn = S[:-1] * a23
    b_sfc = S[-1] * albedo

    if planck is not None:
        emis = torch.clamp(1.0 - a11 - a12, 0.0, 1.0) * PI
        b_up = b_up + emis * b_eff(planck[1:], planck[:-1], dtau)
        b_dn = b_dn + emis * b_eff(planck[:-1], planck[1:], dtau)
        srfc_B = planck[-1] if planck_srfc is None else bc(planck_srfc)
        b_sfc = b_sfc + srfc_B * (1.0 - albedo) * PI

    # backward elimination: Eup[k] = R[k] Edn[k] + Q[k]
    R = [None] * (nz + 1)
    Q = [None] * (nz + 1)
    D = [None] * nz
    R[nz], Q[nz] = albedo, b_sfc
    for k in range(nz - 1, -1, -1):
        D[k] = 1.0 - a12[k] * R[k + 1]
        R[k] = a12[k] + a11[k] * a11[k] * R[k + 1] / D[k]
        Q[k] = a11[k] * R[k + 1] * (a12[k] * Q[k + 1] + b_dn[k]) / D[k] + a11[k] * Q[k + 1] + b_up[k]

    # forward substitution for Edn, then Eup = R Edn + Q
    edn = [torch.zeros(batch, dtype=ireals, device=dev)]
    for k in range(nz):
        edn.append((a11[k] * edn[k] + a12[k] * Q[k + 1] + b_dn[k]) / D[k])
    Edn = torch.stack(edn, 0)
    Eup = torch.stack(R, 0) * Edn + torch.stack(Q, 0)
    return S, Edn, Eup
