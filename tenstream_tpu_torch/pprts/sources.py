"""Thermal diffuse source assembly (port of `thermal_source` from
`tenstream_tpu/pprts/sources.py`; reference `set_thermal_source`,
`src/pprts.F90:4848-4989`).  The solar source lives in
`operators.dir2diff_source` / `direct_surface_reflection`.

All sources are in [W] (face-area scaled), the solve's units.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tenstream_tpu_torch.core.types import PI
from tenstream_tpu_torch.ops.planck import b_eff
from tenstream_tpu_torch.pprts.operators import diff_dst_sums, scatter_diff_dst
from tenstream_tpu_torch.streams import StreamScheme


def thermal_source(
    scheme: StreamScheme,
    diff2diff,  # OrbitCoeff or ([B,] ndiff, ndiff, Nz, Nx, Ny)
    planck: torch.Tensor,  # ([B,] Nz+1, Nx, Ny) [W/m2/sr]
    kabs: torch.Tensor,  # ([B,] Nz, Nx, Ny)
    dz3d: torch.Tensor,
    dx: float,
    dy: float,
    albedo2d: torch.Tensor,
    l1d: np.ndarray,  # (Nz,) bool, host
    planck_srfc: Optional[torch.Tensor] = None,
    collapse_btop: Optional[torch.Tensor] = None,  # ([B,] Nx, Ny) [W/m2/sr]
    collapse_bbot: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Thermal emission source b [W], shape ([B,] ndiff, Nz+1, Nx, Ny).
    With `collapse_btop/bbot`, layer 0 is an atm-collapse super-layer
    whose folded emission (emissivity included) replaces the top dofs'
    layer-0 rows.  With a `mesh` the fields are this rank's block."""
    tauz = kabs * dz3d
    b0 = planck[..., :-1, :, :]
    b1 = planck[..., 1:, :, :]
    btop = b_eff(b1, b0, tauz)
    bbot = b_eff(b0, b1, tauz)

    az = dx * dy / scheme.difftop.area_divider
    ax = dy * dz3d / scheme.diffside.area_divider
    ay = dx * dz3d / scheme.diffside.area_divider

    inward = scheme.diff_inward()
    ntop, nside = scheme.difftop.dof, scheme.diffside.dof
    l1d_mask = torch.as_tensor(np.asarray(l1d, bool), device=planck.device)[:, None, None]

    # per-dof emissivity from the coefficient row sums (reciprocity)
    emis = torch.clamp(1.0 - diff_dst_sums(diff2diff), 0.0, 1.0)

    wtop = scheme.difftop_weights()
    wside = scheme.diffside_weights()
    ftop = scheme.diffside_bsrc_top()
    rows = []
    for d in range(scheme.ndiff):
        e_d = emis[..., d, :, :, :]
        if d < ntop:
            bfac = PI * az * float(wtop[d])
            val = (bbot if inward[d] else btop) * bfac * e_d
            if collapse_btop is not None:
                val = val.clone()
                val[..., 0, :, :] = (collapse_bbot if inward[d] else collapse_btop) * bfac
        else:
            side_pos = (d - ntop) % nside
            area = ax if d < ntop + nside else ay
            bfac = PI * area * float(wside[side_pos])
            f = float(ftop[side_pos])
            bsrc = bbot * (1.0 - f) + btop * f
            val = bsrc * bfac * e_d
            val = torch.where(l1d_mask, torch.zeros_like(val), val)  # no side emission in 1-D layers
        rows.append(val)
    b = scatter_diff_dst(scheme, torch.stack(rows, dim=-4), mesh)

    # surface emission into the upward dofs
    bsrfc = planck[..., -1, :, :] if planck_srfc is None else planck_srfc
    for d in range(ntop):
        if not inward[d]:
            b[..., d, -1, :, :] += (bsrfc * (dx * dy / scheme.difftop.area_divider)
                                    * (1.0 - albedo2d) * PI * float(wtop[d]))
    return b
