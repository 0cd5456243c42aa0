"""Absorption by coefficient divergence (port of `calc_flx_div` from
`tenstream_tpu/pprts/absorption.py`; reference `src/pprts.F90:5152-5509`).

Every unit of power entering a cell that no (src -> dst) coefficient
re-emits was absorbed:  abso = sum_src e_src * (1 - sum_dst c[src, dst]).
Thermal solves subtract the emitted source power; 1-D layers use the
Beer-Lambert form for the direct part.  The result is per cell volume.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tenstream_tpu_torch.pprts.operators import (
    diff_dst_sums,
    gather_diff_src,
    gather_dir_src,
    roll_rows,
)
from tenstream_tpu_torch.pprts.sun import SunInfo
from tenstream_tpu_torch.streams import StreamScheme


def gather_diff_dst(scheme: StreamScheme, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-cell view of what each cell deposited at its dst faces (the
    inverse of `scatter_diff_dst`): (..., ndiff, Nz+1, Nx, Ny) ->
    (..., ndiff, Nz, Nx, Ny)."""
    axis = scheme.diff_axis()
    inward = scheme.diff_inward()
    rows = {}
    shifted = ({}, {})  # inward side dofs: the next face along x / y
    for d in range(scheme.ndiff):
        v = b[..., d, :, :, :]
        if axis[d] == 0:
            rows[d] = v[..., 1:, :, :] if inward[d] else v[..., :-1, :, :]
        elif inward[d]:
            shifted[axis[d] - 1][d] = v[..., :-1, :, :]
        else:
            rows[d] = v[..., :-1, :, :]
    rows.update(roll_rows(shifted[0], -1, -2, mesh))
    rows.update(roll_rows(shifted[1], -1, -1, mesh))
    return torch.stack([rows[d] for d in range(scheme.ndiff)], dim=-4)


def _top_only(scheme_ntop: int, n: int, top: torch.Tensor) -> torch.Tensor:
    """(..., n, Nz, Nx, Ny): `top` (..., Nz, Nx, Ny) on the first
    scheme_ntop dofs, zero after."""
    t = top.unsqueeze(-4)
    lead, cells = tuple(top.shape[:-3]), tuple(top.shape[-3:])
    return torch.cat([t.expand(lead + (scheme_ntop,) + cells),
                      top.new_zeros(lead + (n - scheme_ntop,) + cells)], dim=-4)


def calc_flx_div(
    scheme: StreamScheme,
    diff2diff,
    ediff: torch.Tensor,  # ([B,] ndiff, Nz+1, Nx, Ny) [W]
    volumes: torch.Tensor,  # (Nz, Nx, Ny)
    l1d: np.ndarray,
    kabs: torch.Tensor,
    dz3d: torch.Tensor,
    a11: torch.Tensor,
    a12: torch.Tensor,
    sun: Optional[SunInfo] = None,
    edir: Optional[torch.Tensor] = None,  # [W]
    b_thermal: Optional[torch.Tensor] = None,  # [W]
    cdiv_dir: Optional[torch.Tensor] = None,  # (ndir, Nz, Nx, Ny)
    mesh=None,
) -> torch.Tensor:
    """Absorbed power per cell / volume -> [W/m3].

    `cdiv_dir` is the per-source direct coefficient divergence
    1 - sum_dst(dir2dir) - sum_dst(dir2diff), reduced before the diffuse
    solve so the direct coefficient fields can be freed first.  With a
    `mesh` the fields are this rank's block."""
    l1d_mask = torch.as_tensor(np.asarray(l1d, bool), device=ediff.device)[None, :, None, None]
    abso = torch.zeros(tuple(ediff.shape[:-4]) + tuple(volumes.shape), dtype=ediff.dtype,
                       device=ediff.device)

    if edir is not None and cdiv_dir is not None:
        src = gather_dir_src(scheme, edir, sun.xinc, sun.yinc, mesh)
        # 1-D layers: Beer-Lambert absorption of the direct beam for the
        # top streams, side streams carry nothing
        mu = max(float(sun.mu), 1e-6)
        bl = -torch.expm1(-kabs * dz3d / mu)
        cdiv = torch.where(l1d_mask, _top_only(scheme.dirtop.dof, scheme.ndir, bl), cdiv_dir)
        abso = abso + (src * cdiv).sum(dim=-4)

    src = gather_diff_src(scheme, ediff, mesh)
    cdiv = torch.clamp(1.0 - diff_dst_sums(diff2diff), 0.0, 1.0)
    cdiv_1d_top = torch.clamp(1.0 - a11 - a12, 0.0, 1.0)
    cdiv = torch.where(l1d_mask, _top_only(scheme.difftop.dof, scheme.ndiff, cdiv_1d_top), cdiv)
    abso = abso + (src * cdiv).sum(dim=-4)

    if b_thermal is not None:
        abso = abso - gather_diff_dst(scheme, b_thermal, mesh).sum(dim=-4)

    return abso / volumes
