"""Geometric direct-transfer coefficients for terrain-following cells
(port of `tenstream_tpu/pprts/geometric.py`; reference
`src/geometric_coeffs.F90`, enabled by `-pprts_geometric_coeffs`,
`src/pprts.F90:3037-3060`).

The Monte-Carlo LUT is built for right cuboids; over terrain the top and
bottom faces of a cell tilt and the LUT misplaces the direct beam.  Each
upwind face is covered by a fixed S x S quadrature grid; every sample
marches along the beam to the first exit plane (downwind x / y side,
tilted bottom, tilted top) and contributes exp(-kext * path length) to
that destination.  No data-dependent control flow: the same work for
every cell, all of it vectorised.

Cells: vertical side faces on the regular (dx, dy) raster; top and
bottom faces are planes fitted through the four corner heights, which
average the four neighbouring column interface heights (periodic).
"""

from __future__ import annotations

from typing import Optional

import torch

from tenstream_tpu_torch.core.types import ireals
from tenstream_tpu_torch.pprts.operators import roll_xy

_BIG = 1e30


def corner_heights(zlev3d: torch.Tensor, mesh=None) -> tuple:
    """(z00, z10, z01, z11) corner heights per column interface.

    zlev3d (nz+1, nx, ny) column-centre interface heights; corner (a, b)
    of column (i, j) sits between columns {i-1+a, i+a} x {j-1+b, j+b}.
    With a `mesh`, zlev3d is this rank's block."""
    z = zlev3d

    def avg(si, sj):
        zx = roll_xy(z, si, -2, mesh)
        return 0.25 * (z + zx + roll_xy(z, sj, -1, mesh) + roll_xy(zx, sj, -1, mesh))

    return avg(1, 1), avg(-1, 1), avg(1, -1), avg(-1, -1)


def _plane(z00, z10, z01, z11, dx, dy):
    """Least-squares plane z = c + gx * x + gy * y through 4 corners."""
    gx = ((z10 + z11) - (z00 + z01)) / (2.0 * dx)
    gy = ((z01 + z11) - (z00 + z10)) / (2.0 * dy)
    c = 0.25 * (z00 + z10 + z01 + z11) - gx * (0.5 * dx) - gy * (0.5 * dy)
    return c, gx, gy


def dir2dir_geometric(zlev3d: torch.Tensor, dx: float, dy: float, sundir,
                      kext: torch.Tensor, nsamp: int = 6, mesh=None) -> torch.Tensor:
    """([B,] 3, 3, nz, nx, ny) dense dir2dir blocks [src, dst] in the
    solver's dof order (0: z-faces, 1: x-faces, 2: y-faces).

    zlev3d (nz+1, nx, ny) interface heights [m], TOA -> surface; sundir
    (3,) the photon travel direction (downward: z < 0); kext ([B,] nz,
    nx, ny) extinction [1/m].  The geometry does not depend on the lane:
    only the attenuation carries the lane dim B.  With a `mesh` the fields
    are this rank's block."""
    dev = kext.device
    zlev3d = torch.as_tensor(zlev3d, dtype=ireals, device=dev)
    s = torch.as_tensor(sundir, dtype=ireals, device=dev)
    s = s / torch.linalg.vector_norm(s)
    sx, sy, sz = s[0], s[1], s[2]
    # the upwind x-face is at x = 0 when the beam travels +x
    x_in = 0.0 if float(sx) >= 0 else dx
    x_out = dx - x_in
    y_in = 0.0 if float(sy) >= 0 else dy
    y_out = dy - y_in

    z00, z10, z01, z11 = corner_heights(zlev3d, mesh)
    ct, gxt, gyt = _plane(z00[:-1], z10[:-1], z01[:-1], z11[:-1], dx, dy)
    cb, gxb, gyb = _plane(z00[1:], z10[1:], z01[1:], z11[1:], dx, dy)

    # quadrature offsets: the cell midpoints of an S x S grid
    q = (torch.arange(nsamp, dtype=ireals, device=dev) + 0.5) / nsamp
    qu, qv = torch.meshgrid(q, q, indexing="ij")
    qu = qu.reshape(-1, 1, 1, 1)  # (S2, 1, 1, 1)
    qv = qv.reshape(-1, 1, 1, 1)
    big = torch.tensor(_BIG, dtype=ireals, device=dev)

    def march(px, py, pz):
        """The attenuated contributions ([B,] 4, nz, nx, ny) to dst
        [bottom, x_out, y_out, top] of the samples at (px, py, pz),
        averaged over the samples."""
        tx = torch.where(sx.abs() > 1e-9, (x_out - px) / sx, big)
        ty = torch.where(sy.abs() > 1e-9, (y_out - py) / sy, big)

        def plane_hit(c, gx, gy):
            den = sz - gx * sx - gy * sy
            num = c + gx * px + gy * py - pz
            t = num / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
            return torch.where(t > 1e-9, t, big)

        tb, tt = plane_hit(cb, gxb, gyb), plane_hit(ct, gxt, gyt)
        ts = torch.stack(torch.broadcast_tensors(tb, torch.clamp(tx, min=0.0),
                                                 torch.clamp(ty, min=0.0), tt))
        ts = torch.where(ts <= 1e-9, big, ts)
        tmin, dst = ts.min(dim=0)  # (S2, nz, nx, ny): first minimum, as argmin
        att = torch.exp(-kext.unsqueeze(-4) * tmin)  # ([B,] S2, nz, nx, ny)
        zero = torch.zeros((), dtype=ireals, device=dev)
        return torch.stack([torch.where(dst == k, att, zero).mean(dim=-4) for k in range(4)],
                           dim=-4)

    # src 0: the top face
    px, py = qu * dx, qv * dy
    pz = ct[None] + gxt[None] * px + gyt[None] * py - 1e-6
    w_top = march(px, py, pz)

    # src 1: the upwind x-face
    sign_x = 1.0 if float(sx) > 0 else (-1.0 if float(sx) < 0 else 0.0)
    px = torch.full((1, 1, 1, 1), x_in, dtype=ireals, device=dev) + sign_x * 1e-6 + 0.0 * qu
    py = qu * dy
    zt = ct[None] + gxt[None] * px + gyt[None] * py
    zb = cb[None] + gxb[None] * px + gyb[None] * py
    w_x = march(px, py, zb + qv * (zt - zb))

    # src 2: the upwind y-face
    sign_y = 1.0 if float(sy) > 0 else (-1.0 if float(sy) < 0 else 0.0)
    py = torch.full((1, 1, 1, 1), y_in, dtype=ireals, device=dev) + sign_y * 1e-6 + 0.0 * qu
    px = qu * dx
    zt = ct[None] + gxt[None] * px + gyt[None] * py
    zb = cb[None] + gxb[None] * px + gyb[None] * py
    w_y = march(px, py, zb + qv * (zt - zb))

    # dst order (z, x, y); power leaving through the tilted top is dropped,
    # as the LUT drops it
    return torch.stack([w[..., :3, :, :, :] for w in (w_top, w_x, w_y)], dim=-5)


def zlev_from_dz(dz3d: torch.Tensor, h_srfc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nz+1, nx, ny) interface heights from the layer thicknesses over an
    optional terrain height field (nx, ny)."""
    nz, nx, ny = dz3d.shape
    h = (torch.zeros((nx, ny), dtype=ireals, device=dz3d.device) if h_srfc is None
         else torch.as_tensor(h_srfc, dtype=ireals, device=dz3d.device))
    above = torch.flip(torch.cumsum(torch.flip(dz3d, [0]), dim=0), [0])  # height above surface
    return torch.cat([h[None] + above, h[None]], dim=0)
