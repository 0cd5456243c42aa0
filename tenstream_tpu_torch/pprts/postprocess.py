"""Post-processing: surface-flux smoothing and the terrain slope
correction (port of `tenstream_tpu/pprts/postprocess.py`; reference
`src/pprts_postprocess.F90`: `smooth_surface_fluxes`:44 and
`slope_correction_fluxes`:131)."""

from __future__ import annotations

import torch

from tenstream_tpu_torch.core.types import ireals


def convolve_srfc_5pt(field: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Iterated 5-point (von Neumann) smoothing with periodic wrap of a
    (..., Nx, Ny) field (reference `dmda_convolve_ediff_srfc`)."""
    f = torch.as_tensor(field, dtype=ireals)
    for _ in range(iterations):
        f = 0.2 * (f + torch.roll(f, 1, dims=-2) + torch.roll(f, -1, dims=-2)
                   + torch.roll(f, 1, dims=-1) + torch.roll(f, -1, dims=-1))
    return f


def slope_correction_srfc_edir(edir_srfc: torch.Tensor, hgrad_x, hgrad_y,
                               sundir) -> torch.Tensor:
    """The surface direct flux scaled by the local terrain orientation:
    max(0, cos(sun, surface normal)) / cos(sun, z).  `sundir` is the
    photon travel direction (pointing down); hgrad_x / hgrad_y (Nx, Ny)
    the surface height gradients."""
    edir_srfc = torch.as_tensor(edir_srfc, dtype=ireals)
    t = lambda a: torch.as_tensor(a, dtype=ireals, device=edir_srfc.device)
    sx, sy, sz = (float(sundir[0]), float(sundir[1]), float(sundir[2]))
    nx, ny = -t(hgrad_x), -t(hgrad_y)  # the unnormalised normal (-dh/dx, -dh/dy, 1)
    norm = torch.sqrt(nx * nx + ny * ny + 1.0)
    cos_tilt = torch.clamp((-(sx * nx + sy * ny + sz)) / norm, min=0.0)
    cos_flat = max(-sz, 1e-6)
    return edir_srfc * cos_tilt / cos_flat
