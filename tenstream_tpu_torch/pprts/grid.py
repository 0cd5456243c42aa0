"""Regular-grid description (port of `tenstream_tpu/pprts/grid.py`).

Layouts: cell fields (Nz, Nx, Ny); level fields (Nz+1, Nx, Ny); stream
fields (ndof, Nz+1, Nx, Ny), face-indexed; coefficient fields (nsrc,
ndst, Nz, Nx, Ny).  x and y are periodic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tenstream_tpu_torch.core.types import ireals


@dataclass(frozen=True)
class Grid:
    nz: int
    nx: int
    ny: int
    dx: float
    dy: float
    dz: torch.Tensor  # (Nz,) or (Nz, Nx, Ny)

    @staticmethod
    def create(nz: int, nx: int, ny: int, dx: float, dy: float, dz,
               device="cuda") -> "Grid":
        if isinstance(dz, (int, float)):
            dz = torch.full((nz,), float(dz), dtype=ireals, device=device)
        dz = torch.as_tensor(dz, dtype=ireals, device=device)
        if dz.shape[0] != nz:
            raise ValueError(f"dz first dim {tuple(dz.shape)} != nz {nz}")
        return Grid(nz, nx, ny, float(dx), float(dy), dz)

    @property
    def device(self) -> torch.device:
        return self.dz.device

    @property
    def dz3d(self) -> torch.Tensor:
        """(Nz, Nx, Ny) layer thickness."""
        if self.dz.dim() == 1:
            return self.dz[:, None, None].expand(self.nz, self.nx, self.ny)
        return self.dz

    @property
    def az(self) -> float:
        return self.dx * self.dy

    def volumes(self) -> torch.Tensor:
        return self.dz3d * self.az
