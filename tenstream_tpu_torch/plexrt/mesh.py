"""Structured extruded-triangle grid for the wedge solver (port of
`tenstream_tpu/plexrt/mesh.py`; reference `plexrt/plex_grid.F90`).

Every rectangle of an Nx x Ny grid splits along its ll->ur diagonal into

  T0 (orientation 0): A=(0,0), B=(dx,0), C=(dx,dy)   (lower-right)
  T1 (orientation 1): the same triangle rotated 180 degrees

so T1's transfer coefficients are the canonical wedge table's at
phi + 180.  Side order: 0 = AB, 1 = BC, 2 = CA (the diagonal).  Side s of
T0(i, j) is side s of T1 at offset SIDE_OFFSETS[s] (periodic); side-face
fields live on the T0 owner, (..., 3, nx, ny), and every exchange is a
`torch.roll` (same sign as `jnp.roll`), or on a decomposed solve a halo
exchange of the rank's (x, y) block (`roll2_many`).

Cell fields: (nz, 2, nx, ny); z-face fields: (nz+1, 2, nx, ny).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

# roll offsets (di, dj) from a T0 cell to the T1 cell sharing side s
SIDE_OFFSETS: Tuple[Tuple[int, int], ...] = ((0, -1), (1, 0), (0, 0))


@dataclass(frozen=True)
class PlexGrid:
    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: np.ndarray  # (nz,) layer thickness, TOA -> surface, float32

    @classmethod
    def create(cls, nz, nx, ny, dx, dy, dz) -> "PlexGrid":
        dzv = np.broadcast_to(np.asarray(dz, np.float32), (nz,)).copy()
        return cls(nx=nx, ny=ny, nz=nz, dx=float(dx), dy=float(dy), dz=dzv)

    @property
    def area_tri(self) -> float:
        """Horizontal triangle area."""
        return 0.5 * self.dx * self.dy

    @property
    def side_lengths(self) -> Tuple[float, float, float]:
        return (self.dx, self.dy, float(np.hypot(self.dx, self.dy)))

    @property
    def ncell_horiz(self) -> int:
        return 2 * self.nx * self.ny

    def volumes(self) -> np.ndarray:
        """(nz, 1, 1, 1)-broadcastable cell volumes."""
        return (self.area_tri * self.dz)[:, None, None, None]

    def dz3d(self) -> np.ndarray:
        return np.broadcast_to(self.dz[:, None, None, None], (self.nz, 2, self.nx, self.ny)).copy()


def fish_mesh(nz, nx, ny, dx, dy, dz) -> PlexGrid:
    """The reference's regular test meshes (`plexrt/gen_fish_plex.F90`)."""
    return PlexGrid.create(nz, nx, ny, dx, dy, dz)


def roll2(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Roll the trailing (nx, ny) axes by (di, dj)."""
    if di:
        a = torch.roll(a, di, dims=-2)
    if dj:
        a = torch.roll(a, dj, dims=-1)
    return a


def roll2_many(items, pmesh=None):
    """`roll2` of each (a, di, dj) item.  With a `parallel.mesh.Mesh`, every
    a is this rank's block of a global field and every plane of the call
    goes in one halo exchange.  The side offsets (SIDE_OFFSETS) shift one
    axis at a time, so no corner (diagonal) value is ever exchanged."""
    if pmesh is None:
        return [roll2(a, di, dj) for a, di, dj in items]
    if any(di and dj for _, di, dj in items):
        raise ValueError("roll2_many on a mesh shifts one axis at a time")
    out = [a for a, _, _ in items]
    moved = [k for k, (_, di, dj) in enumerate(items) if di or dj]
    got = pmesh.roll_many([(items[k][0], items[k][1], -2) if items[k][1] else
                           (items[k][0], items[k][2], -1) for k in moved])
    for k, g in zip(moved, got):
        out[k] = g
    return out


def side_to_t1(arr: torch.Tensor, s: int) -> torch.Tensor:
    """Value stored on T0(i, j) side s, seen from its T1 partner."""
    di, dj = SIDE_OFFSETS[s]
    return roll2(arr, -di, -dj)


def side_from_t1(arr: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of `side_to_t1`: a T1-indexed field onto the T0 owner."""
    di, dj = SIDE_OFFSETS[s]
    return roll2(arr, di, dj)
