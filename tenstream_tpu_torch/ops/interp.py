"""N-D multilinear interpolation over rectilinear grids (port of
`tenstream_tpu/ops/interp.py`: `fractional_index`,
`interp_multilinear_cf` and the values of
`interp_4d_layered_onehot_cf`).

All lookups are channels-FIRST: a table (n0, ..., n_{k-1}, C...) looked
up at fractional indices of batch shape B gives C... + B.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tenstream_tpu_torch.core.types import TINY, ireals


def fractional_index(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fractional index of x in a sorted 1-D grid, clipped to the range
    (reference `find_real_location`)."""
    n = grid.shape[0]
    x = torch.clamp(x, grid[0], grid[-1])
    i = torch.searchsorted(grid, x.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, n - 2)
    g0 = grid[i]
    g1 = grid[i + 1]
    frac = (x - g0) / torch.clamp(g1 - g0, min=TINY)
    frac = torch.clamp(frac, 0.0, 1.0)
    return i.to(ireals) + frac


def _floor_weight(f: torch.Tensor, n: int):
    i = torch.clamp(torch.floor(f), 0, n - 2).to(torch.int64)
    return i, f.to(ireals) - i.to(ireals)


def interp_multilinear_cf(table: torch.Tensor, fracs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Multilinear interpolation by 2^k corner gathers, channels-first.

    The corners accumulate one by one in the JAX package's corner order
    (`_accumulate_gathers`): one corner's gather buffer and the sum are the
    only batch-sized payload temporaries, whatever k is."""
    k = len(fracs)
    dims = table.shape[:k]
    C = tuple(table.shape[k:])
    flat_t = table.reshape((-1, int(np.prod(C)) if C else 1)).t()  # (nC, N)
    i0, w1 = zip(*[_floor_weight(f, dims[d]) for d, f in enumerate(fracs)])
    strides = [int(np.prod(dims[d + 1:])) for d in range(k)]
    B = tuple(torch.broadcast_shapes(*[f.shape for f in fracs]))
    base = sum(i0[d] * strides[d] for d in range(k))
    base = torch.broadcast_to(base, B).reshape(-1)
    out = buf = None
    for corner in range(1 << k):
        off = 0
        w = None
        for d in range(k):
            hi = (corner >> d) & 1
            off += hi * strides[d]
            wd = w1[d] if hi else (1.0 - w1[d])
            w = wd if w is None else w * wd
        w = torch.broadcast_to(w, B).reshape(-1)
        idx = base + off if off else base
        if out is None:
            out = torch.index_select(flat_t, 1, idx).mul_(w)
        else:
            buf = torch.index_select(flat_t, 1, idx, out=buf).mul_(w)
            out.add_(buf)
    return out.reshape(C + B)


def _onehot_pair(f: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) interpolation matrix: (1-w) at floor(f), w at floor(f)+1."""
    i, w = _floor_weight(f, n)
    ar = torch.arange(n, device=f.device)
    lo = (i[..., None] == ar).to(ireals)
    hi = (i[..., None] + 1 == ar).to(ireals)
    return lo * (1.0 - w)[..., None] + hi * w[..., None]


def interp_4d_layered_onehot_cf(
    table: torch.Tensor,
    f0: torch.Tensor,
    f1: torch.Tensor,
    f2_layer: torch.Tensor,
    f3: torch.Tensor,
) -> torch.Tensor:
    """4-D multilinear interpolation when axis 2 (aspect) is constant per
    z-layer: per layer, blend the aspect axis, contract a (cells,
    n0*n1) 4-nonzero bilinear weight matrix against the layer table
    (a float32 matmul; TF32 is off package-wide), then blend g per cell.
    Same values as `interp_multilinear_cf`, another summation order.

    f0, f1, f3: (nz, nx, ny); f2_layer: (nz,).  Returns C + (nz, nx, ny).
    """
    n0, n1, n2, n3 = table.shape[:4]
    C = tuple(table.shape[4:])
    nz, nx, ny = torch.broadcast_shapes(f0.shape, f1.shape, f3.shape)
    Bc = nx * ny
    nC = int(np.prod(C)) if C else 1

    i2, w2 = _floor_weight(f2_layer, n2)
    tl = table[:, :, i2].movedim(2, 0)  # (nz, n0, n1, n3, C...)
    th = table[:, :, i2 + 1].movedim(2, 0)
    w2b = w2.reshape((nz,) + (1,) * (tl.dim() - 1)).to(table.dtype)
    tbl = (tl * (1.0 - w2b) + th * w2b).reshape(nz, n0 * n1, n3 * nC)

    fB = lambda f: torch.broadcast_to(f, (nz, nx, ny)).reshape(nz, Bc)
    ft, fw, fg = fB(f0), fB(f1), fB(f3)
    out = torch.empty((nC, nz, Bc), dtype=ireals, device=table.device)
    for k in range(nz):
        oh0 = _onehot_pair(ft[k], n0)
        oh1 = _onehot_pair(fw[k], n1)
        W = (oh0[:, :, None] * oh1[:, None, :]).reshape(Bc, n0 * n1)
        o = (W @ tbl[k]).reshape(Bc, n3, nC)
        oh3 = _onehot_pair(fg[k], n3)
        out[:, k] = torch.einsum("bg,bgc->cb", oh3, o)
    return out.reshape(C + (nz, nx, ny))
