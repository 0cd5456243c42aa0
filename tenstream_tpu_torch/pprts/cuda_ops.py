"""The diffuse-solve kernels K1, K2 and K3, hand-written in CUDA for
Hopper, with their plain PyTorch versions beside them (port of
`tenstream_tpu/pprts/pallas_ops.py`).

K1 `fused_A_dots` replaces `pallas_ops.py::_fused_A_kernel`: A(u) =
u - S(u) on the orbit channels (face<->cell shifts, surface albedo
closure) plus dot(w, Au) and dot(Au, Au), in one pass.  BiCGStab applies
it twice per iteration.

K2 `orbit_contract` replaces `pallas_ops.py::_contract_kernel`: the
per-cell orbit contraction contrib[d] = sum over orbit groups of
orb[o] * sum(src[s in group]).  Placed between `gather_diff_src` and
`scatter_diff_dst` it forms S(x) for the Richardson polish.

K3 `diffuse_apply_dense` replaces `pallas_ops.py::_kernel`
(`diffuse_apply_pallas`): S(x) without the surface closure on the dense
(src, dst) coefficient field, which buildings and
`pprts_orbit_coeffs=False` force; the coefficients may be bfloat16,
products and sums are float32.  BiCGStab and Richardson both apply it on
dense coefficients.

All take a leading batch dim B (K1 returns per-batch dots), and are built
for the 3_10 scheme's 10 diffuse dofs (the plain versions take any
scheme).  A wrapper
runs the plain version only because its tensors lie on the CPU; on a CUDA
tensor it launches the kernel (or raises) -- there is no fallback.  Each
launch adds one to `LAUNCHES[name]`.

The CUDA sources are `tenstream_tpu_torch/csrc/{orbit_ops.cu,
dense_ops.cu, boxmc_ops.cu, bind.cpp}`, built at first use with
`torch.utils.cpp_extension.load` into `tenstream_tpu_torch/_build/`
(sm_90a).  The same extension holds K4, the BoxMC photon tracer, whose
wrapper is `tenstream_tpu_torch/boxmc/cuda_tracer.py::boxmc_trace`; its
launches are counted here too.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.pprts.operators import (
    gather_diff_src,
    orbit_contract_groups,
    orbit_groups,
    scatter_diff_dst,
    surface_closure_rows,
)
from tenstream_tpu_torch.streams import StreamScheme

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("orbit_ops.cu", "dense_ops.cu", "boxmc_ops.cu", "bind.cpp")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]

# kernel name -> launches since the last reset (see reset_launch_counts)
LAUNCHES: Dict[str, int] = {"fused_A_dots": 0, "orbit_contract": 0, "diffuse_apply_dense": 0,
                            "boxmc_trace": 0}

_TS_MAXD = 10
_TS_MAXC = 5


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def load_extension(verbose: bool = False):
    """Build (once per process) and load the kernels' extension."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    return load(
        name="tenstream_torch_kernels",
        sources=[os.path.join(CSRC, s) for s in SOURCES],
        build_directory=BUILD_DIR,
        extra_cflags=["-O2"],
        extra_cuda_cflags=CUDA_FLAGS,
        extra_include_paths=[CSRC],
        verbose=verbose,
    )


def _shift_tables(scheme: StreamScheme):
    """Per dof (z, x, y): dst d is produced by cell face + cshift[d];
    src s is read at face cell + gshift[s]."""
    axis = scheme.diff_axis()
    inward = scheme.diff_inward()
    cshift, gshift = [], []
    for d in range(scheme.ndiff):
        a, inw = int(axis[d]), bool(inward[d])
        c = [0, 0, 0]
        g = [0, 0, 0]
        if inw:
            c[a] = -1
        else:
            g[a] = 1
        cshift.append(tuple(c))
        gshift.append(tuple(g))
    return tuple(cshift), tuple(gshift)


@functools.lru_cache(maxsize=None)
def _tables_cached(scheme: StreamScheme, idx_bytes: bytes, norb: int):
    nd = scheme.ndiff
    if nd != _TS_MAXD:
        raise ValueError(f"the kernels are built for the 3_10 scheme ({_TS_MAXD} diffuse "
                         f"dofs); scheme {scheme.name} has {nd}")
    idx = np.frombuffer(idx_bytes, np.int64).reshape(nd, nd)
    groups = orbit_groups(idx)
    cshift, gshift = _shift_tables(scheme)
    classes = sorted(set(cshift))
    D, C = _TS_MAXD, _TS_MAXC
    ngroups = [0] * D
    gorb = [[0] * D for _ in range(D)]
    gmask = [[0] * D for _ in range(D)]
    for d in range(nd):
        ngroups[d] = len(groups[d])
        for g, (o, ss) in enumerate(groups[d]):
            gorb[d][g] = o
            gmask[d][g] = sum(1 << s for s in ss)
    gz = [0] * D
    gx = [0] * D
    gy = [0] * D
    for s in range(nd):
        gz[s], gx[s], gy[s] = gshift[s]
    ccz, ccx, ccy, cmask = [0] * C, [0] * C, [0] * C, [0] * C
    for c, sh in enumerate(classes):
        ccz[c], ccx[c], ccy[c] = sh
        cmask[c] = sum(1 << d for d in range(nd) if cshift[d] == sh)
    dn, up = surface_closure_rows(scheme)
    walb = [0.0] * D
    for d, w in up:
        walb[d] = w
    itab = ([nd, norb, len(classes)] + ngroups + sum(gorb, []) + sum(gmask, [])
            + gz + gx + gy + ccz + ccx + ccy + cmask + [sum(1 << d for d in dn)])
    return itab, walb


def _tables(scheme: StreamScheme, idx: np.ndarray, norb: int):
    return _tables_cached(scheme, np.ascontiguousarray(idx, np.int64).tobytes(), int(norb))


def _require_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}; all inputs must be on CUDA")


# ---------------------------------------------------------------------------
# K2: orbit contraction
# ---------------------------------------------------------------------------


def orbit_contract_plain(idx: np.ndarray, orb: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: src (B, nd, Nz, Nx, Ny), orb (B, norb, Nz, Nx, Ny)."""
    return orbit_contract_groups(orbit_groups(np.asarray(idx)), orb, src)


def orbit_contract(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """K2: contrib (B, nd, Nz, Nx, Ny) from src (B, nd, ...) and the orbit
    field orb (B, norb, ...)."""
    if src.device.type == "cpu" and orb.device.type == "cpu":
        return orbit_contract_plain(idx, orb, src)
    _require_cuda(src, orb)
    itab, ftab = _tables(scheme, idx, orb.shape[1])
    out = load_extension().orbit_contract(src, orb, itab, ftab)
    LAUNCHES["orbit_contract"] += 1
    return out


def diffuse_apply_orbit(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                        x: torch.Tensor, albedo2d: torch.Tensor) -> torch.Tensor:
    """S(x) for one unbatched field x (nd, Nz+1, Nx, Ny): gather -> K2 ->
    scatter, plus the surface closure (`ediff._make_apply`'s orbit path)."""
    from tenstream_tpu_torch.pprts.operators import add_surface_reflection

    src = gather_diff_src(scheme, x)
    contrib = orbit_contract(scheme, idx, orb[None], src[None])[0]
    out = scatter_diff_dst(scheme, contrib)
    return add_surface_reflection(scheme, out, x, albedo2d)


# ---------------------------------------------------------------------------
# K1: fused A(u) + dots
# ---------------------------------------------------------------------------


def fused_A_dots_plain(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                       u: torch.Tensor, w: torch.Tensor,
                       albedo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: u, w (B, nd, Nz+1, Nx, Ny); orb (B, norb, Nz, Nx,
    Ny); albedo (B, Nx, Ny) -> (Au, dots (B, 2))."""
    src = gather_diff_src(scheme, u)
    S = scatter_diff_dst(scheme, orbit_contract_plain(idx, orb, src))
    dn, up = surface_closure_rows(scheme)
    edn = sum(u[:, d, -1] for d in dn)
    for d, wt in up:
        S[:, d, -1] += albedo * edn * wt
    Au = u - S
    dims = tuple(range(1, u.dim()))
    dots = torch.stack([(w * Au).sum(dim=dims), (Au * Au).sum(dim=dims)], dim=1)
    return Au, dots


def fused_A_dots(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                 u: torch.Tensor, w: torch.Tensor,
                 albedo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (A(u), dots) with dots[b] = (dot(w[b], Au[b]), dot(Au[b], Au[b]))."""
    if all(t.device.type == "cpu" for t in (u, w, orb, albedo)):
        return fused_A_dots_plain(scheme, idx, orb, u, w, albedo)
    _require_cuda(u, w, orb, albedo)
    itab, ftab = _tables(scheme, idx, orb.shape[1])
    Au, dots = load_extension().fused_A_dots(u, w, orb, albedo, itab, ftab)
    LAUNCHES["fused_A_dots"] += 1
    return Au, dots


# ---------------------------------------------------------------------------
# K3: S(x) on dense coefficients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dense_tables(scheme: StreamScheme):
    """[nd] + gz + gx + gy + cz + cx + cy: src s is read at cell + g*[s],
    dst d is produced by the cell face + c*[d]."""
    nd = scheme.ndiff
    if nd != _TS_MAXD:
        raise ValueError(f"the kernels are built for the 3_10 scheme ({_TS_MAXD} diffuse "
                         f"dofs); scheme {scheme.name} has {nd}")
    cshift, gshift = _shift_tables(scheme)
    return [nd] + [sh[a][q] for sh in (gshift, cshift) for q in range(3) for a in range(nd)]


def diffuse_apply_dense_plain(scheme: StreamScheme, coeff: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: coeff (B, nd, nd, Nz, Nx, Ny) [src, dst] in
    float32 or bfloat16, x (B, nd, Nz+1, Nx, Ny) -> S(x) without the
    surface closure, float32."""
    contrib = torch.einsum("bsdkij,bskij->bdkij", coeff.float(), gather_diff_src(scheme, x))
    return scatter_diff_dst(scheme, contrib)


def diffuse_apply_dense(scheme: StreamScheme, coeff: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """K3: S(x) without the surface closure, for dst d at a face
    sum_s coeff[s, d, cell] * x[s, cell + gshift[s]], cell = face +
    cshift[d]; periodic in x and y, zero beyond z."""
    if coeff.device.type == "cpu" and x.device.type == "cpu":
        return diffuse_apply_dense_plain(scheme, coeff, x)
    _require_cuda(coeff, x)
    out = load_extension().diffuse_apply_dense(x, coeff, _dense_tables(scheme))
    LAUNCHES["diffuse_apply_dense"] += 1
    return out
