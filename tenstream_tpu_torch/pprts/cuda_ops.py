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
dense coefficients.  It is 2.5-D blocked (sources staged once per block in
shared memory, coefficients in 16-byte vectors, writes in cell space) and
takes shift tables with gshift in {0, 1} and cshift in {-1, 0} only
(`_k3_shift_refusal`); `dense_launch_config` reports its blocks per SM.

All take a leading batch dim B (K1 returns per-batch dots), and are built
for the 10 diffuse dofs of 3_10 and 8_10 (the plain versions take any
scheme).  K1 is compiled for 3_10's orbit and shift tables, which 8_10
shares, and refuses a scheme whose tables differ: they are code
in `csrc/orbit_3_10.h`, which `orbit_header_text` generates from the same
Python tables the plain version uses, and `load_extension` refuses to build
from a header that differs from it.  A wrapper
runs the plain version only because its tensors lie on the CPU; on a CUDA
tensor it launches the kernel (or raises) -- there is no fallback.  Each
launch adds one to `LAUNCHES[name]`.

The CUDA sources are `tenstream_tpu_torch/csrc/{orbit_ops.cu,
dense_ops.cu, boxmc_ops.cu, bind.cpp}` and their headers, built at first
use with `torch.utils.cpp_extension.load` into
`tenstream_tpu_torch/_build/` (sm_90a).  The same extension holds K4, the
BoxMC photon tracer, whose wrapper is
`tenstream_tpu_torch/boxmc/cuda_tracer.py::boxmc_trace`; its launches are
counted here too.
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


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def load_extension(verbose: bool = False):
    """Build (once per process) and load the kernels' extension."""
    from torch.utils.cpp_extension import load

    _check_header()
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


HEADER_3_10 = "orbit_3_10.h"  # K1's compile-time tables, generated by orbit_header_text


@functools.lru_cache(maxsize=None)
def _k1_tables():
    """The 3_10 tables K1 is compiled for: (idx, norb, groups, cshift,
    gshift, dn, up)."""
    from tenstream_tpu_torch.optprop.facade import diff_pair_orbits
    from tenstream_tpu_torch.streams import get_scheme

    scheme = get_scheme("3_10")
    idx, norb = diff_pair_orbits(scheme, with_mz=False)
    idx = np.asarray(idx, np.int64)
    cshift, gshift = _shift_tables(scheme)
    dn, up = surface_closure_rows(scheme)
    return idx, int(norb), orbit_groups(idx), cshift, gshift, dn, up


def _ternary(name: str, var: str, vals) -> str:
    """A constexpr function of dof `var` returning vals[var] (0 where unlisted)."""
    expr = "".join(f"{var} == {q} ? {v} : " for q, v in enumerate(vals) if v != 0) + "0"
    return f"__host__ __device__ constexpr int {name}(int {var}) {{ return {expr}; }}"


def orbit_header_text() -> str:
    """The text of `csrc/orbit_3_10.h`: K1's orbit contraction, shifts and
    surface closure for the 3_10 scheme as compile-time code, generated from
    the same Python tables the plain version uses (`orbit_groups`,
    `_shift_tables`, `surface_closure_rows`), in the plain version's order
    of sums."""
    idx, norb, groups, cshift, gshift, dn, up = _k1_tables()
    nd = len(groups)
    lines = [
        "// K1's tables for the 3_10 scheme as compile-time code.  Generated by",
        "// tenstream_tpu_torch/pprts/cuda_ops.py::orbit_header_text from the tables of",
        "// the plain version (orbit_groups of diff_pair_orbits(3_10, with_mz=False),",
        "// _shift_tables, surface_closure_rows); do not edit: load_extension refuses",
        "// to build from a copy that differs from what they generate.",
        "#pragma once",
        "",
        f"#define K1_ND {nd}",
        f"#define K1_NORB {norb}",
        "",
        "// source s of a cell (k, i, j) is u[s] at face (k, i, j) + (k1_gz, k1_gx, k1_gy)(s)",
    ]
    for q, name in enumerate(("k1_gz", "k1_gx", "k1_gy")):
        lines.append(_ternary(name, "s", [g[q] for g in gshift]))
    lines.append("// dst d at face (k, i, j) is produced by the cell (k, i, j) + "
                 "(k1_cz, k1_cx, k1_cy)(d)")
    for q, name in enumerate(("k1_cz", "k1_cx", "k1_cy")):
        lines.append(_ternary(name, "d", [c[q] for c in cshift]))
    lines += [
        "// one cell's contributions: c[d] = sum over the orbit groups (o, ss) of dst d of",
        "// o(o) * (sum of s(src) over ss), groups in orbit order, as the plain version",
        "template <class O, class S>",
        "__device__ __forceinline__ void k1_contract(O o, S s, float* c) {",
    ]
    for d in range(nd):
        terms = []
        for o, ss in groups[d]:
            ssum = " + ".join(f"s({q})" for q in ss)
            terms.append(f"o({o}) * " + (f"({ssum})" if len(ss) > 1 else ssum))
        lines.append(f"  c[{d}] = " + " + ".join(terms) + ";")
    lines += [
        "}",
        "",
        "// Lambertian surface closure on face nz: the up dofs gain albedo * (sum of the",
        "// down dofs) * their hemisphere weight",
        "template <class U>",
        "__device__ __forceinline__ void k1_closure(U u, float alb, float* S) {",
        "  const float edn = " + " + ".join(f"u({d})" for d in dn) + ";",
    ]
    for d, wt in up:
        lines.append(f"  S[{d}] += alb * edn * {float(np.float32(wt))!r}f;")
    lines += ["}", ""]
    return "\n".join(lines)


def _check_header() -> None:
    path = os.path.join(CSRC, HEADER_3_10)
    with open(path) as f:
        if f.read() != orbit_header_text():
            raise RuntimeError(f"{path} differs from what orbit_header_text() generates; "
                               "regenerate it from the Python tables")


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
    D = _TS_MAXD
    ngroups = [0] * D
    gorb = [[0] * D for _ in range(D)]
    gmask = [[0] * D for _ in range(D)]
    for d in range(nd):
        ngroups[d] = len(groups[d])
        for g, (o, ss) in enumerate(groups[d]):
            gorb[d][g] = o
            gmask[d][g] = sum(1 << s for s in ss)
    return [nd, norb] + ngroups + sum(gorb, []) + sum(gmask, [])


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
    out = load_extension().orbit_contract(src, orb, _tables(scheme, idx, orb.shape[1]))
    LAUNCHES["orbit_contract"] += 1
    return out


def diffuse_apply_orbit(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                        x: torch.Tensor, albedo2d: torch.Tensor) -> torch.Tensor:
    """S(x) for x ([B,] nd, Nz+1, Nx, Ny) on the orbit field orb ([B,] norb,
    Nz, Nx, Ny): gather -> K2 (one launch for the whole chunk) -> scatter,
    plus the surface closure (`ediff._make_apply`'s orbit path)."""
    from tenstream_tpu_torch.pprts.operators import add_surface_reflection

    lanes = x.dim() == 5
    src = gather_diff_src(scheme, x if lanes else x[None])
    contrib = orbit_contract(scheme, idx, orb if lanes else orb[None], src)
    out = scatter_diff_dst(scheme, contrib if lanes else contrib[0])
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


def _k1_refusal(scheme: StreamScheme, idx: np.ndarray, norb: int) -> None:
    """K1 is compiled for 3_10's orbit, shift and surface-closure tables;
    raise for a scheme whose tables differ.  The check is by tables, not by
    name: 8_10's diffuse layout and orbits equal 3_10's."""
    k_idx, k_norb, _, k_cshift, k_gshift, k_dn, k_up = _k1_tables()
    same = (norb == k_norb and np.shape(idx) == k_idx.shape and np.array_equal(idx, k_idx)
            and _shift_tables(scheme) == (k_cshift, k_gshift)
            and surface_closure_rows(scheme) == (k_dn, k_up))
    if not same:
        raise ValueError(f"K1 is compiled for the 3_10 scheme's orbit tables "
                         f"({HEADER_3_10}); got scheme {scheme.name} with {norb} channels")


def fused_A_dots(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                 u: torch.Tensor, w: torch.Tensor,
                 albedo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (A(u), dots) with dots[b] = (dot(w[b], Au[b]), dot(Au[b], Au[b]))."""
    if all(t.device.type == "cpu" for t in (u, w, orb, albedo)):
        return fused_A_dots_plain(scheme, idx, orb, u, w, albedo)
    _require_cuda(u, w, orb, albedo)
    _k1_refusal(scheme, idx, orb.shape[1])
    Au, dots = load_extension().fused_A_dots(u, w, orb, albedo)
    LAUNCHES["fused_A_dots"] += 1
    return Au, dots


# ---------------------------------------------------------------------------
# K3: S(x) on dense coefficients
# ---------------------------------------------------------------------------


def _k3_shift_refusal(name: str, cshift, gshift) -> None:
    """K3 stages only high source halos and writes each cell's contributions
    to its own face or the next one along an axis: it takes gshift in
    {0, 1} and cshift in {-1, 0} on every axis, and refuses other tables."""
    bad_g = [s for s, g in enumerate(gshift) if any(v not in (0, 1) for v in g)]
    bad_c = [d for d, c in enumerate(cshift) if any(v not in (-1, 0) for v in c)]
    if bad_g or bad_c:
        raise ValueError(f"K3 takes shift tables with gshift in {{0, 1}} and cshift in "
                         f"{{-1, 0}}; scheme {name} has gshift outside at dofs {bad_g}, "
                         f"cshift outside at dofs {bad_c}")


@functools.lru_cache(maxsize=None)
def _dense_tables(scheme: StreamScheme):
    """[nd] + gz + gx + gy + cz + cx + cy: src s is read at cell + g*[s],
    dst d is produced by the cell face + c*[d]."""
    nd = scheme.ndiff
    if nd != _TS_MAXD:
        raise ValueError(f"the kernels are built for the 3_10 scheme ({_TS_MAXD} diffuse "
                         f"dofs); scheme {scheme.name} has {nd}")
    cshift, gshift = _shift_tables(scheme)
    _k3_shift_refusal(scheme.name, cshift, gshift)
    return [nd] + [sh[a][q] for sh in (gshift, cshift) for q in range(3) for a in range(nd)]


def dense_launch_config(dtype: torch.dtype) -> Dict[str, int]:
    """K3's launch configuration on the current CUDA device for float32 or
    bfloat16 coefficients: threads and shared memory per block, blocks per SM."""
    threads, smem, per_sm = load_extension().diffuse_apply_dense_config(dtype == torch.bfloat16)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": per_sm}


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
