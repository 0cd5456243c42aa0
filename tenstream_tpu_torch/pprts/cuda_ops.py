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

All take a leading batch dim B (K1 returns per-batch dots).  K1 and K2
are compiled once for each distinct set of diffuse tables among the cube
schemes (`ORBIT_SCHEMES`: 3_10, which 8_10 shares, 3_6, 8_12, 3_16, which
8_16 shares, 8_18, 3_24 and 3_30): the orbit contraction, the shifts and
the surface closure are code in `csrc/orbit_<scheme>.h`, which
`orbit_header_text` generates from the same Python tables the plain
versions use, and `load_extension` refuses to build from a header that
differs from it.  A call finds its instantiation by comparing the scheme's
tables with each compiled set (`_orbit_instantiation`), not by name, and
raises where none matches.  K3 takes its shifts at run time and is
instantiated for each diffuse dof count of those schemes (`DENSE_NDS`).
The plain versions take any scheme.  A wrapper
runs the plain version only because its tensors lie on the CPU; on a CUDA
tensor it launches the kernel (or raises) -- there is no fallback.  Each
launch adds one to `LAUNCHES[name]`.

Halo mode (a solve decomposed over ranks, `parallel/mesh.py`): K1 and K3
wrap x and y inside the kernel over the whole field they are given; on a
rank's block they read their one-cell ring from halo buffers instead.  K1
takes u and the orbit field padded by a one-cell ring (`Mesh.pad`; w,
albedo and A(u) stay the block's) and its dots cover the block's own
faces.  K3 takes the planes just past the block's high x and y edges as
two extra inputs (`hx`, `hy`, the next ranks' first planes) and writes the
faces its cells make beyond those edges into two extra outputs (`ox`,
`oy`), which `diffuse_apply_dense_mesh` sends to the next ranks, whose
first faces they are.  Only addressing changes, so on a rank that is its
own neighbour a halo launch gives the periodic launch's outputs bit for
bit.  A halo launch counts in `LAUNCHES` like any other and also in
`HALO_LAUNCHES`.  K2 is per cell and runs unchanged on a block.

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
from tenstream_tpu_torch.streams import StreamScheme, get_scheme

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("orbit_ops.cu", "dense_ops.cu", "boxmc_ops.cu", "bind.cpp")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]

# kernel name -> launches since the last reset (see reset_launch_counts)
LAUNCHES: Dict[str, int] = {"fused_A_dots": 0, "orbit_contract": 0, "diffuse_apply_dense": 0,
                            "boxmc_trace": 0}
# of those, the launches in halo mode
HALO_LAUNCHES: Dict[str, int] = {"fused_A_dots": 0, "diffuse_apply_dense": 0}

# The table sets K1 and K2 are compiled for, each named by the first scheme
# that has it: 8_10 has 3_10's diffuse tables and 8_16 has 3_16's
# (`tests/test_torch_kernels.py` checks which schemes share one).  The order is
# the instantiation index `csrc/orbit_schemes.h` dispatches on.
ORBIT_SCHEMES = ("3_10", "3_6", "8_12", "3_16", "8_18", "3_24", "3_30")
ORBIT_INDEX_HEADER = "orbit_schemes.h"
# K3's instantiations: the diffuse dof counts of those schemes (csrc/dense_ops.cu
# dispatches on nd through the list orbit_schemes.h carries)
DENSE_NDS = tuple(sorted({get_scheme(n).ndiff for n in ORBIT_SCHEMES}))


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, HALO_LAUNCHES):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def load_extension(verbose: bool = False):
    """Build (once per process) and load the kernels' extension."""
    from torch.utils.cpp_extension import load

    _check_headers()
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


def orbit_header_name(name: str) -> str:
    """The generated header of the table set named `name`."""
    return f"orbit_{name}.h"


def _scheme_tables(scheme: StreamScheme):
    """A scheme's shift and surface-closure tables: the part of what K1
    compiles in that does not depend on the orbit table."""
    return _shift_tables(scheme), surface_closure_rows(scheme)


@functools.lru_cache(maxsize=None)
def _k1_tables(name: str):
    """The tables of the set named `name` (a scheme of ORBIT_SCHEMES): (idx,
    norb, groups, cshift, gshift, dn, up)."""
    from tenstream_tpu_torch.optprop.facade import diff_pair_orbits

    scheme = get_scheme(name)
    idx, norb = diff_pair_orbits(scheme, with_mz=False)
    idx = np.asarray(idx, np.int64)
    (cshift, gshift), (dn, up) = _scheme_tables(scheme)
    return idx, int(norb), orbit_groups(idx), cshift, gshift, dn, up


def _ternary(name: str, var: str, vals) -> str:
    """A constexpr function of dof `var` returning vals[var] (0 where unlisted)."""
    expr = "".join(f"{var} == {q} ? {v} : " for q, v in enumerate(vals) if v != 0) + "0"
    return f"  __host__ __device__ static constexpr int {name}(int {var}) {{ return {expr}; }}"


def orbit_header_text(name: str) -> str:
    """The text of `csrc/orbit_<name>.h`: the struct `Orbit_<name>` holding
    K1's and K2's orbit contraction, shifts and surface closure for the table
    set `name` as compile-time code, generated from the same Python tables
    the plain version uses (`orbit_groups`, `_shift_tables`,
    `surface_closure_rows`), in the plain version's order of sums."""
    idx, norb, groups, cshift, gshift, dn, up = _k1_tables(name)
    nd = len(groups)
    lines = [
        f"// K1's and K2's tables for the {name} scheme (and every scheme with the same",
        "// diffuse tables) as compile-time code.  Generated by",
        "// tenstream_tpu_torch/pprts/cuda_ops.py::orbit_header_text from the tables of",
        f"// the plain version (orbit_groups of diff_pair_orbits({name}, with_mz=False),",
        "// _shift_tables, surface_closure_rows); do not edit: load_extension refuses",
        "// to build from a copy that differs from what they generate.",
        "#pragma once",
        "",
        f"struct Orbit_{name} {{",
        f"  static constexpr int K1_ND = {nd};",
        f"  static constexpr int K1_NORB = {norb};",
        "",
        "  // source s of a cell (k, i, j) is u[s] at face (k, i, j) + (k1_gz, k1_gx, k1_gy)(s)",
    ]
    for q, fn in enumerate(("k1_gz", "k1_gx", "k1_gy")):
        lines.append(_ternary(fn, "s", [g[q] for g in gshift]))
    lines.append("  // dst d at face (k, i, j) is produced by the cell (k, i, j) + "
                 "(k1_cz, k1_cx, k1_cy)(d)")
    for q, fn in enumerate(("k1_cz", "k1_cx", "k1_cy")):
        lines.append(_ternary(fn, "d", [c[q] for c in cshift]))
    lines += [
        "  // one cell's contributions: c[d] = sum over the orbit groups (o, ss) of dst d of",
        "  // o(o) * (sum of s(src) over ss), groups in orbit order, as the plain version",
        "  template <class O, class S>",
        "  __device__ static __forceinline__ void k1_contract(O o, S s, float* c) {",
    ]
    for d in range(nd):
        terms = []
        for o, ss in groups[d]:
            ssum = " + ".join(f"s({q})" for q in ss)
            terms.append(f"o({o}) * " + (f"({ssum})" if len(ss) > 1 else ssum))
        lines.append(f"    c[{d}] = " + " + ".join(terms) + ";")
    lines += [
        "  }",
        "",
        "  // Lambertian surface closure on face nz: the up dofs gain albedo * (sum of the",
        "  // down dofs) * their hemisphere weight",
        "  template <class U>",
        "  __device__ static __forceinline__ void k1_closure(U u, float alb, float* S) {",
        "    const float edn = " + " + ".join(f"u({d})" for d in dn) + ";",
    ]
    for d, wt in up:
        lines.append(f"    S[{d}] += alb * edn * {float(np.float32(wt))!r}f;")
    lines += ["  }", "};", ""]
    return "\n".join(lines)


def orbit_index_text() -> str:
    """The text of `csrc/orbit_schemes.h`: every generated header, the list
    of K1/K2 instantiations (index, struct) and K3's dof counts, which the
    kernels dispatch on."""
    lines = [
        "// The table sets K1 and K2 are compiled for, in the order of",
        "// tenstream_tpu_torch/pprts/cuda_ops.py::ORBIT_SCHEMES (the instantiation index).",
        "// Generated by cuda_ops.py::orbit_index_text; do not edit.",
        "#pragma once",
        "",
    ]
    lines += [f'#include "{orbit_header_name(n)}"' for n in ORBIT_SCHEMES]
    lines += ["", "// X(instantiation index, tables struct)", "#define TS_ORBIT_SCHEMES(X) \\"]
    lines += [f"  X({q}, Orbit_{n})" + (" \\" if q < len(ORBIT_SCHEMES) - 1 else "")
              for q, n in enumerate(ORBIT_SCHEMES)]
    lines += ["", "// the diffuse dof counts K3 is instantiated for: X(nd)",
              "#define TS_DENSE_NDS(X) " + " ".join(f"X({nd})" for nd in DENSE_NDS), ""]
    return "\n".join(lines)


def generated_headers() -> Dict[str, str]:
    """file name in csrc/ -> the text its generator writes."""
    out = {orbit_header_name(n): orbit_header_text(n) for n in ORBIT_SCHEMES}
    out[ORBIT_INDEX_HEADER] = orbit_index_text()
    return out


def _check_headers() -> None:
    for fname, text in generated_headers().items():
        path = os.path.join(CSRC, fname)
        with open(path) as f:
            if f.read() != text:
                raise RuntimeError(f"{path} differs from what cuda_ops.generated_headers() "
                                   "writes; regenerate it from the Python tables")


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


def _orbit_instantiation(scheme: StreamScheme, idx: np.ndarray, norb: int) -> int:
    """The index in ORBIT_SCHEMES of the table set K1 and K2 are compiled
    for that equals the scheme's orbit table `idx` (norb channels), shift
    tables and surface closure; raise where none does.  The check is by
    tables, not by name: 8_10 runs on 3_10's instantiation, 8_16 on 3_16's."""
    idx = np.asarray(idx)
    own = None
    for q, name in enumerate(ORBIT_SCHEMES):
        k_idx, k_norb, _, k_cshift, k_gshift, k_dn, k_up = _k1_tables(name)
        if norb != k_norb or idx.shape != k_idx.shape or not np.array_equal(idx, k_idx):
            continue
        own = own or _scheme_tables(scheme)
        if own == ((k_cshift, k_gshift), (k_dn, k_up)):
            return q
    raise ValueError(f"K1 and K2 are compiled for the orbit tables of the schemes "
                     f"{', '.join(ORBIT_SCHEMES)} (csrc/orbit_<scheme>.h); scheme {scheme.name} "
                     f"with {norb} channels matches none of them")


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
    inst = _orbit_instantiation(scheme, idx, orb.shape[1])
    out = load_extension().orbit_contract(src, orb, inst)
    LAUNCHES["orbit_contract"] += 1
    return out


def diffuse_apply_orbit(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                        x: torch.Tensor, albedo2d: torch.Tensor, mesh=None) -> torch.Tensor:
    """S(x) for x ([B,] nd, Nz+1, Nx, Ny) on the orbit field orb ([B,] norb,
    Nz, Nx, Ny): gather -> K2 (one launch for the whole chunk) -> scatter,
    plus the surface closure (`ediff._make_apply`'s orbit path).  With a
    `mesh` the gather and the scatter take their halos from the
    neighbouring ranks and K2 runs on the block's cells."""
    from tenstream_tpu_torch.pprts.operators import add_surface_reflection

    lanes = x.dim() == 5
    src = gather_diff_src(scheme, x if lanes else x[None], mesh)
    contrib = orbit_contract(scheme, idx, orb if lanes else orb[None], src)
    out = scatter_diff_dst(scheme, contrib if lanes else contrib[0], mesh)
    return add_surface_reflection(scheme, out, x, albedo2d)


# ---------------------------------------------------------------------------
# K1: fused A(u) + dots
# ---------------------------------------------------------------------------


def _gather_padded(scheme: StreamScheme, up: torch.Tensor) -> torch.Tensor:
    """Sources (B, nd, Nz, Nx+1, Ny+1) of the block's cells and of its low
    halo cells from u padded by a one-cell ring, up (B, nd, Nz+1, Nx+2,
    Ny+2): padded cell c is the block's cell c - 1, and dof s reads the
    face c + gshift[s]."""
    _, gshift = _shift_tables(scheme)
    nz, nx, ny = up.shape[-3] - 1, up.shape[-2] - 2, up.shape[-1] - 2
    return torch.stack([up[:, s, gz:gz + nz, gx:gx + nx + 1, gy:gy + ny + 1]
                        for s, (gz, gx, gy) in enumerate(gshift)], dim=1)


def _scatter_padded(scheme: StreamScheme, contrib: torch.Tensor) -> torch.Tensor:
    """S on the block's faces (B, nd, Nz+1, Nx, Ny) from the contributions
    (B, nd, Nz, Nx+1, Ny+1) of the block's cells and its low halo cells:
    dst d at face f comes from the cell f + cshift[d]."""
    cshift, _ = _shift_tables(scheme)
    nx, ny = contrib.shape[-2] - 1, contrib.shape[-1] - 1
    zero = torch.zeros_like(contrib[:, 0, :1, 1:, 1:])
    rows = []
    for d, (cz, cx, cy) in enumerate(cshift):
        c = contrib[:, d, :, 1 + cx:1 + cx + nx, 1 + cy:1 + cy + ny]
        rows.append(torch.cat([zero, c] if cz == -1 else [c, zero], dim=1))
    return torch.stack(rows, dim=1)


def fused_A_dots_plain(scheme: StreamScheme, idx: np.ndarray, orb: torch.Tensor,
                       u: torch.Tensor, w: torch.Tensor, albedo: torch.Tensor,
                       halo: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: u, w (B, nd, Nz+1, Nx, Ny); orb (B, norb, Nz, Nx,
    Ny); albedo (B, Nx, Ny) -> (Au, dots (B, 2)).  In halo mode u and orb
    are padded by a one-cell ring (..., Nx+2, Ny+2) and the rest is the
    block's."""
    if halo:
        nx, ny = w.shape[-2:]
        src = _gather_padded(scheme, u)
        S = _scatter_padded(scheme, orbit_contract_plain(idx, orb[..., :nx + 1, :ny + 1], src))
        u = u[..., 1:-1, 1:-1]
    else:
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
                 u: torch.Tensor, w: torch.Tensor, albedo: torch.Tensor,
                 halo: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (A(u), dots) with dots[b] = (dot(w[b], Au[b]), dot(Au[b], Au[b])).
    In halo mode u and orb are the block's fields padded by a one-cell ring
    (`Mesh.pad`), the dots the block's partial sums."""
    if all(t.device.type == "cpu" for t in (u, w, orb, albedo)):
        return fused_A_dots_plain(scheme, idx, orb, u, w, albedo, halo)
    _require_cuda(u, w, orb, albedo)
    inst = _orbit_instantiation(scheme, idx, orb.shape[1])
    Au, dots = load_extension().fused_A_dots(u, w, orb, albedo, inst, bool(halo))
    LAUNCHES["fused_A_dots"] += 1
    if halo:
        HALO_LAUNCHES["fused_A_dots"] += 1
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
    """[nd] + gz + gx + gy + cz + cx + cy, nd entries each: src s is read at
    cell + g*[s], dst d is produced by the cell face + c*[d].  Raises for a
    dof count K3 is not instantiated for."""
    nd = scheme.ndiff
    if nd not in DENSE_NDS:
        raise ValueError(f"K3 is instantiated for {DENSE_NDS} diffuse dofs; scheme "
                         f"{scheme.name} has {nd}")
    cshift, gshift = _shift_tables(scheme)
    _k3_shift_refusal(scheme.name, cshift, gshift)
    return [nd] + [sh[a][q] for sh in (gshift, cshift) for q in range(3) for a in range(nd)]


def dense_launch_config(dtype: torch.dtype, nd: int = 10) -> Dict[str, int]:
    """K3's launch configuration on the current CUDA device for float32 or
    bfloat16 coefficients and nd diffuse dofs: threads and shared memory per
    block, blocks per SM."""
    threads, smem, per_sm = load_extension().diffuse_apply_dense_config(
        dtype == torch.bfloat16, nd)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": per_sm}


def _k3_halo_refusal(scheme: StreamScheme) -> None:
    """K3's halo mode stages the high x halo row and the high y halo column
    but not their corner: no source may read both."""
    _, gshift = _shift_tables(scheme)
    both = [s for s, g in enumerate(gshift) if g[1] and g[2]]
    if both:
        raise ValueError(f"K3's halo mode takes no source read across both x and y; scheme "
                         f"{scheme.name} has such sources at dofs {both}")


def diffuse_apply_dense_plain(scheme: StreamScheme, coeff: torch.Tensor, x: torch.Tensor,
                              halo=None):
    """Plain PyTorch K3: coeff (B, nd, nd, Nz, Nx, Ny) [src, dst] in
    float32 or bfloat16, x (B, nd, Nz+1, Nx, Ny) -> S(x) without the
    surface closure, float32.  In halo mode, halo = (hx (B, nd, Nz+1, Ny),
    hy (B, nd, Nz+1, Nx)), the planes just past the block's high x and y
    edges, and the result is (out, ox, oy): the faces made by the block's
    cells on the block (zero where the cells before the block make them)
    and on the planes past its high edges."""
    if halo is None:
        contrib = torch.einsum("bsdkij,bskij->bdkij", coeff.float(), gather_diff_src(scheme, x))
        return scatter_diff_dst(scheme, contrib)
    _k3_halo_refusal(scheme)
    hx, hy = halo
    cshift, gshift = _shift_tables(scheme)
    nb, nd, nf, nx, ny = x.shape
    nz = nf - 1
    xe = x.new_zeros((nb, nd, nf, nx + 1, ny + 1))
    xe[..., :nx, :ny] = x
    xe[..., nx, :ny] = hx
    xe[..., :nx, ny] = hy
    src = torch.stack([xe[:, s, gz:gz + nz, gx:gx + nx, gy:gy + ny]
                       for s, (gz, gx, gy) in enumerate(gshift)], dim=1)
    contrib = torch.einsum("bsdkij,bskij->bdkij", coeff.float(), src)
    oe = x.new_zeros((nb, nd, nf, nx + 1, ny + 1))
    for d, (cz, cx, cy) in enumerate(cshift):
        oe[:, d, -cz:-cz + nz, -cx:-cx + nx, -cy:-cy + ny] = contrib[:, d]
    return oe[..., :nx, :ny], oe[..., nx, :ny], oe[..., :nx, ny]


def diffuse_apply_dense(scheme: StreamScheme, coeff: torch.Tensor, x: torch.Tensor,
                        halo=None):
    """K3: S(x) without the surface closure, for dst d at a face
    sum_s coeff[s, d, cell] * x[s, cell + gshift[s]], cell = face +
    cshift[d]; periodic in x and y, zero beyond z.  With halo = (hx, hy)
    the halo mode of `diffuse_apply_dense_plain`: (out, ox, oy)."""
    if coeff.device.type == "cpu" and x.device.type == "cpu" and (
            halo is None or all(h.device.type == "cpu" for h in halo)):
        return diffuse_apply_dense_plain(scheme, coeff, x, halo)
    _require_cuda(coeff, x)
    if halo is None:
        out = load_extension().diffuse_apply_dense(x, coeff, _dense_tables(scheme))
        LAUNCHES["diffuse_apply_dense"] += 1
        return out
    _k3_halo_refusal(scheme)
    hx, hy = (h.contiguous() for h in halo)
    _require_cuda(hx, hy)
    out = load_extension().diffuse_apply_dense_halo(x, coeff, _dense_tables(scheme), hx, hy)
    LAUNCHES["diffuse_apply_dense"] += 1
    HALO_LAUNCHES["diffuse_apply_dense"] += 1
    return tuple(out)


def diffuse_apply_dense_mesh(scheme: StreamScheme, coeff: torch.Tensor, x: torch.Tensor,
                             mesh) -> torch.Tensor:
    """K3 on a rank's block: the halo planes from the next ranks along x
    and y, K3 in halo mode, then the faces made past the block's high
    edges go to the next ranks, whose first faces they are (`Mesh`; a rank
    that is its own neighbour sends to itself)."""
    cshift, _ = _shift_tables(scheme)
    hx, hy = mesh.sendrecv([(x[..., 0, :], mesh.neighbour(0, -1), mesh.neighbour(0, 1)),
                            (x[..., :, 0], mesh.neighbour(1, -1), mesh.neighbour(1, 1))])
    out, ox, oy = diffuse_apply_dense(scheme, coeff, x, halo=(hx, hy))
    rx, ry = mesh.sendrecv([(ox, mesh.neighbour(0, 1), mesh.neighbour(0, -1)),
                            (oy, mesh.neighbour(1, 1), mesh.neighbour(1, -1))])
    for d, (_, cx, cy) in enumerate(cshift):
        if cx == -1:
            out[:, d, :, 0, :] = rx[:, d]
        elif cy == -1:
            out[:, d, :, :, 0] = ry[:, d]
    return out
