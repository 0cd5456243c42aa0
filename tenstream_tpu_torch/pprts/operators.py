"""Matrix-free stream-transport operators (port of
`tenstream_tpu/pprts/operators.py`).

Stream fields are face-indexed (..., ndof, Nz+1, Nx, Ny), coefficient
fields cell-indexed (..., nsrc, ndst, Nz, Nx, Ny) or `OrbitCoeff`.  x and
y are periodic (`torch.roll`), z has a zero halo.  Every function here
accepts optional leading lane dims (a chunk of bands solved together) on
the stream and coefficient fields.

With a `mesh` (`parallel.mesh.Mesh`) the fields are this rank's (x, y)
block of the global field and every periodic shift is a halo exchange
with the neighbouring ranks (`roll_xy`): the rows that shift the same way
go in one exchange.

This plain path is the twin the CUDA kernels of `cuda_ops.py` are held
against: `fused_A_dots_plain`, `orbit_contract_plain` and
`diffuse_apply_dense_plain` are written from `diffuse_scatter` /
`_orbit_contrib` below.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tenstream_tpu_torch.streams import StreamScheme


class OrbitCoeff:
    """Diffuse (src, dst) coefficient field stored as one channel per
    orbit of the solver symmetry subgroup {x-mirror, y-mirror, x<->y}
    (24 channels instead of ndiff^2 = 100 for 3_10).

    `orb` is (..., norb, Nz, Nx, Ny), with optional leading lane dims
    (a band chunk); `idx[src, dst]` the static orbit id."""

    def __init__(self, orb: torch.Tensor, idx: np.ndarray):
        self.orb = orb
        self.idx = np.asarray(idx, np.int64)

    @property
    def shape(self):
        nf = self.idx.shape[0]
        return tuple(self.orb.shape[:-4]) + (nf, nf) + tuple(self.orb.shape[-3:])

    def astype(self, dt) -> "OrbitCoeff":
        return OrbitCoeff(self.orb.to(dt), self.idx)

    def full(self) -> torch.Tensor:
        """Expanded (..., ndiff, ndiff, Nz, Nx, Ny) field (a materialised copy)."""
        nf = self.idx.shape[0]
        sel = torch.as_tensor(self.idx.ravel(), device=self.orb.device)
        out = self.orb.index_select(-4, sel)
        return out.reshape(tuple(self.orb.shape[:-4]) + (nf, nf) + tuple(self.orb.shape[-3:]))

    def entry(self, s: int, d: int) -> torch.Tensor:
        """Single (src, dst) coefficient field (..., Nz, Nx, Ny)."""
        return self.orb[..., int(self.idx[s, d]), :, :, :]

    def dst_sums(self) -> torch.Tensor:
        """Sum over dst per src (the dense field's sum over dst) in
        float32, via a static per-orbit count matrix."""
        norb = self.orb.shape[-4]
        nf = self.idx.shape[0]
        R = np.zeros((nf, norb), np.float32)
        for s in range(nf):
            for d in range(nf):
                R[s, self.idx[s, d]] += 1.0
        R = torch.as_tensor(R, device=self.orb.device)
        return torch.einsum("so,...okij->...skij", R, self.orb.float())

    def set_layer0(self, block_full: torch.Tensor) -> "OrbitCoeff":
        """A copy with layer 0 overwritten by a full (..., ndiff, ndiff,
        Nx, Ny) block, which must itself be orbit-consistent (the
        atm-collapse folded blocks are); the orbit-representative entries
        are taken."""
        norb = self.orb.shape[-4]
        reps = [None] * norb
        nf = self.idx.shape[0]
        for s in range(nf):
            for d in range(nf):
                o = int(self.idx[s, d])
                if reps[o] is None:
                    reps[o] = (s, d)
        orb0 = torch.stack([block_full[..., s, d, :, :] for (s, d) in reps], dim=-3)
        orb = self.orb.clone()
        orb[..., 0, :, :] = orb0.to(orb.dtype)
        return OrbitCoeff(orb, self.idx)


# a diffuse coefficient field in either storage form: orbit channels or
# the dense (ndiff, ndiff, Nz, Nx, Ny) [src, dst] tensor
DiffCoeff = Union[OrbitCoeff, torch.Tensor]


def diff_coeff_full(coeff: DiffCoeff) -> torch.Tensor:
    """Expanded (ndiff, ndiff, ...) tensor for either storage form."""
    return coeff.full() if isinstance(coeff, OrbitCoeff) else coeff


def diff_dst_sums(coeff: DiffCoeff) -> torch.Tensor:
    """Sum over dst per src of the diffuse coefficients, in float32, for
    either storage form."""
    if isinstance(coeff, OrbitCoeff):
        return coeff.dst_sums()
    return coeff.sum(dim=-4, dtype=torch.float32)


def orbit_groups(idx: np.ndarray):
    """Per dst d: the sorted (orbit, sources) groups of column d of the
    orbit table.  contrib[d] = sum over groups of orb[o] * sum(src[s])."""
    nf = idx.shape[0]
    groups = []
    for d in range(nf):
        by_orbit: dict = {}
        for s in range(nf):
            by_orbit.setdefault(int(idx[s, d]), []).append(s)
        groups.append(tuple(sorted((o, tuple(ss)) for o, ss in by_orbit.items())))
    return tuple(groups)


def roll_xy(v: torch.Tensor, shift: int, dim: int, mesh=None) -> torch.Tensor:
    """`torch.roll(v, shift, dim)` along x or y (dim -2 / -1) of the
    global field; with a mesh, v is this rank's block and the shift a halo
    exchange."""
    return torch.roll(v, shift, dims=dim) if mesh is None else mesh.roll(v, shift, dim)


def roll_rows(rows: dict, shift: int, dim: int, mesh=None) -> dict:
    """`roll_xy` of every value of `rows` (same shapes): one exchange for
    all of them on a mesh."""
    if mesh is None or not rows:
        return {k: roll_xy(v, shift, dim) for k, v in rows.items()}
    keys = list(rows)
    rolled = mesh.roll(torch.stack([rows[k] for k in keys], 0), shift, dim)
    return dict(zip(keys, rolled.unbind(0)))


def gather_diff_src(scheme: StreamScheme, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-cell source values for every diffuse dof:
    (..., ndiff, Nz+1, Nx, Ny) face-indexed -> (..., ndiff, Nz, Nx, Ny)."""
    axis = scheme.diff_axis()
    inward = scheme.diff_inward()
    rows = {}
    shifted = ({}, {})  # outward side dofs read the next face along x / y
    for d in range(scheme.ndiff):
        v = x[..., d, :, :, :]
        if axis[d] == 0:
            rows[d] = v[..., :-1, :, :] if inward[d] else v[..., 1:, :, :]
        elif inward[d]:
            rows[d] = v[..., :-1, :, :]
        else:
            shifted[axis[d] - 1][d] = v[..., :-1, :, :]
    rows.update(roll_rows(shifted[0], -1, -2, mesh))
    rows.update(roll_rows(shifted[1], -1, -1, mesh))
    return torch.stack([rows[d] for d in range(scheme.ndiff)], dim=-4)


def scatter_diff_dst(scheme: StreamScheme, contrib: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-cell destination contributions onto face-indexed arrays:
    (..., ndiff, Nz, Nx, Ny) -> (..., ndiff, Nz+1, Nx, Ny)."""
    axis = scheme.diff_axis()
    inward = scheme.diff_inward()
    zeros_level = torch.zeros_like(contrib[..., 0, :1, :, :])
    cells = {}
    shifted = ({}, {})  # inward side dofs land on the next face along x / y
    for d in range(scheme.ndiff):
        c = contrib[..., d, :, :, :]
        if axis[d] != 0 and inward[d]:
            shifted[axis[d] - 1][d] = c
        else:
            cells[d] = c
    cells.update(roll_rows(shifted[0], 1, -2, mesh))
    cells.update(roll_rows(shifted[1], 1, -1, mesh))
    rows = []
    for d in range(scheme.ndiff):
        c = cells[d]
        if axis[d] == 0:
            parts = [zeros_level, c] if inward[d] else [c, zeros_level]
        else:
            parts = [c, zeros_level]
        rows.append(torch.cat(parts, dim=-3))
    return torch.stack(rows, dim=-4)


def orbit_contract_groups(groups, orb: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """contrib[..., d] = sum over groups (o, ss) of orb[..., o] * sum_s src[..., s];
    sources sharing an orbit are summed before the multiply (the order of
    the TPU contraction kernel)."""
    rows = []
    for d in range(len(groups)):
        acc = None
        for o, ss in groups[d]:
            ssum = src[..., ss[0], :, :, :]
            for s in ss[1:]:
                ssum = ssum + src[..., s, :, :, :]
            term = orb[..., o, :, :, :] * ssum
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows, dim=-4)


def _orbit_contrib(coeff: OrbitCoeff, src: torch.Tensor) -> torch.Tensor:
    """contrib[d] = sum_s orb[idx[s, d]] * src[s] without expanding the
    dense field."""
    return orbit_contract_groups(orbit_groups(coeff.idx), coeff.orb.to(src.dtype), src)


def diffuse_scatter(
    scheme: StreamScheme,
    coeff: DiffCoeff,
    x: torch.Tensor,
    albedo2d: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """S(x): one application of the diffuse transport scatter (with the
    surface reflection closure when `albedo2d` is given).  coeff:
    `OrbitCoeff` or dense (..., ndiff, ndiff, Nz, Nx, Ny) [src, dst], which
    may be stored in bfloat16 (products and sums run in x's dtype)."""
    src = gather_diff_src(scheme, x, mesh)
    if isinstance(coeff, OrbitCoeff):
        contrib = _orbit_contrib(coeff, src)
    else:
        contrib = torch.einsum("...sdkij,...skij->...dkij", coeff.to(x.dtype), src)
    out = scatter_diff_dst(scheme, contrib, mesh)
    if albedo2d is not None:
        out = add_surface_reflection(scheme, out, x, albedo2d)
    return out


def surface_closure_rows(scheme: StreamScheme):
    """(down-top dofs, [(up-top dof, hemisphere weight)]) of the
    Lambertian surface closure."""
    inward = scheme.diff_inward()
    ntop = scheme.difftop.dof
    wtop = scheme.difftop_weights()
    dn = [d for d in range(ntop) if inward[d]]
    up = [(d, float(wtop[d])) for d in range(ntop) if not inward[d]]
    return dn, up


def add_surface_reflection(scheme: StreamScheme, out, x, albedo2d):
    """Lambertian surface closure (Eup_sfc += albedo * Edn_sfc), split
    over the upward bins by hemisphere fraction.  `albedo2d` broadcasts
    against the (..., Nx, Ny) surface face."""
    dn, up = surface_closure_rows(scheme)
    edn_sfc = sum(x[..., d, -1, :, :] for d in dn)
    out = out.clone()
    for d, w in up:
        out[..., d, -1, :, :] += albedo2d * edn_sfc * w
    return out


def gather_dir_src(scheme: StreamScheme, e: torch.Tensor, xinc: int, yinc: int,
                   mesh=None) -> torch.Tensor:
    """Per-cell source values for every direct dof (upwind faces):
    (..., ndir, Nz+1, Nx, Ny) -> (..., ndir, Nz, Nx, Ny)."""
    axis = scheme.dir_axis()
    rows = {}
    shifted = ({}, {})  # against the beam's x / y direction: the next face
    for s in range(scheme.ndir):
        v = e[..., s, :-1, :, :]
        if axis[s] == 0 or (axis[s] == 1 and xinc == 1) or (axis[s] == 2 and yinc == 1):
            rows[s] = v
        else:
            shifted[axis[s] - 1][s] = v
    rows.update(roll_rows(shifted[0], -1, -2, mesh))
    rows.update(roll_rows(shifted[1], -1, -1, mesh))
    return torch.stack([rows[s] for s in range(scheme.ndir)], dim=-4)


def dir2diff_source(
    scheme: StreamScheme,
    dir2diff: torch.Tensor,
    edir: torch.Tensor,
    xinc: int,
    yinc: int,
    mesh=None,
) -> torch.Tensor:
    """Diffuse source [W] from scattered direct radiation:
    dir2diff (..., ndir, ndiff, Nz, Nx, Ny), edir (..., ndir, Nz+1, Nx, Ny)."""
    src = gather_dir_src(scheme, edir, xinc, yinc, mesh)
    contrib = None
    for s in range(scheme.ndir):
        t = dir2diff[..., s, :, :, :, :] * src[..., s, None, :, :, :]
        contrib = t if contrib is None else contrib + t
    return scatter_diff_dst(scheme, contrib, mesh)


def direct_surface_reflection(
    scheme: StreamScheme, edir: torch.Tensor, albedo2d: torch.Tensor
) -> torch.Tensor:
    """b contribution: ground albedo reflecting the direct beam into the
    upward diffuse dofs; edir (..., ndir, Nz+1, Nx, Ny)."""
    edir_sfc = edir[..., : scheme.dirtop.dof, -1, :, :].sum(dim=-3)
    lead = tuple(edir.shape[:-4])
    b = torch.zeros(lead + (scheme.ndiff,) + tuple(edir.shape[-3:]), dtype=edir.dtype,
                    device=edir.device)
    _, up = surface_closure_rows(scheme)
    for d, w in up:
        b[..., d, -1, :, :] += edir_sfc * albedo2d * w
    return b
