"""Two-level spectral preconditioner for the diffuse solve (port of
`tenstream_tpu/pprts/precond.py`).

With horizontally homogeneous (layer-mean) coefficients the diffuse
operator (I - S) is translation-invariant in the periodic (x, y), so a
2-D DFT block-diagonalises it into one (ndiff x (Nz+1)) block-tridiagonal
system per horizontal Fourier mode.  Those are factorised once per solve
by block cyclic reduction (log2(Nz) levels, every op batched over
blocks x modes) and applied by a down/up sweep of batched block matvecs.

    M(r) = L(r - P r)  +  Q C^-1 R r

R/Q are mean-pool / piecewise-constant prolongation over cf x cf blocks,
C the Galerkin coarse operator (a fine +-1 shift becomes the pooled phase
(1 - 1/cf) + e^{i theta}/cf) and L the vertical-line solve of the
high-pass residual.  Complex work is complex64.  The residual is real, so
only one mode of every conjugate pair {k, -k} is factorised and swept
(`_hermitian_modes`).  Block arrays keep the JAX package's
(blocks, d, s, modes) layout; the lanes of a band chunk sit between the
block and the (d, s) axes, (blocks, B, d, s, modes), and are factorised
and swept together.

Over a mesh of ranks the fine residual is pooled on each rank's block and
all-gathered; the coarse system (at most ~64 x 64 modes) is factorised
and solved on every rank on the global coarse grid from the domain-mean
coefficients and albedo (all-reduced), and each rank takes its block of
the coarse correction back.  The line solve is per column, so local.  The
pooling factor comes from the global grid, and a block that it does not
divide is refused.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.types import icomplex
from tenstream_tpu_torch.pprts.operators import OrbitCoeff
from tenstream_tpu_torch.streams import StreamScheme


class CRLevel(NamedTuple):
    """One cyclic-reduction level; arrays (nblocks, ndiff, ndiff, nmodes)."""

    F: torch.Tensor  # D_even^-1
    G: torch.Tensor  # F @ Lo_even (back substitution)
    H: torch.Tensor  # F @ Up_even
    A: torch.Tensor  # Lo_odd @ F[i] (down sweep)
    B: torch.Tensor  # Up_odd @ F[i+1]


class CoarseFactors(NamedTuple):
    levels: Tuple[CRLevel, ...]  # coarsest last
    root: torch.Tensor  # (1, ndiff, ndiff, nc): inverse of the last block
    canon: torch.Tensor  # (nc,) canonical flat mode ids
    src: torch.Tensor  # (M,) canonical position feeding each full mode
    conj: torch.Tensor  # (M,) bool: conjugate the canonical value


def _hermitian_modes(ncx: int, ncy: int):
    """(canon, src, conj) for a real 2-D DFT: `canon` lists one flat
    (kx*ncy + ky) id per conjugate pair; full mode m is
    conj^conj[m](x_canon[src[m]])."""
    canon_list = []
    pos = {}
    for kx in range(ncx):
        for ky in range(ncy):
            if (kx, ky) in pos:
                continue
            pid = len(canon_list)
            canon_list.append(kx * ncy + ky)
            pos[(kx, ky)] = (pid, False)
            pair = ((-kx) % ncx, (-ky) % ncy)
            if pair != (kx, ky) and pair not in pos:
                pos[pair] = (pid, True)
    src = np.zeros(ncx * ncy, np.int64)
    cj = np.zeros(ncx * ncy, bool)
    for (kx, ky), (pid, c) in pos.items():
        src[kx * ncy + ky] = pid
        cj[kx * ncy + ky] = c
    return np.asarray(canon_list, np.int64), src, cj


def auto_coarse_factor(nx: int, ny: int, target: int = 32) -> int:
    """Largest power-of-two pooling factor that keeps the coarse grid at
    >= target in the larger dimension (and divides both)."""
    cf = 1
    while (nx % (2 * cf) == 0 and ny % (2 * cf) == 0
           and max(nx // (2 * cf), ny // (2 * cf)) >= target):
        cf *= 2
    return cf


def _mean_coeff(coeff) -> torch.Tensor:
    """Layer-mean (..., ndiff, ndiff, Nz) of the diffuse coefficient field
    (`OrbitCoeff` or dense), in float32."""
    if not isinstance(coeff, OrbitCoeff):
        return coeff.mean(dim=(-2, -1), dtype=torch.float32)
    m = coeff.orb.float().mean(dim=(-2, -1))  # (..., norb, Nz)
    nf = coeff.idx.shape[0]
    sel = torch.as_tensor(coeff.idx.ravel(), device=m.device)
    return m.index_select(-2, sel).reshape(tuple(m.shape[:-2]) + (nf, nf, m.shape[-1]))


def _phase_tables(scheme: StreamScheme, ncx: int, ncy: int, cf: int):
    """Per-(src, dst, mode) Galerkin phases and the z-offset masks."""
    axis = scheme.diff_axis()
    inward = scheme.diff_inward()
    nf = scheme.ndiff
    w = 1.0 / cf
    phx = (1.0 - w) + w * np.exp(1j * 2.0 * np.pi * np.arange(ncx) / ncx)
    phy = (1.0 - w) + w * np.exp(1j * 2.0 * np.pi * np.arange(ncy) / ncy)
    G = np.ones((nf, ncx, ncy), np.complex64)  # gather phase per src
    P = np.ones((nf, ncx, ncy), np.complex64)  # scatter phase per dst
    for d in range(nf):
        if axis[d] == 1 and not inward[d]:
            G[d] = phx[:, None]
        elif axis[d] == 2 and not inward[d]:
            G[d] = phy[None, :]
        if axis[d] == 1 and inward[d]:
            P[d] = np.conj(phx)[:, None]
        elif axis[d] == 2 and inward[d]:
            P[d] = np.conj(phy)[None, :]
    Phi = (G[:, None] * P[None, :]).reshape(nf, nf, ncx * ncy)
    offs = (axis == 0) & (~inward)  # up dofs source from face k+1
    offd = (axis == 0) & inward  # down dofs scatter to face k+1
    return Phi, offs, offd


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Block matmul in the (..., d, s, modes) layout."""
    return torch.einsum("...dsm,...stm->...dtm", A, B)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block matvec: (blocks, d, s, modes) x (blocks, s, modes)."""
    return torch.einsum("...dsm,...sm->...dm", A, x)


def _cinv(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Batched complex block inverse by unrolled Gauss-Jordan over the
    block size, elementwise over the minor mode axis.  No pivoting: the
    blocks are I - T with spectral radius < 1 plus Schur updates of the
    same character, so the pivots stay near 1; `eps` guards exact zeros."""
    n = A.shape[-3]
    A = A.clone()
    X = torch.eye(n, dtype=A.dtype, device=A.device)[:, :, None].expand(A.shape).clone()
    for i in range(n):
        piv = A[..., i, i, :][..., None, :]
        den = torch.where(piv.abs() < eps, torch.full_like(piv, eps), piv)
        rowA = A[..., i, :, :] / den
        rowX = X[..., i, :, :] / den
        colA = A[..., :, i, :].clone()
        colA[..., i, :] = 0.0
        A -= colA[..., :, None, :] * rowA[..., None, :, :]
        X -= colA[..., :, None, :] * rowX[..., None, :, :]
        A[..., i, :, :] = rowA
        X[..., i, :, :] = rowX
    return X


def _pad_blocks(L1: int) -> int:
    """Block count padded to 2^m - 1."""
    Lp = 1
    while Lp < L1:
        Lp = 2 * Lp + 1
    return Lp


def _domain_mean(block_mean: torch.Tensor, mesh) -> torch.Tensor:
    """The domain mean from the ranks' (equal-sized) block means."""
    if mesh is None:
        return block_mean
    return mesh.all_reduce(block_mean) / mesh.world


def build_coarse_factors(scheme: StreamScheme, coeff, albedo2d: torch.Tensor,
                         cf: int, ncx: int, ncy: int, mesh=None) -> CoarseFactors:
    """Assemble and factorise the per-mode coarse block-tridiagonal
    systems (I - S_hom) from the layer-mean coefficients (of the whole
    domain on a mesh; ncx, ncy are the global coarse grid's)."""
    nf = scheme.ndiff
    dev = albedo2d.device
    cbar = _domain_mean(_mean_coeff(coeff), mesh)  # (..., s, d, Nz)
    nz = cbar.shape[-1]
    L1 = nz + 1

    Phi, offs, offd = _phase_tables(scheme, ncx, ncy, cf)
    Phi = torch.as_tensor(Phi, device=dev)
    T = cbar[..., None].to(icomplex) * Phi[:, :, None, :]  # (..., s, d, k, m)
    T = torch.movedim(T, -2, 0).transpose(-3, -2)  # (k, ..., d, s, m)

    mask = lambda a: torch.as_tensor(a[..., None], device=dev)
    m00 = mask((~offd)[:, None] & (~offs)[None, :])  # (d, s, 1)
    m11 = mask(offd[:, None] & offs[None, :])
    m01 = mask(offd[:, None] & (~offs)[None, :])  # sub-diagonal
    m10 = mask((~offd)[:, None] & offs[None, :])  # super-diagonal
    zT = torch.zeros_like(T)
    zero = torch.zeros_like(T[:1])
    eye = torch.eye(nf, dtype=icomplex, device=dev)[:, :, None]
    D = eye - torch.cat([torch.where(m00, T, zT), zero], 0)
    D = D - torch.cat([zero, torch.where(m11, T, zT)], 0)
    Lo = -torch.cat([zero, torch.where(m01, T, zT)], 0)
    Up = -torch.cat([torch.where(m10, T, zT), zero], 0)

    # surface albedo closure (mode-independent, mean albedo)
    inward = scheme.diff_inward()
    wtop = scheme.difftop_weights()
    alb = np.zeros((nf, nf), np.float32)
    for d in range(scheme.difftop.dof):
        if not inward[d]:
            for s in range(scheme.difftop.dof):
                if inward[s]:
                    alb[d, s] = float(wtop[d])
    amean = _domain_mean(albedo2d.float().mean(), mesh)
    D[-1] -= amean * torch.as_tensor(alb, device=dev).to(icomplex)[:, :, None]

    Lp = _pad_blocks(L1)
    if Lp > L1:
        pad = Lp - L1
        zp = torch.zeros((pad,) + tuple(D.shape[1:]), dtype=icomplex, device=dev)
        D = torch.cat([D, zp + eye], 0)
        Lo = torch.cat([Lo, zp], 0)
        Up = torch.cat([Up, zp], 0)

    canon, src, cj = _hermitian_modes(ncx, ncy)
    canon_t = torch.as_tensor(canon, device=dev)
    D, Lo, Up = (t.index_select(-1, canon_t) for t in (D, Lo, Up))

    # cyclic reduction: eliminate the even positions at each level
    levels = []
    while D.shape[0] > 1:
        De, Do = D[0::2], D[1::2]
        Loe, Loo = Lo[0::2], Lo[1::2]
        Upe, Upo = Up[0::2], Up[1::2]
        F = _cinv(De)
        A = _mm(Loo, F[:-1])
        B = _mm(Upo, F[1:])
        levels.append(CRLevel(F, _mm(F, Loe), _mm(F, Upe), A, B))
        D = Do - _mm(A, Upe[:-1]) - _mm(B, Loe[1:])
        Lo = -_mm(A, Loe[:-1])
        Up = -_mm(B, Upe[1:])
    return CoarseFactors(tuple(levels), _cinv(D), canon_t,
                         torch.as_tensor(src, device=dev), torch.as_tensor(cj, device=dev))


def _dft_mat(n: int, inverse: bool, device) -> torch.Tensor:
    """Dense (n, n) DFT matrix (the coarse grid is small)."""
    k = np.arange(n)
    sgn = 2j if inverse else -2j
    m = np.exp(sgn * np.pi * np.outer(k, k) / n) / (n if inverse else 1.0)
    return torch.as_tensor(m.astype(np.complex64), device=device)


def _dft2(rc: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """2-D DFT over the trailing (x, y) axes by two dense matmuls."""
    Fx = _dft_mat(rc.shape[-2], inverse, rc.device)
    Fy = _dft_mat(rc.shape[-1], inverse, rc.device)
    out = torch.einsum("...xy,xu->...uy", rc, Fx)
    return torch.einsum("...uy,yv->...uv", out, Fy)


def coarse_solve(factors: CoarseFactors, rc: torch.Tensor) -> torch.Tensor:
    """DFT2 -> cyclic-reduction down/up sweeps -> inverse DFT2.
    rc: (..., ndiff, Nz+1, ncx, ncy) real."""
    lead = tuple(rc.shape[:-4])
    nf, L1, ncx, ncy = rc.shape[-4:]
    rh = _dft2(rc.to(icomplex))
    rh = torch.movedim(rh.reshape(lead + (nf, L1, ncx * ncy)), -2, 0)  # (l, ..., d, m)
    rh = rh.index_select(-1, factors.canon)
    Lp = _pad_blocks(L1)
    if Lp > L1:
        rh = torch.cat([rh, rh.new_zeros((Lp - L1,) + tuple(rh.shape[1:]))], 0)

    r_evens = []
    for lev in factors.levels:
        re, ro = rh[0::2], rh[1::2]
        r_evens.append(re)
        rh = ro - _mv(lev.A, re[:-1]) - _mv(lev.B, re[1:])

    x = _mv(factors.root, rh)  # (1, d, m)
    for lev, re in zip(reversed(factors.levels), reversed(r_evens)):
        zpad = torch.zeros_like(x[:1])
        xe = _mv(lev.F, re) - _mv(lev.G, torch.cat([zpad, x], 0)) - _mv(lev.H, torch.cat([x, zpad], 0))
        out = x.new_empty((xe.shape[0] + x.shape[0],) + tuple(x.shape[1:]))
        out[0::2] = xe
        out[1::2] = x
        x = out

    x = x[:L1]
    xf = x.index_select(-1, factors.src)
    xf = torch.where(factors.conj, xf.conj(), xf)
    xc = torch.movedim(xf, 0, -2).reshape(lead + (nf, L1, ncx, ncy))
    return _dft2(xc, inverse=True).real.to(rc.dtype)


def pool2d(r: torch.Tensor, cf: int) -> torch.Tensor:
    """Mean-pool the trailing (x, y) dims by cf."""
    if cf == 1:
        return r
    *lead, nx, ny = r.shape
    return r.reshape(*lead, nx // cf, cf, ny // cf, cf).mean(dim=(-3, -1))


def unpool2d(rc: torch.Tensor, cf: int) -> torch.Tensor:
    """Piecewise-constant prolongation."""
    if cf == 1:
        return rc
    return torch.repeat_interleave(torch.repeat_interleave(rc, cf, dim=-2), cf, dim=-1)


def make_two_level_pc(scheme: StreamScheme, coeff, albedo2d: torch.Tensor,
                      cf: int = 0, coarse_target: int = 32, mesh=None):
    """M(r), the additive two-level preconditioner; the coarse and line
    factorisations run here, once per solve.  With a `mesh`, coeff,
    albedo2d and r are this rank's block."""
    from tenstream_tpu_torch.pprts.ediff import make_line_pc

    nx, ny = coeff.shape[-2], coeff.shape[-1]
    gnx, gny = (nx, ny) if mesh is None else mesh.global_shape(nx, ny)
    if cf <= 0:
        cf = auto_coarse_factor(gnx, gny, coarse_target)
    if nx % cf or ny % cf:
        raise ValueError(f"the two-level preconditioner pools {cf} x {cf} cells (from the "
                         f"{gnx} x {gny} grid), which does not divide this rank's {nx} x {ny} "
                         "block; choose a layout whose blocks it divides, or diff_precond="
                         "'two_level_<N>' / 'line'")
    factors = build_coarse_factors(scheme, coeff, albedo2d, cf, gnx // cf, gny // cf, mesh)
    line = make_line_pc(scheme, coeff, albedo2d)
    if mesh is not None:
        bx, by = nx // cf, ny // cf
        own = (slice(mesh.px * bx, (mesh.px + 1) * bx), slice(mesh.py * by, (mesh.py + 1) * by))

    def M(r):
        rc = pool2d(r, cf)
        z_hi = line(r - unpool2d(rc, cf))
        if mesh is None:
            zc = coarse_solve(factors, rc)
        else:
            zc = coarse_solve(factors, mesh.all_gather_blocks(rc))[..., own[0], own[1]]
        return z_hi + unpool2d(zc, cf)

    return M
