"""Direct (solar beam) transport solver (port of
`tenstream_tpu/pprts/edir.py`: `solve_edir`, `solve_edir_sharded`,
`inner_iter_policy`, `_edir_core` and the cyclic affine recurrences).

The z recursion is a sequential loop over layers (exact, like the
reference sweep).  Inside a layer the x and y side-stream recursions are
solved exactly as periodic affine recurrences X[i+1] = A[i] X[i] + B[i]:
an inclusive log-depth (Hillis-Steele) scan of the affine maps along the
axis -- torch has no associative_scan -- then the periodic closure
X[0] = (I - prod A)^-1 Q.  The x<->y cross coupling is relaxed with a
few pair passes plus one Aitken extrapolation and a cleanup pass.

The sun octant enters as host integers (xinc, yinc); the recurrences run
in the canonical (+x, +y, -z) orientation via axis flips.

A band chunk (a leading lane dim on dir2dir and the incoming beam) is
solved in one pass: the lanes ride along as a trailing batch dim of the
scans, and the Aitken step extrapolates each lane with its own rate.

Over a mesh of ranks (`solve_edir_sharded`) each rank holds its (x, y)
block: the in-layer recurrences run as local scans closed by one
all-gather of the per-rank (ds x ds) carry summaries along the row or
column (`cyclic_affine_solve_sharded`), Aitken's sums are all-reduced, and
the octant flips are global data movements (the mirror rank's block, and
the face flip's roll by one crosses a block edge).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tenstream_tpu_torch.streams import StreamScheme


def _flip_cell(arr, dim, axis, mesh=None):
    """Reverse the global field along x or y (axis 0 / 1) at tensor dim."""
    if mesh is None:
        return torch.flip(arr, dims=(dim,))
    return mesh.flip(arr, dim, axis)


def _flip_face(arr, dim, axis, mesh=None):
    # face f -> (N - f) mod N: reverse then roll by one
    if mesh is None:
        return torch.roll(torch.flip(arr, dims=(dim,)), 1, dims=dim)
    return mesh.roll(mesh.flip(arr, dim, axis), 1, dim, axis)


def affine_scan(A: torch.Tensor, B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps x -> A[n] x + B[n] along dim 0
    (later maps applied after earlier ones): returns (P, Q) with
    P[n] = A[n] ... A[0] and Q[n] the composed offset.
    A: (N, ds, ds, ...), B: (N, ds, ...).  log2(N) doubling steps."""
    P, Q = A, B
    n = A.shape[0]
    off = 1
    while off < n:
        Pc, Qc = P[off:], Q[off:]
        Pp, Qp = P[:-off], Q[:-off]
        if P.shape[1] == 1:
            Pn = Pc * Pp
            Qn = Pc[:, :, 0] * Qp + Qc
        else:
            Pn = torch.einsum("nab...,nbc...->nac...", Pc, Pp)
            Qn = torch.einsum("nab...,nb...->na...", Pc, Qp) + Qc
        P = torch.cat([P[:off], Pn], dim=0)
        Q = torch.cat([Q[:off], Qn], dim=0)
        off *= 2
    return P, Q


def _closure_solve(Pl, Ql):
    """X0 = (I - Pl)^-1 Ql for ds in {1, 2}."""
    ds = Ql.shape[0]
    if ds == 1:
        return Ql / torch.clamp(1.0 - Pl[:, 0], min=1e-20)
    if ds == 2:
        a = 1.0 - Pl[0, 0]
        b = -Pl[0, 1]
        c = -Pl[1, 0]
        d = 1.0 - Pl[1, 1]
        det = torch.clamp(a * d - b * c, min=1e-20)
        return torch.stack([(d * Ql[0] - b * Ql[1]) / det,
                            (-c * Ql[0] + a * Ql[1]) / det], dim=0)
    raise NotImplementedError("dirside dof > 2")


def cyclic_affine_solve(A: torch.Tensor, B: torch.Tensor, axis: int) -> torch.Tensor:
    """Solve the periodic recurrence X[i+1] = A[i] X[i] + B[i] along grid
    `axis` (0 = x, 1 = y).  A: (ds, ds, Nx, Ny) [dst, src]; B: (ds, Nx, Ny).
    Returns X face-indexed, shaped like B."""
    Bm = torch.movedim(B, 1 + axis, 0)  # (N, ds, batch)
    Am = torch.movedim(A, 2 + axis, 0)  # (N, ds, ds, batch)
    P, Q = affine_scan(Am, Bm)
    X0 = _closure_solve(P[-1], Q[-1])
    if P.shape[1] == 1:
        Xrest = P[:-1, :, 0] * X0[None] + Q[:-1]
    else:
        Xrest = torch.einsum("nab...,b...->na...", P[:-1], X0) + Q[:-1]
    X = torch.cat([X0[None], Xrest], dim=0)
    return torch.movedim(X, 0, 1 + axis)


def _compose(A2, A1):
    """The maps' product A2 A1 for (ds, ds, ...) blocks."""
    if A2.shape[0] == 1:
        return A2 * A1
    return torch.einsum("ab...,bc...->ac...", A2, A1)


def _apply(A, x):
    """A x for a (ds, ds, ...) block and (ds, ...) vectors."""
    if A.shape[0] == 1:
        return A[:, 0] * x
    return torch.einsum("ab...,b...->a...", A, x)


def cyclic_affine_solve_sharded(A: torch.Tensor, B: torch.Tensor, axis: int,
                                mesh) -> torch.Tensor:
    """`cyclic_affine_solve` of a recurrence whose axis is decomposed over
    the mesh's ranks (the JAX package's `_cyclic_affine_solve_sharded`):
    a local inclusive scan, one all-gather of every rank's (ds x ds)
    summary along the axis, the ring's composition and closure, then this
    rank's start value.  With one rank along the axis the composition is
    with identities only, so the result equals `cyclic_affine_solve`."""
    Bm = torch.movedim(B, 1 + axis, 0)  # (Nloc, ds, batch)
    Am = torch.movedim(A, 2 + axis, 0)
    P, Q = affine_scan(Am, Bm)
    summary = torch.cat([P[-1], Q[-1][:, None]], dim=1)  # (ds, ds + 1, batch)
    parts = mesh.all_gather_axis(summary, axis)
    ds = B.shape[0]
    A_all = [p[:, :ds] for p in parts]
    B_all = [p[:, ds] for p in parts]
    eye = torch.zeros_like(A_all[0])
    for i in range(ds):
        eye[i, i] = 1.0
    # pre[k] maps the ring origin's boundary value to rank k's first value
    pre = [(eye, torch.zeros_like(B_all[0]))]
    M_A, M_B = pre[0]
    for k in range(len(parts)):
        M_A, M_B = _compose(A_all[k], M_A), _apply(A_all[k], M_B) + B_all[k]
        if k < len(parts) - 1:
            pre.append((M_A, M_B))
    X0 = _closure_solve(M_A, M_B)
    myA, myB = pre[mesh.px if axis == 0 else mesh.py]
    X_start = _apply(myA, X0) + myB
    if P.shape[1] == 1:
        Xrest = P[:-1, :, 0] * X_start[None] + Q[:-1]
    else:
        Xrest = torch.einsum("nab...,b...->na...", P[:-1], X_start) + Q[:-1]
    X = torch.cat([X_start[None], Xrest], dim=0)
    return torch.movedim(X, 0, 1 + axis)


def _tdot(c, v):
    """sum_s c[s, d] v[s] per cell: c (s, d, Nx, Ny[, B]), v (s, Nx, Ny[, B])."""
    return torch.einsum("sd...,s...->d...", c, v)


def _edir_core(scheme: StreamScheme, c: torch.Tensor, incoming_top: torch.Tensor,
               n_inner: int, aitken: bool = False, cleanup: bool = True,
               mesh=None) -> torch.Tensor:
    """Canonical-orientation direct solve (photons travel +x, +y, -z)."""
    if mesh is None:
        solve = cyclic_affine_solve
    else:
        solve = lambda A, B, axis: cyclic_affine_solve_sharded(A, B, axis, mesh)
    nt = scheme.dirtop.dof
    ns = scheme.dirside.dof
    nd = scheme.ndir
    nz = c.shape[2]
    cells = tuple(incoming_top.shape[1:])  # (Nx, Ny[, B])
    sl_t = slice(0, nt)
    sl_x = slice(nt, nt + ns)
    sl_y = slice(nt + ns, nt + 2 * ns)

    edir = torch.zeros((nd, nz + 1) + cells, dtype=incoming_top.dtype,
                       device=incoming_top.device)
    T_in = incoming_top
    for k in range(nz):
        c_k = c[:, :, k]
        ctt, ctx, cty = c_k[sl_t, sl_t], c_k[sl_t, sl_x], c_k[sl_t, sl_y]
        cxx = c_k[sl_x, sl_x].transpose(0, 1)  # [dst, src] for the recurrence
        cyy = c_k[sl_y, sl_y].transpose(0, 1)
        cxy, cxt = c_k[sl_x, sl_y], c_k[sl_x, sl_t]
        cyx, cyt = c_k[sl_y, sl_x], c_k[sl_y, sl_t]

        bx_top = _tdot(ctx, T_in)
        by_top = _tdot(cty, T_in)

        def pair(X, Y):
            X = solve(cxx, bx_top + _tdot(cyx, Y), axis=0)
            Y = solve(cyy, by_top + _tdot(cxy, X), axis=1)
            return X, Y

        Y = torch.zeros((ns,) + cells, dtype=T_in.dtype, device=T_in.device)
        X = torch.zeros_like(Y)
        Xp, Yp = X, Y
        Xpp, Ypp = X, Y
        for _ in range(n_inner):
            Xpp, Ypp = Xp, Yp
            Xp, Yp = X, Y
            X, Y = pair(X, Y)

        if aitken and n_inner >= 3:
            dX1, dY1 = X - Xp, Y - Yp
            dX0, dY0 = Xp - Xpp, Yp - Ypp
            lane_sum = lambda a: a.sum(dim=(0, 1, 2))  # per lane, or all for no lanes
            num = lane_sum(dX1 * dX1) + lane_sum(dY1 * dY1)
            den = lane_sum(dX0 * dX0) + lane_sum(dY0 * dY0)
            if mesh is not None:  # global sums: the rate is the undecomposed one
                num, den = mesh.all_reduce(torch.stack([num, den])).unbind(0)
            rho = torch.clamp(torch.sqrt(num / torch.clamp(den, min=1e-30)), max=0.95)
            f = rho / (1.0 - rho)
            X = X + f * dX1
            Y = Y + f * dY1
            if cleanup:
                X, Y = pair(X, Y)

        edir[sl_t, k] = T_in
        edir[sl_x, k] = X
        edir[sl_y, k] = Y
        T_in = _tdot(ctt, T_in) + _tdot(cxt, X) + _tdot(cyt, Y)
    edir[sl_t, nz] = T_in
    return edir


def _canonicalize(dir2dir, incoming_top, xinc, yinc, mesh=None):
    c = dir2dir
    if xinc == 0:
        c = _flip_cell(c, 3, 0, mesh)
        incoming_top = _flip_cell(incoming_top, 1, 0, mesh)
    if yinc == 0:
        c = _flip_cell(c, 4, 1, mesh)
        incoming_top = _flip_cell(incoming_top, 2, 1, mesh)
    return c, incoming_top


def _uncanonicalize(scheme, edir, xinc, yinc, mesh=None):
    nt, ns = scheme.dirtop.dof, scheme.dirside.dof
    sl_t = slice(0, nt)
    sl_x = slice(nt, nt + ns)
    sl_y = slice(nt + ns, nt + 2 * ns)
    if xinc == 0:
        edir = torch.cat([_flip_cell(edir[sl_t], 2, 0, mesh), _flip_face(edir[sl_x], 2, 0, mesh),
                          _flip_cell(edir[sl_y], 2, 0, mesh)], dim=0)
    if yinc == 0:
        edir = torch.cat([_flip_cell(edir[sl_t], 3, 1, mesh), _flip_cell(edir[sl_x], 3, 1, mesh),
                          _flip_face(edir[sl_y], 3, 1, mesh)], dim=0)
    return edir


def inner_iter_policy(theta_deg: float) -> Tuple[int, bool, bool]:
    """(n_inner, aitken, cleanup) by sun zenith angle (the JAX package's
    measured tiers: 4 passes below 70 deg, 7 above, always Aitken +
    cleanup)."""
    if theta_deg < 70.0:
        return 4, True, True
    return 7, True, True


def solve_edir(
    scheme: StreamScheme,
    dir2dir: torch.Tensor,
    incoming_top: torch.Tensor,
    xinc: int,
    yinc: int,
    n_inner: int = 8,
    aitken: bool = False,
    cleanup: bool = True,
    mesh=None,
) -> torch.Tensor:
    """March the direct beam down through all layers.

    dir2dir: ([B,] ndir, ndir, Nz, Nx, Ny) [src, dst]; incoming_top: ([B,]
    ntop, Nx, Ny) [W].  Returns edir ([B,] ndir, Nz+1, Nx, Ny) [W],
    face-indexed.  With a `mesh` the fields are this rank's block
    (`solve_edir_sharded`)."""
    lanes = dir2dir.dim() == 6
    if lanes:  # lanes become the trailing batch dim of the scans
        dir2dir = torch.movedim(dir2dir, 0, -1).contiguous()
        incoming_top = torch.movedim(incoming_top, 0, -1).contiguous()
    if dir2dir.shape[0] != scheme.ndir:
        raise ValueError(f"dir2dir has {dir2dir.shape[0]} dofs, scheme {scheme.ndir}")
    c, inc = _canonicalize(dir2dir, incoming_top, xinc, yinc, mesh)
    edir = _edir_core(scheme, c, inc, n_inner, aitken=aitken, cleanup=cleanup, mesh=mesh)
    edir = _uncanonicalize(scheme, edir, xinc, yinc, mesh)
    return torch.movedim(edir, -1, 0).contiguous() if lanes else edir


def solve_edir_sharded(scheme: StreamScheme, dir2dir: torch.Tensor, incoming_top: torch.Tensor,
                       xinc: int, yinc: int, mesh, n_inner: int = 8, aitken: bool = False,
                       cleanup: bool = True) -> torch.Tensor:
    """`solve_edir` on this rank's (x, y) block of a decomposed field (the
    JAX package's `solve_edir_sharded`): dir2dir and incoming_top are the
    rank's blocks, and so is the result."""
    return solve_edir(scheme, dir2dir, incoming_top, xinc, yinc, n_inner=n_inner,
                      aitken=aitken, cleanup=cleanup, mesh=mesh)
