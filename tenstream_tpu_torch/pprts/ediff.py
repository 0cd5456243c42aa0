"""Diffuse transport solvers for (I - S) x = b, matrix-free (port of
`tenstream_tpu/pprts/ediff.py`).

  * `solve_bicgstab` -- right-preconditioned BiCGStab on A(x) = x - S(x).
    On orbit coefficients every operator apply is the fused kernel K1
    (`cuda_ops.fused_A_dots`): A(u) plus the two Krylov dots the
    iteration needs next.  On dense coefficients A(u) = u - (K3(u) +
    surface closure) and the dots are torch's.
  * `solve_richardson` -- adaptive-omega preconditioned Richardson,
    x <- x + omega M^-1 (b + S x - x); S(x) runs through kernel K2
    (`cuda_ops.orbit_contract`) on orbit coefficients and through K3
    (`cuda_ops.diffuse_apply_dense`) on dense ones.  The solver runs it
    as the convergence-guaranteed polish after BiCGStab, or alone with
    `diff_solver="richardson"`.

On CUDA tensors the kernels run; on CPU tensors their plain versions.
A dense coefficient field may be stored in bfloat16: the kernels and the
preconditioners read it as float32.

Both solvers take a band chunk: b of shape (B, ndiff, Nz+1, Nx, Ny) is B
independent systems (lanes) solved together, the counterpart of the JAX
package's `jax.vmap` over its `lax.while_loop` solvers.  Every scalar of
the iteration is per lane; a lane that has converged or stalled is
frozen -- its iterate and its counts no longer change -- and the loop
ends when every lane has stopped.  Each kernel launch carries the whole
chunk.  An unbatched b (ndiff, Nz+1, Nx, Ny) is a chunk of one and
returns plain numbers.

JAX keeps the iteration on the device.  Here the loop is a Python loop,
and each iteration synchronises with the host exactly once for the whole
chunk: one small tensor of per-lane scalars (residual, the dots the next
iteration's restart and breakdown tests need, a finiteness probe) comes
back in a single transfer.  The scalars that feed vector updates (alpha,
omega, rho) stay (B,) device tensors.  Both solvers return the number of
host syncs they made.

Over a mesh of ranks (`mesh=`, each rank holding its (x, y) block) every
operator apply takes its halos from the neighbouring ranks (K1 and K3 in
halo mode, K2 between halo-aware gather and scatter), and every dot,
norm and sum is the rank's partial sum made global by one `all_reduce`
at each point where the iteration needs it: after each A apply (alpha
and omega), and the per-iteration scalars before the host sync.  Every
decision on the host (freezing a lane, the stall and restart tests, the
polish's divergence guard, omega's controller) reads only those global
values, so all ranks take the same branches and call the collectives in
the same order.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import torch

from tenstream_tpu_torch.core.types import TINY
from tenstream_tpu_torch.pprts.cuda_ops import (
    diffuse_apply_dense,
    diffuse_apply_dense_mesh,
    diffuse_apply_orbit,
    fused_A_dots,
)
from tenstream_tpu_torch.pprts.edir import affine_scan
from tenstream_tpu_torch.pprts.operators import OrbitCoeff, add_surface_reflection
from tenstream_tpu_torch.streams import StreamScheme


def _make_pc(scheme: StreamScheme, coeff, albedo2d, precond, mesh=None) -> Callable:
    """Preconditioner closure from the `diff_precond` option value:
    "two_level" (line + spectral coarse; auto coarse target 64 points at
    global grids of 256 and more, 32 below), "two_level_<N>", "line",
    "none"."""
    if precond in (True, "line"):
        return make_line_pc(scheme, coeff, albedo2d)
    if isinstance(precond, str) and precond.startswith("two_level"):
        from tenstream_tpu_torch.pprts.precond import make_two_level_pc

        tail = precond[len("two_level"):]
        nxy = (coeff.shape[-2], coeff.shape[-1])
        if mesh is not None:
            nxy = mesh.global_shape(*nxy)
        if tail == "":
            target = 64 if max(nxy) >= 256 else 32
        elif tail.startswith("_") and tail[1:].isdigit() and int(tail[1:]) > 0:
            target = int(tail[1:])
        else:
            raise ValueError(
                f"unknown diff_precond value {precond!r}: expected 'two_level'"
                " or 'two_level_<positive int>' (or 'line'/'none')")
        return make_two_level_pc(scheme, coeff, albedo2d, coarse_target=target, mesh=mesh)
    if precond in (False, "none"):
        return lambda r: r
    raise ValueError(f"unknown diff_precond value {precond!r}: expected 'line', "
                     "'two_level', 'two_level_<N>', or 'none'")


def _make_apply(scheme: StreamScheme, coeff, albedo2d, mesh=None) -> Callable:
    """S(x) with the surface closure on ([B,] ndiff, Nz+1, Nx, Ny): gather ->
    K2 -> scatter on orbit coefficients, K3 on dense ones (in halo mode on
    a mesh)."""
    if isinstance(coeff, OrbitCoeff):
        return lambda x: diffuse_apply_orbit(scheme, coeff.idx, coeff.orb, x, albedo2d, mesh)

    def dense(c, x):
        if mesh is None:
            return diffuse_apply_dense(scheme, c, x)
        return diffuse_apply_dense_mesh(scheme, c, x, mesh)

    def apply(x):
        if x.dim() == 5:
            out = dense(coeff, x)
        else:
            out = dense(coeff[None], x[None])[0]
        return add_surface_reflection(scheme, out, x, albedo2d)

    return apply


def _line_blocks(scheme: StreamScheme, coeff):
    """(d_up, d_dn, a_dn, b_dn, a_up, b_up) with the blocks' layer axis
    moved to the front: (Nz, ..., Nx, Ny) float32."""
    inward = scheme.diff_inward()
    d_up = 0 if not inward[0] else 1
    d_dn = 1 - d_up
    if isinstance(coeff, OrbitCoeff):
        e = lambda s, d: torch.movedim(coeff.entry(s, d).float(), -3, 0)
    else:
        e = lambda s, d: torch.movedim(coeff[..., s, d, :, :, :].float(), -3, 0)
    # src Edn -> dst Edn, src Eup -> dst Edn, ...
    return d_up, d_dn, e(d_dn, d_dn), e(d_up, d_dn), e(d_up, d_up), e(d_dn, d_up)


def _dof(r: torch.Tensor, d: int) -> torch.Tensor:
    """Stream d of r (..., ndof, Nz+1, Nx, Ny) with its level axis first."""
    return torch.movedim(r[..., d, :, :, :], -3, 0)


def _with_vertical(r: torch.Tensor, d_dn: int, d_up: int, Edn, Eup) -> torch.Tensor:
    x = r.clone()
    x[..., d_dn, :, :, :] = torch.movedim(Edn, 0, -3)
    x[..., d_up, :, :, :] = torch.movedim(Eup, 0, -3)
    return x


def vertical_line_solve(scheme: StreamScheme, coeff, r: torch.Tensor,
                        albedo2d: torch.Tensor) -> torch.Tensor:
    """Solve M x = r where M keeps only the vertical couplings of (I - S):
    the difftop up/down pair per column (block-tridiagonal in z, solved
    by a backward and a forward sweep) plus the albedo closure; side dofs
    are identity.  The unfactored reference of `make_line_pc`."""
    if scheme.difftop.dof != 2:
        return r
    d_up, d_dn, a_dn, b_dn, a_up, b_up = _line_blocks(scheme, coeff)
    r_dn, r_up = _dof(r, d_dn), _dof(r, d_up)
    nz = a_dn.shape[0]
    R = [None] * (nz + 1)
    Q = [None] * (nz + 1)
    D = [None] * nz
    R[nz], Q[nz] = albedo2d.expand_as(r_up[-1]), r_up[-1]
    for k in range(nz - 1, -1, -1):
        D[k] = 1.0 - b_dn[k] * R[k + 1]
        R[k] = b_up[k] + a_up[k] * R[k + 1] * a_dn[k] / D[k]
        Q[k] = a_up[k] * (R[k + 1] * (b_dn[k] * Q[k + 1] + r_dn[k + 1]) / D[k] + Q[k + 1]) + r_up[k]
    edn = [r_dn[0]]
    for k in range(nz):
        edn.append((a_dn[k] * edn[k] + b_dn[k] * Q[k + 1] + r_dn[k + 1]) / D[k])
    Edn = torch.stack(edn, 0)
    return _with_vertical(r, d_dn, d_up, Edn, torch.stack(R, 0) * Edn + torch.stack(Q, 0))


def _affine_prefix(A: torch.Tensor, c: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """All values of X[k+1] = A[k] X[k] + c[k] with X[0] = x0, by the
    log-depth scan of `edir.affine_scan` over dim 0.  A, c: (n, ...);
    returns (n+1, ...) including x0."""
    P, Q = affine_scan(A[:, None, None], c[:, None])
    return torch.cat([x0[None], P[:, 0, 0] * x0[None] + Q[:, 0]], 0)


def _affine_suffix(A: torch.Tensor, c: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """All values of X[k] = A[k] X[k+1] + c[k] with X[n] = xn."""
    return torch.flip(_affine_prefix(torch.flip(A, (0,)), torch.flip(c, (0,)), xn), (0,))


def make_line_pc(scheme: StreamScheme, coeff, albedo2d: torch.Tensor) -> Callable:
    """Factored vertical-line preconditioner: the r-independent R/D
    elimination runs once here; each apply is two log-depth affine scans
    (same math as `vertical_line_solve`).  Lanes of a band chunk are
    factorised and applied together."""
    if scheme.difftop.dof != 2:
        return lambda r: r
    d_up, d_dn, a_dn, b_dn, a_up, b_up = _line_blocks(scheme, coeff)
    nz = a_dn.shape[0]
    R_next = [None] * nz
    D = [None] * nz
    R = albedo2d.float().expand_as(a_dn[0])
    for k in range(nz - 1, -1, -1):
        R_next[k] = R
        D[k] = 1.0 - b_dn[k] * R
        R = b_up[k] + a_up[k] * R * a_dn[k] / D[k]
    R_next = torch.stack(R_next, 0)
    D = torch.stack(D, 0)
    R_all = torch.cat([R[None], R_next], 0)  # (Nz+1, ...)

    # Q[k] = A_q[k] Q[k+1] + f_dn[k] r_dn[k+1] + r_up[k]
    # Edn[k+1] = A_e[k] Edn[k] + (b_dn[k] Q[k+1] + r_dn[k+1]) / D[k]
    f_dn = a_up * R_next / D
    A_q = a_up * (R_next * b_dn / D + 1.0)
    A_e = a_dn / D
    inv_D = 1.0 / D

    def M(r):
        r_dn, r_up = _dof(r, d_dn), _dof(r, d_up)
        Q_all = _affine_suffix(A_q, f_dn * r_dn[1:] + r_up[:-1], r_up[-1])
        Edn = _affine_prefix(A_e, (b_dn * Q_all[1:] + r_dn[1:]) * inv_D, r_dn[0])
        return _with_vertical(r, d_dn, d_up, Edn, R_all * Edn + Q_all)

    return M


def _lanes(coeff, b: torch.Tensor, x0: Optional[torch.Tensor]):
    """(coeff, b, x0) with a lane dim, and whether the caller passed one."""
    if b.dim() == 5:
        return coeff, b, x0, True
    coeff = OrbitCoeff(coeff.orb[None], coeff.idx) if isinstance(coeff, OrbitCoeff) else coeff[None]
    return coeff, b[None], None if x0 is None else x0[None], False


def _lane_dots(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,) per-lane dot products of (B, ...) fields (on a mesh: this
    rank's partial sums)."""
    return (u * v).reshape(u.shape[0], -1).sum(dim=1)


def _global(t: torch.Tensor, mesh) -> torch.Tensor:
    """Partial sums made global: one all_reduce over the mesh's ranks."""
    return t if mesh is None else mesh.all_reduce(t)


def lane_norms(r: torch.Tensor, mesh=None) -> torch.Tensor:
    """(B,) per-lane 2-norms of (B, ...) fields.  On a mesh the squares of
    the ranks' norms are summed: with one rank, sqrt(n * n) gives back n
    exactly (correctly rounded float arithmetic), so the norm is the
    undecomposed one bit for bit."""
    n = torch.linalg.vector_norm(r.reshape(r.shape[0], -1), dim=1)
    return n if mesh is None else torch.sqrt(mesh.all_reduce(n * n))


def _per_lane(v: torch.Tensor) -> torch.Tensor:
    """(B,) lane scalars -> (B, 1, 1, 1, 1) for vector updates."""
    return v[:, None, None, None, None]


def _lane_tensor(vals, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values per lane as a device tensor.  On the card the copy goes
    through pinned memory without waiting for the device: a plain copy to
    the card would synchronise the stream a second time per iteration."""
    t = torch.tensor(vals, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _keep_lanes(new: torch.Tensor, old: torch.Tensor, frozen: List[int]) -> torch.Tensor:
    """`new` with the frozen lanes' values taken from `old`."""
    if frozen:
        idx = _lane_tensor(frozen, torch.int64, new.device)
        new[idx] = old[idx]
    return new


# the polish gives up on a lane whose residual grows past this multiple of
# its first residual (see solve_richardson)
POLISH_DIVERGED = 10.0


def solve_richardson(
    scheme: StreamScheme,
    coeff,
    b: torch.Tensor,
    albedo2d: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    omega0: Union[float, Sequence[float]] = 1.0,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    max_iter: int = 3000,
    precond="line",
    tol: Union[None, float, Sequence[float]] = None,
    mesh=None,
):
    """Adaptive-omega preconditioned Richardson iteration.  Returns
    (x, niter, omega_final, res, host_syncs); for a band chunk niter,
    omega_final and res are per-lane lists, and omega0 / tol may be too.

    `tol` replaces the relative-to-first-residual stop with an absolute
    residual target (the polish after BiCGStab).  As in the JAX loop, the
    residual tested is that of the iterate before the step, so a lane
    that is already converged still takes one step.

    A polish can diverge where BiCGStab converged: on buildings, a warm
    start left a lane's true residual just above its target, and the
    iteration grew it to NaN in 573 steps (phase 14 of `chip_smoke.py`, an
    H100; the JAX loop has no guard either).  So in polish mode a lane
    whose residual exceeds `POLISH_DIVERGED` times its first one stops and
    returns its starting iterate, residual and omega; a polish that
    converges is untouched.  With a `mesh` the fields are this rank's
    block and the residuals global."""
    coeff, b, x0, lanes = _lanes(coeff, b, x0)
    nb = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0
    M = _make_pc(scheme, coeff, albedo2d, precond, mesh)
    S_apply = _make_apply(scheme, coeff, albedo2d, mesh)
    lane_list = lambda v: [float(a) for a in v] if isinstance(v, (list, tuple)) else [float(v)] * nb
    tols = None if tol is None else lane_list(tol)

    # omega <= 1: this is a Jacobi-type iteration, for which omega > 1
    # diverges once the scattering operator's spectral radius nears 1
    omega_min, omega_max = 0.6, 1.0
    it = [0] * nb
    res, res0, res_prev2 = [math.inf] * nb, [1.0] * nb, [math.inf] * nb
    omega = lane_list(omega0)
    omega_start = list(omega)
    omega_dir, omega_step, log_rate_prev = [1.0] * nb, [0.05] * nb, [0.0] * nb
    syncs = 0
    x_start, diverged = x, [False] * nb

    def running(i):
        if it[i] >= max_iter or diverged[i]:
            return False
        if tols is not None:
            return res[i] >= tols[i]
        return res[i] >= atol and res[i] >= rtol * res0[i]

    active = [running(i) for i in range(nb)]
    while any(active):
        r = b + S_apply(x) - x
        res_dev = lane_norms(r, mesh)
        om = _lane_tensor(omega, b.dtype, b.device)
        x = _keep_lanes(x + _per_lane(om) * M(r), x, [i for i in range(nb) if not active[i]])
        res_new = res_dev.tolist()  # the iteration's one host sync
        syncs += 1
        for i in range(nb):
            if not active[i]:
                continue
            rn = res_new[i]
            if it[i] == 0:
                res0[i] = max(rn, 1e-30)
            elif tols is not None and not rn <= POLISH_DIVERGED * res0[i]:
                # a diverging polish (NaN included): back to where it began
                diverged[i], active[i] = True, False
                res[i], omega[i], it[i] = res0[i], omega_start[i], it[i] + 1
                continue
            # adaptive omega controller (log-rate feedback)
            if it[i] >= 2 and rn > 0 and res_prev2[i] > 0:
                log_rate = 0.5 * math.log(max(rn, 1e-30) / max(res_prev2[i], 1e-30))
                if log_rate < log_rate_prev[i]:
                    omega_step[i] = min(omega_step[i] * 1.3, omega_max - omega_min)
                else:
                    omega_step[i] = max(omega_step[i] * 0.5, 0.01)
                    omega_dir[i] = -omega_dir[i]
                omega[i] = min(max(omega[i] + omega_dir[i] * omega_step[i], omega_min), omega_max)
                log_rate_prev[i] = log_rate
            it[i], res_prev2[i], res[i] = it[i] + 1, res[i], rn
            active[i] = running(i)
    if any(diverged):
        x = torch.where(_per_lane(_lane_tensor(diverged, torch.bool, x.device)), x_start, x)
    if lanes:
        return x, it, omega, res, syncs
    return x[0], it[0], omega[0], res[0], syncs


def _safe(v: torch.Tensor, eps: float) -> torch.Tensor:
    """Divide-safe denominator: keep magnitude >= eps, preserve sign."""
    return torch.where(v.abs() < eps, torch.where(v < 0, -eps, eps).to(v.dtype), v)


def solve_bicgstab(
    scheme: StreamScheme,
    coeff,
    b: torch.Tensor,
    albedo2d: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    maxiter: int = 1000,
    precond="line",
    mesh=None,
):
    """Matrix-free right-preconditioned BiCGStab on A(x) = x - S(x).
    Returns (x, niter, res, host_syncs); for a band chunk niter and res
    are per-lane lists.

    As in the JAX solver: a warm x0 is replaced by its optimal multiple
    alpha x0 (alpha = <A x0, b> / <A x0, A x0>); the Krylov directions
    restart from the current residual every 10 non-improving iterations
    and on a rho breakdown; a non-finite update freezes the iterate and
    counts as a stall; 30 non-improving iterations end the solve (the
    Richardson polish that follows guarantees the final accuracy).  Each
    lane runs this logic on its own scalars.  With a `mesh` the fields are
    this rank's block and every scalar is global."""
    coeff, b, x0, lanes = _lanes(coeff, b, x0)
    nb = b.shape[0]
    if isinstance(coeff, OrbitCoeff):
        alb = albedo2d.expand((nb,) + tuple(b.shape[-2:])).contiguous()
        if mesh is None:
            def fused_AD(u, w):
                Au, dots = fused_A_dots(scheme, coeff.idx, coeff.orb, u, w, alb)
                return Au, dots[:, 0], dots[:, 1]
        else:
            # K1's halo mode: the orbit field's ring once per solve, u's per apply
            orb_pad = mesh.pad(coeff.orb.contiguous())

            def fused_AD(u, w):
                Au, dots = fused_A_dots(scheme, coeff.idx, orb_pad, mesh.pad(u), w, alb, halo=True)
                dots = mesh.all_reduce(dots)
                return Au, dots[:, 0], dots[:, 1]
    else:
        S_apply = _make_apply(scheme, coeff, albedo2d, mesh)

        def fused_AD(u, w):
            Au = u - S_apply(u)
            dots = _global(torch.stack([_lane_dots(w, Au), _lane_dots(Au, Au)]), mesh)
            return Au, dots[0], dots[1]

    M = _make_pc(scheme, coeff, albedo2d, precond, mesh)
    eps = TINY * 1e4
    stall_limit = 30
    restart_every = 10
    syncs = 0
    dev, dt = b.device, b.dtype
    mask = lambda flags: _lane_tensor(flags, torch.bool, dev)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        Ax, num, den = fused_AD(x0, b)
        alpha0 = torch.where(den > eps, num / _safe(den, eps), torch.ones_like(den))
        x = _per_lane(alpha0) * x0
        r = b - _per_lane(alpha0) * Ax
    rhat = r
    one = torch.ones((nb,), dtype=dt, device=dev)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = one

    def reduce(*vals):
        """The per-lane sums made global, stacked: (len(vals), B)."""
        return _global(torch.stack(vals), mesh)

    def fetch(st):
        nonlocal syncs
        syncs += 1
        return st.tolist()

    g = reduce(_lane_dots(b, b), _lane_dots(r, r))
    rr_dev = g[1]
    bb, rr = fetch(g)
    tol = [max(rtol * math.sqrt(q), atol) for q in bb]
    res = [math.sqrt(q) for q in rr]
    rhr_dev, rhr, hh = rr_dev, list(rr), list(rr)
    best_res, stall, it = list(res), [0] * nb, [0] * nb

    def running(i):
        return it[i] < maxiter and res[i] > tol[i] and stall[i] < stall_limit

    active = [running(i) for i in range(nb)]
    while any(active):
        restart = [active[i] and stall[i] > 0 and stall[i] % restart_every == 0
                   for i in range(nb)]
        if any(restart):
            # plateau restart from the current residual
            m = mask(restart)
            m5 = _per_lane(m)
            rhat = torch.where(m5, r, rhat)
            p = torch.where(m5, 0.0, p)
            v = torch.where(m5, 0.0, v)
            rho, alpha, omega = (torch.where(m, one, q) for q in (rho, alpha, omega))
            rhr_dev = torch.where(m, rr_dev, rhr_dev)
            for i in range(nb):
                if restart[i]:
                    rhr[i] = hh[i] = rr[i]
        rho_new = rhr_dev
        p_new = r + _per_lane((rho_new / _safe(rho, eps)) * (alpha / _safe(omega, eps))) * (
            p - _per_lane(omega) * v)
        breakdown = [active[i] and abs(rhr[i]) < eps * max(math.sqrt(hh[i]) * math.sqrt(rr[i]),
                                                           eps) for i in range(nb)]
        if any(breakdown):
            # rho breakdown: restart the directions from the current r
            m = mask(breakdown)
            rhat = torch.where(_per_lane(m), r, rhat)
            rho_new = torch.where(m, rr_dev, rho_new)
            p_new = torch.where(_per_lane(m), r, p_new)
        p = p_new

        phat = M(p)
        v, rv, _ = fused_AD(phat, rhat)
        alpha = rho_new / _safe(rv, eps)
        s = r - _per_lane(alpha) * v
        shat = M(s)
        t, ts, tt = fused_AD(shat, s)
        omega_new = ts / _safe(tt, eps)
        x_new = x + _per_lane(alpha) * phat + _per_lane(omega_new) * shat
        r_new = s - _per_lane(omega_new) * t

        g = reduce(_lane_dots(r_new, r_new), _lane_dots(rhat, r_new), _lane_dots(rhat, rhat),
                   x_new.reshape(nb, -1).sum(dim=1))
        rr_new_dev, rhr_new_dev = g[0], g[1]
        rr_new, rhr_new, hh_new, xsum = fetch(g)
        ok = [math.isfinite(rr_new[i]) and math.isfinite(xsum[i]) for i in range(nb)]
        # frozen lanes and non-finite updates keep the previous iterate
        keep = [i for i in range(nb) if not (active[i] and ok[i])]
        x = _keep_lanes(x_new, x, keep)
        r = _keep_lanes(r_new, r, keep)
        k = mask([i not in keep for i in range(nb)])
        rr_dev = torch.where(k, rr_new_dev, rr_dev)
        rhr_dev = torch.where(k, rhr_new_dev, rhr_dev)
        bad = [i for i in range(nb) if active[i] and not ok[i]]
        if bad:
            # non-finite guard: the kept residual against the new rhat
            g = reduce(_lane_dots(rhat, r), _lane_dots(rhat, rhat))
            rhr_dev = torch.where(mask([i in bad for i in range(nb)]), g[0], rhr_dev)
            rhr_b, hh_b = fetch(g)
        rho, omega = rho_new, omega_new
        for i in range(nb):
            if not active[i]:
                continue
            if ok[i]:
                rr[i], rhr[i], hh[i] = rr_new[i], rhr_new[i], hh_new[i]
            else:
                rhr[i], hh[i] = rhr_b[i], hh_b[i]
            res[i] = math.sqrt(rr[i])
            if res[i] < best_res[i] * (1.0 - 1e-4):
                best_res[i] = res[i]
                stall[i] = 0 if ok[i] else stall[i] + 1
            else:
                stall[i] += 1
            it[i] += 1
            active[i] = running(i)
    if lanes:
        return x, it, res, syncs
    return x[0], it[0], res[0], syncs
