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

JAX keeps the iteration in a `lax.while_loop` on the device.  Here the
loop is a Python loop, and each iteration synchronises with the host
exactly once: one small tensor of scalars (residual, the dots the next
iteration's restart and breakdown tests need, a finiteness probe) comes
back in a single transfer.  The scalars that feed vector updates (alpha,
omega, rho) stay 0-d device tensors.  Both solvers return the number of
host syncs they made.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from tenstream_tpu_torch.core.types import TINY
from tenstream_tpu_torch.pprts.cuda_ops import (
    diffuse_apply_dense,
    diffuse_apply_orbit,
    fused_A_dots,
)
from tenstream_tpu_torch.pprts.edir import affine_scan
from tenstream_tpu_torch.pprts.operators import OrbitCoeff, add_surface_reflection
from tenstream_tpu_torch.streams import StreamScheme


def _make_pc(scheme: StreamScheme, coeff, albedo2d, precond) -> Callable:
    """Preconditioner closure from the `diff_precond` option value:
    "two_level" (line + spectral coarse; auto coarse target 64 points at
    grids of 256 and more, 32 below), "two_level_<N>", "line", "none"."""
    if precond in (True, "line"):
        return make_line_pc(scheme, coeff, albedo2d)
    if isinstance(precond, str) and precond.startswith("two_level"):
        from tenstream_tpu_torch.pprts.precond import make_two_level_pc

        tail = precond[len("two_level"):]
        if tail == "":
            target = 64 if max(coeff.shape[-2], coeff.shape[-1]) >= 256 else 32
        elif tail.startswith("_") and tail[1:].isdigit() and int(tail[1:]) > 0:
            target = int(tail[1:])
        else:
            raise ValueError(
                f"unknown diff_precond value {precond!r}: expected 'two_level'"
                " or 'two_level_<positive int>' (or 'line'/'none')")
        return make_two_level_pc(scheme, coeff, albedo2d, coarse_target=target)
    if precond in (False, "none"):
        return lambda r: r
    raise ValueError(f"unknown diff_precond value {precond!r}: expected 'line', "
                     "'two_level', 'two_level_<N>', or 'none'")


def _make_apply(scheme: StreamScheme, coeff, albedo2d) -> Callable:
    """S(x) with the surface closure: gather -> K2 -> scatter on orbit
    coefficients, K3 on dense ones."""
    if isinstance(coeff, OrbitCoeff):
        return lambda x: diffuse_apply_orbit(scheme, coeff.idx, coeff.orb, x, albedo2d)
    cb = coeff[None]
    return lambda x: add_surface_reflection(
        scheme, diffuse_apply_dense(scheme, cb, x[None])[0], x, albedo2d)


def _line_blocks(scheme: StreamScheme, coeff):
    inward = scheme.diff_inward()
    d_up = 0 if not inward[0] else 1
    d_dn = 1 - d_up
    if isinstance(coeff, OrbitCoeff):
        e = lambda s, d: coeff.entry(s, d).float()
    else:
        e = lambda s, d: coeff[s, d].float()
    # (Nz, Nx, Ny): src Edn -> dst Edn, src Eup -> dst Edn, ...
    return d_up, d_dn, e(d_dn, d_dn), e(d_up, d_dn), e(d_up, d_up), e(d_dn, d_up)


def vertical_line_solve(scheme: StreamScheme, coeff, r: torch.Tensor,
                        albedo2d: torch.Tensor) -> torch.Tensor:
    """Solve M x = r where M keeps only the vertical couplings of (I - S):
    the difftop up/down pair per column (block-tridiagonal in z, solved
    by a backward and a forward sweep) plus the albedo closure; side dofs
    are identity.  The unfactored reference of `make_line_pc`."""
    if scheme.difftop.dof != 2:
        return r
    d_up, d_dn, a_dn, b_dn, a_up, b_up = _line_blocks(scheme, coeff)
    r_dn, r_up = r[d_dn], r[d_up]
    nz = a_dn.shape[0]
    R = [None] * (nz + 1)
    Q = [None] * (nz + 1)
    D = [None] * nz
    R[nz], Q[nz] = albedo2d, r_up[-1]
    for k in range(nz - 1, -1, -1):
        D[k] = 1.0 - b_dn[k] * R[k + 1]
        R[k] = b_up[k] + a_up[k] * R[k + 1] * a_dn[k] / D[k]
        Q[k] = a_up[k] * (R[k + 1] * (b_dn[k] * Q[k + 1] + r_dn[k + 1]) / D[k] + Q[k + 1]) + r_up[k]
    edn = [r_dn[0]]
    for k in range(nz):
        edn.append((a_dn[k] * edn[k] + b_dn[k] * Q[k + 1] + r_dn[k + 1]) / D[k])
    Edn = torch.stack(edn, 0)
    x = r.clone()
    x[d_dn] = Edn
    x[d_up] = torch.stack(R, 0) * Edn + torch.stack(Q, 0)
    return x


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
    (same math as `vertical_line_solve`)."""
    if scheme.difftop.dof != 2:
        return lambda r: r
    d_up, d_dn, a_dn, b_dn, a_up, b_up = _line_blocks(scheme, coeff)
    nz = a_dn.shape[0]
    R_next = [None] * nz
    D = [None] * nz
    R = albedo2d.float()
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
        r_dn, r_up = r[d_dn], r[d_up]
        Q_all = _affine_suffix(A_q, f_dn * r_dn[1:] + r_up[:-1], r_up[-1])
        Edn = _affine_prefix(A_e, (b_dn * Q_all[1:] + r_dn[1:]) * inv_D, r_dn[0])
        x = r.clone()
        x[d_dn] = Edn
        x[d_up] = R_all * Edn + Q_all
        return x

    return M


def solve_richardson(
    scheme: StreamScheme,
    coeff,
    b: torch.Tensor,
    albedo2d: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    omega0: float = 1.0,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    max_iter: int = 3000,
    precond="line",
    tol: Optional[float] = None,
) -> Tuple[torch.Tensor, int, float, float, int]:
    """Adaptive-omega preconditioned Richardson iteration.  Returns
    (x, niter, omega_final, res, host_syncs).

    `tol` replaces the relative-to-first-residual stop with an absolute
    residual target (the polish after BiCGStab).  As in the JAX loop, the
    residual tested is that of the iterate before the step, so a solve
    that is already converged still takes one step."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = _make_pc(scheme, coeff, albedo2d, precond)
    S_apply = _make_apply(scheme, coeff, albedo2d)

    # omega <= 1: this is a Jacobi-type iteration, for which omega > 1
    # diverges once the scattering operator's spectral radius nears 1
    omega_min, omega_max = 0.6, 1.0
    it, res, res0, res_prev2 = 0, math.inf, 1.0, math.inf
    omega, omega_dir, omega_step, log_rate_prev = float(omega0), 1.0, 0.05, 0.0
    syncs = 0

    def unconverged():
        if tol is not None:
            return res >= tol
        return res >= atol and res >= rtol * res0

    while it < max_iter and unconverged():
        r = b + S_apply(x) - x
        res_dev = torch.linalg.vector_norm(r)
        x = x + omega * M(r)
        res_new = float(res_dev)  # the iteration's one host sync
        syncs += 1
        if it == 0:
            res0 = max(res_new, 1e-30)
        # adaptive omega controller (log-rate feedback)
        if it >= 2 and res_new > 0 and res_prev2 > 0:
            log_rate = 0.5 * math.log(max(res_new, 1e-30) / max(res_prev2, 1e-30))
            if log_rate < log_rate_prev:
                omega_step = min(omega_step * 1.3, omega_max - omega_min)
            else:
                omega_step = max(omega_step * 0.5, 0.01)
                omega_dir = -omega_dir
            omega = min(max(omega + omega_dir * omega_step, omega_min), omega_max)
            log_rate_prev = log_rate
        it, res_prev2, res = it + 1, res, res_new
    return x, it, omega, res, syncs


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
) -> Tuple[torch.Tensor, int, float, int]:
    """Matrix-free right-preconditioned BiCGStab on A(x) = x - S(x).
    Returns (x, niter, res, host_syncs).

    As in the JAX solver: a warm x0 is replaced by its optimal multiple
    alpha x0 (alpha = <A x0, b> / <A x0, A x0>); the Krylov directions
    restart from the current residual every 10 non-improving iterations
    and on a rho breakdown; a non-finite update freezes the iterate and
    counts as a stall; 30 non-improving iterations end the solve (the
    Richardson polish that follows guarantees the final accuracy)."""
    dot = lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1))
    if isinstance(coeff, OrbitCoeff):
        orb = coeff.orb[None]
        alb = albedo2d.expand(b.shape[-2:]).contiguous()[None]

        def fused_AD(u, w):
            Au, dots = fused_A_dots(scheme, coeff.idx, orb, u[None], w[None], alb)
            return Au[0], dots[0, 0], dots[0, 1]
    else:
        S_apply = _make_apply(scheme, coeff, albedo2d)

        def fused_AD(u, w):
            Au = u - S_apply(u)
            return Au, dot(w, Au), dot(Au, Au)

    M = _make_pc(scheme, coeff, albedo2d, precond)
    eps = TINY * 1e4
    stall_limit = 30
    restart_every = 10
    syncs = 0

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        Ax, num, den = fused_AD(x0, b)
        alpha0 = torch.where(den > eps, num / _safe(den, eps), torch.ones_like(den))
        x = alpha0 * x0
        r = b - alpha0 * Ax
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = one

    def fetch(*vals):
        nonlocal syncs
        syncs += 1
        return torch.stack(vals).tolist()

    rr_dev = dot(r, r)
    bb, rr = fetch(dot(b, b), rr_dev)
    tol = max(rtol * math.sqrt(bb), atol)
    res = math.sqrt(rr)
    rhr_dev, rhr, hh = rr_dev, rr, rr
    best_res, stall, it = res, 0, 0

    while it < maxiter and res > tol and stall < stall_limit:
        if stall > 0 and stall % restart_every == 0:
            # plateau restart from the current residual
            rhat, rhr_dev, rhr, hh = r, rr_dev, rr, rr
            p = torch.zeros_like(b)
            v = torch.zeros_like(b)
            rho = alpha = omega = one
        rho_new = rhr_dev
        if abs(rhr) < eps * max(math.sqrt(hh) * math.sqrt(rr), eps):
            # rho breakdown: restart the directions from the current r
            rhat, rho_new = r, rr_dev
            p = r
        else:
            p = r + (rho_new / _safe(rho, eps)) * (alpha / _safe(omega, eps)) * (p - omega * v)

        phat = M(p)
        v, rv, _ = fused_AD(phat, rhat)
        alpha = rho_new / _safe(rv, eps)
        s = r - alpha * v
        shat = M(s)
        t, ts, tt = fused_AD(shat, s)
        omega_new = ts / _safe(tt, eps)
        x_new = x + alpha * phat + omega_new * shat
        r_new = s - omega_new * t

        rr_new_dev, rhr_new_dev = dot(r_new, r_new), dot(rhat, r_new)
        rr_new, rhr_new, hh_new, xsum = fetch(rr_new_dev, rhr_new_dev, dot(rhat, rhat),
                                              x_new.sum())
        ok = math.isfinite(rr_new) and math.isfinite(xsum)
        if ok:
            x, r = x_new, r_new
            rr_dev, rr, rhr_dev, rhr, hh = rr_new_dev, rr_new, rhr_new_dev, rhr_new, hh_new
        else:
            # non-finite guard: keep the previous iterate, count a stall
            rhr_dev = dot(rhat, r)
            rhr, hh = fetch(rhr_dev, dot(rhat, rhat))
        rho, omega = rho_new, omega_new
        res = math.sqrt(rr)
        if res < best_res * (1.0 - 1e-4):
            best_res = res
            stall = 0 if ok else stall + 1
        else:
            stall += 1
        it += 1
    return x, it, res, syncs
