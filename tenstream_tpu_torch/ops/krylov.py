"""Matrix-free BiCGStab on tuple-of-tensors states, in lanes (port of
`tenstream_tpu/ops/krylov.py::bicgstab_tree`; reference KSPFBCGS, which
the plexrt wedge solvers use, `plexrt/plex_rt.F90:2228,2408`).

Same algorithm and guards as the JAX function: in-loop breakdown
restarts (`_safe`), a restart from the best iterate every
`restart_every` stalled steps, a stagnation exit after `stall_limit`,
the fallback to the best iterate when an update goes non-finite, and the
stopping rule ||r|| <= max(rtol ||b||, atol).

Every leaf carries a leading lane dimension: each lane
is its own system (dots, scalars and stopping per lane), as under the JAX
package's `jax.vmap`, and a lane that has stopped keeps its state, its
`niter`, `res` and `tol` while the others iterate.  One host sync per
iteration reads the lanes' flags (whether each update was finite, improved
on its best and is still above its tolerance); iteration and stall counts
are kept on the host, and the selections the flags steer are skipped
where every lane agrees.

On a decomposed state (each rank holding its part of every leaf) pass
`reduce`, a sum over the ranks: every dot is one all-reduce, so every
flag the host reads, and with it every rank's sequence of collectives,
is the same on every rank.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

Tree = Tuple[torch.Tensor, ...]


def _lane(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Per-lane scalars (B,) shaped to broadcast against leaf `a`."""
    return c.view((-1,) + (1,) * (a.dim() - 1))


def _dot(u: Sequence[torch.Tensor], v: Sequence[torch.Tensor], reduce=None) -> torch.Tensor:
    """Per-lane dot product over all leaves, (B,); `reduce` sums it over
    the ranks of a decomposed state."""
    d = sum((a * b).sum(dim=tuple(range(1, a.dim()))) for a, b in zip(u, v))
    return d if reduce is None else reduce(d)


def _norm(u, reduce=None) -> torch.Tensor:
    return torch.sqrt(torch.clamp(_dot(u, u, reduce), min=0.0))


def _safe(v: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(v.abs() < eps, torch.where(v < 0, -eps, eps), v)


def _axpy(x, c, y) -> Tree:
    """x + c * y per leaf, c per lane."""
    return tuple(a + _lane(c, b) * b for a, b in zip(x, y))


def _select(mask: List[bool], new, old):
    """Per lane, `new` where mask else `old` (a host mask: whole trees pass
    through where every lane agrees)."""
    if all(mask):
        return new
    if not any(mask):
        return old
    m = torch.as_tensor(mask, device=new[0].device)
    return tuple(torch.where(_lane(m, a), a, b) for a, b in zip(new, old))


def bicgstab_tree(
    A: Callable,
    b,
    x0=None,
    M: Optional[Callable] = None,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    maxiter: int = 1000,
    stall_limit: int = 30,
    restart_every: int = 10,
    reduce: Optional[Callable] = None,
):
    """Right-preconditioned BiCGStab on A(x) = b; `b`, `x0` and A's
    argument and result are tuples of tensors whose leaves lead with the
    lane dimension B.  `reduce` sums a (B,) partial dot over the ranks of a
    decomposed state (None: the state is whole).  Returns (x, niter, res,
    tol): niter (B,) int64 and res, tol (B,) tensors."""
    if M is None:
        M = lambda r: r
    dot = lambda u, v: _dot(u, v, reduce)
    norm = lambda u: _norm(u, reduce)

    b = tuple(b)
    dev, dtype = b[0].device, b[0].dtype
    nb = b[0].shape[0]
    eps = torch.finfo(dtype).tiny * 1e4
    one = torch.ones(nb, dtype=dtype, device=dev)
    zeros = tuple(torch.zeros_like(a) for a in b)

    x = zeros if x0 is None else tuple(x0)
    r = tuple(bb - ax for bb, ax in zip(b, A(x)))
    tol = torch.clamp(rtol * norm(b), min=atol)
    res0 = norm(r)
    rhat, p, v = r, zeros, zeros
    rho = alpha = omega = one
    best_x, best_r, best_res = x, r, res0
    it_h, stall_h = [0] * nb, [0] * nb
    act = [maxiter > 0 and c for c in (res0 > tol).tolist()]

    while any(act):
        lane_on = torch.as_tensor(act, device=dev)
        state0 = (x, r, rhat, p, v, rho, alpha, omega)
        # restart from the best iterate every `restart_every` stalled steps
        restart = [s > 0 and s % restart_every == 0 for s in stall_h]
        if any(restart):
            rm = torch.as_tensor(restart, device=dev)
            x, r, rhat = (_select(restart, best_x, x), _select(restart, best_r, r),
                          _select(restart, best_r, rhat))
            p, v = _select(restart, zeros, p), _select(restart, zeros, v)
            rho, alpha, omega = (torch.where(rm, one, c) for c in (rho, alpha, omega))

        rho_new = dot(rhat, r)
        breakdown = rho_new.abs() < eps * torch.clamp(norm(rhat) * norm(r), min=eps)
        rhat = tuple(torch.where(_lane(breakdown, a), c, a) for a, c in zip(rhat, r))
        rho_new = torch.where(breakdown, dot(r, r), rho_new)
        beta = (rho_new / _safe(rho, eps)) * (alpha / _safe(omega, eps))
        p = tuple(torch.where(_lane(breakdown, rr), rr,
                              rr + _lane(beta, rr) * (pp - _lane(omega, vv) * vv))
                  for rr, pp, vv in zip(r, p, v))

        phat = M(p)
        v = A(phat)
        alpha = rho_new / _safe(dot(rhat, v), eps)
        s = _axpy(r, -alpha, v)
        shat = M(s)
        t = A(shat)
        omega = dot(t, s) / _safe(dot(t, t), eps)
        x_new = tuple(xx + _lane(alpha, ph) * ph + _lane(omega, sh) * sh
                      for xx, ph, sh in zip(x, phat, shat))
        r_new = _axpy(s, -omega, t)
        rho = rho_new

        rr_dot = dot(r_new, r_new)
        ok = torch.isfinite(rr_dot) & torch.isfinite(dot(x_new, x_new))
        res_new = torch.sqrt(torch.clamp(rr_dot, min=0.0))
        improved = res_new < best_res * (1.0 - 1e-4)
        # the iteration's one host sync
        ok_h, improved_h, above_h = torch.stack([ok, improved, res_new > tol]).tolist()
        if not all(ok_h):
            # a non-finite update falls back to the best iterate and its residual
            x_new = _select(ok_h, x_new, best_x)
            r_new = _select(ok_h, r_new, tuple(bb - ax for bb, ax in zip(b, A(best_x))))
            res_new = norm(r_new)
            improved = res_new < best_res * (1.0 - 1e-4)
            improved_h, above_h = torch.stack([improved, res_new > tol]).tolist()

        # lanes that had stopped keep every part of their state
        keep_best = [a and i for a, i in zip(act, improved_h)]
        best_x, best_r = _select(keep_best, x_new, best_x), _select(keep_best, r_new, best_r)
        best_res = torch.where(lane_on & improved, res_new, best_res)
        x, r, rhat, p, v = (_select(act, new, old) for new, old in
                            zip((x_new, r_new, rhat, p, v), state0[:5]))
        rho, alpha, omega = (torch.where(lane_on, new, old) for new, old in
                             zip((rho, alpha, omega), state0[5:]))
        for i in range(nb):
            if act[i]:
                it_h[i] += 1
                stall_h[i] = 0 if improved_h[i] and ok_h[i] else stall_h[i] + 1
                act[i] = it_h[i] < maxiter and above_h[i] and stall_h[i] < stall_limit

    final_res = norm(r)
    x_out = _select((best_res < final_res).tolist(), best_x, x)
    it = torch.as_tensor(it_h, dtype=torch.int64, device=dev)
    return x_out, it, torch.minimum(best_res, final_res), tol
