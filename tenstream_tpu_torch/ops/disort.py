"""Multi-stream 1-D solver (DISORT class) by doubling-adding (port of
`tenstream_tpu/ops/disort.py`; the reference couples DISORT as its
plane-parallel column reference, `src/pprts_1D_solvers.F90`, option
handling `src/pprts.F90:2606-2652`).

The matrix-operator method gives the fluxes with batched small matrix
products, inverses and solves only:

  * per layer, reflection and transmission operators R, T of the
    discrete-ordinate flux bins are built by doubling from a second-order
    thin-layer start;
  * solar and thermal emergent-source vectors double alongside (the beam
    attenuates by exp(-dtau / 2^k / mu0) between sub-layers);
  * the layers combine by the adding equations in two sweeps (surface up,
    then TOA down), giving the fluxes at every level.

Everything is batched over columns: shapes (Nz, nb, N, N), N streams per
hemisphere.  Double-Gauss nodes mu_i on (0, 1], a delta-M scaled
Henyey-Greenstein phase function with 2N Legendre moments, flux bins
f_i = 2 pi mu_i w_i I_i, so Edn = sum_i f-_i.

As in the JAX package every layer takes every one of the `n_double`
doubling steps and a mask keeps the layers whose own count is reached
(a per-layer early exit would sum in another order).  The small matrix
products must run in true float32: `disort_fluxes` turns TF32 off for
the duration of the call.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.types import ireals


def _double_gauss(n: int):
    """Gauss-Legendre nodes/weights mapped to (0, 1): sum w = 1."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def _legendre_table(lmax: int, mu: np.ndarray) -> np.ndarray:
    """P_l(mu) for l = 0..lmax, shape (lmax+1, len(mu))."""
    out = np.zeros((lmax + 1, mu.size))
    out[0] = 1.0
    if lmax >= 1:
        out[1] = mu
    for l in range(1, lmax):
        out[l + 1] = ((2 * l + 1) * mu * out[l] - l * out[l - 1]) / (l + 1)
    return out


@contextlib.contextmanager
def _true_float32():
    """Matrix products in IEEE float32 (no TF32) on the card, whatever the
    process-wide default.  One flag only: PyTorch refuses to report the
    matmul precision once its two APIs for it have both been used."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _disort_core(dtau, w0, g, mu0, incSolar, albedo, b_layer, b_srfc, nstreams: int,
                 n_double: int, with_solar: bool, with_thermal: bool):
    """(S, Edn, Eup) on (nz+1, nb) for (nz, nb) layer fields; incSolar,
    albedo and b_srfc (nb,), mu0 a 0-dim tensor."""
    dev = dtau.device
    nz, nb = dtau.shape
    N = nstreams
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=ireals, device=dev)

    # ---- delta-M scaling with 2N moments (chi_l = g^l for HG) ----------
    L = 2 * N - 1
    fpeak = g ** (2 * N)
    dtau_s = (1.0 - w0 * fpeak) * dtau
    w0_s = torch.clamp(w0 * (1.0 - fpeak) / torch.clamp(1.0 - w0 * fpeak, min=1e-12),
                       0.0, 1.0 - 1e-6)

    mu_np, w_np = _double_gauss(N)
    Pl = f32(_legendre_table(L, mu_np))  # (L+1, N)
    mu, wq = f32(mu_np), f32(w_np)
    ls = np.arange(L + 1)
    two_l1 = f32(2 * ls + 1)
    parity = f32((-1.0) ** ls)

    # delta-scaled moments per cell: (L+1, nz, nb)
    gl = torch.pow(g[None], f32(ls)[:, None, None])
    chi = (gl - fpeak[None]) / torch.clamp(1.0 - fpeak[None], min=1e-12)

    # azimuthally averaged phase between the quadrature bins: (nz, nb, N, N)
    coef = two_l1[:, None, None] * chi
    coef_o = coef * parity[:, None, None]
    p_same = torch.einsum("lzb,li,lj->zbij", coef, Pl, Pl)
    p_opp = torch.einsum("lzb,li,lj->zbij", coef_o, Pl, Pl)
    half_w0 = 0.5 * w0_s

    # ---- thin-layer start (flux-bin representation), second order in
    # dt0 with generator blocks A (within a hemisphere) and B (across):
    #   T(dt) = I + dt A + dt^2/2 (A^2 + B^2),  R(dt) = dt B + dt^2/2 (AB + BA)
    # every layer starts near dtau0 ~ 2^-7 and doubles up to its depth
    delta0 = 2.0 ** -7
    m_dbl = torch.clamp(torch.ceil(torch.log2(torch.clamp(dtau_s, min=1e-20) / delta0)),
                        0, n_double)  # (nz, nb)
    dt0 = dtau_s / torch.pow(2.0, m_dbl)
    # gain_ij = (w0/2) w_i p_ij / mu_j
    gain_s = half_w0[..., None, None] * wq[:, None] * p_same / mu[None, None, None, :]
    gain_o = half_w0[..., None, None] * wq[:, None] * p_opp / mu[None, None, None, :]
    del p_same, p_opp
    eye = torch.eye(N, dtype=ireals, device=dev)
    A = gain_s - torch.diag(1.0 / mu)
    B = gain_o
    del gain_s, gain_o
    d1 = dt0[..., None, None]
    h2 = 0.5 * d1 * d1
    T = eye + d1 * A + h2 * (A @ A + B @ B)
    R = d1 * B + h2 * (A @ B + B @ A)
    h2v = 0.5 * dt0[..., None] * dt0[..., None]
    zeros_v = torch.zeros((nz, nb, N), dtype=ireals, device=dev)
    sp = sm = tp = tm = zeros_v
    tb = None
    if with_solar:
        # beam -> bin phase (beam cosine mu0): (nz, nb, N)
        pl0 = [torch.ones_like(mu0), mu0]
        for l in range(1, L):
            pl0.append(((2 * l + 1) * mu0 * pl0[l] - l * pl0[l - 1]) / (l + 1))
        Pl0 = torch.stack(pl0)  # (L+1,)
        pb_same = torch.einsum("lzb,l,li->zbi", coef, Pl0, Pl)
        pb_opp = torch.einsum("lzb,l,li->zbi", coef_o, Pl0, Pl)
        # solar sources per unit (tilted) beam flux at the sub-layer top
        sig_m = half_w0[..., None] * wq * pb_same  # down -> down, per unit dtau
        sig_p = half_w0[..., None] * wq * pb_opp  # down -> up
        inv_mu0 = 1.0 / torch.clamp(mu0, min=1e-6)
        sm = dt0[..., None] * sig_m + h2v * (_mv(A, sig_m) + _mv(B, sig_p) - inv_mu0 * sig_m)
        sp = dt0[..., None] * sig_p + h2v * (_mv(A, sig_p) + _mv(B, sig_m) - inv_mu0 * sig_p)
        tb = torch.exp(-dt0 * inv_mu0)
    if with_thermal:
        sig_t = (1.0 - w0_s)[..., None] * (2.0 * np.pi) * wq * b_layer[..., None]
        tp = tm = dt0[..., None] * sig_t + h2v * (_mv(A, sig_t) + _mv(B, sig_t))
    del A, B, d1, h2

    # ---- doubling (a layer keeps its state once its count is reached) --
    for j in range(n_double):
        act = j < m_dbl
        act_m, act_v = act[..., None, None], act[..., None]
        D = torch.linalg.inv(eye - R @ R)
        TD = T @ D
        Rn = R + TD @ (R @ T)
        Tn = TD @ T
        if with_solar:
            d_s = _mv(D, sm + tb[..., None] * _mv(R, sp))
            sp_n = sp + _mv(T, _mv(R, d_s) + tb[..., None] * sp)
            sm_n = _mv(T, d_s) + tb[..., None] * sm
            sp, sm = torch.where(act_v, sp_n, sp), torch.where(act_v, sm_n, sm)
            tb = torch.where(act, tb * tb, tb)
        if with_thermal:
            d_t = _mv(D, tm + _mv(R, tp))
            tp_n = tp + _mv(T, _mv(R, d_t) + tp)
            tm_n = _mv(T, d_t) + tm
            tp, tm = torch.where(act_v, tp_n, tp), torch.where(act_v, tm_n, tm)
        R, T = torch.where(act_m, Rn, R), torch.where(act_m, Tn, T)
        del D, TD, Rn, Tn

    # ---- beam attenuation to each level --------------------------------
    tb_layer = torch.exp(-dtau_s / torch.clamp(mu0, min=1e-6))  # (nz, nb)
    S_lvl = incSolar * torch.cat([torch.ones((1, nb), dtype=ireals, device=dev),
                                  torch.cumprod(tb_layer, dim=0)], dim=0)  # (nz+1, nb), tilted

    # per-layer sources at their beam strength (and thermal emission)
    src_m = sm * S_lvl[:-1, :, None] + tm  # emergent downward at the layer bottom
    src_p = sp * S_lvl[:-1, :, None] + tp  # emergent upward at the layer top

    # ---- surface ---------------------------------------------------------
    refl_bins = 2.0 * mu * wq  # Lambertian redistribution over the bins
    R_sfc = albedo[:, None, None] * refl_bins[None, :, None] * torch.ones(
        (nb, N, N), dtype=ireals, device=dev)
    dir_sfc = mu0 * S_lvl[-1]  # direct horizontal flux at the surface
    Sup_sfc = albedo[:, None] * refl_bins[None, :] * dir_sfc[:, None]
    if with_thermal:
        Sup_sfc = Sup_sfc + (1.0 - albedo)[:, None] * (2.0 * np.pi) * (mu * wq)[None, :] * \
            b_srfc[:, None]

    # ---- sweep 1, surface up: R_below and S_up at every level ------------
    # (the interface below layer k: u = R_b d + S_u ; d = sm_k + R_k u)
    R_below = [None] * (nz + 1)
    S_up = [None] * (nz + 1)
    R_b, S_u = R_sfc, Sup_sfc
    for k in range(nz - 1, -1, -1):
        R_below[k + 1], S_up[k + 1] = R_b, S_u
        Rk, Tk = R[k], T[k]
        M = eye - Rk @ R_b
        d = torch.linalg.solve(M, (src_m[k] + _mv(Rk, S_u))[..., None])[..., 0]
        u = _mv(R_b, d) + S_u
        S_u = src_p[k] + _mv(Tk, u)
        # R_new = R_k + T_k R_b (I - R_k R_b)^-1 T_k
        R_b = Rk + Tk @ (R_b @ torch.linalg.solve(M, Tk))
    R_below[0], S_up[0] = R_b, S_u

    # ---- sweep 2, TOA down: downward flux bins at every level ------------
    d_all = [torch.zeros((nb, N), dtype=ireals, device=dev)]
    for k in range(nz):
        Rk, Tk = R[k], T[k]
        rhs = _mv(Tk, d_all[k]) + src_m[k] + _mv(Rk, S_up[k + 1])
        d_all.append(torch.linalg.solve(eye - Rk @ R_below[k + 1], rhs[..., None])[..., 0])
    d_all = torch.stack(d_all)  # (nz+1, nb, N)
    u_all = torch.einsum("kbij,kbj->kbi", torch.stack(R_below), d_all) + torch.stack(S_up)
    return S_lvl, d_all.sum(-1), u_all.sum(-1)


def disort_fluxes(dtau: torch.Tensor, w0, g, mu0, incSolar, albedo, planck=None,
                  planck_srfc=None, nstreams: int = 8, n_double: int = 14
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, Edn, Eup) at the Nz+1 levels for every column.

    dtau, w0, g: (Nz, *batch); mu0 the sun's cosine (None: thermal only);
    incSolar the TOA beam on the tilted plane, albedo and planck_srfc
    scalars or tensors broadcastable to (*batch,); planck (Nz+1, *batch) at
    the levels [W/m2/sr] adds thermal emission (layer-mean B).  nstreams
    is per hemisphere (8: a 16-stream DISORT run).  S is in tilted-plane
    units, Edn and Eup horizontal [W/m2].  The beam term is built only
    when mu0 is given or incSolar is not the number 0 (the JAX function
    builds it always; its sources are then exactly 0).

    Every layer starts its doubling near dtau0 ~ 2^-7 and takes the
    doublings it needs, up to n_double (thicker layers start coarser)."""
    dev = dtau.device
    dtau = dtau.to(ireals)
    nz = dtau.shape[0]
    batch = tuple(dtau.shape[1:])
    nb = int(np.prod(batch)) if batch else 1
    t = lambda a: torch.as_tensor(a, dtype=ireals, device=dev)
    flat = lambda a: torch.broadcast_to(t(a), (nz,) + batch).reshape(nz, nb)
    per_col = lambda a: torch.broadcast_to(t(a), batch).reshape(nb)
    with_thermal = planck is not None
    if with_thermal:
        planck = t(planck)
        b_layer = flat(0.5 * (planck[:-1] + planck[1:]))
        b_srfc = per_col(planck[-1] if planck_srfc is None else planck_srfc)
    else:
        b_layer = b_srfc = None
    with_solar = mu0 is not None or not (isinstance(incSolar, (int, float)) and incSolar == 0)
    mu0 = t(1.0 if mu0 is None else mu0)
    mu0 = torch.where(mu0 > 1e-6, mu0, torch.ones_like(mu0))
    with _true_float32():
        S, Edn, Eup = _disort_core(flat(dtau), flat(w0), flat(g), mu0, per_col(incSolar),
                                   per_col(albedo), b_layer, b_srfc, int(nstreams),
                                   int(n_double), with_solar, with_thermal)
    shape = (nz + 1,) + batch
    return S.reshape(shape), Edn.reshape(shape), Eup.reshape(shape)
