"""Full-domain Monte-Carlo reference solver on the 3-D grid: the port of
`tenstream_tpu/pprts/mcdmda.py` (reference `src/mcdmda.F90`,
`solve_mcdmda`:125).

Photons start uniformly over the top plane, travel along the sun
direction and march cell by cell through piecewise-constant optical
properties: each step goes to the next cell wall (overshooting it by a
cell-relative epsilon) or to a sampled scattering point, absorbs by
implicit capture, wraps periodically in x and y, escapes at TOA, and at
the surface reflects Lambertian with probability `albedo`.  Weights
below 1e-4 face Russian roulette.  The tallies are per-cell absorption,
TOA upward and surface downward / absorbed flux.

The draws are the JAX package's, bit for bit: they are counter based, so
photon p draws element p of `jax.random.uniform(step_key, (n,))`
whether or not the other photons still walk.  The key schedule is
JAX's: `k0, k1, kloop = split(key, 3)` (start positions; the first free
paths from `fold_in(kloop, 0)`), then per step `key, ks, kc, kp, kr, ka2
= split(key, 6)` with `fold_in(ka2, 1)` (the reflected azimuth) and
`fold_in(kr, 2)` (the roulette).  The keys are hashed on the host; each
step draws only what its live photons use, in one threefry call.

The physics is float32 and follows JAX's operation for operation, so a
photon walks the same path on every device and in both packages: where
XLA's CPU backend contracts a product and a sum into one fused
multiply-add, `_fma` rounds once; `exp` and `log` are XLA's float32
Cephes polynomials and `sin` / `cos` glibc's `sinf` / `cosf`, which
`jnp.exp`, `jnp.log`, `jnp.sin` and `jnp.cos` evaluate on the CPU.  The
walk compacts its state to the live photons every step, each photon
keeping its index as its draw counter; on the card, once few photons are
left, it steps them masked, as JAX does, from CUDA graphs (`DENSE_MAX`).
The tallies are float64 sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tenstream_tpu_torch.core import prng

_MASK = 0xFFFFFFFF
_F32 = np.float32
_TWO_PI = float(_F32(2 * math.pi))

# The walk's work since the last `reset_stats()`: steps, live photons per
# step, photons, photon-steps.
STATS = {"steps": 0, "live": [], "photons": 0, "photon_steps": 0}


def reset_stats() -> None:
    STATS.update(steps=0, live=[], photons=0, photon_steps=0)


class McResult(NamedTuple):
    abso: torch.Tensor  # (Nz, Nx, Ny) absorbed power [W/m3]
    eup_toa: torch.Tensor  # (Nx, Ny) upward flux at TOA [W/m2]
    edn_srfc: torch.Tensor  # (Nx, Ny) total downward flux at surface [W/m2]
    sfc_absorbed: torch.Tensor  # (Nx, Ny) [W/m2]
    leftover: torch.Tensor  # scalar: untallied weight fraction (diagnostics)
    niter: int  # iterations used


# ---------------------------------------------------------------------------
# float32 arithmetic as XLA's CPU backend evaluates it
# ---------------------------------------------------------------------------

def _fma_exact(a, b, c):
    """a * b + c with one rounding: the float64 product of two float32
    values is exact."""
    d = lambda v: v.double() if torch.is_tensor(v) else float(v)
    return (d(a) * d(b) + d(c)).float()


_FAST = {}
_SCALARS = {}


def _fast(device) -> dict:
    """Which float32 operations of torch on `device` round as the walk
    needs, checked once on a random sample: `fma`, torch.addcmul and
    torch.add(..., alpha=) fused into one rounding; `sqrt`, torch.sqrt
    correctly rounded (not so on every CPU build).  Where they do, they
    replace the float64 emulations, which give the same bits slower."""
    key = str(device)
    if key not in _FAST:
        g = torch.Generator().manual_seed(1)
        a, b, c = (torch.randn(1 << 16, generator=g).to(device) * s for s in (1.0, 3.0, 0.5))
        s = float(_F32(0.7071067811865476))
        one = torch.ones((), device=device)
        fma = (torch.equal(torch.addcmul(c, a, b), _fma_exact(a, b, c))
               and torch.equal(torch.addcmul(one, a, b), _fma_exact(a, b, 1.0))
               and torch.equal(torch.add(c, a, alpha=s), _fma_exact(a, s, c))
               and torch.equal(torch.add(one, a, alpha=s), _fma_exact(a, s, 1.0)))
        x = a.abs()
        _FAST[key] = {"fma": fma, "sqrt": torch.equal(torch.sqrt(x), x.double().sqrt().float())}
    return _FAST[key]


def _scalar(v: float, device) -> torch.Tensor:
    k = (v, str(device))
    if k not in _SCALARS:
        _SCALARS[k] = torch.tensor(v, dtype=torch.float32, device=device)
    return _SCALARS[k]


def _fma(a, b, c):
    """a * b + c with one rounding, as XLA's CPU backend contracts it; the
    float scalars among b and c (or a) are float32 values."""
    if not torch.is_tensor(a):
        a, b = b, a
    if not _fast(a.device)["fma"]:
        return _fma_exact(a, b, c)
    if not torch.is_tensor(c):
        c = _scalar(float(c), a.device)
    if torch.is_tensor(b):
        return torch.addcmul(c, a, b)
    return torch.add(c, a, alpha=b)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    if _fast(x.device)["sqrt"]:
        return torch.sqrt(x)
    return x.double().sqrt().float()


def _exp(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp` of float32 on the CPU: Cephes' expf (range reduction by
    n ln 2 in two parts, degree-5 polynomial, scale by 2^n)."""
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.floor(_fma(x, float(_F32(1.44269504088896341)), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    x = _fma(n, -0.693359375, x)
    x = _fma(n, float(-_F32(-2.12194440e-4)), x)
    z = _fma(x, float(_F32(1.9875691500e-4)), float(_F32(1.3981999507e-3)))
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1):
        z = _fma(z, x, float(_F32(c)))
    z = _fma(z, x * x, x) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z * pow2


_LOG_P = [float(_F32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]


def _log(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log` of positive normal float32 on the CPU: Cephes' logf."""
    t = torch.clamp(x, min=float(np.array(0x00800000, np.uint32).view(_F32)))
    bits = t.view(torch.int32)
    e = (bits >> 23).float() - 127.0 + 1.0
    t = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = t < float(_F32(0.707106781186547524))
    e = e - small.float()
    t = (t - 1.0) + torch.where(small, t, torch.zeros_like(t))
    x2 = t * t
    x3 = x2 * t
    P = _LOG_P
    y = _fma(t, P[0], P[1])
    y1 = _fma(t, P[3], P[4])
    y2 = _fma(t, P[6], P[7])
    y = _fma(y, t, P[2])
    y1 = _fma(y1, t, P[5])
    y2 = _fma(y2, t, P[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * float(_F32(-2.12194440e-4)))
    t = _fma(x2, -0.5, t)
    t = t + y
    return _fma(e, 0.693359375, t)


# glibc's sinf / cosf (sysdeps/ieee754/flt-32/s_sinf.c): double arithmetic,
# one rounding to float at the end
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_C = [float.fromhex(h) for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                 "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_S = [float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                 "-0x1.994eb3774cf24p-13")]
_TOP12_PIO4 = 0x3F490FDB >> 20  # abstop12(pi/4)
_TOP12_TINY = 0x39800000 >> 20  # abstop12(0x1p-12)


def _sincos_poly(x, x2, odd, negate_c):
    """sinf_poly: the sine polynomial where `odd` is False, else the cosine
    one (coefficients negated where `negate_c`)."""
    x3 = x * x2
    s = (x + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    sgn = torch.where(negate_c, -1.0, 1.0).double()
    x4 = x2 * x2
    c = (sgn * _C[0] + x2 * (sgn * _C[1])) + x4 * (sgn * _C[2])
    c = c + (x4 * x2) * (sgn * _C[3] + x2 * (sgn * _C[4]))
    return torch.where(odd, c, s)


_CONSTANTS = {}


def _const(name: str, device) -> torch.Tensor:
    """Small constant tensors, made once per device (a step replayed from a
    CUDA graph copies nothing from the host)."""
    k = (name, str(device))
    if k not in _CONSTANTS:
        _CONSTANTS[k] = {
            "sign": lambda: torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64),
            "sincos": lambda: torch.tensor([False, True])[:, None],
            "row_z": lambda: torch.tensor([False, False, True])[:, None],
        }[name]().to(device)
    return _CONSTANTS[k]


def _sinf_cosf(y: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """glibc's sinf (where `cos` is False) or cosf of finite |y| < 120; `cos`
    is a bool tensor that broadcasts against y."""
    top = (y.view(torch.int32) >> 20) & 0x7FF
    x = y.double()
    r = x * _HPI_INV
    n = (r.to(torch.int32) + 0x800000) >> 24
    xr = x - n.double() * _HPI
    sign = _const("sign", y.device)[n & 3]
    q = n ^ cos.int()
    red = _sincos_poly(xr * sign, xr * xr, (q & 1) == 1, (n & 2) == 2)
    small = _sincos_poly(x, x * x, cos.expand(n.shape), torch.zeros_like(n, dtype=torch.bool))
    out = torch.where(top < _TOP12_PIO4, small, red).float()
    tiny = torch.where(cos, torch.ones_like(y), y)
    return torch.where(top < _TOP12_TINY, tiny, out)


def _sincos(y: torch.Tensor):
    """(glibc's sinf, cosf) of y (m,) in one pass over [y, y]."""
    both = _sinf_cosf(torch.stack([y, y]), _const("sincos", y.device))
    return both[0], both[1]


def _floordiv(x: torch.Tensor, y: float) -> torch.Tensor:
    """`x // y` for float32 as jnp evaluates it (fmod, then the floor)."""
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    fix = (mod != 0) & ((mod < 0) != (y < 0))
    return torch.round(torch.where(fix, div - 1.0, div))


def _remainder(x: torch.Tensor, y: float) -> torch.Tensor:
    """`x % y` for float32 as jnp evaluates it."""
    mod = torch.fmod(x, y)
    fix = (mod != 0) & ((mod < 0) != (y < 0))
    return torch.where(fix, mod + y, mod)


# ---------------------------------------------------------------------------
# the physics of one step, on (3, m) positions and directions
# ---------------------------------------------------------------------------

class _Medium(NamedTuple):
    kabs: torch.Tensor  # (nz * nx * ny,) float32
    ksca: torch.Tensor
    g: torch.Tensor
    zlev: torch.Tensor  # (nz + 1,) depth below TOA
    shape: tuple  # (nz, nx, ny)
    width: torch.Tensor  # (2, 1): dx, dy
    length: torch.Tensor  # (2, 1): Lx, Ly
    top: torch.Tensor  # (2, 1): nx - 1, ny - 1
    H: float
    eps_wall: float
    albedo: float


def _hg(u, g):
    iso = g.abs() < 1e-4
    gs = torch.where(iso, torch.full_like(g, 0.5), g)
    frac = _fma(-gs, gs, 1.0) / _fma(2.0 * gs, u, 1.0 - gs)
    ct = _fma(-frac, frac, _fma(gs, gs, 1.0)) / (2.0 * gs)
    return torch.clamp(torch.where(iso, _fma(2.0, u, -1.0), ct), -1.0, 1.0)


def _rotate(d, ct, phi):
    """The direction d (3, m) turned by acos(ct) at azimuth phi."""
    dx, dy, dz = d
    st = _sqrt(torch.clamp(_fma(-ct, ct, 1.0), min=0.0))
    denom = _sqrt(torch.clamp(_fma(-dz, dz, 1.0), min=1e-12))
    straight = dz.abs() > 0.99999
    ux = torch.where(straight, torch.ones_like(dy), dy / denom)
    uy = torch.where(straight, torch.zeros_like(dx), -dx / denom)
    vx = uy * dz
    vy = -ux * dz
    vz = _fma(ux, dy, -(uy * dx))
    sp, cp = _sincos(phi)
    nx = _fma(st, _fma(cp, ux, sp * vx), ct * dx)
    ny = _fma(st, _fma(cp, uy, sp * vy), ct * dy)
    nz = _fma(st * sp, vz, ct * dz)
    n = _sqrt(torch.clamp(_fma(nz, nz, _fma(nx, nx, ny * ny)), min=1e-30))
    return torch.stack([nx, ny, nz]) / n


def _cell(md: _Medium, pos):
    """The cell of each photon: (i, j) (2, m), k (m,), the flat index."""
    nz, nx, ny = md.shape
    ij = torch.minimum(torch.clamp(_floordiv(pos[:2], md.width).long(), min=0), md.top)
    k = torch.clamp(torch.searchsorted(md.zlev, pos[2], right=True) - 1, 0, nz - 1)
    return ij, k, (k * nx + ij[0]) * ny + ij[1]


def _wall_distance(md: _Medium, pos, d, ij, k):
    """Distance to the next cell wall plus the overshoot (JAX's axis_dist
    on x, y and z at once; XLA contracts the x / y walls' products into the
    differences)."""
    fij = ij.float()
    lo = torch.cat([_fma(fij, md.width, -pos[:2]), (md.zlev[k] - pos[2])[None]])
    hi = torch.cat([_fma(fij + 1.0, md.width, -pos[:2]), (md.zlev[k + 1] - pos[2])[None]])
    small = d.abs() < 1e-9
    d_safe = torch.where(small, torch.full_like(d, 1e-9), d)
    t = torch.where(d > 0, hi / d_safe, lo / d_safe)
    t = torch.where(small, torch.full_like(t, 1e30), torch.clamp(t, min=0.0))
    return t.amin(0) + md.eps_wall


class _State(NamedTuple):
    pos: torch.Tensor  # (3, m) x, y, depth below TOA
    dir: torch.Tensor  # (3, m) travel direction, z growing downward
    w: torch.Tensor
    tau: torch.Tensor  # optical depth left to the next scattering
    alive: torch.Tensor
    pid: torch.Tensor  # the photon's index: its draw counter


def _move(md: _Medium, st: _State):
    """First half of a step: to the next wall or scattering point, with
    implicit absorption.  Returns the moved state, the step's cells,
    `scattering` and the absorbed weight per photon."""
    ij, k, flat = _cell(md, st.pos)
    ka, ksc, gg = md.kabs[flat], md.ksca[flat], md.g[flat]
    t_wall = _wall_distance(md, st.pos, st.dir, ij, k)
    t_sca = torch.where(ksc > 1e-12, st.tau / torch.clamp(ksc, min=1e-12),
                        torch.full_like(st.tau, 1e30))
    travel = torch.minimum(t_wall, t_sca)
    scattering = st.alive & (t_sca < t_wall)
    tau = torch.where(scattering, torch.zeros_like(st.tau), _fma(-ksc, travel, st.tau))
    w_new = st.w * _exp(-ka * travel)
    dw = torch.where(st.alive, st.w - w_new, torch.zeros_like(w_new))
    pos = _fma(st.dir, travel, st.pos)
    pos = torch.cat([_remainder(pos[:2], md.length), pos[2:]])
    moved = st._replace(pos=torch.where(st.alive, pos, st.pos), tau=tau,
                        w=torch.where(st.alive, w_new, st.w))
    return moved, (ij, flat, gg), scattering, dw


def _draw_need(md: _Medium, st: _State, scattering):
    """(7, m): which photons use which of the step's draws (a superset)."""
    hit = st.pos[2] >= md.H
    tau = scattering | (st.tau <= 0) | hit
    return torch.stack([scattering, scattering, tau, hit, hit, hit, st.w < 1e-4]) & st.alive


def _reflected(u_mu, u_phi):
    """Lambertian directions upward (3, m); XLA simplifies sqrt(u) * sqrt(u)
    to u."""
    s, c = _sincos(u_phi * _TWO_PI)
    st = _sqrt(torch.clamp(1.0 - u_mu, min=0.0))
    return torch.stack([st * c, st * s, -_sqrt(u_mu)])


def _events(md: _Medium, st: _State, cells, scattering, u, tallies, sub=None):
    """Second half of a step (draws u (7, m)): scattering, TOA escape, the
    surface, the roulette; adds the exits to `tallies` (3, nx * ny).  The
    new directions and free paths are evaluated for every photon, or (sub:
    the indices of the photons that draw kc, ks and kr) for those only."""
    ij, flat, gg = cells
    nx_ny = tallies.shape[1]
    if sub is None:
        d = torch.where(scattering, _rotate(st.dir, _hg(u[KC], gg), u[KP] * _TWO_PI), st.dir)
        tau_new = -_log(torch.clamp(u[KS], min=1e-12))
        up = _reflected(u[KA2], u[KA2F])
    else:
        sc, ts, hs = sub
        d, up, tau_new = st.dir.clone(), torch.zeros_like(st.dir), torch.zeros_like(st.tau)
        d[:, sc] = _rotate(st.dir[:, sc], _hg(u[KC, sc], gg[sc]), u[KP, sc] * _TWO_PI)
        tau_new[ts] = -_log(torch.clamp(u[KS, ts], min=1e-12))
        up[:, hs] = _reflected(u[KA2, hs], u[KA2F, hs])
    tau = torch.where(scattering | (st.tau <= 0), tau_new, st.tau)
    depth = st.pos[2]
    escaped = st.alive & (depth <= 0.0)
    alive = st.alive & ~escaped
    hit = alive & (depth >= md.H)
    reflect = hit & (u[KR] < md.albedo)
    absorbed = hit & ~reflect
    alive = alive & ~absorbed
    col = ij[0] * md.shape[2] + ij[1]
    zero = torch.zeros_like(st.w)
    tallies.view(-1).index_add_(0, torch.cat([col, col + nx_ny, col + 2 * nx_ny]), torch.cat(
        [torch.where(escaped, st.w, zero), torch.where(hit, st.w, zero),
         torch.where(absorbed, st.w, zero)]).double())
    d = torch.where(reflect, up, d)
    pos = torch.where(reflect & _const("row_z", reflect.device), float(_F32(md.H) - _F32(1e-5)),
                      st.pos)
    tau = torch.where(reflect, tau_new, tau)
    low = alive & (st.w < 1e-4)
    surv = u[KRF] < 0.5
    w = torch.where(low & surv, st.w * 2.0, st.w)
    return _State(pos, d, w, tau, alive & (~low | surv), st.pid)


def _step(md: _Medium, st: _State, draw, abso, tallies) -> _State:
    """One step of every photon in st (JAX's loop body); `draw(md, moved
    state, scattering)` gives the step's uniforms (7, m), valid where used,
    and the photons that use them (or None: every photon)."""
    st, cells, scattering, dw = _move(md, st)
    abso.index_add_(0, cells[1], dw.double())
    u, sub = draw(md, st, scattering)
    return _events(md, st, cells, scattering, u, tallies, sub)


def _sparse_draws(keys):
    """The step's uniforms for the (draw, photon) pairs that use them."""
    def draw(md, st, scattering):
        need = _draw_need(md, st, scattering)
        sizes = need.sum(1).tolist()
        g, p = need.nonzero().unbind(1)  # draw-major, so p splits by draw
        u = torch.zeros(need.shape, dtype=torch.float32, device=need.device)
        if g.numel():
            kg = keys[g]
            y0, y1 = prng.threefry2x32(kg[:, 0], kg[:, 1], torch.zeros_like(p), st.pid[p])
            u[g, p] = prng.to_uniform(y0 ^ y1)
        per_draw = p.split(sizes)
        return u, (per_draw[KC], per_draw[KS], per_draw[KR])
    return draw


def _dense_draws(keys):
    """All seven uniforms of every photon: no data-dependent shapes."""
    def draw(md, st, scattering):
        y0, y1 = prng.threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(st.pid)[None],
                                   st.pid[None])
        return prng.to_uniform(y0 ^ y1), None
    return draw


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def _threefry_int(k0: int, k1: int, x0: int, x1: int):
    """threefry2x32 of one counter pair under one key, in Python ints."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in prng._ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _split(key, n):
    return [_threefry_int(*key, 0, i) for i in range(n)]


def _fold_in(key, d):
    return _threefry_int(*key, 0, d & _MASK)


# order of the seven draws in a step's key table
KC, KP, KS, KR, KA2, KA2F, KRF = range(7)


def _step_keys(key):
    """(next loop key, the step's seven draw keys in the order above)."""
    key, ks, kc, kp, kr, ka2 = _split(key, 6)
    return key, [kc, kp, ks, kr, ka2, _fold_in(ka2, 1), _fold_in(kr, 2)]


class _KeyTable:
    """Every step's seven draw keys, (max_iter, 7, 2) int64 on the device,
    hashed on the host in blocks as the loop reaches them."""

    BLOCK = 64

    def __init__(self, kloop, max_iter: int, device):
        self.key, self.done = kloop, 0
        self.table = torch.zeros((max(max_iter, 1), 7, 2), dtype=torch.int64, device=device)

    def upto(self, n: int) -> torch.Tensor:
        n = min(n, self.table.shape[0])
        if n > self.done:
            stop = min(self.table.shape[0], max(n, self.done + self.BLOCK))
            rows = []
            for _ in range(self.done, stop):
                self.key, keys = _step_keys(self.key)
                rows.append(keys)
            self.table[self.done:stop] = torch.tensor(rows, dtype=torch.int64)
            self.done = stop
        return self.table


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

# On the card the walk switches from compacting every step to segments of
# SEGMENT steps on a fixed set of photons (dead ones masked, as JAX masks
# them), each step replayed from a CUDA graph, once no more than DENSE_MAX
# photons live: the tail's steps are then not bound by launching ~600 small
# kernels from the host.  Both give the same photons the same arithmetic.
DENSE_MAX = {"cuda": 2 ** 19, "cpu": 0}
SEGMENT = 32


def _compact(st: _State) -> _State:
    keep = st.alive.nonzero().squeeze(1)
    if keep.numel() == st.pid.numel():
        return st
    return _State(st.pos[:, keep], st.dir[:, keep], st.w[keep], st.tau[keep], st.alive[keep],
                  st.pid[keep])


def _segments(md, st, keytab, it, max_iter, abso, tallies, live):
    """Masked steps from step `it` until no photon lives or max_iter,
    compacting whenever half the photons died: (state, steps run); appends
    the live count at each step's start to `live`."""
    cuda = st.pid.is_cuda
    while it < max_iter and st.pid.numel():
        table = keytab.upto(max_iter)
        buf = _State(*(t.clone() for t in st))
        stepno = torch.tensor([it], dtype=torch.int64, device=st.pid.device)
        log = torch.zeros(max_iter, dtype=torch.int64, device=st.pid.device)

        def step():
            log.index_put_((stepno,), buf.alive.sum().reshape(1))
            keys = table.index_select(0, stepno)[0]
            new = _step(md, buf, _dense_draws(keys), abso, tallies)
            for b, t in zip(buf, new):
                b.copy_(t)
            stepno.add_(1)

        graph = None
        first, m = it, buf.pid.numel()
        while it < max_iter:
            n = min(SEGMENT, max_iter - it)
            if graph is None and cuda:
                step()  # the warm-up is a real step
                it, n = it + 1, n - 1
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    step()
            for _ in range(n):
                graph.replay() if graph is not None else step()
            it += n
            alive = int(buf.alive.sum())
            if alive == 0 or alive <= m // 2:
                break
        counts = log[first:it].tolist()
        # steps replayed after the last photon died did nothing
        stop = counts.index(0) if 0 in counts else len(counts)
        live += counts[:stop]
        it = first + stop
        del graph
        st = _compact(buf)
    return st, it


def solve_mcdmda(key, kabs, ksca, g, dz, dx: float, dy: float, albedo: float, sundir,
                 edirTOA: float, n_photons: int = 100000, max_iter: int = 4000,
                 device="cuda") -> McResult:
    """Solar Monte-Carlo solve (JAX `solve_mcdmda`); fluxes normalised to
    edirTOA * mu [W/m2].

    key: a `prng.Threefry` or its two key words; kabs, ksca, g (Nz, Nx, Ny)
    and dz (Nz,) (layer thickness, TOA to surface) are arrays or tensors;
    sundir (3,) is the photon travel direction.  Runs on `device`."""
    dev = torch.device(device)
    if isinstance(key, prng.Threefry):
        key = key.key
    key = tuple(int(k) & _MASK for k in (key.tolist() if torch.is_tensor(key) else key))
    host = lambda a: np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, _F32)
    nz, nx, ny = np.shape(kabs)
    dz_np = host(dz)
    dx, dy = _F32(dx), _F32(dy)
    zlev = np.concatenate([np.zeros(1, _F32), np.cumsum(dz_np, dtype=_F32)])
    Lx, Ly = _F32(nx) * dx, _F32(ny) * dy
    f32 = lambda a: torch.as_tensor(np.asarray(a, _F32), device=dev)
    md = _Medium(*(f32(host(a)).reshape(-1) for a in (kabs, ksca, g)), f32(zlev), (nz, nx, ny),
                 f32([[dx], [dy]]), f32([[Lx], [Ly]]),
                 torch.tensor([[nx - 1], [ny - 1]], device=dev), float(zlev[-1]),
                 float(_F32(1e-3) * min(min(dx, dy), dz_np.min())), float(albedo))
    n = int(n_photons)

    k0, k1, kloop = _split(key, 3)
    pid = torch.arange(n, dtype=torch.int64, device=dev)
    u = lambda k: prng.to_uniform(torch.bitwise_xor(*prng.threefry2x32(*k, torch.zeros_like(pid),
                                                                       pid)))
    sd = np.asarray(sundir, _F32)
    sd = (sd / _F32(np.sqrt(_fma(torch.tensor(sd[2]), float(sd[2]), _fma(
        torch.tensor(sd[1]), float(sd[1]), float(sd[0] * sd[0]))).item()))).astype(_F32)
    st = _State(pos=torch.stack([u(k0) * float(Lx), u(k1) * float(Ly),
                                 torch.full((n,), float(_F32(1e-5)), device=dev)]),
                dir=f32([[sd[0]], [sd[1]], [-sd[2]]]).expand(3, n).contiguous(),
                w=torch.ones(n, device=dev),
                tau=-_log(torch.clamp(u(_fold_in(kloop, 0)), min=1e-12)),
                alive=torch.ones(n, dtype=torch.bool, device=dev), pid=pid)

    abso = torch.zeros(nz * nx * ny, dtype=torch.float64, device=dev)
    tallies = torch.zeros((3, nx * ny), dtype=torch.float64, device=dev)  # eup, edn, sfc abs
    keytab = _KeyTable(kloop, max_iter, dev)
    live, it = [], 0
    dense_max = DENSE_MAX.get(dev.type, 0)
    while it < max_iter and st.pid.numel():
        if st.pid.numel() <= dense_max:
            st, it = _segments(md, st, keytab, it, max_iter, abso, tallies, live)
            break
        live.append(st.pid.numel())
        keys = keytab.upto(it + 1)[it]
        st = _compact(_step(md, st, _sparse_draws(keys), abso, tallies))
        it += 1

    leftover = (st.w.double().sum() / n).float()
    STATS["steps"] += len(live)
    STATS["live"] += live
    STATS["photons"] += n
    STATS["photon_steps"] += int(sum(live))

    mu0 = max(float(-sd[2]), 1e-6)
    w_photon = edirTOA * mu0 * float(Lx) * float(Ly) / n
    cell_vol = torch.as_tensor(dz_np.astype(np.float64), device=dev)[:, None, None] * (
        float(dx) * float(dy))
    col = tallies.reshape(3, nx, ny) * (w_photon / (float(dx) * float(dy)))
    return McResult(
        abso=(abso.reshape(nz, nx, ny) * w_photon / cell_vol).float(),
        eup_toa=col[0].float(),
        edn_srfc=col[1].float(),
        sfc_absorbed=col[2].float(),
        leftover=leftover,
        niter=it,
    )
