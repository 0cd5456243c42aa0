"""Monte-Carlo photon tracing through a triangular wedge (prism): the port
of `tenstream_tpu/plexrt/wedge_boxmc.py` (reference
`src/boxmc_wedge_5_8.inc`, `boxmc_wedge_5_5.inc`, `boxmc_wedge_18_8.inc`
with the cube tracer's physics, `src/boxmc.F90`).

Canonical prism: triangle A=(0,0), B=(dx,0), C=(dx,dy) extruded over z
in [0, dz]; `apex=(cx, cy)` traces the general triangle C=(cx, cy) in
units of dx.  Faces: 0 TOP (z=dz), 1 BOT (z=0), 2 side AB (y=0), 3 side
BC, 4 side CA.  Dof orders are the JAX package's (its module docstring):
diffuse 5_8 / 18_8 [top, AB dn, AB up, BC dn, BC up, CA dn, CA up, bot],
5_5 [top, AB, BC, CA, bot]; direct 5_8 / 5_5 the faces (top, AB, BC, CA,
bot); 18_8 top corners A, B, C (0-2), per side four quads (3-6 AB, 7-10
BC, 11-14 CA) and bottom corners (15-17).

Batched over entries.  JAX vmaps `run_wedge_boxmc` over an entry grid,
each entry with its own key and its own loop; here one loop walks the
photons of every entry (of every source, `trace_wedge`), and each step
advances only the photons still alive.  The draws are JAX's, bit for
bit: they are counter based, so photon p at step s of an entry is
element p of a uniform draw under that entry's step key, whether or not
the other photons are still walking.  The keys follow JAX's order:
`kpos, kdir, kloop = split(key, 3)`, then per step `key, ks, kphi, kct,
krou = split(key, 5)`, and the samplers' own splits (including where a
sampler reuses the key it split).  The float32 physics follows JAX line
by line; where XLA contracts a product and a sum into one rounding and
torch does not, a photon's path can differ in the last bit, and rarely a
branch flips.

A walk still going at `max_iter` has its weight spread over the diffuse
exits (the reference's leftover renormalization), as in JAX.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.boxmc.tracer import (
    _BIG,
    _ROULETTE_SURVIVE,
    _WEIGHT_ROULETTE,
    _hg_costheta,
    _rotate_about,
)
from tenstream_tpu_torch.core import prng

NDIFF = 8

# scheme -> (ndir, ndiff); the reference's wedge geometry set
WEDGE_SCHEMES = {"5_8": (5, 8), "5_5": (5, 5), "18_8": (18, 8)}

# diffuse source per dof: (face, zsign)
_DIFF_SRCS = ((0, 0), (2, -1), (2, +1), (3, -1), (3, +1), (4, -1), (4, +1), (1, 0))
_DIFF_SRCS_5_5 = ((0, 0), (2, 0), (3, 0), (4, 0), (1, 0))
# 18_8 direct source -> (face, subface): top/bot corner 0=A, 1=B, 2=C; sides
# 0=(z-top,u-low), 1=(z-top,u-high), 2=(z-bot,u-low), 3=(z-bot,u-high)
_DIR_SRCS_18 = ([(0, c) for c in range(3)] + [(2, q) for q in range(4)]
                + [(3, q) for q in range(4)] + [(4, q) for q in range(4)]
                + [(1, c) for c in range(3)])
_EPS = 1e-6
_TWO_PI = 2.0 * math.pi
_DEG2RAD = float(np.float32(np.pi / 180))  # jnp.deg2rad's float32 factor

# The tracer's work since the last `reset_stats()`, summed over `trace_wedge`
# calls: photon loops' steps, live photons per step, photons, photon-steps.
STATS = {"steps": 0, "live": [], "photons": 0, "photon_steps": 0}


def reset_stats() -> None:
    STATS.update(steps=0, live=[], photons=0, photon_steps=0)


class _Geom(NamedTuple):
    """The triangle's float32 constants, as JAX computes them."""

    bx: float
    by: float
    cx: float
    cy: float
    normals: tuple  # inward (nx, ny) of AB, BC, CA
    quads: tuple  # the three corner quads ((x, y) x 4) of A, B, C


def _geom(dy_over_dx: float, apex) -> _Geom:
    f = np.float32
    bx, by = f(1.0), f(dy_over_dx)
    cx, cy = (bx, by) if apex is None else (f(apex[0]), f(apex[1]))
    lbc = np.sqrt((cx - bx) * (cx - bx) + cy * cy)
    lca = np.sqrt(cx * cx + cy * cy)
    normals = ((f(0.0), f(1.0)), (-cy / lbc, (cx - bx) / lbc), (cy / lca, -cx / lca))
    A, B, C = (f(0.0), f(0.0)), (bx, f(0.0)), (cx, cy)
    G = tuple((a + b + c) / f(3.0) for a, b, c in zip(A, B, C))
    mid = lambda p, q: tuple((a + b) / f(2.0) for a, b in zip(p, q))
    mAB, mBC, mAC = mid(A, B), mid(B, C), mid(A, C)
    quads = ((A, mAB, G, mAC), (B, mBC, G, mAB), (C, mAC, G, mBC))
    fl = lambda t: tuple(fl(x) for x in t) if isinstance(t, tuple) else float(t)
    return _Geom(float(bx), float(by), float(cx), float(cy), fl(normals), fl(quads))


def _draws(n: int, device):
    """draw(keys (E, 2)) -> (E * n,): element p of `jax.random.uniform(key_e,
    (n,))` at e * n + p."""
    ctr = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return lambda keys: prng.uniform_keys(keys[:, None, :], ctr).reshape(-1)


def _on_side(face, u, z, g: _Geom):
    """A point at edge parameter u on side `face`, nudged inside."""
    f = np.float32
    eps_x, eps_y = f(_EPS) * f(g.bx), f(_EPS) * f(g.by)
    if face == 2:  # AB: A + u*(B-A), nudge inward (+y)
        return u * g.bx, torch.zeros_like(u) + float(eps_y), z
    nx, ny = g.normals[face - 2]
    if face == 3:  # BC: B + u*(C-B)
        return (_fma(u, float(f(g.cx) - f(g.bx)), g.bx) + float(eps_x * f(nx)),
                _fma(u, g.cy, float(eps_y * f(ny))), z)
    return _fma(u, g.cx, float(eps_x * f(nx))), _fma(u, g.cy, float(eps_y * f(ny))), z  # CA


def _f32(x: float) -> float:
    return float(np.float32(x))


def _fma(a, b, c):
    """a * b + c with one rounding, as XLA on the CPU contracts it: the
    float64 product of two float32 values is exact."""
    a = a.double() if torch.is_tensor(a) else a
    return (a * b + (c.double() if torch.is_tensor(c) else c)).float()


def _sample_on_face(draw, kpos, face, bz, g: _Geom):
    """Uniform positions on one of the 5 faces (JAX `_sample_on_wedge_face`)."""
    k1, k2 = prng.split_keys(kpos, 2).unbind(1)
    if face in (0, 1):  # `_sample_in_triangle(kpos)` splits kpos again: k1, k2
        r1 = torch.sqrt(draw(k1))
        r2 = draw(k2)
        x = _fma(r1 * (1.0 - r2), g.bx, r1 * r2 * g.cx)
        y = r1 * r2 * g.cy
        return x, y, bz * (_f32(1 - _EPS) if face == 0 else _EPS)
    u = draw(k1)
    z = draw(k2) * bz
    return _on_side(face, u, z, g)


def _sample_on_subface(draw, kpos, face, sub, bz, g: _Geom):
    """Uniform positions on one 18_8 direct sub-face (JAX
    `_sample_on_wedge_subface`)."""
    if face in (0, 1):  # `_sample_in_quad`
        k1, k2, k3 = prng.split_keys(kpos, 3).unbind(1)
        pick = draw(k1) < 0.5
        r1, r2 = draw(k2), draw(k3)
        s = torch.sqrt(r1)
        p0, p1, p2, p3 = g.quads[sub]
        xy = []
        for c in range(2):
            pa = torch.where(pick, p1[c], p2[c])
            pb = torch.where(pick, p2[c], p3[c])
            xy.append(_fma(s * r2, pb, _fma(1 - s, p0[c], (s * (1 - r2)) * pa)))
        return xy[0], xy[1], bz * (_f32(1 - _EPS) if face == 0 else _EPS)
    k1, k2 = prng.split_keys(kpos, 2).unbind(1)
    u0, u1 = (0.0, 0.5) if sub in (0, 2) else (0.5, 1.0)
    z0, z1 = (0.5, 1.0) if sub in (0, 1) else (0.0, 0.5)
    u = u0 + (u1 - u0) * draw(k1)
    z = (z0 + (z1 - z0) * draw(k2)) * bz
    return _on_side(face, u, z, g)


def _sample_lambertian(draw, kdir, face, zsign, g: _Geom):
    """Cosine-weighted directions about the inward normal of `face`, side
    faces optionally restricted to the down / up hemisphere."""
    k1, k2 = prng.split_keys(kdir, 2).unbind(1)
    mu = torch.sqrt(draw(k1))
    phi = draw(k2) * _TWO_PI
    st = torch.sqrt(torch.clamp(_fma(-mu, mu, 1.0), min=0.0))
    a, b = st * torch.cos(phi), st * torch.sin(phi)
    if face == 0:
        return a, b, -mu
    if face == 1:
        return a, b, mu
    nx, ny = g.normals[face - 2]
    dz = b
    if zsign != 0:
        dz = b.abs() if zsign > 0 else -b.abs()
    return _fma(mu, nx, -(a * ny)), _fma(mu, ny, a * nx), dz


def _exit_face(px, py, pz, dx, dy, dz, bz, g: _Geom):
    """Distance to the prism boundary and the face id hit (0..4): the first
    of the smallest, as `jnp.argmin` takes it."""

    def plane_t(num, den):
        den_safe = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
        t = num / den_safe
        return torch.where(den < 1e-12, torch.full_like(t, _BIG), torch.clamp(t, min=0.0))

    (nbcx, nbcy), (ncax, ncay) = g.normals[1], g.normals[2]
    ts = torch.stack([
        plane_t(bz - pz, dz),
        plane_t(pz, -dz),
        plane_t(py, -dy),
        plane_t(_fma(px - g.bx, nbcx, nbcy * py), -_fma(dx, nbcx, nbcy * dy)),
        plane_t(_fma(px, ncax, ncay * py), -_fma(dx, ncax, ncay * dy)),
    ])
    tmin, face = torch.min(ts, dim=0)
    return tmin, face


def _classify_subface_18(face, px, py, pz, bz, g: _Geom):
    """Exit position -> 18_8 direct dof."""
    lamC = py / g.cy
    lamB = _fma(lamC, -g.cx, px) / g.bx
    lamA = 1.0 - lamB - lamC
    corner = torch.argmax(torch.stack([lamA, lamB, lamC]), dim=0)
    u_ab = px / g.bx
    f = np.float32
    cbx, cx, cy = f(g.cx) - f(g.bx), f(g.cx), f(g.cy)
    den = lambda a, b: float(max(f(np.float64(a) * a + f(b * b)), f(1e-30)))
    u_bc = _fma(px - g.bx, float(cbx), py * g.cy) / den(cbx, cy)
    u_ca = _fma(px, g.cx, py * g.cy) / den(cx, cy)
    u = torch.where(face == 3, u_bc, torch.where(face == 4, u_ca, u_ab))
    sub = torch.where(pz >= bz / 2, 0, 2) + (u >= 0.5).long()
    base = torch.tensor([0, 15, 3, 7, 11], device=face.device)[face]
    return base + torch.where(face <= 1, corner, sub)


class WedgeGroup(NamedTuple):
    """The entries of one source: keys (E, 2) int64 and the optical
    parameters, float32 (E,) tensors (phi, theta in degrees, direct only)."""

    keys: torch.Tensor
    src: int
    ldir: bool
    tauz: torch.Tensor
    w0: torch.Tensor
    g: torch.Tensor
    aspect: torch.Tensor
    phi: torch.Tensor
    theta: torch.Tensor


def _start(group: WedgeGroup, n: int, scheme: str, g: _Geom):
    """Starting positions and directions of the group's photons (E * n,
    entry-major) and each entry's loop key."""
    draw = _draws(n, group.keys.device)
    kpos, kdir, kloop = prng.split_keys(group.keys, 3).unbind(1)
    bz = torch.clamp(group.aspect, min=1e-6).repeat_interleave(n)
    if group.ldir:
        if scheme == "18_8":
            face, sub = _DIR_SRCS_18[group.src]
            px, py, pz = _sample_on_subface(draw, kpos, face, sub, bz, g)
        else:
            px, py, pz = _sample_on_face(draw, kpos, (0, 2, 3, 4, 1)[group.src], bz, g)
        phi, theta = group.phi * _DEG2RAD, group.theta * _DEG2RAD
        d = (torch.sin(phi) * torch.sin(theta), torch.cos(phi) * torch.sin(theta),
             -torch.cos(theta))
        dx, dy, dz = (c.repeat_interleave(n) for c in d)
    else:
        face, zsign = (_DIFF_SRCS_5_5 if scheme == "5_5" else _DIFF_SRCS)[group.src]
        px, py, pz = _sample_on_face(draw, kpos, face, bz, g)
        dx, dy, dz = _sample_lambertian(draw, kdir, face, zsign, g)
    return (px, py, pz, dx, dy, dz), kloop


def trace_wedge(groups: Sequence[WedgeGroup], n_photons: int, max_iter: int = 3000,
                scheme: str = "5_8", dy_over_dx: float = 1.0,
                apex=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(T, S) per group, (E, ndir) and (E, ndiff): each entry as JAX's
    `run_wedge_boxmc(key_e, src, ldir, ...)` traces it.  Every group's
    photons walk in one loop, on the keys' device; each step hashes the
    draws of the live photons and the next key split of every entry in one
    threefry call.  Adds its work to `STATS`."""
    ndir, ndiff = WEDGE_SCHEMES[scheme]
    g = _geom(dy_over_dx, apex)
    dev = groups[0].keys.device
    n = int(n_photons)
    sizes = [grp.keys.shape[0] for grp in groups]
    E = sum(sizes)
    cat = lambda name: torch.cat([getattr(grp, name).to(torch.float32) for grp in groups])
    bz_e = torch.clamp(cat("aspect"), min=1e-6)
    kext = cat("tauz") / bz_e
    w0_e = cat("w0")
    ksca_e, kabs_e, g_e = w0_e * kext, (1.0 - w0_e) * kext, cat("g")
    ldir_e = torch.cat([torch.full((s,), grp.ldir, device=dev) for s, grp in zip(sizes, groups)])

    parts, kloop = zip(*(_start(grp, n, scheme, g) for grp in groups))
    px, py, pz, dx, dy, dz = (torch.cat(c) for c in zip(*parts))
    ent = torch.arange(E, device=dev).repeat_interleave(n)
    pid = torch.arange(n, dtype=torch.int64, device=dev).repeat(E)
    w = torch.ones_like(px)
    scattered = torch.zeros_like(px, dtype=torch.bool)
    # the step's keys per entry: (E, 5, 2) = next loop key, ks, kphi, kct, krou
    step_keys = prng.split_keys(torch.cat(kloop), 5)
    five = torch.arange(5, dtype=torch.int64, device=dev).repeat(E)
    if scheme == "5_5":
        diff_tbl = torch.tensor([0, 0, 4, 4, 1, 1, 2, 2, 3, 3], device=dev)
    else:
        diff_tbl = torch.tensor([0, 0, 7, 7, 1, 2, 3, 4, 5, 6], device=dev)
    dir_tbl = torch.tensor([0, 4, 1, 2, 3], device=dev)
    # float64 tallies: JAX sums each step's exits in a tree, and a running
    # float32 sum of ~n weights near 1 would lose ~1e-5 of a coefficient
    T = torch.zeros(E * ndir, dtype=torch.float64, device=dev)
    S = torch.zeros(E * ndiff, dtype=torch.float64, device=dev)
    live_counts = []

    for _ in range(max_iter):
        m = ent.numel()
        if m == 0:
            break
        live_counts.append(m)
        # one hash: the live photons' four draws and every entry's next split
        pk = step_keys[:, 1:][ent].transpose(0, 1).reshape(-1, 2)  # (4 m, 2)
        keys = torch.cat([pk, step_keys[:, 0].repeat_interleave(5, dim=0)])
        ctr = torch.cat([pid.repeat(4), five])
        y0, y1 = prng.threefry2x32(keys[:, 0], keys[:, 1], ctr >> 32, ctr & 0xFFFFFFFF)
        step_keys = torch.stack([y0[4 * m:], y1[4 * m:]], dim=-1).reshape(E, 5, 2)
        bits = (y0[:4 * m] ^ y1[:4 * m]).reshape(4, m)
        u = prng.to_uniform(bits[0], 1e-12)
        u_phi, u_ct, u_rou = (prng.to_uniform(b) for b in bits[1:])

        bz, ksca, kabs = bz_e[ent], ksca_e[ent], kabs_e[ent]
        dmax, face = _exit_face(px, py, pz, dx, dy, dz, bz, g)
        s_free = torch.where(ksca > 1e-12, -torch.log(u) / torch.clamp(ksca, min=1e-12),
                             torch.full_like(u, _BIG))
        travel = torch.minimum(s_free, dmax)
        w = w * torch.exp(-kabs * travel)
        px, py, pz = _fma(dx, travel, px), _fma(dy, travel, py), _fma(dz, travel, pz)

        exiting = s_free >= dmax
        ex = exiting.nonzero().squeeze(1)
        if ex.numel():
            e_x, f_x, w_x = ent[ex], face[ex], w[ex]
            diff_dst = diff_tbl[2 * f_x + (dz[ex] > 0).long()]
            as_direct = ldir_e[e_x] & ~scattered[ex]
            if scheme == "18_8":
                dir_dst = _classify_subface_18(f_x, px[ex], py[ex], pz[ex], bz[ex], g)
            else:
                dir_dst = dir_tbl[f_x]
            w_x = w_x.double()
            T.index_add_(0, (e_x * ndir + dir_dst)[as_direct], w_x[as_direct])
            S.index_add_(0, (e_x * ndiff + diff_dst)[~as_direct], w_x[~as_direct])

        scattering = s_free < dmax
        ct = _hg_costheta(u_ct, g_e[ent])
        ndx, ndy, ndz = _rotate_about(dx, dy, dz, ct, u_phi * _TWO_PI)
        dx = torch.where(scattering, ndx, dx)
        dy = torch.where(scattering, ndy, dy)
        dz = torch.where(scattering, ndz, dz)
        scattered = scattered | scattering

        low = ~exiting & (w < _WEIGHT_ROULETTE)
        surv = u_rou < _ROULETTE_SURVIVE
        w = torch.where(low & surv, w / _ROULETTE_SURVIVE, w)
        keep = (~exiting & (~low | surv)).nonzero().squeeze(1)
        if keep.numel() < m:
            px, py, pz, dx, dy, dz, w, scattered, ent, pid = (
                a[keep] for a in (px, py, pz, dx, dy, dz, w, scattered, ent, pid))

    leftover = torch.zeros(E, dtype=torch.float64, device=dev).index_add_(0, ent, w.double()).float()
    T, S = T.float(), S.float().reshape(E, ndiff)
    s_sum = S.sum(-1, keepdim=True)
    S = torch.where(s_sum > 0, S * (1.0 + leftover[:, None] / torch.clamp(s_sum, min=1e-30)), S)
    norm = 1.0 / float(n)
    T, S = T.reshape(E, ndir) * norm, S * norm
    STATS["steps"] += len(live_counts)
    STATS["live"] += live_counts
    STATS["photons"] += E * n
    STATS["photon_steps"] += int(sum(live_counts))
    out, lo = [], 0
    for s in sizes:
        out.append((T[lo:lo + s], S[lo:lo + s]))
        lo += s
    return out


def run_wedge_boxmc(key, src: int, ldir: bool, tauz, w0, g, aspect, phi_deg=0.0, theta_deg=0.0,
                    dy_over_dx: float = 1.0, n_photons: int = 10000, max_iter: int = 3000,
                    scheme: str = "5_8", apex=None, device="cuda"):
    """(T, S) transfer fractions of one wedge source (JAX
    `run_wedge_boxmc`), for one key or a batch of entries.

    key: a `prng.Threefry`, or int64 key words (2,) or (E, 2); the optical
    parameters (aspect = dz/dx, tauz = kext*dz, phi / theta of the photon
    travel direction in degrees, phi = 0 -> +y, 90 -> +x) are floats or
    tensors that broadcast to E entries.  Returns (ndir,) and (ndiff,) for
    one key and scalar parameters, else (E, ndir) and (E, ndiff)."""
    if isinstance(key, prng.Threefry):
        key = key.words()
    key = torch.as_tensor(key, dtype=torch.int64, device=device)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    vals = [f32(v) for v in (tauz, w0, g, aspect, phi_deg, theta_deg)]
    scalar = key.dim() == 1 and all(v.dim() == 0 for v in vals)
    keys = key.reshape(-1, 2)
    E = max([keys.shape[0]] + [v.numel() for v in vals])
    vals = [v.reshape(-1).expand(E) for v in vals]
    keys = keys.expand(E, 2)
    (T, S), = trace_wedge([WedgeGroup(keys, src, ldir, *vals[:4], *vals[4:])], n_photons,
                          max_iter, scheme, dy_over_dx, apex)
    return (T[0], S[0]) if scalar else (T, S)
