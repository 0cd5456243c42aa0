"""Vectorized Monte-Carlo photon tracing through a unit box: the general
tracer (port of `tenstream_tpu/boxmc/tracer.py::run_boxmc`).

Parity: reference `src/boxmc.F90` (`t_boxmc%get_coeff`:395,
`run_photons`:559, `move_photon`:742, `scatter_photon`:847 with
Henyey-Greenstein sampling `hengreen`:819, `roulette`:682) and
`src/boxmc_geometry.F90` (cube intersections).

Every source and classification rule of `boxmc.schemes` is handled here:
sub-face direct sources (`dir_src_rects`), positional direct
classification (quad8), sectored, quadrant and mu-window diffuse sources,
sectored top exits, per-face angular exits (zsign, quad, quad_main,
sector_main, ring), `periodic_xy`, and the truncation redistribution.
K4 (`boxmc.cuda_tracer`) traces the full-face schemes faster; this one is
plain PyTorch on any device, as the JAX package's is a plain vector loop
outside any Pallas kernel.

Absorption uses implicit capture (weight *= exp(-kabs * pathlength) with
scattering-only free paths); low-weight photons die by Russian roulette;
walks still going at `max_iter` have their weight redistributed onto the
tallied diffuse exits (keeps energy conservation exact).

Random numbers come from a `torch.Generator` (the JAX package splits a
key): the two packages agree in distribution, not draw for draw.  All
entries of a call share the generator; the loop draws only for photons
still walking (the walk state is compacted after each step), so the cost
follows the photon-steps.

Conventions: box [0,dx]x[0,dy]x[0,dz] with dx = dy = 1, z is altitude,
canonical sun octant (+x, +y, -z).  Outputs are (T, S): per-destination
fractions of the injected power leaving as direct (T, direct sources
only) or diffuse (S) radiation.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tenstream_tpu_torch.boxmc.schemes import get_box_scheme

_WEIGHT_ROULETTE = 1e-4
_ROULETTE_SURVIVE = 0.5
_BIG = 1e30
_SECTOR_CENTERS = [0.0, 1.5 * math.pi, math.pi, 0.5 * math.pi]  # +y, -x, -y, +x
_MODE_IDS = {"zsign": 0, "quad": 1, "quad_main": 2, "sector_main": 3, "ring": 4}


def _hg_costheta(u, g):
    """Sample cos(theta) from the Henyey-Greenstein phase function."""
    iso = g.abs() < 1e-4
    gs = torch.where(iso, torch.full_like(g, 0.5), g)
    frac = (1.0 - gs * gs) / (1.0 - gs + 2.0 * gs * u)
    ct_hg = (1.0 + gs * gs - frac * frac) / (2.0 * gs)
    return torch.clamp(torch.where(iso, 2.0 * u - 1.0, ct_hg), -1.0, 1.0)


def _rotate_about(dx, dy, dz, ct, phi):
    """New direction at angle acos(ct) from (dx, dy, dz) with azimuth phi."""
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    denom = torch.sqrt(torch.clamp(1.0 - dz * dz, min=1e-12))
    straight_up = dz.abs() > 0.99999
    ux = torch.where(straight_up, torch.ones_like(dy), dy / denom)
    uy = torch.where(straight_up, torch.zeros_like(dx), -dx / denom)
    vx, vy, vz = uy * dz, -ux * dz, ux * dy - uy * dx  # v = d x u
    cp, sp = torch.cos(phi), torch.sin(phi)
    nx = st * (cp * ux + sp * vx) + ct * dx
    ny = st * (cp * uy + sp * vy) + ct * dy
    nz = st * sp * vz + ct * dz
    norm = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-30))
    return nx / norm, ny / norm, nz / norm


def _sample_on_face(rand, face, bz, n, rect=None):
    """Uniform positions on a box face (or a sub-rectangle of it), nudged
    slightly inside; bz is per photon."""
    u, v = rand(n), rand(n)
    eps = 1e-6
    if rect is not None:
        u0, u1, v0, v1 = rect
        u = u0 + u * (u1 - u0)
        v = v0 + v * (v1 - v0)
    full = lambda val: torch.full_like(u, val)
    if face == 0:
        return u, v, bz * (1 - eps)
    if face == 1:
        return u, v, bz * eps
    if face == 2:
        return full(eps), v, u * bz
    if face == 3:
        return full(1 - eps), v, u * bz
    if face == 4:
        return u, full(eps), v * bz
    return u, full(1 - eps), v * bz


def _sample_lambertian(rand, spec, n):
    """Lambertian directions about the inward normal of the source face,
    optionally restricted to a z hemisphere, an azimuth sector or
    tangential quadrant, and a mu window (reference
    `init_diff_photon_3_10`, `boxmc_3_30.inc:354-356`,
    `init_diff_photon_3_16/_3_24`)."""
    face = spec.face
    u = rand(n)
    mu = torch.sqrt(spec.mu_min ** 2 + u * (spec.mu_max ** 2 - spec.mu_min ** 2))
    st = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
    if spec.phi_sector is not None and face in (0, 1):
        phi = _SECTOR_CENTERS[spec.phi_sector] + (rand(n) - 0.5) * (0.5 * math.pi)
        return st * torch.sin(phi), st * torch.cos(phi), (mu if face == 1 else -mu)
    phi = rand(n) * (2.0 * math.pi)
    a, b = st * torch.cos(phi), st * torch.sin(phi)
    if spec.quadrant is not None:
        # tangential signs q = 2*(t1<0) + (t2<0); folding |.| keeps the
        # azimuthally symmetric distribution correct within the quadrant
        t1 = a.abs() * (1.0 if spec.quadrant in (0, 1) else -1.0)
        t2 = b.abs() * (1.0 if spec.quadrant in (0, 2) else -1.0)
        return ((t1, t2, -mu), (t1, t2, mu), (mu, t1, t2), (-mu, t1, t2), (t1, mu, t2),
                (t1, -mu, t2))[face]
    dx, dy, dz = ((a, b, -mu), (a, b, mu), (mu, a, b), (-mu, a, b), (a, mu, b), (a, -mu, b))[face]
    if spec.zsign != 0:
        dz = dz.abs() if spec.zsign > 0 else -dz.abs()
    return dx, dy, dz


def _exit_face(px, py, pz, dx, dy, dz, bz):
    """Distance to the box boundary and the face id that is hit."""

    def axis_t(p, d, hi):
        tiny = d.abs() < 1e-12
        d_safe = torch.where(tiny, torch.full_like(d, 1e-12), d)
        bound = torch.where(d > 0, hi, torch.zeros_like(p))
        t = (bound - p) / d_safe
        return torch.where(tiny, torch.full_like(t, _BIG), torch.clamp(t, min=0.0))

    tx, ty, tz = axis_t(px, dx, 1.0), axis_t(py, dy, 1.0), axis_t(pz, dz, bz)
    tmin = torch.minimum(tx, torch.minimum(ty, tz))
    face = torch.where(tmin == tz, torch.where(dz > 0, 0, 1),
                       torch.where(tmin == tx, torch.where(dx > 0, 3, 2),
                                   torch.where(dy > 0, 5, 4)))
    return tmin, face


def run_boxmc(generator: torch.Generator, scheme_name: str, src: int, ldir: bool, tauz, w0, g,
              aspect, phi_deg=0.0, theta_deg=0.0, n_photons: int = 10000, max_iter: int = 3000,
              periodic_xy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace n_photons for one (source, optical state), or for each of a
    batch: the optical parameters are floats or 1-D tensors that
    broadcast to B entries.  Runs on the generator's device.  Returns (T,
    S), (ndir,) and (ndiff,) for scalar parameters, else (B, ndir) and (B,
    ndiff), normalized by the injected power (reference
    `t_boxmc%get_coeff`, `src/boxmc.F90:395`)."""
    scheme = get_box_scheme(scheme_name)
    dev, f32 = generator.device, torch.float32
    ndir, ndiff = scheme.ndir, scheme.ndiff
    vals = [torch.as_tensor(v, dtype=f32, device=dev) for v in (tauz, w0, g, aspect, phi_deg, theta_deg)]
    scalar = all(v.dim() == 0 for v in vals)
    tauz, w0, g_e, aspect, phi_deg, theta_deg = (v.reshape(-1) for v in torch.broadcast_tensors(*vals))
    B, N = tauz.shape[0], int(n_photons)
    bz_e = torch.clamp(aspect, min=1e-6)
    kext = tauz / bz_e
    ksca_e, kabs_e = w0 * kext, (1.0 - w0) * kext
    rand = lambda n: torch.rand(n, generator=generator, device=dev, dtype=f32)

    ent = torch.arange(B, device=dev).repeat_interleave(N)
    bz = bz_e[ent]
    n = B * N
    if ldir:
        rect = scheme.dir_src_rects[src] if scheme.dir_src_rects else None
        px, py, pz = _sample_on_face(rand, scheme.dir_src_faces[src], bz, n, rect=rect)
        phi, theta = torch.deg2rad(phi_deg), torch.deg2rad(theta_deg)
        dx = (torch.sin(phi) * torch.sin(theta))[ent]
        dy = (torch.cos(phi) * torch.sin(theta))[ent]
        dz = (-torch.cos(theta))[ent]
    else:
        spec = scheme.diff_srcs[src]
        px, py, pz = _sample_on_face(rand, spec.face, bz, n)
        dx, dy, dz = _sample_lambertian(rand, spec, n)

    w = torch.ones(n, dtype=f32, device=dev)
    scattered = torch.zeros(n, dtype=torch.bool, device=dev)
    ksca, kabs, g = ksca_e[ent], kabs_e[ent], g_e[ent]
    dir_table = torch.tensor(scheme.dir_dst_by_face, device=dev)
    diff_table = torch.tensor(scheme.diff_dst_by_face_zsign, device=dev)  # (6, 2)
    if scheme.diff_face_class is not None:
        fc_mode = torch.tensor([_MODE_IDS[m] for m, _ in scheme.diff_face_class], device=dev)
        fc_tbl = torch.tensor([list(d) + [0] * (5 - len(d)) for _, d in scheme.diff_face_class],
                              device=dev)  # (6, 5)
    if scheme.diff_top_sector_dst is not None:
        top_tbl = torch.tensor(scheme.diff_top_sector_dst, device=dev)  # (2, 4)
    T = torch.zeros(B * (ndir + 1), dtype=f32, device=dev)  # last column of each row: dump
    S = torch.zeros(B * (ndiff + 1), dtype=f32, device=dev)

    for _ in range(max_iter):
        if ent.numel() == 0:
            break
        m = ent.numel()
        dmax, face = _exit_face(px, py, pz, dx, dy, dz, bz)
        u = torch.clamp(rand(m), min=1e-12)
        s_free = torch.where(ksca > 1e-12, -torch.log(u) / torch.clamp(ksca, min=1e-12),
                             torch.full_like(u, _BIG))
        travel = torch.minimum(s_free, dmax)
        w = w * torch.exp(-kabs * travel)
        px, py, pz = px + dx * travel, py + dy * travel, pz + dz * travel

        hit_boundary = s_free >= dmax
        if periodic_xy:
            side = (face >= 2) & hit_boundary
            px = torch.where(side & (face == 2), torch.ones_like(px),
                             torch.where(side & (face == 3), torch.zeros_like(px), px))
            py = torch.where(side & (face == 4), torch.ones_like(py),
                             torch.where(side & (face == 5), torch.zeros_like(py), py))
            exiting = hit_boundary & (face < 2)
        else:
            exiting = hit_boundary

        up = dz > 0
        diff_dst = diff_table[face, up.long()]
        if scheme.diff_face_class is not None:
            # per-face angular binning (reference `update_diff_stream_3_24/_3_30/_8_18`)
            t1 = torch.where(face <= 1, dx, torch.where(face <= 3, dy, dx))
            t2 = torch.where(face <= 1, dy, dz)
            mu_n = torch.where(face <= 1, dz.abs(), torch.where(face <= 3, dx.abs(), dy.abs()))
            quad = 2 * (t1 <= 0).long() + (t2 <= 0).long()
            sector = torch.where(t2.abs() > t1.abs(), torch.where(t2 > 0, 0, 2),
                                 torch.where(t1 > 0, 3, 1))
            is_main = mu_n >= scheme.alim
            mode = fc_mode[face]
            col = torch.where(mode == 0, up.long(), quad)
            col = torch.where(mode == 2, torch.where(is_main, 0, 1 + quad), col)
            col = torch.where(mode == 3, torch.where(is_main, 0, 1 + sector), col)
            col = torch.where(mode == 4, torch.where(is_main, 0, 1), col)
            diff_dst = fc_tbl[face, col]
        elif scheme.diff_top_sector_dst is not None:
            # azimuth-sector binning of top/bot exits (reference `update_diff_stream_3_16`)
            sector = torch.where(dy.abs() > dx.abs(), torch.where(dy > 0, 0, 2),
                                 torch.where(dx > 0, 3, 1))
            diff_dst = torch.where(face <= 1, top_tbl[torch.clamp(face, 0, 1), sector], diff_dst)
        if ldir:
            if scheme.dir_classify == "quad8":
                # top/bot quadrants + side z-halves (update_dir_stream_8_10)
                quad = (px > 0.5).long() + 2 * (py > 0.5).long()
                zhalf = (pz > 0.5 * bz).long()
                dir_dst = torch.where(face <= 1, quad,
                                      torch.where(face <= 3, 4 + zhalf, 6 + zhalf))
            else:
                dir_dst = dir_table[face]
                dir_dst = torch.where(dir_dst < 0, ndir, dir_dst)
            as_direct = exiting & ~scattered
            as_diffuse = exiting & scattered
            T.index_add_(0, (ent * (ndir + 1) + dir_dst)[as_direct], w[as_direct])
            S.index_add_(0, (ent * (ndiff + 1) + diff_dst)[as_diffuse], w[as_diffuse])
        else:
            S.index_add_(0, (ent * (ndiff + 1) + diff_dst)[exiting], w[exiting])

        scattering = s_free < dmax
        ct = _hg_costheta(rand(m), g)
        ndx, ndy, ndz = _rotate_about(dx, dy, dz, ct, rand(m) * (2.0 * math.pi))
        dx = torch.where(scattering, ndx, dx)
        dy = torch.where(scattering, ndy, dy)
        dz = torch.where(scattering, ndz, dz)
        scattered = scattered | scattering
        alive = ~exiting

        # Russian roulette on low weights (reference `roulette`:682)
        low = alive & (w < _WEIGHT_ROULETTE)
        surv = rand(m) < _ROULETTE_SURVIVE
        w = torch.where(low & surv, w / _ROULETTE_SURVIVE, w)
        keep = (alive & (~low | surv)).nonzero().squeeze(1)
        (ent, bz, ksca, kabs, g, px, py, pz, dx, dy, dz, w, scattered) = (
            t[keep] for t in (ent, bz, ksca, kabs, g, px, py, pz, dx, dy, dz, w, scattered))

    # truncated walks: redistribute the surviving weight onto the tallied
    # diffuse exit distribution so energy is conserved
    leftover = torch.zeros(B, dtype=f32, device=dev).index_add_(0, ent, w)
    s_main = S.view(B, ndiff + 1)[:, :ndiff]
    s_sum = s_main.sum(1, keepdim=True)
    s_main = torch.where(s_sum > 0, s_main * (1.0 + leftover[:, None] / torch.clamp(s_sum, min=1e-30)),
                         s_main)
    norm = 1.0 / float(N)
    T, S = T.view(B, ndir + 1)[:, :ndir] * norm, s_main * norm
    return (T[0], S[0]) if scalar else (T, S)
