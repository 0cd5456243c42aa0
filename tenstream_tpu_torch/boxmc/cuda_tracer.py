"""K4, the BoxMC photon tracer, hand-written in CUDA for Hopper, with its
plain PyTorch version beside it (port of `tenstream_tpu/boxmc/pallas_tracer.py`).

`boxmc_trace` replaces `pallas_tracer.py::_make_kernel.<kernel>`: one
(entry, source) per launch row, 5120 photons each, traced with the TPU
kernel's int32 counter hash (`hash_uniform`), Henyey-Greenstein
scattering, implicit absorption, weight roulette (below 1e-4, survive
with p 0.5), exit classification into T (ndir) / S (ndiff) and
truncation redistribution of the weight still walking at `max_iter`.  A
row of params is (tauz, w0, aspect, g, phi, theta, seed, face, zsign),
float32; the result row is [T | S] plus the entry's photon-steps (loop
iterations entered alive, summed over its photons).  The hash's program
id is the row's index within the launch, so a launch of the same rows
gives the same tallies in the kernel, in its plain version and in the TPU
kernel (up to float32 roundoff of the transcendentals).  The kernel walks
the launch's photons from one queue and writes a record per photon (tally
code and weight); a second kernel sums each entry's records in a fixed
order, which `reduce_records` repeats, so the plain version gives the
kernel's tallies bit for bit where its records are the kernel's.

`run_boxmc_cuda` is `run_boxmc_pallas` with the same arguments and (T, S)
result: it builds the seed, face and zsign columns as
`pallas_tracer.py:325-343` does.

The kernel represents full-face sources (Lambertian over the whole inward
hemisphere or one z half of it, or the sun's direction) and face-based
exit classification.  Schemes with sub-face direct sources, positional
direct classification, sectored, quadrant or mu-window diffuse sources,
sectored top exits or per-face angular exits are refused
(`kernel_refusal`); the JAX package's TPU route sends 3_16 and 8_16 to its
kernel regardless and gets their sectors wrong (ROADMAP, faults found).
`optprop/lut.py` sends those schemes to the general tracer
(`boxmc/tracer.py`).

The plain version `boxmc_trace_plain` is batched over rows: one lockstep
loop over all rows' photons that runs to the longest walk; each photon's
step i draws counter i + 1 whatever the batch, so batching changes no
result.  It keeps only the photons still walking (compacted after each
step), so its cost follows the photon-steps, and like the kernel it stops
a photon at its exit (the TPU kernel keeps moving exited photons by ~0,
which changes their weights by ulps).  The wrapper runs it only because
its tensor lies on the CPU; on a CUDA tensor it launches the kernel or
raises.  Each launch adds one to `cuda_ops.LAUNCHES["boxmc_trace"]`;
`last_warp_trips` reads the last launch's warp loop trips.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.boxmc.schemes import BoxScheme, get_box_scheme
from tenstream_tpu_torch.pprts import cuda_ops

PHOTONS = 5120  # photons per entry (the TPU kernel's 8 x 640 batch)
MAX_BATCH = 4096  # rows per launch (the TPU kernel's fixed grid)
REDUCE_THREADS = 256  # photons per entry are summed by 256 threads (K4's reduction)
_LAST_TRIPS = [None]  # warp loop trips of the last kernel launch (a device tensor)
NPARAM = 9
_WEIGHT_ROULETTE = 1e-4
_ROULETTE_SURVIVE = 0.5
_BIG = 1e30
_TWO_PI = 2.0 * np.pi


def _i32(v: int) -> int:
    """v wrapped to the int32 range (two's complement)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 (the sign extension masked out)."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def hash_uniform(lane: torch.Tensor, base: torch.Tensor, ctr: int, salt: int) -> torch.Tensor:
    """The TPU kernel's counter hash (`pallas_tracer.py::_hash_uniform`) in
    int32 tensors, whose multiplications wrap as its do: uniform in [0, 1)
    from the top 24 bits."""
    x = lane ^ (base * -1640531527)  # 0x9E3779B9
    x = x + _i32(ctr * -2048144789 + salt * -1028477387)  # 0x85EBCA6B, 0xC2B2AE35
    x = x ^ _lsr(x, 16)
    x = x * 0x7FEB352D
    x = x ^ _lsr(x, 15)
    x = x * -2073453131  # 0x84699DB5 (the TPU kernel's comment says 0x846CA68B)
    x = x ^ _lsr(x, 16)
    return _lsr(x, 8).to(torch.float32) * (1.0 / (1 << 24))


def kernel_refusal(scheme_name: str, ldir: bool) -> Optional[str]:
    """Why K4 cannot trace this scheme's sources of this kind, or None."""
    box = get_box_scheme(scheme_name)
    if ldir and box.dir_src_rects is not None:
        return "sub-face direct sources (dir_src_rects)"
    if ldir and box.dir_classify is not None:
        return f"positional direct classification ({box.dir_classify})"
    # a scattered direct photon is classified by the diffuse rules too
    if box.diff_top_sector_dst is not None:
        return "sectored top/bottom diffuse exits (diff_top_sector_dst)"
    if box.diff_face_class is not None:
        return "per-face angular diffuse exits (diff_face_class)"
    if not ldir:
        for s in box.diff_srcs:
            if (s.phi_sector is not None or s.quadrant is not None or s.mu_min != 0.0
                    or s.mu_max != 1.0):
                return "sectored, quadrant or mu-window diffuse sources"
    return None


def _check_scheme(scheme_name: str, ldir: bool) -> BoxScheme:
    why = kernel_refusal(scheme_name, ldir)
    if why is not None:
        raise ValueError(f"K4 cannot trace scheme {scheme_name} "
                         f"({'direct' if ldir else 'diffuse'}): {why}; use boxmc.tracer.run_boxmc")
    return get_box_scheme(scheme_name)


@functools.lru_cache(maxsize=None)
def _tables(scheme_name: str) -> Tuple[int, ...]:
    """dir_code[6] + diff_dn[6] + diff_up[6]: tally code per exit face
    (diffuse codes offset by ndir; -1 tallies nowhere)."""
    box = get_box_scheme(scheme_name)
    dirc = [int(v) for v in box.dir_dst_by_face]
    dn = [box.ndir + int(box.diff_dst_by_face_zsign[f][0]) for f in range(6)]
    up = [box.ndir + int(box.diff_dst_by_face_zsign[f][1]) for f in range(6)]
    return tuple(dirc + dn + up)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _select(face: torch.Tensor, vals) -> torch.Tensor:
    out = vals[5]
    for f in range(4, -1, -1):
        out = torch.where(face == f, vals[f], out)
    return out


def _axis_t(p, d, hi):
    tiny = d.abs() < 1e-12
    d_safe = torch.where(tiny, torch.full_like(d, 1e-12), d)
    bound = torch.where(d > 0, hi, torch.zeros_like(p))
    t = (bound - p) / d_safe
    return torch.where(tiny, torch.full_like(t, _BIG), torch.clamp(t, min=0.0))


def _hg_costheta(u, g):
    iso = g.abs() < 1e-4
    gs = torch.where(iso, torch.full_like(g, 0.5), g)
    g2 = gs * gs
    frac = (1.0 - g2) / ((1.0 - gs) + (2.0 * gs) * u)
    ct = ((1.0 + g2) - frac * frac) / (2.0 * gs)
    return torch.clamp(torch.where(iso, 2.0 * u - 1.0, ct), -1.0, 1.0)


def _rotate_about(dx, dy, dz, ct, phi):
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    denom = torch.sqrt(torch.clamp(1.0 - dz * dz, min=1e-12))
    straight_up = dz.abs() > 0.99999
    ux = torch.where(straight_up, torch.ones_like(dy), dy / denom)
    uy = torch.where(straight_up, torch.zeros_like(dx), -dx / denom)
    vx = uy * dz
    vy = -ux * dz
    vz = ux * dy - uy * dx
    cp, sp = torch.cos(phi), torch.sin(phi)
    nx = st * (cp * ux + sp * vx) + ct * dx
    ny = st * (cp * uy + sp * vy) + ct * dy
    nz = st * sp * vz + ct * dz
    norm = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-30))
    return nx / norm, ny / norm, nz / norm


def boxmc_trace_plain(rows: torch.Tensor, scheme_name: str, ldir: bool,
                      max_iter: int = 3000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: rows (B, 9) float32 -> (out (B, ndir + ndiff)
    [T | S] float32, photon-steps (B,) int64)."""
    box = _check_scheme(scheme_name, ldir)
    code, w, left, nstep = photon_records_plain(rows, scheme_name, ldir, max_iter)
    out = reduce_records(code, w, left, box.ndir, box.ndir + box.ndiff)
    return out, nstep.sum(1)


def photon_records_plain(rows: torch.Tensor, scheme_name: str, ldir: bool,
                         max_iter: int = 3000):
    """Each photon's walk for rows (B, 9): (tally code (B, N) int64, -1 for
    none; exit weight (B, N); weight still walking at max_iter (B, N), 0 for
    the others; photon-steps (B, N) int64), N = PHOTONS."""
    box = _check_scheme(scheme_name, ldir)
    dev, f32, i32 = rows.device, torch.float32, torch.int32
    B, N = rows.shape[0], PHOTONS
    rows = rows.to(f32)
    tauz, w0, aspect, g_e, phi_deg, theta_deg, seed_f, face_f, zsign = rows.unbind(1)
    face_e = sum((face_f >= c).to(i32) for c in (0.5, 1.5, 2.5, 3.5, 4.5))
    base_e = (seed_f.to(i32) * 747796405 + torch.arange(B, dtype=i32, device=dev)) | 1
    bz_e = torch.clamp(aspect, min=1e-6)
    kext = tauz / bz_e
    ksca_e = w0 * kext
    kabs_e = (1.0 - w0) * kext

    pid = torch.arange(B * N, dtype=torch.int64, device=dev)
    ent = pid // N
    lane = (pid % N).to(i32)
    base, face, bz = base_e[ent], face_e[ent], bz_e[ent]
    uni = lambda ctr, salt: hash_uniform(lane, base, ctr, salt)

    eps = torch.tensor(1e-6, dtype=f32, device=dev)
    ome = 1.0 - eps
    u1, u2 = uni(0, 0), uni(0, 1)
    one = torch.ones_like(u1)
    px = _select(face, (u1, u1, one * eps, one * ome, u1, u1))
    py = _select(face, (u2, u2, u2, u2, one * eps, one * ome))
    pz = _select(face, (bz * ome, bz * eps, u1 * bz, u1 * bz, u2 * bz, u2 * bz))
    if ldir:
        phi, theta = torch.deg2rad(phi_deg), torch.deg2rad(theta_deg)
        dx = (torch.sin(phi) * torch.sin(theta))[ent]
        dy = (torch.cos(phi) * torch.sin(theta))[ent]
        dz = (-torch.cos(theta))[ent]
    else:
        mu = torch.sqrt(uni(0, 2))
        sphi = uni(0, 3) * _TWO_PI
        st = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
        a, b = st * torch.cos(sphi), st * torch.sin(sphi)
        dx = _select(face, (a, a, mu, -mu, a, a))
        dy = _select(face, (b, b, a, a, mu, -mu))
        dz = _select(face, (-mu, mu, b, b, b, b))
        zs = zsign[ent]
        dz = torch.where(zs > 0.5, dz.abs(), torch.where(zs < -0.5, -dz.abs(), dz))

    tab = torch.tensor(_tables(scheme_name), dtype=torch.int64, device=dev).view(3, 6)
    code_out = torch.full((B * N,), -1, dtype=torch.int64, device=dev)
    w_out = torch.zeros(B * N, dtype=f32, device=dev)
    nstep = torch.full((B * N,), max_iter, dtype=torch.int64, device=dev)
    w = torch.ones_like(px)
    scattered = torch.zeros_like(px, dtype=torch.bool)
    ksca, kabs, g = ksca_e[ent], kabs_e[ent], g_e[ent]

    for i in range(max_iter):
        if pid.numel() == 0:
            break
        tx, ty, tz = _axis_t(px, dx, 1.0), _axis_t(py, dy, 1.0), _axis_t(pz, dz, bz)
        dmax = torch.minimum(tx, torch.minimum(ty, tz))
        u = torch.clamp(uni(i + 1, 0), min=1e-12)
        s_free = torch.where(ksca > 1e-12, -torch.log(u) / torch.clamp(ksca, min=1e-12),
                             torch.full_like(u, _BIG))
        travel = torch.minimum(s_free, dmax)
        w = w * torch.exp(-kabs * travel)
        px = px + dx * travel
        py = py + dy * travel
        pz = pz + dz * travel

        exiting = s_free >= dmax
        fid = torch.where(dmax == tz, torch.where(dz > 0, 0, 1),
                          torch.where(dmax == tx, torch.where(dx > 0, 3, 2),
                                      torch.where(dy > 0, 5, 4)))
        code = torch.where(dz > 0, tab[2][fid], tab[1][fid])
        if ldir:
            code = torch.where(scattered, code, tab[0][fid])
        code_out[pid[exiting]] = code[exiting]
        w_out[pid[exiting]] = w[exiting]

        ct = _hg_costheta(uni(i + 1, 1), g)
        ndx, ndy, ndz = _rotate_about(dx, dy, dz, ct, uni(i + 1, 2) * _TWO_PI)
        scattering = ~exiting
        dx = torch.where(scattering, ndx, dx)
        dy = torch.where(scattering, ndy, dy)
        dz = torch.where(scattering, ndz, dz)
        scattered = scattered | scattering

        low = scattering & (w < _WEIGHT_ROULETTE)
        surv = uni(i + 1, 3) < _ROULETTE_SURVIVE
        w = torch.where(low & surv, w / _ROULETTE_SURVIVE, w)
        alive = scattering & (~low | surv)
        nstep[pid[~alive]] = i + 1
        keep = alive.nonzero().squeeze(1)
        (pid, lane, base, bz, ksca, kabs, g, px, py, pz, dx, dy, dz, w, scattered) = (
            t[keep] for t in (pid, lane, base, bz, ksca, kabs, g, px, py, pz, dx, dy, dz, w,
                              scattered))

    left = torch.zeros(B * N, dtype=f32, device=dev)
    left[pid] = w  # still walking at max_iter
    return code_out.view(B, N), w_out.view(B, N), left.view(B, N), nstep.view(B, N)


def reduce_records(code: torch.Tensor, w: torch.Tensor, left: torch.Tensor, ndir: int,
                   nc: int) -> torch.Tensor:
    """[T | S] rows from per-photon records, in K4's order of float32 adds.

    code (B, N) is each photon's tally code (outside [0, nc): none), w (B,
    N) its exit weight, left (B, N) the weight still walking at max_iter
    (0 for the others).  As in `boxmc_ops.cu::boxmc_reduce_kernel`: thread
    t of 256 adds the photons t, t + 256, ... in turn into one sum per
    code and one leftover sum, the 256 partial sums halve in a fixed tree,
    the diffuse tallies add up in code order to the scattered mass, and
    the diffuse tallies are scaled by 1 + leftover / mass (truncation
    redistribution).  Adding 0.0 to the sums of the other codes changes
    no bit, so these are the kernel's tallies bit for bit when the records
    are."""
    B, N = code.shape
    T = REDUCE_THREADS
    f32, dev = torch.float32, code.device
    codes = torch.arange(nc, device=dev).view(1, nc, 1)
    code, w, left = code.view(B, N // T, T), w.view(B, N // T, T), left.view(B, N // T, T)
    acc = torch.zeros((B, nc + 1, T), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    for k in range(N // T):
        acc[:, :nc] += torch.where(code[:, k, None, :] == codes, w[:, k, None, :], zero)
        acc[:, nc] += left[:, k]
    stride = T // 2
    while stride:
        acc[..., :stride] = acc[..., :stride] + acc[..., stride:2 * stride]
        stride //= 2
    tally, leftover = acc[:, :nc, 0], acc[:, nc, 0]
    s_mass = torch.zeros(B, dtype=f32, device=dev)
    for c in range(ndir, nc):
        s_mass = s_mass + tally[:, c]
    scale = torch.where(s_mass > 0, 1.0 + leftover / torch.clamp(s_mass, min=1e-30),
                        torch.ones_like(s_mass))
    norm = torch.tensor(1.0 / N, dtype=f32, device=dev)
    return torch.cat([tally[:, :ndir] * norm, tally[:, ndir:] * scale[:, None] * norm], 1)


# ---------------------------------------------------------------------------
# the wrapper and the TPU kernel's entry point
# ---------------------------------------------------------------------------


def launch_order(rows: torch.Tensor) -> torch.Tensor:
    """The order in which K4's photon queue takes the rows: longest expected
    walks first (int32 (B,), on the rows' device).  A photon scatters about
    (1 + key)^2 times in a box whose smallest scattering optical size is key
    = w0 * tauz * min(1, 1 / aspect), and weight roulette ends it after about
    1 / (1 - w0) steps, whichever comes first.  The order changes no result:
    it only lets the long walks overlap the short ones."""
    tau, w0, aspect = rows[:, 0], rows[:, 1], rows[:, 2].clamp(min=1e-6)
    key = w0 * tau * torch.clamp(1.0 / aspect, max=1.0)
    cost = torch.minimum((1.0 + key) ** 2, 1.0 / (1.0 - w0 + 1e-7))
    return torch.argsort(cost, descending=True, stable=True).to(torch.int32)


def boxmc_trace(rows: torch.Tensor, scheme_name: str, ldir: bool,
                max_iter: int = 3000) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: rows (B, 9) float32 -> (out (B, ndir + ndiff) [T | S], photon-steps
    (B,) int64), one launch row per entry."""
    box = _check_scheme(scheme_name, ldir)
    if rows.device.type == "cpu":
        return boxmc_trace_plain(rows, scheme_name, ldir, max_iter)
    cuda_ops._require_cuda(rows)
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != NPARAM \
            or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous float32 (B, {NPARAM}), got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    out, steps, trips = cuda_ops.load_extension().boxmc_trace(
        rows, launch_order(rows), int(bool(ldir)), box.ndir, box.ndiff,
        list(_tables(scheme_name)), int(max_iter))
    cuda_ops.LAUNCHES["boxmc_trace"] += 1
    _LAST_TRIPS[0] = trips
    return out, steps


def last_warp_trips() -> int:
    """Loop trips of all warps of the last kernel launch (synchronises):
    that launch's photon-steps / (32 * trips) is its lanes' utilisation."""
    return int(_LAST_TRIPS[0].item())


def entry_rows(params, scheme_name: str, src: int, ldir: bool, seed: int,
               device="cuda") -> torch.Tensor:
    """(B, 9) float32 launch rows: columns 0-5 of params (tauz, w0, aspect,
    g, phi, theta; fewer columns leave zeros), then the seed, source face
    and z hemisphere columns as `pallas_tracer.py:325-343` builds them."""
    box = get_box_scheme(scheme_name)
    if ldir:
        face, zsign = box.dir_src_faces[src], 0
    else:
        spec = box.diff_srcs[src]
        face, zsign = spec.face, spec.zsign
    params = torch.as_tensor(params, dtype=torch.float32)
    B = params.shape[0]
    rows = torch.zeros((B, NPARAM), dtype=torch.float32)
    ncol = min(params.shape[1], 6)
    rows[:, :ncol] = params[:, :ncol].cpu()
    rows[:, 6] = float((seed + 977 * src) % (1 << 22))
    rows[:, 7] = float(face)
    rows[:, 8] = float(zsign)
    return rows.to(device)


def run_boxmc_cuda(params, scheme_name: str, src: int, ldir: bool, max_iter: int = 3000,
                   seed: int = 0, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace all entries of `params` (B, >= 6: tauz, w0, aspect, g, phi,
    theta) with K4 on `device`; returns (T (B, ndir), S (B, ndiff))."""
    box = _check_scheme(scheme_name, ldir)
    rows = entry_rows(params, scheme_name, src, ldir, seed, device)
    if rows.shape[0] > MAX_BATCH:
        raise ValueError(f"chunk {rows.shape[0]} exceeds the launch size {MAX_BATCH}")
    out, _ = boxmc_trace(rows, scheme_name, ldir, max_iter)
    return out[:, :box.ndir], out[:, box.ndir:]
