"""Closed-form direct->direct transfer coefficients for cube schemes
(port of `tenstream_tpu/boxmc/direct_transmission.py`: `supports_scheme`,
`dir2dir_analytic` and `dir2dir_table`).

A direct photon leaves the beam at any interaction; for entry on a cube
face with the sun in the canonical octant (+x, +y, -z) the path to the
boundary is L = min(C, A, B) with C constant and A ~ U[0, amax],
B ~ U[0, bmax].  The expectation of exp(-sigma L) per argmin class (the
exit face) reduces to elementary integrals -- no Monte-Carlo noise.

The scheme data (direct source faces, classification, exit-face -> dst
map) come from `tenstream_tpu_torch.boxmc.schemes`.
"""

from __future__ import annotations

import numpy as np
import torch

from tenstream_tpu_torch.boxmc.schemes import BOT, TOP, XMAX, XMIN, YMAX, YMIN, get_box_scheme
from tenstream_tpu_torch.core.types import ireals

_BIG = 1e30


def _i0(sigma, M):
    """int_0^M exp(-sigma t) dt, stable for sigma*M -> 0."""
    x = sigma * M
    return torch.where(x < 1e-4, M * (1.0 - 0.5 * x),
                       -torch.expm1(-x) / torch.clamp(sigma, min=1e-30))


def _i1(sigma, M):
    """int_0^M t exp(-sigma t) dt; series below x = 0.05 (the exact form
    cancels catastrophically in float32 there)."""
    x = sigma * M
    series = 0.5 * M * M * (1.0 - 2.0 * x / 3.0 + 0.25 * x * x - x * x * x / 15.0)
    s = torch.clamp(sigma, min=1e-30)
    exact = (1.0 - (1.0 + x) * torch.exp(-x)) / (s * s)
    return torch.where(x < 0.05, series, exact)


def _class_probs(sigma, C, amax, bmax):
    """(T_C, T_A, T_B): E[exp(-sigma L)] per argmin class of
    L = min(C, A, B), A ~ U[0, amax], B ~ U[0, bmax]."""
    pAgtC = torch.clamp(1.0 - C / amax, 0.0, 1.0)
    pBgtC = torch.clamp(1.0 - C / bmax, 0.0, 1.0)
    zero = torch.zeros((), dtype=sigma.dtype, device=sigma.device)
    tC = torch.where(C >= _BIG, zero,
                     torch.exp(-sigma * torch.clamp(C, max=_BIG)) * pAgtC * pBgtC)
    M = torch.minimum(torch.minimum(amax, bmax), C)
    tA = torch.where(amax >= _BIG, zero,
                     torch.clamp((_i0(sigma, M) - _i1(sigma, M) / bmax) / amax, min=0.0))
    tB = torch.where(bmax >= _BIG, zero,
                     torch.clamp((_i0(sigma, M) - _i1(sigma, M) / amax) / bmax, min=0.0))
    return tC, tA, tB


def _inv(x, lo=1e-7):
    """1/x with x -> 0 mapped to _BIG (axis never crossed)."""
    return torch.where(x > lo, 1.0 / torch.clamp(x, min=lo),
                       torch.full_like(x, _BIG))


def _dir2dir_3src(tau, aspect, phi_deg, theta_deg):
    """(..., 3 src, 3 class) transmissions for the TOP/XMIN/YMIN layout,
    class order (C, A, B); the angles are floats or tensors that broadcast
    with tau and aspect."""
    dev = tau.device
    bz = torch.clamp(aspect, min=1e-6)
    sigma = tau / bz
    phi = torch.deg2rad(torch.as_tensor(phi_deg, dtype=ireals, device=dev))
    theta = torch.deg2rad(torch.as_tensor(theta_deg, dtype=ireals, device=dev))
    sx = torch.sin(phi) * torch.sin(theta)
    sy = torch.cos(phi) * torch.sin(theta)
    sz = torch.cos(theta)
    inv_sx, inv_sy, inv_sz = _inv(sx), _inv(sy), _inv(sz)
    cz = torch.clamp(bz * inv_sz, max=_BIG)
    shp = torch.broadcast_shapes(sigma.shape, cz.shape)
    sigma = torch.broadcast_to(sigma, shp)
    bcast = lambda v: torch.broadcast_to(v, shp)
    top = _class_probs(sigma, bcast(cz), bcast(inv_sx), bcast(inv_sy))
    xm = _class_probs(sigma, bcast(inv_sx), bcast(cz), bcast(inv_sy))
    ym = _class_probs(sigma, bcast(inv_sy), bcast(cz), bcast(inv_sx))
    return torch.stack([torch.stack(top, -1), torch.stack(xm, -1),
                        torch.stack(ym, -1)], dim=-2)


# per source, the exit face of each (C, A, B) argmin class
_CLASS_FACE = {
    0: (BOT, XMAX, YMAX),
    1: (XMAX, BOT, YMAX),
    2: (YMAX, BOT, XMAX),
}


def supports_scheme(scheme_name: str) -> bool:
    """True when the closed form covers the scheme's direct layout (3
    full-face sources TOP/XMIN/YMIN, face-based classification)."""
    try:
        box = get_box_scheme(scheme_name)
    except KeyError:
        return False
    return (box.dir_classify is None and box.dir_src_rects is None
            and tuple(box.dir_src_faces) == (TOP, XMIN, YMIN))


def dir2dir_analytic(scheme_name: str, tau: torch.Tensor, aspect: torch.Tensor,
                     phi_deg, theta_deg) -> torch.Tensor:
    """Exact dir2dir block: inputs broadcast (the angles are floats or
    tensors); returns (..., ndir, ndir) [src, dst]."""
    if not supports_scheme(scheme_name):
        raise ValueError(f"no closed form for scheme {scheme_name}")
    box = get_box_scheme(scheme_name)
    probs = _dir2dir_3src(tau, aspect, phi_deg, theta_deg)
    out = torch.zeros(probs.shape[:-2] + (box.ndir, box.ndir), dtype=probs.dtype,
                      device=probs.device)
    for src in range(3):
        for cls, face in enumerate(_CLASS_FACE[src]):
            dst = box.dir_dst_by_face[face]
            if dst >= 0:
                out[..., src, dst] += probs[..., src, cls]
    return out


def dir2dir_table(scheme_name: str, tau_grid, aspect_grid, phi_grid, theta_grid) -> np.ndarray:
    """Exact dir2dir LUT block on an axis grid, evaluated on the CPU:
    (ntau, naspect, nphi, ntheta, ndir, ndir) float32 numpy.  dir2dir does
    not depend on (w0, g); the caller broadcasts over those axes."""
    mesh = np.meshgrid(*(np.asarray(a, np.float32)
                         for a in (tau_grid, aspect_grid, phi_grid, theta_grid)), indexing="ij")
    t, a, p, th = (torch.from_numpy(m) for m in mesh)
    return dir2dir_analytic(scheme_name, t, a, p, th).numpy().astype(np.float32)
