"""Wedge azimuth re-parameterization (port of
`tenstream_tpu/plexrt/param_phi.py`; reference `src/LUT_param_phi.F90`,
`param_phi_from_azimuth`:20, `azimuth_from_param_phi`:57).

The reference tabulates wedge coefficients over param_phi in [-2, 2],
anchored at the side-face alignment angles of the triangle A=(0,0),
B=(1,0), C=(Cx, Cy > 0) with inner angles alpha at A and beta at B:

    90 - alpha/2 -> -2,  90 - alpha -> -1,  beta - 90 -> +1,  beta/2 - 90 -> +2

The wedge tables keep a plain periodic azimuth on one canonical
triangle; a cell of another shape evaluates them through the monotone
circle map built from the same four anchors (`canonical_azimuth_map`),
the identity for congruent cells.  float32 tensors throughout, angles in
degrees unless noted.
"""

from __future__ import annotations

import math

import torch

from tenstream_tpu_torch.core.types import ireals


def _f32(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=ireals, device=dev)


def triangle_angles(Cx, Cy):
    """Inner angles (alpha at A, beta at B) in radians
    (`src/LUT_param_phi.F90:29-31`)."""
    Cx = _f32(Cx)
    Cy = _f32(Cy, Cx)
    return torch.atan2(Cy, Cx), torch.atan2(Cy, 1.0 - Cx)


def _anchors_rad(Cx, Cy):
    """The four anchor azimuths [90-alpha/2, 90-alpha, beta-90,
    beta/2-90] (radians), descending in phi, on a trailing axis."""
    alpha, beta = triangle_angles(Cx, Cy)
    h = math.pi / 2
    return torch.stack([h - alpha / 2, h - alpha, beta - h, beta / 2 - h], dim=-1)


def param_phi_from_azimuth(phi_rad, Cx, Cy):
    """Azimuth (radians) -> param_phi in [-2, 2]: the reference's three
    local splines (`src/LUT_param_phi.F90:20-47`)."""
    a = _anchors_rad(Cx, Cy)
    m2, m1, p1, p2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    phi = _f32(phi_rad, a)
    x_lo = -2.0 + (-1.0 - -2.0) / (m1 - m2) * (phi - m2)
    x_mid = -1.0 + (1.0 - -1.0) / (p1 - m1) * (phi - m1)
    x_hi = 1.0 + (2.0 - 1.0) / (p2 - p1) * (phi - p1)
    return torch.where(phi > m1, x_lo, torch.where(phi < p1, x_hi, x_mid))


def azimuth_from_param_phi(param_phi, Cx, Cy):
    """param_phi in [-2, 2] -> azimuth (radians), the inverse
    (`src/LUT_param_phi.F90:57-84`)."""
    a = _anchors_rad(Cx, Cy)
    m2, m1, p1, p2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x = _f32(param_phi, a)
    phi_lo = m2 + (m1 - m2) * (x - -2.0)
    phi_mid = m1 + (p1 - m1) * (x - -1.0) / 2.0
    phi_hi = p1 + (p2 - p1) * (x - 1.0)
    return torch.where(x < -1.0, phi_lo, torch.where(x > 1.0, phi_hi, phi_mid))


def canonical_azimuth_map(phi_deg, Cx, Cy, Cx0, Cy0):
    """Map a cell-local sun azimuth (degrees, any value) on a triangle
    with apex (Cx, Cy) to the azimuth on the canonical triangle
    (Cx0, Cy0) with the same param_phi coordinate: a monotone
    piecewise-linear circle map through the four anchors, including the
    wrap segment from the +2 anchor round to the -2 anchor."""
    two_pi = 2.0 * math.pi
    src = _anchors_rad(Cx, Cy)
    dst = _anchors_rad(_f32(Cx0, src), _f32(Cy0, src))
    phi = torch.deg2rad(_f32(phi_deg, src))

    def seg_map(phi, lo_s, hi_s, lo_d, hi_d):
        t = (phi - lo_s) / torch.clamp(hi_s - lo_s, min=1e-12)
        return lo_d + t * (hi_d - lo_d)

    a0, a1, a2, a3 = src[..., 0], src[..., 1], src[..., 2], src[..., 3]
    b0, b1, b2, b3 = dst[..., 0], dst[..., 1], dst[..., 2], dst[..., 3]
    # phi into (a0 - 2 pi, a0]
    phi_n = phi - two_pi * torch.ceil((phi - a0) / two_pi)

    out = seg_map(phi_n, a1, a0, b1, b0)
    out = torch.where(phi_n < a1, seg_map(phi_n, a2, a1, b2, b1), out)
    out = torch.where(phi_n < a2, seg_map(phi_n, a3, a2, b3, b2), out)
    out = torch.where(phi_n < a3, seg_map(phi_n, a0 - two_pi, a3, b0 - two_pi, b3), out)
    return torch.rad2deg(out)
