"""Sun geometry bookkeeping (port of `tenstream_tpu/pprts/sun.py`; pure numpy).

Parity: reference `setup_suninfo` (`src/pprts.F90:1118-1185`) and
`spherical_2_cartesian` (`src/helper_functions.fypp:2025` —
sundir = (-sin t sin p, -sin t cos p, -cos t), i.e. `sundir` is the
direction of photon TRAVEL, pointing downward for sun above horizon).

The azimuth is folded into the canonical [0, 90] octant (`sym_rot_phi`)
for the LUT lookup; the actual octant is carried as the static integers
xinc/yinc: xinc == 1 iff photons travel toward +x (reference sets
xinc=0 for sin(phi)>0, whose sundir_x is negative — same statement).
The octant switches (`lswitch_east = xinc==0`, `lswitch_north = yinc==0`,
`src/pprts.F90:5236`) select the symmetry unfolding and the sweep
direction.  These are host-side (static) values: changing the sun octant
recompiles the solve, matching how the reference re-permutes its sweep.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SunInfo:
    phi: float  # azimuth [deg], reference convention (0 = sun in +y)
    theta: float  # zenith [deg]; < 0 encodes sun below horizon
    mu: float  # max(cos(theta), 0)
    symmetry_phi: float  # folded azimuth in [0, 90] for the LUT
    xinc: int  # 1 iff photons travel toward +x
    yinc: int  # 1 iff photons travel toward +y

    @property
    def sun_up(self) -> bool:
        return self.theta >= 0.0 and self.mu > 0.0

    @property
    def switch_x(self) -> bool:
        return self.xinc == 0

    @property
    def switch_y(self) -> bool:
        return self.yinc == 0


def sundir_from_angles(phi_deg: float, theta_deg: float) -> np.ndarray:
    p, t = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    return np.array([-np.sin(t) * np.sin(p), -np.sin(t) * np.cos(p), -np.cos(t)])


def suninfo_from_sundir(sundir) -> SunInfo:
    sundir = np.asarray(sundir, np.float64)
    sundir = sundir / max(np.linalg.norm(sundir), 1e-30)
    px, py, pz = sundir  # photon travel direction

    theta = np.rad2deg(np.arccos(np.clip(-pz, -1.0, 1.0)))
    phi = np.rad2deg(np.arctan2(-px, -py))  # reference phi convention
    mu = max(np.cos(np.deg2rad(theta)), 0.0)

    # fold azimuth to [0, 90] (reference sym_rot_phi)
    sym = np.rad2deg(np.arcsin(np.abs(np.sin(np.deg2rad(phi)))))
    sym = float(np.clip(sym, 0.0, 90.0))

    xinc = 1 if px > 0 else 0
    yinc = 1 if py > 0 else 0

    if theta >= 90.0:
        theta_out = -1.0
        mu = 0.0
    else:
        theta_out = float(theta)

    return SunInfo(
        phi=float(phi),
        theta=theta_out,
        mu=float(mu),
        symmetry_phi=sym,
        xinc=xinc,
        yinc=yinc,
    )
