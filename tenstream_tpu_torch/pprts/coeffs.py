"""Per-cell transfer-coefficient field assembly (port of
`tenstream_tpu/pprts/coeffs.py`: `assemble_coeffs` in orbit and dense
form, `determine_1d_layers`, `_onedee_blocks`, `_onedee_diff_orbit`).

3-D layers interpolate the LUT; layers flagged 1-D (aspect >=
twostr_ratio) get analytic delta-Eddington blocks, so the solvers have
no 1-D special case.  The LUT lookups run on the 3-D layers only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.types import TINY, ireals
from tenstream_tpu_torch.ops.eddington import eddington_coeff_ec
from tenstream_tpu_torch.pprts.operators import DiffCoeff, OrbitCoeff
from tenstream_tpu_torch.pprts.sun import SunInfo
from tenstream_tpu_torch.streams import StreamScheme


class CoeffFields(NamedTuple):
    dir2dir: Optional[torch.Tensor]  # (ndir, ndir, Nz, Nx, Ny)
    dir2diff: Optional[torch.Tensor]  # (ndir, ndiff, Nz, Nx, Ny)
    diff2diff: DiffCoeff  # OrbitCoeff or (ndiff, ndiff, Nz, Nx, Ny)


def optical_state(kabs, ksca, dz3d, dx: float):
    """(tauz, w0, aspect) per cell."""
    kext = kabs + ksca
    tauz = kext * dz3d
    w0 = ksca / torch.clamp(kext, min=TINY)
    aspect = dz3d / dx
    return tauz, w0, aspect


def _onedee_blocks(scheme: StreamScheme, a11, a12, a13, a23, a33,
                   want_dir: bool = True, want_diff: bool = True):
    """Analytic (dir2dir, dir2diff, diff2diff) blocks of 1-D layers; the
    direct pair or the dense diffuse block is None when not wanted."""
    shp = tuple(a11.shape)
    nd, nf = scheme.ndir, scheme.ndiff
    inward = scheme.diff_inward()
    inv = scheme.diff_inv_dof()
    wtop = scheme.difftop_weights()
    z = lambda *lead: torch.zeros(lead + shp, dtype=a11.dtype, device=a11.device)
    dir2dir = dir2diff = diff2diff = None
    if want_dir:
        dir2dir = z(nd, nd)
        dir2diff = z(nd, nf)
        for t in range(scheme.dirtop.dof):
            dir2dir[t, t] = a33
            for d in range(scheme.difftop.dof):
                dir2diff[t, d] = (a23 if inward[d] else a13) * float(wtop[d])
    if want_diff:
        diff2diff = z(nf, nf)
        for d in range(scheme.difftop.dof):
            diff2diff[d, d] = a11
            diff2diff[int(inv[d]), d] = a12
    return dir2dir, dir2diff, diff2diff


def _onedee_diff_orbit(scheme: StreamScheme, orbit_idx: np.ndarray, norb: int, a11, a12):
    """The 1-D diff2diff blocks in orbit-channel form."""
    inv = scheme.diff_inv_dof()
    orb = torch.zeros((norb,) + tuple(a11.shape), dtype=a11.dtype, device=a11.device)
    for d in range(scheme.difftop.dof):
        orb[int(orbit_idx[d, d])] = a11
        orb[int(orbit_idx[int(inv[d]), d])] = a12
    return orb


def assemble_coeffs(
    scheme: StreamScheme,
    opp,
    kabs: torch.Tensor,
    ksca: torch.Tensor,
    g: torch.Tensor,
    dz3d: torch.Tensor,
    dx: float,
    l1d: np.ndarray,  # (Nz,) bool, host
    sun: Optional[SunInfo],
    need_dir: bool,
    orbit: bool = False,
) -> Tuple[CoeffFields, Tuple[torch.Tensor, ...]]:
    """Coefficient fields and the eddington set (a11, a12, a13, a23,
    a33).  orbit=True stores diff2diff as `OrbitCoeff` (needs a
    symmetrized LUT), else as the dense (ndiff, ndiff, Nz, Nx, Ny) tensor.
    dz3d may be (Nz, 1, 1) (per-layer thickness, which lets the lookup
    take the one-hot path) or full."""
    if orbit and getattr(opp, "_solver_orbit_idx", None) is None:
        raise ValueError("orbit coefficient storage needs a symmetrized LUT")
    tauz, w0, aspect = optical_state(kabs, ksca, dz3d, dx)
    mu = sun.mu if (sun is not None and need_dir) else 1.0
    a11, a12, a13, a23, a33 = eddington_coeff_ec(
        tauz, w0, g, torch.tensor(mu, dtype=ireals, device=tauz.device))
    want_dir = bool(need_dir and sun is not None and sun.sun_up)

    l1d = np.asarray(l1d, bool)
    idx3d = np.nonzero(~l1d)[0]

    dd, df, ff = _onedee_blocks(scheme, a11, a12, a13, a23, a33, want_dir=want_dir,
                                want_diff=not orbit)
    if orbit:
        oidx = opp._solver_orbit_idx
        ff = _onedee_diff_orbit(scheme, oidx, int(oidx.max()) + 1, a11, a12)
    if idx3d.size:
        sel = torch.as_tensor(idx3d, device=tauz.device)
        tz_r, w0_r, g_r, asp_r = (x[sel] for x in (tauz, w0, g, aspect))
        if orbit:
            ff[:, sel] = opp.diff_coeffs_orbit(tz_r, w0_r, g_r, asp_r)
        else:
            ff[:, :, sel] = opp.diff_coeffs(tz_r, w0_r, g_r, asp_r)
        if want_dir:
            c_dd, c_df = opp.dir_coeffs(tz_r, w0_r, g_r, asp_r, sun.symmetry_phi, sun.theta,
                                        switch_x=sun.switch_x, switch_y=sun.switch_y)
            dd[:, :, sel] = c_dd
            df[:, :, sel] = c_df
    return CoeffFields(dd, df, OrbitCoeff(ff, oidx) if orbit else ff), (a11, a12, a13, a23, a33)


def determine_1d_layers(dz3d: torch.Tensor, dx: float, twostr_ratio: float) -> np.ndarray:
    """Layers whose aspect ratio reaches the threshold solve 1-D (host
    bool array; reference `determine_1d_layers`)."""
    aspect = dz3d / dx
    return (aspect.amax(dim=(1, 2)) >= twostr_ratio).cpu().numpy()
