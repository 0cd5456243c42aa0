"""Per-cell transfer-coefficient field assembly (port of
`tenstream_tpu/pprts/coeffs.py`: `assemble_coeffs` in orbit and dense
form, `determine_1d_layers`, `_onedee_blocks`, `_onedee_diff_orbit`, and
the atmosphere-collapse folds `fold_eddington_adding`,
`fold_thermal_emission`, `onedee_blocks_collapsed`).

3-D layers interpolate the LUT; layers flagged 1-D (aspect >=
twostr_ratio) get analytic delta-Eddington blocks, so the solvers have
no 1-D special case.  The LUT lookups run on the 3-D layers only.

A band chunk is assembled in one pass: its lanes are cellwise
independent, so `assemble_coeffs` lays the (B, Nz, Nx, Ny) fields side by
side along x, runs one lookup over all of them, and hands back the fields
with the lane dim leading.
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
    l1d: np.ndarray,
    sun: Optional[SunInfo],
    need_dir: bool,
    orbit: bool = False,
) -> Tuple[CoeffFields, Tuple[torch.Tensor, ...]]:
    """Coefficient fields and the eddington set (a11, a12, a13, a23,
    a33).  orbit=True stores diff2diff as `OrbitCoeff` (needs a
    symmetrized LUT), else as the dense (ndiff, ndiff, Nz, Nx, Ny) tensor.
    dz3d may be (Nz, 1, 1) (per-layer thickness, which lets the lookup
    take the one-hot path) or full (Nz, Nx, Ny).

    kabs/ksca/g may carry a leading lane dim B (a band chunk); the fields
    then come back as (B, ...) with one lookup over all lanes."""
    if kabs.dim() == 3:
        return _assemble(scheme, opp, kabs, ksca, g, dz3d, dx, l1d, sun, need_dir, orbit)
    B, nz, nx, ny = kabs.shape
    side = lambda a: a.permute(1, 0, 2, 3).reshape(nz, B * nx, ny)
    dz_s = dz3d if tuple(dz3d.shape[-2:]) == (1, 1) else side(dz3d.expand(B, nz, nx, ny))
    coeffs, edd = _assemble(scheme, opp, side(kabs), side(ksca), side(g), dz_s, dx, l1d, sun,
                            need_dir, orbit)

    def back(a):  # (..., Nz, B*Nx, Ny) -> (B, ..., Nz, Nx, Ny)
        lead = tuple(a.shape[:-3])
        a = a.reshape(lead + (nz, B, nx, ny))
        return torch.movedim(a, len(lead) + 1, 0).contiguous()

    dd = None if coeffs.dir2dir is None else back(coeffs.dir2dir)
    df = None if coeffs.dir2diff is None else back(coeffs.dir2diff)
    ff = coeffs.diff2diff
    ff = OrbitCoeff(back(ff.orb), ff.idx) if isinstance(ff, OrbitCoeff) else back(ff)
    return CoeffFields(dd, df, ff), tuple(back(a) for a in edd)


def _assemble(
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
    """`assemble_coeffs` on unbatched (Nz, Nx, Ny) fields."""
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


def fold_thermal_emission(a11, a12, btop, bbot):
    """Fold per-layer thermal emission (btop up at each layer top, bbot
    down at each bottom, emissivity applied) through the stack with the
    exact interface recursion of `fold_eddington_adding`.  Inputs have
    the layer axis leading, (K, ...).  Returns the stack's emission
    leaving its top and its bottom face (block-model exact, in-stack
    scattering included)."""
    T, Rb, Eup, Edn = a11[0], a12[0], btop[0], bbot[0]
    for k in range(1, a11.shape[0]):
        t, r, s_up, s_dn = a11[k], a12[k], btop[k], bbot[k]
        denom = 1.0 - Rb * r
        B = (r * Edn + s_up) / denom
        A = Edn + Rb * B
        Edn = t * A + s_dn
        Eup = Eup + T * B
        T, Rb = T * t / denom, r + t * Rb * t / denom
    return Eup, Edn


def fold_eddington_adding(a11, a12, a13, a23, a33):
    """Fold a stack of plane-parallel layers into ONE effective layer by
    the exact adding method (reference `adding`, `src/pprts.F90:2125-2198`,
    whose interface denominator uses the top reflectivity where the
    bottom one belongs; here the Schur elimination is exact).

    Inputs are per-layer symmetric two-stream sets with the layer axis
    leading, (K, ...).  Returns the asymmetric combined set
    (Ttop, Rtop, Tbot, Rbot, rdir, sdir, tdir): Ttop/Rtop act on
    radiation from the top, Tbot/Rbot from below, (rdir, sdir, tdir) the
    direct->diffuse up/down and direct->direct transmissions."""
    T, Rt, Rb, tdir, rdir, sdir = a11[0], a12[0], a12[0], a33[0], a13[0], a23[0]
    for k in range(1, a11.shape[0]):
        t, r, s_up, s_dn, t_dir = a11[k], a12[k], a13[k], a23[k], a33[k]
        denom = 1.0 - Rb * r
        T2 = T * t / denom
        Rt2 = Rt + T * r * T / denom
        Rb2 = r + t * Rb * t / denom
        # the new layer's upward source bounces between the composite
        # bottom (Rb) and the layer top (r)
        B = (r * sdir + s_up * tdir) / denom
        A = sdir + Rb * B
        sdir = t * A + s_dn * tdir
        rdir = rdir + T * B
        tdir = tdir * t_dir
        T, Rt, Rb = T2, Rt2, Rb2
    return T, Rt, T, Rb, rdir, sdir, tdir


def onedee_blocks_collapsed(scheme: StreamScheme, folded):
    """Per-cell blocks of the collapsed super-layer from the folded set:
    downward top dofs transmit Ttop / reflect Rtop, upward ones Tbot /
    Rbot.  Returns (dir2dir, dir2diff, diff2diff) shaped
    (..., nd, nd, Nx, Ny) / (..., nd, nf, Nx, Ny) / (..., nf, nf, Nx, Ny)
    for folded fields shaped (..., Nx, Ny)."""
    Ttop, Rtop, Tbot, Rbot, rdir, sdir, tdir = folded
    lead, hw = tuple(Ttop.shape[:-2]), tuple(Ttop.shape[-2:])
    nd, nf = scheme.ndir, scheme.ndiff
    inward = scheme.diff_inward()
    inv = scheme.diff_inv_dof()
    wtop = scheme.difftop_weights()
    z = lambda n, m: torch.zeros(lead + (n, m) + hw, dtype=Ttop.dtype, device=Ttop.device)
    dir2dir, dir2diff, diff2diff = z(nd, nd), z(nd, nf), z(nf, nf)
    for t in range(scheme.dirtop.dof):
        dir2dir[..., t, t, :, :] = tdir
        for d in range(scheme.difftop.dof):
            dir2diff[..., t, d, :, :] = (sdir if inward[d] else rdir) * float(wtop[d])
    # (src, dst): src d transmits into dst d and reflects into dst inv[d]
    for d in range(scheme.difftop.dof):
        diff2diff[..., d, d, :, :] = Ttop if inward[d] else Tbot
        diff2diff[..., d, int(inv[d]), :, :] = Rtop if inward[d] else Rbot
    return dir2dir, dir2diff, diff2diff
