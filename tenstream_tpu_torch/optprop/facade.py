"""Batched transfer-coefficient lookups over whole grids (port of
`tenstream_tpu/optprop/facade.py`).

Per solve the sun angles are constant, so the 6-D direct tables are
blended down to 4-D (bilinear in phi/theta) before one batched 4-D
lookup yields the (src, dst) coefficient fields with stream dims leading.
Symmetrized diffuse tables repeat each value over its cube-group (src,
dst) orbit, so only one channel per orbit is interpolated and the
solver keeps the 24 channels of the no-z-mirror subgroup (`OrbitCoeff`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.types import ireals
from tenstream_tpu_torch.ops.interp import (
    fractional_index,
    interp_4d_layered_onehot_cf,
    interp_multilinear_cf,
)
from tenstream_tpu_torch.optprop.lut import LUT, perm_group
from tenstream_tpu_torch.streams import StreamScheme, get_scheme


def diff_pair_orbits(scheme: StreamScheme, with_mz: bool = True) -> Tuple[np.ndarray, int]:
    """Orbit id of every (src, dst) diffuse pair under the cube symmetry
    group (x/y/z mirrors + x<->y); with_mz=False drops the z-mirror (the
    solver storage subgroup)."""
    p = scheme.diff_mirror_perms()
    gens = [p["mx"], p["my"], p["mxy"]] + ([p["mz"]] if with_mz else [])
    group = perm_group(gens)
    n = scheme.ndiff
    orbit = -np.ones((n, n), np.int64)
    norb = 0
    for s in range(n):
        for d in range(n):
            if orbit[s, d] >= 0:
                continue
            for g in group:
                orbit[g[s], g[d]] = norb
            norb += 1
    return orbit, norb


class OptProp:
    """Device-resident coefficient tables for one scheme.

    interp_mode "onehot" (default) contracts per z-layer one-hot weight
    matrices when the aspect ratio is constant per layer, else (and for
    "multilinear") it gathers the 16 corners.  Both give the multilinear
    values.  analytic_dir2dir (default: where supported) evaluates the
    closed-form dir2dir at the cell's actual (tau, aspect, phi, theta).
    """

    def __init__(self, lut: LUT, scheme: StreamScheme | None = None,
                 analytic_dir2dir: bool | None = None, interp_mode: str = "onehot",
                 device="cuda"):
        if interp_mode not in ("onehot", "multilinear"):
            raise NotImplementedError(
                f"interp_mode {interp_mode!r} is not ported (ROADMAP M3)")
        self.lut = lut
        self.scheme = scheme or get_scheme(lut.scheme)
        self.interp_mode = interp_mode
        if analytic_dir2dir is None:
            from tenstream_tpu_torch.boxmc.direct_transmission import supports_scheme

            analytic_dir2dir = supports_scheme(self.scheme.name)
        self.analytic_dir2dir = analytic_dir2dir
        dev = torch.device(device)
        self._dir2dir = lut.dir2dir.to(dev, ireals)
        self.device = self._dir2dir.device  # with the index, as tensors report it
        self._dir2diff = lut.dir2diff.to(dev, ireals)
        self._diff2diff = lut.diff2diff.to(dev, ireals)
        g = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        ax = lut.dir_axes
        self._dir_grids = tuple(g(a) for a in (ax.tau, ax.w0, ax.aspect, ax.g))
        self._phi_grid = g(ax.phi)
        self._theta_grid = g(ax.theta)
        ax = lut.diff_axes
        self._diff_grids = tuple(g(a) for a in (ax.tau, ax.w0, ax.aspect, ax.g))

        # orbit-compressed diffuse channels; the consistency gate keeps
        # unsymmetrized tables off the orbit path
        self._solver_orbit_idx = None
        self._diff_orbit_idx = None  # (ndiff^2,) cube-group orbit of each (src, dst) pair
        orbit, norb = diff_pair_orbits(self.scheme)
        t = lut.diff2diff.detach().cpu().numpy().astype(np.float32)
        flat = t.reshape(t.shape[:4] + (-1,))
        oflat = orbit.ravel()
        acc = np.zeros(t.shape[:4] + (norb,), np.float64)
        cnt = np.zeros(norb)
        np.add.at(acc, (..., oflat), flat)
        np.add.at(cnt, oflat, 1.0)
        mean = (acc / cnt).astype(np.float32)
        if np.abs(flat - mean[..., oflat]).max() <= 1e-5:
            self._diff2diff_orb = torch.as_tensor(mean, device=dev)
            self._diff_orbit_idx = torch.as_tensor(oflat, device=dev)
            osub, nsub = diff_pair_orbits(self.scheme, with_mz=False)
            sub2full = np.zeros(nsub, np.int64)
            nf = self.scheme.ndiff
            for s in range(nf):
                for d in range(nf):
                    sub2full[osub[s, d]] = orbit[s, d]
            self._solver_orbit_idx = osub
            self._sub2full = torch.as_tensor(sub2full, device=dev)

    # ------------------------------------------------------------------
    def _interp(self, table, fr):
        """One-hot per-layer path when aspect is per-layer constant (frac
        shape (nz, 1, 1) against 3-D tau/w0), else the corner gathers."""
        ft, fw, fa, fg = fr
        if (self.interp_mode == "onehot" and fa.dim() == 3
                and tuple(fa.shape[-2:]) == (1, 1)
                and ft.dim() == 3 and tuple(ft.shape[-2:]) != (1, 1)):
            return interp_4d_layered_onehot_cf(table, ft, fw, fa.reshape(-1), fg)
        return interp_multilinear_cf(table, fr)

    def _slice_angles(self, table, phi_deg: float, theta_deg: float):
        """Bilinear blend of the (phi, theta) axes -> 4-D table."""
        dev = self.device
        fp = fractional_index(self._phi_grid, torch.tensor(phi_deg, dtype=ireals, device=dev))
        ft = fractional_index(self._theta_grid, torch.tensor(theta_deg, dtype=ireals, device=dev))
        fp, ft = float(fp), float(ft)
        ip = int(np.clip(np.floor(fp), 0, self._phi_grid.shape[0] - 2))
        it = int(np.clip(np.floor(ft), 0, self._theta_grid.shape[0] - 2))
        wp = np.float32(fp) - np.float32(ip)
        wt = np.float32(ft) - np.float32(it)
        wp, wt = float(wp), float(wt)
        t00 = table[:, :, :, :, ip, it]
        t10 = table[:, :, :, :, ip + 1, it]
        t01 = table[:, :, :, :, ip, it + 1]
        t11 = table[:, :, :, :, ip + 1, it + 1]
        return (t00 * ((1 - wp) * (1 - wt)) + t10 * (wp * (1 - wt))
                + t01 * ((1 - wp) * wt) + t11 * (wp * wt))

    def _fracs(self, grids, tauz, w0, aspect, g):
        return (fractional_index(grids[0], tauz), fractional_index(grids[1], w0),
                fractional_index(grids[2], aspect), fractional_index(grids[3], g))

    # ------------------------------------------------------------------
    def dir_coeffs(self, tauz, w0, g, aspect, phi_deg: float, theta_deg: float,
                   switch_x: bool = False, switch_y: bool = False):
        """(dir2dir, dir2diff) with shapes (ndir, ndir) + B and
        (ndir, ndiff) + B.  phi_deg is the symmetry azimuth in [0, 90];
        switch_x/switch_y unfold the actual sun octant."""
        t2f = self._slice_angles(self._dir2diff, phi_deg, theta_deg)
        fr = self._fracs(self._dir_grids, tauz, w0, aspect, g)
        ndir, ndiff = self.scheme.ndir, self.scheme.ndiff
        if self.analytic_dir2dir:
            from tenstream_tpu_torch.boxmc.direct_transmission import dir2dir_analytic

            c_dd = dir2dir_analytic(self.scheme.name, tauz, aspect, phi_deg, theta_deg)
            c_dd = torch.movedim(c_dd, (-2, -1), (0, 1))
        else:
            t2d = self._slice_angles(self._dir2dir, phi_deg, theta_deg)
            c_dd = self._interp(t2d.reshape(t2d.shape[:4] + (ndir * ndir,)), fr)
            c_dd = c_dd.reshape((ndir, ndir) + tuple(c_dd.shape[1:]))
        c_df = self._interp(t2f.reshape(t2f.shape[:4] + (ndir * ndiff,)), fr)
        c_df = c_df.reshape((ndir, ndiff) + tuple(c_df.shape[1:]))
        if switch_x or switch_y:
            q = torch.as_tensor(self.scheme.diff_switch_perm(switch_x, switch_y),
                                device=c_df.device)
            p = torch.as_tensor(self.scheme.dir_switch_perm(switch_x, switch_y),
                                device=c_df.device)
            c_dd = c_dd[p][:, p]
            c_df = c_df[p][:, q]
        return c_dd, c_df

    def diff_coeffs(self, tauz, w0, g, aspect) -> torch.Tensor:
        """diff2diff in dense form: (ndiff, ndiff) + B [src, dst].  A
        symmetrized table interpolates one channel per orbit and expands
        with a static take; an unsymmetrized one interpolates all
        ndiff^2 channels."""
        fr = self._fracs(self._diff_grids, tauz, w0, aspect, g)
        nd = self.scheme.ndiff
        if self._diff_orbit_idx is not None:
            c = self._interp(self._diff2diff_orb, fr)[self._diff_orbit_idx]
        else:
            c = self._interp(self._diff2diff.reshape(self._diff2diff.shape[:4] + (nd * nd,)), fr)
        return c.reshape((nd, nd) + tuple(c.shape[1:]))

    def diff_coeffs_orbit(self, tauz, w0, g, aspect) -> torch.Tensor:
        """diff2diff in solver-orbit channel form: (norb,) + B."""
        if self._solver_orbit_idx is None:
            raise ValueError("orbit coefficient storage needs a symmetrized LUT")
        fr = self._fracs(self._diff_grids, tauz, w0, aspect, g)
        c = self._interp(self._diff2diff_orb, fr)
        return c[self._sub2full]
