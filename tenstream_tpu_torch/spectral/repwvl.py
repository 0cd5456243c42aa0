"""repwvl: the representative-wavelength spectral backend (port of
`tenstream_tpu/spectral/repwvl.py`; reference `repwvl/`: a few trained
monochromatic wavelengths with weights replace the band and k-distribution
loop, `repwvl_base.F90` table layout, `repwvl_optprop.F90:repwvl_dtau:240`
cross-section interpolation, `rayleigh.F90` Bodhaine Rayleigh,
`repwvl_pprts.F90:405,606` thermal and solar weighting).

Conventions:
  * solar weights are TOA irradiances [W/m2] per wavelength (sum 1368.6);
  * thermal weights multiply the Planck spectral radiance per nm, so
    B_gpt = wgt * 1e-9 * B_lambda(wvl, T) [W/m2/sr];
  * tracer order (H2O self-continuum [quadratic in vmr], H2O, CO2, O3,
    N2O, CO, CH4, O2, HNO3, N2), CO and HNO3 fixed at 1e-9, N2 at 0.78102
    (`repwvl_optprop.F90:52-54`).

The gas optics are float64 numpy on the background column, as in the JAX
package, and come back as float32 CPU tensors.  The per-wavelength water
and ice cloud optics work on the caller's device (the Fu ice
parameterization in float64 there, cast to float32).  Tables: the
repository's `data/repwvl/*.npz` (n_wvl 15, 20, 25 or 50).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from tenstream_tpu_torch.atm import DATA_DIR, Atmosphere
from tenstream_tpu_torch.core.types import AVOGADRO, GRAV, ireals
from tenstream_tpu_torch.ops.interp import fractional_index
from tenstream_tpu_torch.spectral.fu_ice import fu_ice_optprop
from tenstream_tpu_torch.spectral.gasoptics import SpectralOptProps

_DIR = os.path.join(DATA_DIR, "repwvl")
MOLMASS_AIR = 28.9644e-3  # [kg/mol]
_H, _C, _KB = 6.62607015e-34, 2.99792458e8, 1.380649e-23
_R_DRY = 287.058


def _planck_lambda(lam_m, T):
    """B_lambda [W/m2/m/sr] (reference `planck`, `tenstr_atm.F90:987`)."""
    return 2.0 * _H * _C**2 / (
        lam_m**5 * (np.exp(_H * _C / (lam_m * _KB * T)) - 1.0)
    )


def rayleigh_bodhaine(lambda_um, co2_vmr):
    """Rayleigh cross section [cm2] (reference `rayleigh.F90:44-75`)."""
    lam = np.asarray(lambda_um, np.float64)
    co2 = co2_vmr * 1e-4  # ppv percent
    l2 = lam * lam
    lm2 = 1.0 / l2
    n_300 = (8060.51 + 2480990.0 / (132.274 - lm2)
             + 17455.7 / (39.32957 - lm2)) * 1e-8
    n = (1.0 + 0.54 * (co2_vmr * 1e-6 - 0.0003)) * n_300 + 1.0
    n2 = n * n
    ref_ratio = (n2 - 1.0) ** 2 / (n2 + 2.0) ** 2
    F_N2 = 1.034 + 3.17e-4 / l2
    F_O2 = 1.096 + 1.385e-3 / l2 + 1.448e-4 / (l2 * l2)
    F_air = (78.084 * F_N2 + 20.946 * F_O2 + 0.934 + co2 * 1.15) / (
        78.084 + 20.946 + 0.934 + co2
    )
    N_s = 2.546899e19
    ray_const = 24.0 * np.pi**3 / N_s / N_s
    lambda_cm = lam * 1e-4
    return ray_const / lambda_cm**4 * ref_ratio * F_air


class RepwvlOptics:
    """Backend for `specint_pprts(specint="repwvl")`."""

    def __init__(self, n_wvl: int = 15, data_dir: Optional[str] = None):
        self.n_wvl = n_wvl
        self.data_dir = data_dir or _DIR
        self._cache: Dict[str, dict] = {}
        self._mie: Dict[str, tuple] = {}

    def _load(self, band: str) -> dict:
        if band not in self._cache:
            z = np.load(os.path.join(self.data_dir, f"repwvl_{band}_{self.n_wvl}.npz"),
                        allow_pickle=False)
            self._cache[band] = {k: z[k] for k in z.files if z[k].dtype.kind == "f"}
        return self._cache[band]

    def _gas_tau(self, tb: dict, atm: Atmosphere) -> np.ndarray:
        """(nwvl, nlay) optical depth (reference `repwvl_dtau:240`)."""
        play = np.asarray(atm.play, np.float64)  # [Pa]
        tlay = np.asarray(atm.tlay, np.float64)
        dP = np.asarray(atm.plev[1:] - atm.plev[:-1], np.float64)
        g = atm.gases
        nlay = play.size
        zero = np.zeros(nlay)

        def vmr(name, default=None):
            if name in g:
                return np.broadcast_to(np.asarray(g[name], np.float64), (nlay,))
            return np.full(nlay, default) if default is not None else zero

        # tracer order per tracernames (module docstring)
        h2o = vmr("h2o")
        VMRS = np.stack([
            h2o, h2o, vmr("co2"), vmr("o3"), vmr("n2o"),
            np.full(nlay, 1e-9), vmr("ch4"), vmr("o2", 0.20942),
            np.full(nlay, 1e-9), np.full(nlay, 0.78102),
        ])  # (10, nlay)

        num_dens = dP * AVOGADRO / MOLMASS_AIR / GRAV  # [molec/m2]

        p_ref = tb["p_ref"]  # (41,) descending? (starts 110000)
        # fractional index along p_ref (monotone decreasing in the file)
        order = np.argsort(p_ref)
        pr = p_ref[order]
        wp = np.interp(play, pr, np.arange(pr.size))
        ip0s = np.clip(np.floor(wp).astype(int), 0, pr.size - 2)
        wgt_p = wp - ip0s
        # map back to original (descending) indexing
        ip0 = order[ip0s]
        ip1 = order[np.clip(ip0s + 1, 0, pr.size - 1)]

        t_ref = tb["t_ref"]
        t_pert = tb["t_pert"]  # (9,) e.g. -40..+40
        tgrid = t_pert[None, :] + t_ref[ip0][:, None]  # (nlay, 9)
        wt = np.clip(
            np.array([np.interp(tlay[k], tgrid[k], np.arange(t_pert.size))
                      for k in range(nlay)]),
            0, t_pert.size - 1 - 1e-6,
        )
        it0 = np.floor(wt).astype(int)
        wgt_t = wt - it0

        xsec = tb["xsec"]  # (Nt_pert, Ntracer, Nwvl, Np)
        vref = tb["vmrs_ref"]  # (Ntracer, Np)
        ntracer, nwvl = xsec.shape[1], xsec.shape[2]
        _tr = np.arange(ntracer)[None, :, None]
        _wv = np.arange(nwvl)[None, None, :]

        def x_at(itx, ipx):  # -> (ntracer, nwvl, nlay)
            out = xsec[itx[:, None, None], _tr, _wv, ipx[:, None, None]]
            return np.moveaxis(out, 0, -1)

        xs0 = (x_at(it0, ip0) * (1 - wgt_t) + x_at(it0 + 1, ip0) * wgt_t)
        xs1 = (x_at(it0, ip1) * (1 - wgt_t) + x_at(it0 + 1, ip1) * wgt_t)
        # H2O self-continuum: cross sections normalized by the reference
        # vmr, entering quadratically (`repwvl_dtau:296-303`)
        xs0 = xs0.copy()
        xs1 = xs1.copy()
        xs0[0] = xs0[0] / np.maximum(vref[0, ip0], 1e-30)
        xs1[0] = xs1[0] / np.maximum(vref[0, ip1], 1e-30)
        xs = xs0 * (1 - wgt_p) + xs1 * wgt_p  # (ntracer, nwvl, nlay)

        V = VMRS.copy()
        V[0] = V[0] ** 2
        tau = np.einsum("swk,sk->wk", xs, V * num_dens[None, :])

        # Bremen O3/NO2 quadratic cross sections (`repwvl_dtau:322-334`)
        for key, v in (("crs_o3", VMRS[3]), ("crs_no2", zero)):
            if key in tb and tb[key].size:
                c = tb[key]  # (nwvl, 3)
                dT = tlay - 273.15
                sigma = np.maximum(
                    0.0, c[:, 0][:, None] + c[:, 1][:, None] * dT[None]
                    + c[:, 2][:, None] * dT[None] ** 2
                ) * 1e-20
                rho = play / (_R_DRY * tlay)
                dz = dP / (rho * GRAV)
                N = play / (_KB * tlay) * 1e-4 * dz  # [molec/cm2... per ref]
                tau = tau + v[None, :] * N[None, :] * sigma
        return np.maximum(tau, 0.0)

    def _rayleigh_tau(self, tb, atm) -> np.ndarray:
        dP = np.asarray(atm.plev[1:] - atm.plev[:-1], np.float64)
        co2 = float(np.mean(np.asarray(atm.gases.get("co2", 400e-6)))) * 1e6
        xs = rayleigh_bodhaine(tb["wvl"] * 1e-3, co2)  # [cm2] per wvl
        N = dP * AVOGADRO / GRAV / MOLMASS_AIR  # [molec/m2]
        return xs[:, None] * 1e-4 * N[None, :]

    def solar(self, atm: Atmosphere) -> SpectralOptProps:
        tb = self._load("sw")
        tau_r = self._rayleigh_tau(tb, atm)
        tau = self._gas_tau(tb, atm) + tau_r
        w0 = tau_r / np.maximum(tau, 1e-30)
        tau_t = torch.as_tensor(tau, dtype=ireals)
        return SpectralOptProps(tau=tau_t, w0=torch.as_tensor(w0, dtype=ireals),
                                g=torch.zeros_like(tau_t),
                                weight=torch.as_tensor(tb["wgts"], dtype=ireals))

    def thermal(self, atm: Atmosphere) -> SpectralOptProps:
        tb = self._load("lw")
        tau = torch.as_tensor(self._gas_tau(tb, atm), dtype=ireals)
        tlev = np.asarray(atm.tlev, np.float64)
        # per-nm weights: wgt * 1e-9 * B_lambda integrates to sigma T^4
        B = tb["wgts"][:, None] * 1e-9 * _planck_lambda(tb["wvl"][:, None] * 1e-9, tlev[None, :])
        z = torch.zeros_like(tau)
        return SpectralOptProps(tau=tau, w0=z, g=z, weight=torch.ones(tau.shape[0], dtype=ireals),
                                planck=torch.as_tensor(B, dtype=ireals))

    def _mie_tables(self, kind: str):
        """The Mie water-cloud table at this backend's wavelengths
        (`mie_tables.F90`; ext in [km^-1/(g/m^3)]): (reff grid, ext, ssa,
        g), float64 (nwvl, nreff), built once per kind."""
        if kind not in self._mie:
            mie = np.load(os.path.join(self.data_dir, "mie_wc_table.npz"))
            wvls = self._load("sw" if kind == "sw" else "lw")["wvl"] * 1e-3  # [nm] -> [um]
            mw = mie["wvl"]  # [um]
            iw = np.clip(np.interp(wvls, mw, np.arange(mw.size)), 0, mw.size - 1)
            i0 = np.floor(iw).astype(int)
            f = (iw - i0)[:, None]
            i1 = np.minimum(i0 + 1, mw.size - 1)
            self._mie[kind] = (mie["reff"],) + tuple(mie[k][i0] * (1 - f) + mie[k][i1] * f
                                                     for k in ("ext", "ssa", "g"))
        return self._mie[kind]

    def cloud_optprops_gpt(self, kind: str, lwc_gm3: torch.Tensor, reff_um: torch.Tensor,
                           dz_m: torch.Tensor, gsel=slice(None)):
        """Per-wavelength Mie water-cloud (tau, w0, g), shapes (nwvl_sel,) +
        grid, float32 on the fields' device."""
        reff_grid, ext, ssa, gg = self._mie_tables(kind)
        dev = lwc_gm3.device
        fr = fractional_index(torch.as_tensor(np.asarray(reff_grid, np.float32), device=dev),
                              reff_um.to(ireals))
        j0 = torch.clamp(torch.floor(fr), 0, len(reff_grid) - 2).to(torch.int64)
        w = (fr - j0.to(ireals))[None]
        sel = gsel if isinstance(gsel, slice) else torch.as_tensor(np.asarray(gsel), device=dev)

        def gi(t):
            t = torch.as_tensor(t, dtype=ireals, device=dev)[sel]
            return t[:, j0] * (1 - w) + t[:, j0 + 1] * w

        # ext [km^-1/(g/m^3)] * lwc [g/m3] * dz [m] * 1e-3
        tau = gi(ext) * lwc_gm3[None] * dz_m[None] * 1e-3
        return tau, gi(ssa), gi(gg)

    def ice_optprops_gpt(self, kind: str, iwc_gm3: torch.Tensor, reice_um: torch.Tensor,
                         dz_m: torch.Tensor, gsel=slice(None)):
        """Per-wavelength Fu ice (tau, w0, g), shapes (nwvl_sel,) + grid
        (`repwvl_optprop.F90:164-181`): the parameterization in float64 on
        the fields' device for the selected wavelengths, cast to float32."""
        wvl = self._load("sw" if kind == "sw" else "lw")["wvl"] * 1e-3
        kext, w0, g = (a.to(ireals) for a in fu_ice_optprop(
            np.atleast_1d(wvl[gsel]), reice_um, solar=(kind == "sw")))
        return kext * iwc_gm3[None] * dz_m[None], w0, g
