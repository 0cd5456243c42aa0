"""ecCKD gas optics backend (port of `tenstream_tpu/spectral/ecckd.py`;
reference `ecckd/ecckd_optprop.F90`: `ecckd_dtau` -- per-gas molar
absorption interpolated bilinearly in (log p, T) with the concentration
codes None/Linear/RelativeLinear/LUT -- and `ecckd_planck`).

The gas optical depths are float64, as in the JAX package: the per-cell
table indices and weights on the host in numpy, the (cells, g-points)
gathers and blends in torch on the backend's device (the CPU unless the
caller names one; `specint_pprts` and `specint_plexrt` name the solver's
when they build the backend from its name).  Every step of the blend is
one multiply or add, so the card's values equal the host's bit for bit.
They come back as float32 tensors on that device.  The per-g-point
droplet and ice optics work on tensors on the caller's device.

Tables are read from the repository's `data/ecckd/*.npz` next to this
package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from tenstream_tpu_torch.atm import DATA_DIR, Atmosphere
from tenstream_tpu_torch.core.types import GRAV, PI, ireals
from tenstream_tpu_torch.spectral.gasoptics import SpectralOptProps, particle_optprops_gpt

MOLMASS_AIR = 28.9644e-3  # [kg/mol]

# concentration dependence codes: None=0, Linear=1, LUT=2, RelativeLinear=3
_NONE, _LINEAR, _LUT, _RELATIVE_LINEAR = 0, 1, 2, 3

DEFAULT_DIR = os.path.join(DATA_DIR, "ecckd")

# cells per block of the gas optics' (cells, g-points) blends: ~0.27 GB
# of float64 per temporary at 32 g-points
_BLOCK = 1 << 20


def _frac_index(grid: np.ndarray, x: np.ndarray):
    i = np.clip(np.searchsorted(grid, x, side="right") - 1, 0, len(grid) - 2)
    w = (x - grid[i]) / (grid[i + 1] - grid[i])
    return i, np.clip(w, 0.0, 1.0)


@dataclass
class _CkdTables:
    z: Dict[str, np.ndarray]

    @property
    def ngpt(self) -> int:
        return self.z["composite_mabs"].shape[-1]


@lru_cache(maxsize=8)
def _load(kind: str, n_gpt: int, data_dir: str) -> _CkdTables:
    name = {
        ("sw", 16): "ecckd-1.0_sw_climate_rgb-16.npz",
        ("sw", 32): "ecckd-1.0_sw_climate_rgb-32.npz",
        ("lw", 16): "ecckd-1.0_lw_climate_fsck-16.npz",
        ("lw", 32): "ecckd-1.0_lw_climate_fsck-32.npz",
    }[(kind, n_gpt)]
    path = os.path.join(data_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — run tools/extract_ecckd.py to generate the "
            "ecCKD table artifacts"
        )
    return _CkdTables(dict(np.load(path, allow_pickle=True)))


class EcckdGasOptics:
    """Gas-optics backend for `specint_pprts(specint='ecckd')`."""

    def __init__(self, n_gpt: int = 32, data_dir: Optional[str] = None, device=None):
        self.n_gpt = n_gpt
        self.data_dir = os.path.abspath(data_dir or DEFAULT_DIR)
        self.device = torch.device("cpu" if device is None else device)
        self._tables: Dict[tuple, tuple] = {}
        self._on_device: Dict[tuple, torch.Tensor] = {}

    def _t(self, tb: _CkdTables, name: str) -> torch.Tensor:
        """Table `name` as a float64 tensor on the backend's device."""
        key = (id(tb), name)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(np.asarray(tb.z[name], np.float64),
                                                   device=self.device)
        return self._on_device[key]

    def _h(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- core tau computation -------------------------------------------
    def _gas_tau(self, tb: _CkdTables, atm: Atmosphere) -> torch.Tensor:
        """(ngpt, nlay[, nx, ny]) float64 gas optical depth on the backend's
        device (reference `ecckd_dtau`).  Per-(x, y)-column atmospheres
        flatten to pseudo columns through the same interpolation."""
        z = tb.z
        play = np.asarray(atm.play, np.float64)
        grid_shape = play.shape  # (nlay[, nx, ny])
        play = play.ravel()
        tlay = np.asarray(atm.tlay, np.float64).ravel()
        dP = np.asarray(atm.plev[1:] - atm.plev[:-1], np.float64).ravel()  # >0 TOA->sfc
        M = play.shape[0]

        def flat_gas(gas, default=0.0):
            v = atm.gases.get(gas)
            if v is None:
                return np.full(M, default, np.float64)
            return np.broadcast_to(
                np.asarray(v, np.float64).reshape(
                    (grid_shape[0],) + (1,) * (len(grid_shape) - 1)
                ) if np.asarray(v).ndim == 1 else np.asarray(v, np.float64),
                grid_shape,
            ).ravel()

        # per-cell table indices and weights, on the host
        logp = np.log(z["pressure"])  # (53,)
        ip, wp = _frac_index(logp, np.log(np.clip(play, z["pressure"][0], z["pressure"][-1])))

        # temperature grid depends on the pressure index (reference uses
        # the ip0 row): (6, 53) -> per-layer rows
        tgrid = z["temperature"][:, ip]  # (6, M)
        it = np.clip((tgrid <= tlay[None, :]).sum(0) - 1, 0, tgrid.shape[0] - 2)
        t0 = np.take_along_axis(tgrid, it[None], 0)[0]
        t1 = np.take_along_axis(tgrid, (it + 1)[None], 0)[0]
        wt = np.clip((tlay - t0) / np.maximum(t1 - t0, 1e-30), 0.0, 1.0)

        mult = dP / (MOLMASS_AIR * GRAV)  # [mol/m2]

        # per gas: the (M,) factor in front of its molar absorption, and
        # for LUT-coded gases the concentration index and weight
        terms = []
        for gas in z["gases"]:
            gas = str(gas)
            code = int(z[f"{gas}_code"])
            if code == _NONE:
                terms.append((gas, mult, None, None))
            elif code == _LINEAR:
                terms.append((gas, mult * flat_gas(gas), None, None))
            elif code == _RELATIVE_LINEAR:
                ref = float(z[f"{gas}_ref_vmr"])
                terms.append((gas, mult * (flat_gas(gas) - ref), None, None))
            elif code == _LUT:
                vmr = flat_gas(gas, default=1e-9)
                frac_grid = np.log(z[f"{gas}_mole_fraction"])  # (12,)
                ic, wc = _frac_index(frac_grid, np.log(np.clip(vmr, np.exp(frac_grid[0]),
                                                               np.exp(frac_grid[-1]))))
                terms.append((gas, mult * vmr, ic, wc))

        # the (M, ngpt) gathers and blends, on the device, in blocks of
        # cells; each step is one multiply or add, as in the JAX package
        tau = torch.empty((M, tb.ngpt), dtype=torch.float64, device=self.device)
        for lo in range(0, M, _BLOCK):
            sl = slice(lo, min(lo + _BLOCK, M))
            it_b, ip_b = self._h(it[sl]), self._h(ip[sl])
            w = self._h(wp[sl])[:, None]
            wt_b = self._h(wt[sl])[:, None]

            def interp_pt(mabs, *lead):  # mabs ([12,] 6, 53, ngpt) -> (B, ngpt)
                v00 = mabs[lead + (it_b, ip_b)]
                v01 = mabs[lead + (it_b, ip_b + 1)]
                v10 = mabs[lead + (it_b + 1, ip_b)]
                v11 = mabs[lead + (it_b + 1, ip_b + 1)]
                return (1 - wt_b) * ((1 - w) * v00 + w * v01) + wt_b * ((1 - w) * v10 + w * v11)

            acc = torch.zeros((sl.stop - lo, tb.ngpt), dtype=torch.float64, device=self.device)
            for gas, fac, ic, wc in terms:
                mabs = self._t(tb, f"{gas}_mabs")
                f = self._h(fac[sl])[:, None]
                if ic is None:
                    acc += f * interp_pt(mabs)
                else:
                    ic_b = self._h(ic[sl])
                    wc_b = self._h(wc[sl])[:, None]
                    lo_v = interp_pt(mabs, ic_b)
                    hi_v = interp_pt(mabs, ic_b + 1)
                    acc += f * ((1 - wc_b) * lo_v + wc_b * hi_v)
            tau[sl] = torch.clamp(acc, min=0.0)
        return tau.reshape(grid_shape + (tb.ngpt,)).movedim(-1, 0)

    # -- public API ------------------------------------------------------
    @property
    def n_gpt_solar(self) -> int:
        return self.n_gpt

    @property
    def n_gpt_thermal(self) -> int:
        return self.n_gpt

    def solar(self, atm: Atmosphere) -> SpectralOptProps:
        tb = _load("sw", self.n_gpt, self.data_dir)
        tau_gas = self._gas_tau(tb, atm)
        # Rayleigh: molar scattering coefficient per gpt [m2/mol]
        moles = self._h(np.asarray(atm.plev[1:] - atm.plev[:-1], np.float64)
                        / (MOLMASS_AIR * GRAV))
        coeff = self._t(tb, "rayleigh_molar_scattering_coeff")
        tau_ray = coeff.reshape((tb.ngpt,) + (1,) * moles.dim()) * moles[None]
        tau = tau_gas + tau_ray
        w0 = tau_ray / torch.clamp(tau, min=1e-30)
        tau_t = tau.to(ireals)
        return SpectralOptProps(tau=tau_t, w0=w0.to(ireals), g=torch.zeros_like(tau_t),
                                weight=self._t(tb, "solar_irradiance").to(ireals))

    def thermal(self, atm: Atmosphere) -> SpectralOptProps:
        tb = _load("lw", self.n_gpt, self.data_dir)
        tau = self._gas_tau(tb, atm).to(ireals)
        planck = self._planck_table(tb, np.asarray(atm.tlev, np.float64))
        z = torch.zeros_like(tau)
        return SpectralOptProps(tau=tau, w0=z, g=z,
                                weight=torch.ones(tb.ngpt, dtype=ireals, device=self.device),
                                planck=planck.to(ireals))

    def _planck_table(self, tb: _CkdTables, T: np.ndarray) -> torch.Tensor:
        """(ngpt,) + T.shape Planck radiance [W/m2/sr], float64 on the
        backend's device."""
        tp = tb.z["temperature_planck"]  # (231,)
        pf = self._t(tb, "planck_function")  # (231, ngpt) [W/m2]
        itv, wtv = _frac_index(tp, np.clip(T.ravel(), tp[0], tp[-1]))
        B = torch.empty((itv.size, tb.ngpt), dtype=torch.float64, device=self.device)
        for lo in range(0, itv.size, _BLOCK):
            sl = slice(lo, min(lo + _BLOCK, itv.size))
            i, w = self._h(itv[sl]), self._h(wtv[sl])[:, None]
            B[sl] = ((1 - w) * pf[i] + w * pf[i + 1]) / PI
        return B.reshape(T.shape + (tb.ngpt,)).movedim(-1, 0)

    def planck_at(self, T) -> np.ndarray:
        """Per-g-point Planck emission [W/m2/sr] at temperature(s) `T`,
        shape (ngpt,) + shape(T), float32 (reference `ecckd_planck`)."""
        tb = _load("lw", self.n_gpt, self.data_dir)
        return self._planck_table(tb, np.asarray(T, np.float64)).to(torch.float32).cpu().numpy()

    # -- per-gpoint cloud optics ----------------------------------------
    def _particle_tables(self, kind: str, table: str):
        """(reff_grid [um], kext, w0, g) per gpt, spectral shape (ngpt,
        nreff): the particle table averaged over each g-point's
        wavenumber intervals with `gpoint_fraction`, extinction- and
        scattering-weighted (w0_g = <k w0>/<k>, g_g = <k w0 g>/<k w0>)."""
        key = (kind, table)
        if key not in self._tables:
            tb = _load(kind, self.n_gpt, self.data_dir)
            mie = np.load(os.path.join(self.data_dir, table))
            wvn_mid = 0.5 * (tb.z["wavenumber1"] + tb.z["wavenumber2"])  # (nint,)
            gfrac = tb.z["gpoint_fraction"]  # (ngpt, nint)
            wnorm = gfrac / np.maximum(gfrac.sum(1, keepdims=True), 1e-30)
            mw = mie["wavenumber"]
            order = np.argsort(mw)

            def onto(arr2):  # (nreff, n_mie_wvn) -> (nreff, nint)
                return np.stack([np.interp(wvn_mid, mw[order], row[order]) for row in arr2], 0)

            kext = onto(mie["mass_extinction_coefficient"])
            w0 = onto(mie["single_scattering_albedo"])
            g = onto(mie["asymmetry_factor"])
            kext_g = wnorm @ kext.T  # (ngpt, nreff)
            ksca_g = wnorm @ (kext * w0).T
            kscg_g = wnorm @ (kext * w0 * g).T
            w0_g = ksca_g / np.maximum(kext_g, 1e-30)
            g_g = kscg_g / np.maximum(ksca_g, 1e-30)
            self._tables[key] = (mie["effective_radius"] * 1e6, kext_g.astype(np.float32),
                                 w0_g.astype(np.float32), g_g.astype(np.float32))
        return self._tables[key]

    def _cloud_tables(self, kind: str):
        return self._particle_tables(kind, "mie_droplet_scattering.npz")

    def _ice_tables(self, kind: str):
        return self._particle_tables(kind, "fu-muskatel-rough_ice_scattering.npz")

    def cloud_optprops_gpt(self, kind: str, lwc_gm3: torch.Tensor, reff_um: torch.Tensor,
                           dz_m: torch.Tensor, gsel=slice(None)):
        """Per-gpoint water-cloud (tau, w0, g), shapes (ngpt_sel,) + grid."""
        return particle_optprops_gpt(self._cloud_tables(kind), lwc_gm3, reff_um, dz_m, gsel)

    def ice_optprops_gpt(self, kind: str, iwc_gm3: torch.Tensor, reice_um: torch.Tensor,
                         dz_m: torch.Tensor, gsel=slice(None)):
        """Per-gpoint ice-cloud (tau, w0, g), shapes (ngpt_sel,) + grid."""
        return particle_optprops_gpt(self._ice_tables(kind), iwc_gm3, reice_um, dz_m, gsel)
