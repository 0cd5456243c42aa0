"""Gas optics backends: per-g-point optical properties of the gas column
(port of `tenstream_tpu/spectral/gasoptics.py`).

A backend returns whole tensors over (ngpt, nlay[, nx, ny]) in one call;
the spectral driver solves them in batched chunks of g-points.  The
optical properties are float32 tensors on the CPU (the column work is
host-side numpy, as in the JAX package); the driver moves one chunk at a
time to the solver's device.

  * `GrayGasOptics`  -- one gray g-point per spectral region
  * `SyntheticCKD`   -- a structured correlated-k model with
    Malkmus-band-style k-distributions (the shape of a real CKD scheme,
    placeholder spectroscopy)

Backends return the GAS optical depths; clouds are merged by the driver.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.core.types import PI, SOLAR_CONSTANT, STEFAN_BOLTZMANN, ireals
from tenstream_tpu_torch.ops.interp import fractional_index
from tenstream_tpu_torch.ops.planck import planck_radiance_wavenumber


def _t(a) -> torch.Tensor:
    """float32 CPU tensor."""
    return torch.as_tensor(np.asarray(a), dtype=ireals)


class SpectralOptProps(NamedTuple):
    """Per-gpoint gas optical properties (float32 tensors, on the backend's
    device).

    tau:    (ngpt, nlay, ...) gas optical depth
    w0:     (ngpt, nlay, ...) single-scatter albedo (Rayleigh)
    g:      (ngpt, nlay, ...) asymmetry (0 for gas)
    weight: (ngpt,) TOA solar flux [W/m2] per gpt (solar) or quadrature
            weights (thermal)
    planck: optional (ngpt, nlev, ...) Planck radiance per gpt [W/m2/sr]
    planck_srfc: optional (ngpt, ...) surface Planck radiance per gpt
    """

    tau: torch.Tensor
    w0: torch.Tensor
    g: torch.Tensor
    weight: torch.Tensor
    planck: Optional[torch.Tensor] = None
    planck_srfc: Optional[torch.Tensor] = None


def rayleigh_optical_depth(plev_pa: np.ndarray, wavelength_um: float) -> np.ndarray:
    """Per-layer Rayleigh scattering optical depth (float64 host)."""
    lam = wavelength_um
    tau_total = 0.008569 * lam**-4 * (1.0 + 0.0113 * lam**-2 + 0.00013 * lam**-4)
    dp = (plev_pa[1:] - plev_pa[:-1]) / 101325.0
    return tau_total * dp


@dataclass
class GrayGasOptics:
    """Single gray g-point per spectral region."""

    tau_solar_column: float = 0.2
    tau_thermal_column: float = 4.0

    n_gpt_solar = 1
    n_gpt_thermal = 1

    def solar(self, atm: Atmosphere) -> SpectralOptProps:
        dp = (atm.plev[1:] - atm.plev[:-1]) / (atm.plev[-1] - atm.plev[0])
        tau = _t(self.tau_solar_column * dp)[None]
        ray = _t(rayleigh_optical_depth(atm.plev, 0.55))[None]
        tau_tot = tau + ray
        w0 = ray / torch.clamp(tau_tot, min=1e-30)
        return SpectralOptProps(tau=tau_tot, w0=w0, g=torch.zeros_like(tau_tot),
                                weight=_t([SOLAR_CONSTANT]))

    def thermal(self, atm: Atmosphere) -> SpectralOptProps:
        dp = (atm.plev[1:] - atm.plev[:-1]) / (atm.plev[-1] - atm.plev[0])
        tau = _t(self.tau_thermal_column * dp)[None]
        B = STEFAN_BOLTZMANN * _t(atm.tlev) ** 4 / PI
        return SpectralOptProps(tau=tau, w0=torch.zeros_like(tau), g=torch.zeros_like(tau),
                                weight=_t([1.0]), planck=B[None])


# (band lo, band hi [cm-1], active gas, band-mean mass absorption strength
#  [m2/kg] at reference conditions, k-distribution log-width)
_SW_BANDS = [
    (2600.0, 3250.0, "h2o", 2e-2, 2.5),
    (3250.0, 4000.0, "h2o", 5e-2, 2.5),
    (4000.0, 4650.0, "h2o", 3e-2, 2.5),
    (4650.0, 5150.0, "co2", 2e-2, 2.0),
    (5150.0, 6150.0, "h2o", 8e-2, 2.5),
    (6150.0, 7700.0, "h2o", 2e-2, 2.5),
    (7700.0, 8050.0, "h2o", 1e-2, 2.0),
    (8050.0, 12850.0, "h2o", 4e-3, 2.0),
    (12850.0, 16000.0, "h2o", 1e-3, 1.5),
    (16000.0, 22650.0, "o3", 1e-1, 1.0),
    (22650.0, 29000.0, "o3", 5e-1, 1.0),
    (29000.0, 38000.0, "o3", 5e1, 1.0),
    (38000.0, 50000.0, "o3", 5e2, 1.0),
    (820.0, 2600.0, "h2o", 2e-1, 2.5),
]

_LW_BANDS = [
    (10.0, 350.0, "h2o", 5e0, 2.5),
    (350.0, 500.0, "h2o", 2e0, 2.5),
    (500.0, 630.0, "h2o", 5e-1, 2.5),
    (630.0, 700.0, "co2", 3e1, 2.0),
    (700.0, 820.0, "co2", 8e0, 2.0),
    (820.0, 980.0, "h2o", 2e-2, 2.0),
    (980.0, 1080.0, "o3", 2e1, 1.5),
    (1080.0, 1180.0, "h2o", 3e-2, 2.0),
    (1180.0, 1390.0, "h2o", 3e-1, 2.5),
    (1390.0, 1480.0, "h2o", 3e0, 2.5),
    (1480.0, 1800.0, "h2o", 8e0, 2.5),
    (1800.0, 2080.0, "h2o", 1e0, 2.5),
    (2080.0, 2250.0, "h2o", 5e-1, 2.0),
    (2250.0, 2380.0, "co2", 1e1, 2.0),
    (2380.0, 2600.0, "h2o", 2e-1, 2.0),
    (2600.0, 3250.0, "h2o", 1e-1, 2.5),
]

_MOLMASS = {"h2o": 18.0153e-3, "co2": 44.01e-3, "o3": 47.998e-3, "o2": 32.0e-3,
            "ch4": 16.04e-3, "n2o": 44.013e-3}


@dataclass
class SyntheticCKD:
    """Correlated-k with Malkmus-style g-point distributions: each band
    gets `n_gpt_per_band` Gauss-Legendre g-points, k(g) = k_mean *
    exp(sigma * spread) with linear pressure and weak temperature
    scaling; the solar source per g-point is the band's 5777 K Planck
    fraction, thermal Planck radiances are band-integrated."""

    n_gpt_per_band: int = 8

    @property
    def n_gpt_solar(self) -> int:
        return len(_SW_BANDS) * self.n_gpt_per_band

    @property
    def n_gpt_thermal(self) -> int:
        return len(_LW_BANDS) * self.n_gpt_per_band

    def _gpt_nodes(self):
        x, w = np.polynomial.legendre.leggauss(self.n_gpt_per_band)
        return 0.5 * (x + 1.0), 0.5 * w

    def _band_tau(self, atm: Atmosphere, bands):
        """(ngpt, nlay, ...) tau and (ngpt,) quad weights + band ids."""
        gnodes, gweights = self._gpt_nodes()
        nmol = atm.air_molecules_per_m2()
        taus, weights, bidx = [], [], []
        p_scale = np.clip(atm.play / 5e4, 0.05, 2.0)
        t_scale = np.clip(atm.tlay / 250.0, 0.5, 2.0) ** 0.5
        for ib, (lo, hi, gas, kmean, sigma) in enumerate(bands):
            vmr = atm.gases.get(gas, np.zeros_like(atm.play))
            mpath = nmol * vmr * _MOLMASS[gas] / 6.02214076e23  # kg/m2
            for gn, gw in zip(gnodes, gweights):
                spread = np.exp(sigma * (2.0 * gn - 1.0) * 2.0)
                k = kmean * spread * p_scale * t_scale
                taus.append(k * mpath)
                weights.append(gw)
                bidx.append(ib)
        return (np.stack(taus, 0).astype(np.float32), np.asarray(weights, np.float32),
                np.asarray(bidx, np.int32))

    def solar(self, atm: Atmosphere) -> SpectralOptProps:
        tau, qw, bidx = self._band_tau(atm, _SW_BANDS)
        bb = np.array([float(planck_radiance_wavenumber(lo, hi, 5777.0))
                       for lo, hi, *_ in _SW_BANDS])
        frac = bb / bb.sum()
        w = (SOLAR_CONSTANT * frac[bidx] * qw).astype(np.float32)
        ray = np.stack([rayleigh_optical_depth(atm.plev, 1e4 / (0.5 * (lo + hi)))
                        for lo, hi, *_ in _SW_BANDS], 0)[bidx].astype(np.float32)
        tau_tot = tau + ray
        w0 = ray / np.maximum(tau_tot, 1e-30)
        return SpectralOptProps(tau=_t(tau_tot), w0=_t(w0), g=torch.zeros(tau_tot.shape),
                                weight=_t(w))

    def thermal(self, atm: Atmosphere) -> SpectralOptProps:
        tau, qw, bidx = self._band_tau(atm, _LW_BANDS)
        planck_bands = np.stack([planck_radiance_wavenumber(lo, hi, _t(atm.tlev)).numpy()
                                 for lo, hi, *_ in _LW_BANDS], 0)  # (nband, nlev, ...)
        planck = (planck_bands[bidx].T * qw).T.astype(np.float32)
        z = torch.zeros(tau.shape)
        return SpectralOptProps(tau=_t(tau), w0=z, g=z, weight=_t(qw), planck=_t(planck))


def cloud_optprops(lwc_gm3: torch.Tensor, reff_um: torch.Tensor,
                   dz_m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Band-independent water-cloud optics in the geometric-optics limit:
    tau = 3 LWP / (2 rho_w reff), w0 = 0.9985, g = 0.86."""
    lwp = lwc_gm3 * 1e-3 * dz_m  # kg/m2
    reff = torch.clamp(reff_um, min=2.0) * 1e-6
    tau = 1.5 * lwp / (1000.0 * reff)
    return tau, torch.full_like(tau, 0.9985), torch.full_like(tau, 0.86)


def particle_optprops_gpt(tables, water: torch.Tensor, reff_um: torch.Tensor,
                          dz_m: torch.Tensor, gsel=slice(None)):
    """Per-g-point particle (tau, w0, g), shapes (ngpt_sel,) + grid, from
    `tables` = (reff grid [um], kext, w0, g), each table (ngpt, nreff), a
    condensate content [g/m3] and an effective radius [um], on the
    caller's device: float32, linear in the radius (the ecCKD and RRTMG_SW
    backends' droplet and ice optics)."""
    reff_grid, kext_g, w0_g, g_g = tables
    dev = water.device
    path = water * 1e-3 * dz_m  # kg/m2
    fr = fractional_index(torch.as_tensor(np.asarray(reff_grid, np.float32), device=dev),
                          reff_um.to(ireals))
    i0 = torch.clamp(torch.floor(fr), 0, len(reff_grid) - 2).to(torch.int64)
    w = (fr - i0.to(ireals))[None]
    if not isinstance(gsel, slice):
        gsel = torch.as_tensor(np.asarray(gsel), device=dev)

    def gi(tbl):
        t = torch.as_tensor(tbl, dtype=ireals, device=dev)[gsel]
        return t[:, i0] * (1 - w) + t[:, i0 + 1] * w

    return gi(kext_g) * path[None], gi(w0_g), gi(g_g)
