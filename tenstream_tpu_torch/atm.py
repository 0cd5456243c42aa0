"""Atmosphere input layer: background profiles, grid merging, heating
rates (port of `tenstream_tpu/atm.py`).

Host-side column work stays float64 numpy, as in the JAX package; only
`abso2hr` works on tensors.  Arrays are ordered TOA -> surface along axis
0 (the solver's z convention), pressures are Pa, and every dynamics
field may be (nlev,) or (nlev, nx, ny).

The background profile `data/atm/afglus_100m.dat` is read from the
repository's `data/` directory next to this package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.types import CP_DRY_AIR, GRAV, K_BOLTZMANN, R_DRY_AIR, ireals

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

# U.S. Standard Atmosphere 1976 layer structure (geopotential km, lapse K/km)
_USSA_H = np.array([0.0, 11.0, 20.0, 32.0, 47.0, 51.0, 71.0, 84.852])
_USSA_LAPSE = np.array([-6.5, 0.0, 1.0, 2.8, 0.0, -2.8, -2.0])
_T0 = 288.15
_P0 = 101325.0


def us_standard_atmosphere(z_m: np.ndarray) -> Dict[str, np.ndarray]:
    """Analytic USSA76 p [Pa], T [K], air number density [1/m3] at z [m]."""
    z = np.asarray(z_m, np.float64) / 1000.0
    T = np.empty_like(z)
    p = np.empty_like(z)
    Tb, pb = _T0, _P0
    bounds = _USSA_H
    for i, zi in enumerate(z):
        Tb, pb = _T0, _P0
        for b in range(len(_USSA_LAPSE)):
            h0, h1, L = bounds[b], bounds[b + 1], _USSA_LAPSE[b]
            htop = min(zi, h1)
            dh = max(htop - h0, 0.0)
            if dh > 0:
                Tn = Tb + L * dh
                if abs(L) > 1e-12:
                    pn = pb * (Tn / Tb) ** (-GRAV / (R_DRY_AIR * L * 1e-3))
                else:
                    pn = pb * np.exp(-GRAV * dh * 1000.0 / (R_DRY_AIR * Tb))
                Tb, pb = Tn, pn
            if zi <= h1:
                break
        T[i] = Tb
        p[i] = pb
    air = p / (K_BOLTZMANN * T)
    return {"z": np.asarray(z_m, np.float64), "p": p, "T": T, "air": air}


def standard_trace_gases(z_m: np.ndarray, p: np.ndarray) -> Dict[str, np.ndarray]:
    """Volume mixing ratios of the standard gases (approximate standard
    mid-latitude shapes; parity with the afglus column set)."""
    z = np.asarray(z_m, np.float64) / 1000.0
    co2 = np.full_like(z, 415e-6)
    o2 = np.full_like(z, 0.2095)
    ch4 = 1.8e-6 * np.exp(-np.maximum(z - 15.0, 0.0) / 30.0)
    n2o = 0.33e-6 * np.exp(-np.maximum(z - 12.0, 0.0) / 20.0)
    # water vapour: ~78% RH-ish exponential decay in the troposphere
    h2o = 7.8e-3 * np.exp(-z / 2.1)
    h2o = np.maximum(h2o, 3e-6)
    # ozone: Chapman-like layer peaked near 23 km
    o3 = 7.0e-6 * np.exp(-0.5 * ((z - 23.0) / 6.0) ** 2) + 3e-8
    return {"h2o": h2o, "co2": co2, "o3": o3, "o2": o2, "ch4": ch4, "n2o": n2o}


def load_atmfile(path: str) -> Dict[str, np.ndarray]:
    """Read a libRadtran background profile ASCII file
    (reference `load_atmfile`, `src/tenstr_atm.F90:776`:
    columns z[km] p[hPa] T[K] air[1/cm3] o3 o2 h2o co2 no2 [1/cm3])."""
    raw = np.loadtxt(path, comments="#")
    cols = ["z", "p", "T", "air", "o3", "o2", "h2o", "co2", "no2", "n2o", "ch4"]
    out = {}
    for i, c in enumerate(cols[: raw.shape[1]]):
        out[c] = raw[:, i]
    out["z"] = out["z"] * 1e3  # km -> m
    out["p"] = out["p"] * 1e2  # hPa -> Pa
    for gas in ("o3", "o2", "h2o", "co2", "no2", "n2o", "ch4"):
        if gas in out:
            out[gas] = out[gas] / out["air"]  # number density -> vmr
    out["air"] = out["air"] * 1e6  # 1/cm3 -> 1/m3
    return out


def hydrostat_lev(plev: np.ndarray, tlay: np.ndarray, z_srfc: float = 0.0) -> np.ndarray:
    """Hydrostatic level heights from pressure levels and layer temps
    (reference `hydrostat_lev`, `src/tenstr_atm.F90:875`).  plev/tlay
    ordered TOA..surface like the solver's z axis? No — input ordered
    surface..TOA ascending height; plev (N+1,), tlay (N,)."""
    z = np.empty(plev.shape[0])
    z[0] = z_srfc
    for k in range(tlay.shape[0]):
        rho = 0.5 * (plev[k] + plev[k + 1]) / (R_DRY_AIR * tlay[k])
        dz = (plev[k] - plev[k + 1]) / (rho * GRAV)
        z[k + 1] = z[k] + dz
    return z


@dataclass
class Atmosphere:
    """Merged dynamics+background column set for the spectral drivers.

    All arrays ordered TOA -> surface along axis 0 (solver z convention):
      plev, tlev, zlev: (Nz+1, ...) ; play, tlay, dz: (Nz, ...)
      gas vmr dicts: (Nz, ...)
    """

    plev: np.ndarray
    tlev: np.ndarray
    zlev: np.ndarray
    gases: Dict[str, np.ndarray]
    lwc: Optional[np.ndarray] = None  # cloud liquid water content [g/m3]
    reliq: Optional[np.ndarray] = None  # effective radius [um]
    iwc: Optional[np.ndarray] = None
    reice: Optional[np.ndarray] = None
    cfrac: Optional[np.ndarray] = None  # cloud fraction [0..1] (McICA)
    skin_temperature: Optional[np.ndarray] = None  # (nx, ny) [K]

    @property
    def play(self) -> np.ndarray:
        return 0.5 * (self.plev[:-1] + self.plev[1:])

    @property
    def tlay(self) -> np.ndarray:
        return 0.5 * (self.tlev[:-1] + self.tlev[1:])

    @property
    def dz(self) -> np.ndarray:
        return self.zlev[:-1] - self.zlev[1:]

    @property
    def nlay(self) -> int:
        return self.plev.shape[0] - 1

    def air_molecules_per_m2(self) -> np.ndarray:
        """Column air molecules per layer [1/m2] from hydrostatics
        (plev is ordered TOA -> surface, so plev[1:] > plev[:-1])."""
        AVOG = 6.02214076e23
        M_AIR = 28.9644e-3
        return (self.plev[1:] - self.plev[:-1]) / (GRAV * M_AIR) * AVOG

    def layer_air_density(self) -> np.ndarray:
        return self.play / (R_DRY_AIR * self.tlay)


def setup_standard_atmosphere(
    nlay: int = 40,
    ztop: float = 40e3,
    z_grid: Optional[np.ndarray] = None,
) -> Atmosphere:
    """Background atmosphere on a height grid, TOA->surface ordering."""
    if z_grid is None:
        # layer thicknesses in geometric progression, finest (~x20) near
        # the ground (LES-like), ordered TOA -> surface
        raw = np.geomspace(20.0, 1.0, nlay)
        dz = raw / raw.sum() * ztop
        zlev = ztop - np.concatenate([[0.0], np.cumsum(dz)])
        zlev[-1] = 0.0
    else:
        zlev = np.asarray(z_grid, np.float64)
    bg = us_standard_atmosphere(zlev)
    gases_lev = standard_trace_gases(zlev, bg["p"])
    gases = {k: 0.5 * (v[:-1] + v[1:]) for k, v in gases_lev.items()}
    return Atmosphere(plev=bg["p"], tlev=bg["T"], zlev=zlev, gases=gases)


def merge_dyn_rad_grid(
    atm_bg: Atmosphere,
    zlev_dyn: np.ndarray,
    tlev_dyn: np.ndarray,
) -> Tuple[Atmosphere, int]:
    """Stack the background atmosphere above a height-grid dynamics
    column (legacy synthetic-scene helper; `setup_tenstr_atm` is the
    reference-parity pressure-honoring entry point)."""
    z_top_dyn = float(np.max(zlev_dyn))
    keep = atm_bg.zlev > z_top_dyn + 1.0
    zlev = np.concatenate([atm_bg.zlev[keep], zlev_dyn])
    bg = us_standard_atmosphere(zlev)
    tlev = np.concatenate([atm_bg.tlev[keep], np.asarray(tlev_dyn)])
    gases_lev = standard_trace_gases(zlev, bg["p"])
    gases = {k: 0.5 * (v[:-1] + v[1:]) for k, v in gases_lev.items()}
    return (
        Atmosphere(plev=bg["p"], tlev=tlev, zlev=zlev, gases=gases),
        int(keep.sum()),
    )


# ---------------------------------------------------------------------------
# Reference-parity host-model input: per-column dynamics grids merged with
# the background profile, honoring the dynamics pressure
# ---------------------------------------------------------------------------

_GAS_NAMES = ("h2o", "o3", "co2", "ch4", "n2o", "o2")


def default_atm_filename() -> str:
    """The repository's AFGL US-standard background profile
    (`data/atm/afglus_100m.dat`)."""
    return os.path.join(DATA_DIR, "atm", "afglus_100m.dat")


def load_background(atm_filename: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Background profile levels ordered TOA -> surface: z [m], p [Pa],
    T [K] plus gas vmrs (reference `load_atmfile` + `t_bg_atm`,
    `src/tenstr_atm.F90:776,82-96`)."""
    path = atm_filename or default_atm_filename()
    if os.path.exists(path):
        prof = load_atmfile(path)
    else:  # analytic fallback when the data file is absent
        z = np.linspace(80e3, 0.0, 81)
        bg = us_standard_atmosphere(z)
        prof = {"z": z, "p": bg["p"], "T": bg["T"], "air": bg["air"]}
        prof.update(standard_trace_gases(z, bg["p"]))
    order = np.argsort(-prof["z"])  # TOA first
    return {k: np.asarray(v, np.float64)[order] for k, v in prof.items()}


def _col3(a, shape2) -> np.ndarray:
    """Broadcast (n,) or (n, nx, ny) input to (n,) + shape2."""
    a = np.asarray(a, np.float64)
    if a.ndim == 1 and shape2:
        return np.broadcast_to(a[:, None, None], a.shape + shape2).copy()
    return a


def setup_tenstr_atm(
    plev,
    tlev,
    *,
    tlay=None,
    h2ovmr=None,
    o3vmr=None,
    co2vmr=None,
    ch4vmr=None,
    n2ovmr=None,
    o2vmr=None,
    lwc=None,
    reliq=None,
    iwc=None,
    reice=None,
    cfrac=None,
    surface_height=None,
    skin_temperature=None,
    atm_filename: Optional[str] = None,
) -> Atmosphere:
    """Build the merged dynamics+background atmosphere.

    Parity: `setup_tenstr_atm` + `merge_dyn_rad_grid`
    (`src/tenstr_atm.F90:136,403`): per-column hydrostatic level heights
    are computed from the DYNAMICS pressure and temperature (surface
    height optional), the number of background levels stacked on top is
    chosen so the background starts above every column's top (both in
    height and pressure, :498-513), and gas/cloud fields inside the
    dynamics grid come from the host model where provided, else from the
    background profile interpolated at the column heights
    (`merge_grid_var`:371-400).

    All dynamics inputs ordered TOA -> surface, (nlev[, nx, ny]);
    pressures in Pa.  Returns an `Atmosphere` whose fields are
    (nlay[+1], nx, ny) when any input is per-column, else 1-D.
    """
    plev = np.asarray(plev, np.float64)
    tlev = np.asarray(tlev, np.float64)
    # horizontal shape from ANY per-column input (a 1-D pressure grid
    # with 3-D cloud fields is a common host-model pattern)
    shape2 = ()
    for a in (plev, tlev, tlay, h2ovmr, o3vmr, lwc, reliq, iwc, reice, cfrac):
        if a is not None and np.ndim(a) > 1:
            shape2 = np.shape(a)[1:]
            break
    plev = _col3(plev, shape2)
    tlev = _col3(tlev, shape2)
    nlev_d = plev.shape[0]
    nlay_d = nlev_d - 1

    if tlay is None:
        tlay_d = 0.5 * (tlev[:-1] + tlev[1:])
    else:
        tlay_d = _col3(tlay, shape2)

    bg = load_background(atm_filename)
    h_srfc = np.zeros(shape2) if surface_height is None else np.asarray(surface_height, np.float64)

    # per-column hydrostatic heights of the dynamics levels (TOA->sfc):
    # integrate upward from the surface (reference `hydrostat_lev`:875)
    rho = 0.5 * (plev[:-1] + plev[1:]) / (R_DRY_AIR * tlay_d)
    dz_d = (plev[1:] - plev[:-1]) / (rho * GRAV)  # >0, TOA->sfc ordering
    zlev_d = np.empty_like(plev)
    zlev_d[-1] = h_srfc
    zlev_d[:-1] = h_srfc + np.cumsum(dz_d[::-1], axis=0)[::-1]

    # how many background levels go on top: both the height and the
    # pressure of the lowest used background level must clear every
    # column's top (reference :498-513)
    global_maxheight = float(np.max(zlev_d[0]))
    global_minplev = float(np.min(plev[0]))
    if global_maxheight >= bg["z"][0] or global_minplev <= bg["p"][0]:
        raise ValueError("background profile does not reach above the dynamics grid")
    atm_ke = int(min(np.sum(bg["z"] > global_maxheight + 1.0),
                     np.sum(bg["p"] < global_minplev * (1.0 - 1e-6))))

    nlev = atm_ke + nlev_d
    full = lambda a_bg, a_d: np.concatenate(
        [_col3(a_bg[:atm_ke], shape2), a_d], axis=0)

    plev_m = full(bg["p"], plev)
    tlev_m = full(bg["T"], tlev)
    tlay_m = np.concatenate(
        [_col3(0.5 * (bg["T"][:atm_ke] + bg["T"][1:atm_ke + 1]), shape2), tlay_d], 0)

    # merged hydrostatic heights over the FULL column (reference :566-568
    # recomputes zt from the merged plev/tlay per column)
    rho_m = 0.5 * (plev_m[:-1] + plev_m[1:]) / (R_DRY_AIR * tlay_m)
    dz_m = (plev_m[1:] - plev_m[:-1]) / (rho_m * GRAV)
    zlev_m = np.empty_like(plev_m)
    zlev_m[-1] = h_srfc
    zlev_m[:-1] = h_srfc + np.cumsum(dz_m[::-1], axis=0)[::-1]

    # gases: host-model values inside the dynamics grid where given,
    # else background interpolated at the merged layer pressures
    zlay_m = 0.5 * (zlev_m[:-1] + zlev_m[1:])
    provided = dict(h2o=h2ovmr, o3=o3vmr, co2=co2vmr, ch4=ch4vmr, n2o=n2ovmr, o2=o2vmr)
    gases = {}
    for gas in _GAS_NAMES:
        if gas not in bg:
            continue
        # background value by height (bg z is TOA-first descending)
        zq = np.clip(zlay_m, bg["z"][-1], bg["z"][0])
        vbg = np.interp(-zq.ravel(), -bg["z"], bg[gas]).reshape(zlay_m.shape)
        if provided[gas] is not None:
            vbg[atm_ke:] = _col3(provided[gas], shape2)
        gases[gas] = vbg

    def cloud(a):
        if a is None:
            return None
        out = np.zeros((nlev - 1,) + shape2, np.float32)
        out[atm_ke:] = _col3(a, shape2)
        return out

    return Atmosphere(
        plev=plev_m, tlev=tlev_m, zlev=zlev_m, gases=gases,
        lwc=cloud(lwc), reliq=cloud(reliq), iwc=cloud(iwc),
        reice=cloud(reice), cfrac=cloud(cfrac),
        skin_temperature=None if skin_temperature is None else np.asarray(skin_temperature, np.float64),
    )


def abso2hr(abso_w_m3: torch.Tensor, play, tlay) -> torch.Tensor:
    """Absorbed power density [W/m3] -> heating rate [K/day]."""
    dev = abso_w_m3.device
    rho = (torch.as_tensor(np.asarray(play), dtype=ireals, device=dev)
           / (R_DRY_AIR * torch.as_tensor(np.asarray(tlay), dtype=ireals, device=dev)))
    return abso_w_m3 / (rho * CP_DRY_AIR) * 86400.0
