"""RRTMG_SW gas optics: the 112-g-point shortwave k-distribution (port of
`tenstream_tpu/spectral/rrtmg_sw.py`; reference
`rrtmg/rrtmg/optprop_rrtmg.F90:optprop_rrtm_sw`, driving AER's RRTMG_SW).

The per-layer coefficients follow `rrtmg/rrtm_sw/rrtmg_sw_setcoef.f90`
(reference pressure and temperature indices, water-vapour self and
foreign continuum factors, column amounts) and the per-band optical depths
`rrtmg/rrtm_sw/rrtmg_sw_taumol.f90` (key-species eta interpolation, minor
absorbers, Rayleigh, the Kurucz source at the band's reference layer).
Both the lower- and the upper-atmosphere branch are evaluated for every
layer and a troposphere mask selects; the 14 per-band routines are one
evaluator driven by a table of band configurations.

The gas optics are float64 numpy on the background column, as in the JAX
package, and come back as float32 CPU tensors; the per-g-point droplet
optics work on tensors on the caller's device.  The tables are the
repository's `data/rrtmg/rrtmg_sw_112.npz`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from tenstream_tpu_torch.atm import DATA_DIR, Atmosphere
from tenstream_tpu_torch.core.types import AVOGADRO, GRAV, ireals
from tenstream_tpu_torch.spectral.gasoptics import SpectralOptProps, particle_optprops_gpt

MOLMASS_AIR = 28.9644e-3  # [kg/mol]
_DEFAULT = os.path.join(DATA_DIR, "rrtmg", "rrtmg_sw_112.npz")
_MIE = os.path.join(DATA_DIR, "ecckd", "mie_droplet_scattering.npz")

# Per-band configuration (rrtmg_sw_taumol.f90, taumol16..29).
# lo/up: ('pair', sp1, sp2, strrat) 9-point (lower) / 5-point (upper)
#        eta interpolation; ('single', sp); ('none',).
# extra: [(array, species)] cross-section additions.
# cont:  water continuum (self+foreign lower, foreign upper).
# rayl:  'scalar' | 'perg' | 'eta' (band 24: eta-dependent below).
# sflux: ('lo'|'up'|'fixed', layreffr) + eta-resolved if the stored
#        sfluxref is 2-D; 'scale' multiplies (band 27 scalekur).
_B = lambda **kw: kw
_BANDS = [
    _B(n=16, lo=("pair", "h2o", "ch4", 252.131), up=("single", "ch4"),
       cont=True, rayl="scalar", sflux=("up", 18)),
    _B(n=17, lo=("pair", "h2o", "co2", 0.364641), up=("pair", "h2o", "co2", 0.364641),
       cont=True, cont_up=True, rayl="scalar", sflux=("up", 30)),
    _B(n=18, lo=("pair", "h2o", "ch4", 38.9589), up=("single", "ch4"),
       cont=True, rayl="scalar", sflux=("lo", 6)),
    _B(n=19, lo=("pair", "h2o", "co2", 5.49281), up=("single", "co2"),
       cont=True, rayl="scalar", sflux=("lo", 3)),
    _B(n=20, lo=("single", "h2o"), up=("single", "h2o"),
       cont=True, cont_up=True, extra=[("absch4", "ch4")],
       extra_up=[("absch4", "ch4")], rayl="scalar", sflux=("lo", 3)),
    _B(n=21, lo=("pair", "h2o", "co2", 0.0045321), up=("pair", "h2o", "co2", 0.0045321),
       cont=True, cont_up=True, rayl="scalar", sflux=("lo", 8)),
    _B(n=22, lo=("pair", "h2o", "o2", 0.022708 * 1.6), up=("single", "o2"),
       up_colscale=1.6, cont=True, o2cont=True, rayl="scalar", sflux=("lo", 2)),
    _B(n=23, lo=("single", "h2o"), up=("none",),
       cont=True, lo_kscale=1.029, rayl="perg", sflux=("lo", 6)),
    _B(n=24, lo=("pair", "h2o", "o2", 0.124692), up=("single", "o2"),
       cont=True, extra=[("abso3a", "o3")], extra_up=[("abso3b", "o3")],
       rayl="eta", sflux=("lo", 1)),
    _B(n=25, lo=("single", "h2o"), up=("none",),
       extra=[("abso3a", "o3")], extra_up=[("abso3b", "o3")],
       rayl="perg", sflux=("lo", 2)),
    _B(n=26, lo=("none",), up=("none",), rayl="perg", sflux=("fixed", 0)),
    _B(n=27, lo=("single", "o3"), up=("single", "o3"),
       rayl="perg", sflux=("up", 32), sflux_scale=50.15 / 48.37),
    _B(n=28, lo=("pair", "o3", "o2", 6.67029e-7), up=("pair", "o3", "o2", 6.67029e-7),
       rayl="scalar", sflux=("up", 58)),
    _B(n=29, lo=("single", "h2o"), up=("single", "co2"),
       cont=True, extra=[("absco2", "co2")], extra_up=[("absh2o", "h2o")],
       rayl="scalar", sflux=("up", 49)),
]


def _setcoef(pavel_hpa, tavel, coldry, vmr: Dict[str, np.ndarray], preflog, tref):
    """Layer interpolation coefficients (`rrtmg_sw_setcoef.f90:143-283`).

    All arrays (nlay,), TOA->surface; indices 0-based."""
    plog = np.log(pavel_hpa)
    jp = np.clip((36.0 - 5.0 * (plog + 0.04)).astype(int), 1, 58) - 1  # 0..57
    fp = 5.0 * (preflog[jp] - plog)

    def t_index(jpx):
        jt = np.clip((3.0 + (tavel - tref[jpx]) / 15.0).astype(int), 1, 4) - 1
        ft = (tavel - tref[jpx]) / 15.0 - (jt + 1 - 3)
        return jt, ft

    jt, ft = t_index(jp)
    jt1, ft1 = t_index(jp + 1)

    compfp = 1.0 - fp
    fac = dict(
        f00=compfp * (1.0 - ft), f10=compfp * ft,
        f01=fp * (1.0 - ft1), f11=fp * ft1,
    )

    tropo = plog > 4.56

    water = vmr["h2o"]
    scalefac = pavel_hpa * (296.0 / 1013.0) / tavel
    forfac = scalefac / (1.0 + water)
    # lower: index from temperature; upper: fixed slot 3 (0-based 2)
    factor_lo = (332.0 - tavel) / 36.0
    indfor = np.where(tropo, np.clip(factor_lo.astype(int), 1, 2),
                      3).astype(int) - 1
    forfrac = np.where(tropo, factor_lo - (indfor + 1),
                       (tavel - 188.0) / 36.0 - 1.0)

    factor_s = (tavel - 188.0) / 7.2
    indself = np.clip(factor_s.astype(int) - 7, 1, 9) - 1
    selffac = np.where(tropo, water * forfac, 0.0)
    selffrac = np.where(tropo, factor_s - (indself + 1 + 7), 0.0)

    col = {k: 1e-20 * v * coldry for k, v in vmr.items()}
    for k in ("co2", "ch4", "o2", "n2o"):
        if k in col:
            col[k] = np.where(col[k] <= 0.0, 1e-32 * coldry, col[k])
    col["mol"] = 1e-20 * coldry + col["h2o"]

    return dict(jp=jp, jt=jt, jt1=jt1, fac=fac, tropo=tropo,
                forfac=forfac, forfrac=forfrac, indfor=indfor,
                selffac=selffac, selffrac=selffrac, indself=indself,
                col=col)


def _interp_single(k, sc, lower):
    """k (5, NP, ng): T/p interpolation without eta (taumol20 pattern)."""
    jp0 = np.clip(sc["jp"], 0, 11) if lower else np.clip(sc["jp"] - 12, 0, 45)
    f = sc["fac"]
    return (f["f00"][:, None] * k[sc["jt"], jp0]
            + f["f10"][:, None] * k[sc["jt"] + 1, jp0]
            + f["f01"][:, None] * k[sc["jt1"], jp0 + 1]
            + f["f11"][:, None] * k[sc["jt1"] + 1, jp0 + 1])


def _eta(colA, colB, strrat, npts):
    speccomb = colA + strrat * colB
    specparm = np.minimum(colA / np.maximum(speccomb, 1e-300), 0.999999)
    specmult = npts * specparm
    js = specmult.astype(int)  # 0-based, 0..npts-1
    fs = specmult - js
    return speccomb, js, fs


def _interp_pair(k, sc, js, fs, lower):
    """k (neta, 5, NP, ng): eta + T/p interpolation (taumol16 pattern)."""
    jp0 = np.clip(sc["jp"], 0, 11) if lower else np.clip(sc["jp"] - 12, 0, 45)
    f = sc["fac"]
    jt, jt1 = sc["jt"], sc["jt1"]
    w1 = (1.0 - fs)[:, None]
    w2 = fs[:, None]
    out = (
        f["f00"][:, None] * (w1 * k[js, jt, jp0] + w2 * k[js + 1, jt, jp0])
        + f["f10"][:, None] * (w1 * k[js, jt + 1, jp0] + w2 * k[js + 1, jt + 1, jp0])
        + f["f01"][:, None] * (w1 * k[js, jt1, jp0 + 1] + w2 * k[js + 1, jt1, jp0 + 1])
        + f["f11"][:, None] * (w1 * k[js, jt1 + 1, jp0 + 1] + w2 * k[js + 1, jt1 + 1, jp0 + 1])
    )
    return out


def _continuum(bd, sc):
    """colh2o * (self + foreign continuum) (`taumol16:305-310`)."""
    sref, fref = bd["selfref"], bd["forref"]
    inds, indf = sc["indself"], sc["indfor"]
    indf = np.minimum(indf, fref.shape[0] - 2)
    self_t = sref[inds] + sc["selffrac"][:, None] * (sref[inds + 1] - sref[inds])
    for_t = fref[indf] + sc["forfrac"][:, None] * (fref[indf + 1] - fref[indf])
    return (sc["selffac"][:, None] * self_t, sc["forfac"][:, None] * for_t)


def _laysolfr(kind, layreffr, sc):
    """Solar-source reference layer (top-down index).

    Mirrors the Fortran bottom-up scans (`taumol18:494-499` lower,
    `taumol16:317-322` upper): the lowest layer of the region whose
    reference-pressure index reached layreffr; region top if none."""
    jp1 = sc["jp"] + 1  # 1-based like the reference
    region = sc["tropo"] if kind == "lo" else ~sc["tropo"]
    k_idx = np.arange(jp1.size)
    region_top = k_idx[region].min() if region.any() else 0
    cand = region & (jp1 >= layreffr)
    if kind == "lo" and not (region & (jp1 < layreffr)).any():
        return region_top  # no crossing below -> default stays at top
    if not cand.any():
        return region_top if kind == "lo" else 0
    return k_idx[cand].max()


def _band_optics(cfg, bd, sc, nlay):
    """One band's (gas tau, Rayleigh tau), each (nlay, ng), and its solar
    source (ng,)."""
    col = sc["col"]
    ng = bd["sfluxref"].shape[0]
    js_lo = fs_lo = js_up = fs_up = None
    # ---- lower-atmosphere gas tau ---------------------------------------
    lo = cfg["lo"]
    if lo[0] == "pair":
        speccomb, js_lo, fs_lo = _eta(col[lo[1]], col[lo[2]], lo[3], 8)
        tau_lo = speccomb[:, None] * _interp_pair(bd["ka"], sc, js_lo, fs_lo, True)
    elif lo[0] == "single":
        tau_lo = cfg.get("lo_kscale", 1.0) * col[lo[1]][:, None] * _interp_single(bd["ka"], sc,
                                                                                  True)
    else:
        tau_lo = np.zeros((nlay, ng))
    if cfg.get("cont", False):
        # band 23's givfac (lo_kscale) scales the line part only
        s_t, f_t = _continuum(bd, sc)
        tau_lo = tau_lo + col["h2o"][:, None] * (s_t + f_t)
    for arr, gas in cfg.get("extra", []):
        tau_lo = tau_lo + col[gas][:, None] * bd[arr][None, :]
    if cfg.get("o2cont", False):
        tau_lo = tau_lo + (4.35e-4 * col["o2"] / 700.0)[:, None]

    # ---- upper-atmosphere gas tau ---------------------------------------
    up = cfg["up"]
    if up[0] == "pair":
        # kb of the two-key upper bands is (5 eta, 5 T, 47 p, ng)
        speccomb_u, js_up, fs_up = _eta(col[up[1]], col[up[2]], up[3], 4)
        tau_up = speccomb_u[:, None] * _interp_pair(bd["kb"], sc, js_up, fs_up, False)
    elif up[0] == "single":
        tau_up = cfg.get("up_colscale", 1.0) * col[up[1]][:, None] * _interp_single(bd["kb"], sc,
                                                                                   False)
    else:
        tau_up = np.zeros((nlay, ng))
    if cfg.get("cont_up", False):
        _, f_t = _continuum(bd, sc)
        tau_up = tau_up + col["h2o"][:, None] * f_t
    for arr, gas in cfg.get("extra_up", []):
        tau_up = tau_up + col[gas][:, None] * bd[arr][None, :]
    if cfg.get("o2cont", False):
        tau_up = tau_up + (4.35e-4 * col["o2"] / 700.0)[:, None]
    tau_g = np.where(sc["tropo"][:, None], tau_lo, tau_up)

    # ---- Rayleigh ---------------------------------------------------------
    if cfg["rayl"] == "scalar":
        tau_r = col["mol"][:, None] * bd["rayl"] * np.ones((1, ng))
    elif cfg["rayl"] == "perg":
        tau_r = col["mol"][:, None] * bd["rayl"][None, :]
    else:  # band 24: eta-dependent below, raylb above
        ra = bd["rayla"]  # (ng, 9)
        r_lo = ra[:, js_lo].T + fs_lo[:, None] * (ra[:, js_lo + 1].T - ra[:, js_lo].T)
        tau_r = col["mol"][:, None] * np.where(sc["tropo"][:, None], r_lo, bd["raylb"][None, :])

    # ---- solar source -----------------------------------------------------
    sf = bd["sfluxref"]
    scale = cfg.get("sflux_scale", 1.0)
    kind, layreffr = cfg["sflux"]
    if sf.ndim == 1:
        sfz = sf * scale
    else:
        k_sol = _laysolfr(kind if kind != "fixed" else "lo", layreffr, sc)
        js, fs = (js_lo, fs_lo) if kind == "lo" else (js_up, fs_up)
        j = min(int(js[k_sol]), sf.shape[1] - 2)
        sfz = (sf[:, j] + fs[k_sol] * (sf[:, j + 1] - sf[:, j])) * scale
    return tau_g, tau_r, sfz


class RrtmgSwOptics:
    """Solar backend for `specint_pprts(specint="rrtmg_sw")`; `thermal`
    raises (the reference tree has no RRTMG_LW k-tables)."""

    n_gpt = 112

    def __init__(self, data_path: Optional[str] = None, tsi: Optional[float] = None):
        z = np.load(data_path or _DEFAULT)
        self._d = {k: np.asarray(z[k], np.float64) for k in z.files}
        self.tsi = tsi  # optional rescale of the Kurucz total
        self._cloud_cache = None

    def _column(self, atm: Atmosphere):
        plev = np.asarray(atm.plev, np.float64)
        play = np.asarray(atm.play, np.float64)
        tlay = np.asarray(atm.tlay, np.float64)
        dP = plev[1:] - plev[:-1]
        coldry = dP / (GRAV * MOLMASS_AIR) * AVOGADRO * 1e-4  # molec/cm2
        vmr = {k: np.broadcast_to(np.asarray(v, np.float64), play.shape).copy()
               for k, v in atm.gases.items()}
        for k in ("h2o", "co2", "o3", "ch4", "o2", "n2o"):
            vmr.setdefault(k, np.zeros_like(play))
        return play / 100.0, tlay, coldry, vmr

    def solar(self, atm: Atmosphere) -> SpectralOptProps:
        pavel, tavel, coldry, vmr = self._column(atm)
        d = self._d
        sc = _setcoef(pavel, tavel, coldry, vmr, d["preflog"], d["tref"])
        taus, rays, sflux = [], [], []
        for cfg in _BANDS:
            b = cfg["n"]
            bd = {k.split("/", 1)[1]: v for k, v in d.items() if k.startswith(f"b{b}/")}
            tau_g, tau_r, sfz = _band_optics(cfg, bd, sc, pavel.size)
            taus.append(tau_g)
            rays.append(tau_r)
            sflux.append(sfz)
        tau_g = np.concatenate(taus, axis=1).T  # (ngpt, nlay)
        tau_r = np.concatenate(rays, axis=1).T
        w = np.concatenate(sflux)
        if self.tsi is not None:
            w = w * (self.tsi / w.sum())
        # the interpolation can give tiny negative taus at mesospheric
        # (p, T) outside the tables' envelope: clamp like the reference
        tau_g = np.maximum(tau_g, 0.0)
        tau_r = np.maximum(tau_r, 0.0)
        tau = tau_g + tau_r
        w0 = np.clip(tau_r / np.maximum(tau, 1e-30), 0.0, 1.0)
        tau_t = torch.as_tensor(tau, dtype=ireals)
        return SpectralOptProps(tau=tau_t, w0=torch.as_tensor(w0, dtype=ireals),
                                g=torch.zeros_like(tau_t), weight=torch.as_tensor(w, dtype=ireals))

    def _cloud_tables(self):
        """Band-mean Mie droplet optics per g-point (as RRTMG couples its
        band cloud properties, `rrtmg/rrtm_sw/rrtmg_sw_cldprop.f90`): each
        g-point takes its band's mean over the Mie table's wavenumbers
        inside the band.  (reff grid [um], kext, w0, g), float64 tables
        (ngpt, nreff), built once."""
        if self._cloud_cache is not None:
            return self._cloud_cache
        mie = np.load(_MIE)
        mw = mie["wavenumber"]
        order = np.argsort(mw)
        mw_s = mw[order]
        kext_all = mie["mass_extinction_coefficient"][:, order]  # (nreff, nw)
        w0_all = mie["single_scattering_albedo"][:, order]
        g_all = mie["asymmetry_factor"][:, order]
        rows_k, rows_s, rows_sg = [], [], []
        for cfg in _BANDS:
            b = cfg["n"]
            w1, w2 = self._d[f"b{b}/wavenum"]
            ng = self._d[f"b{b}/sfluxref"].shape[0]
            inside = (mw_s >= w1) & (mw_s <= w2)
            if inside.any():
                k = kext_all[:, inside].mean(1)
                s = (kext_all * w0_all)[:, inside].mean(1)
                sg = (kext_all * w0_all * g_all)[:, inside].mean(1)
            else:
                mid = 0.5 * (w1 + w2)
                k = np.array([np.interp(mid, mw_s, r) for r in kext_all])
                s = np.array([np.interp(mid, mw_s, r) for r in kext_all * w0_all])
                sg = np.array([np.interp(mid, mw_s, r) for r in kext_all * w0_all * g_all])
            rows_k += [k] * ng
            rows_s += [s] * ng
            rows_sg += [sg] * ng
        kext_g = np.stack(rows_k)
        ksca_g = np.stack(rows_s)
        kscg_g = np.stack(rows_sg)
        w0_g = ksca_g / np.maximum(kext_g, 1e-30)
        g_g = kscg_g / np.maximum(ksca_g, 1e-30)
        self._cloud_cache = (mie["effective_radius"] * 1e6, kext_g, w0_g, g_g)
        return self._cloud_cache

    def cloud_optprops_gpt(self, kind: str, lwc_gm3: torch.Tensor, reff_um: torch.Tensor,
                           dz_m: torch.Tensor, gsel=slice(None)):
        """Per-g-point water-cloud (tau, w0, g), shapes (ngpt_sel,) + grid."""
        return particle_optprops_gpt(self._cloud_tables(), lwc_gm3, reff_um, dz_m, gsel)

    def thermal(self, atm: Atmosphere):
        raise NotImplementedError(
            "RRTMG_LW k-tables are not vendored in the reference tree (rrtmg_lw_k_g.f90 "
            "absent); use the ecCKD LW backend.")
