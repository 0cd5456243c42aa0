"""Neighbouring Column Approximation (NCA) for triangle columns (port of
`tenstream_tpu/plexrt/nca.py`; reference `plexrt/nca_multi_tri.F90`,
Klinger & Mayer 2019, driven as `plexrt_external_solvers.F90:compute_nca`,
:560-760).

A thermal-only post-process: the 1-D heating rates of a wedge-column
solve are replaced by 3-D-corrected ones built from the fluxes of the
three side-neighbouring columns and the cells above and below.  Every
(layer, cell) computes at once; side neighbours come from one gather
through the TriMesh tables (`nca_icon`) or the structured mesh's rolls
(`nca_structured`), on a decomposed solve through one ghost-cell or
halo exchange with the neighbouring ranks, and the emissivity / correction tables
(`data/nca/nca_tables.npz`) are read by clamped bilinear interpolation
with the thin-optical-depth analytic limit.  The `atan` weight fits of
`determine_weights` / `Absside` (nca_multi_tri.F90:345-376) are the
published parameterization.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from tenstream_tpu_torch.core.types import PI, ireals
from tenstream_tpu_torch.ops.interp import fractional_index
from tenstream_tpu_torch.parallel.mesh import GhostExchange
from tenstream_tpu_torch.plexrt.mesh import SIDE_OFFSETS, roll2_many

# height of the unit equilateral triangle: hc = H * edge
_H = 0.86603

_DEFAULT_TABLE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "data", "nca", "nca_tables.npz")


@dataclass(frozen=True)
class NcaTables:
    """NCA lookup tables on a device: eps tables index [tau_hx, tau_z],
    corr tables [aspect (var_1), tau (var_2)] (`eps_tab(ix, iy)`,
    nca_multi_tri.F90:430); the npz stores them transposed."""

    eps_top: torch.Tensor
    eps_side: torch.Tensor
    corr_top: torch.Tensor
    corr_side: torch.Tensor
    tau_hx: torch.Tensor
    tau_z: torch.Tensor
    var_1: torch.Tensor
    var_2: torch.Tensor

    @classmethod
    def load(cls, path: str = _DEFAULT_TABLE_PATH, device="cuda") -> "NcaTables":
        d = np.load(path)
        f = lambda k: torch.as_tensor(np.asarray(d[k], np.float32), device=device)
        return cls(eps_top=f("eps_top").T.contiguous(), eps_side=f("eps_side").T.contiguous(),
                   corr_top=f("corr_top").T.contiguous(),
                   corr_side=f("corr_side").T.contiguous(), tau_hx=f("tau_hx"),
                   tau_z=f("tau_z"), var_1=f("var_1"), var_2=f("var_2"))


def _bilinear(tab, ax0, ax1, x0, x1):
    """Clamped bilinear lookup of tab[(ax0), (ax1)] at (x0, x1)."""
    f0 = fractional_index(ax0, x0)
    f1 = fractional_index(ax1, x1)
    i0 = torch.clamp(torch.floor(f0), 0, ax0.shape[0] - 2).to(torch.int64)
    i1 = torch.clamp(torch.floor(f1), 0, ax1.shape[0] - 2).to(torch.int64)
    w0 = f0 - i0
    w1 = f1 - i1
    return (tab[i0, i1] * (1 - w0) * (1 - w1) + tab[i0 + 1, i1] * w0 * (1 - w1)
            + tab[i0, i1 + 1] * (1 - w0) * w1 + tab[i0 + 1, i1 + 1] * w0 * w1)


def interpol_emis(tables: NcaTables, tauhx, tauz, side: bool):
    """Face emissivity (`interpol_emis`, nca_multi_tri.F90:384): below the
    tables the thin limit 1 - exp(-min(tau)), else clamped bilinear,
    capped at 1."""
    tauhx, tauz = torch.broadcast_tensors(tauhx, tauz)
    tab = tables.eps_side if side else tables.eps_top
    emis = _bilinear(tab, tables.tau_hx, tables.tau_z, tauhx, tauz)
    thin = 1.0 - torch.exp(-torch.minimum(tauz, tauhx))
    below = (tauhx < tables.tau_hx[0]) | (tauz < tables.tau_z[0])
    return torch.clamp(torch.where(below, thin, emis), max=1.0)


def interpol_corr(tables: NcaTables, asp, tau, side: bool):
    """Correction factor (`interpol_2d`, nca_multi_tri.F90:464)."""
    asp, tau = torch.broadcast_tensors(asp, tau)
    tab = tables.corr_side if side else tables.corr_top
    return _bilinear(tab, tables.var_1, tables.var_2, asp, tau)


def _determine_weights(dz, hc, kabs_nb):
    """Top / bottom face flux blend weights (nca_multi_tri.F90:345-362):
    w1 the side columns' share, w2 = 1 - w1 the own column's."""
    asp = torch.clamp(dz / hc, 0.1, 10.0)
    wa = torch.atan(asp * 1.29) * (-0.75) + 1.21
    wb = asp ** 0.027 * (-7.98) + asp * (-0.01) + torch.atan(asp * 0.11) + 7.36
    wc = asp ** 0.49 * 1.46 + asp * (-0.25) + torch.atan(asp * (-0.29)) - 0.12
    w1 = torch.atan(kabs_nb * dz * wa) * wb + wc
    return w1, 1.0 - w1


def _side_split(kabs_s, dz, dx_s):
    """Entry- vs exit-level flux blend on a side face
    (nca_multi_tri.F90:364-376, `Absside` f1 / f2)."""
    f1 = torch.atan(kabs_s * dz * (-2.08 / (dz / dx_s))) * 0.31192 + 0.49
    f1 = torch.clamp(f1, min=0.0)
    return f1, 1.0 - f1


def nca_heating_rate(tables: NcaTables, dx_s, dz, atop, abot, area_s, vol, kabs, kabs_top,
                     kabs_bot, edn_top, eup_bot, b_top, b_bot, kabs_s, edn_top_s, eup_top_s,
                     edn_bot_s, eup_bot_s):
    """The 3-D thermal heating rate of every cell [W/m3]
    (`plexrt_nca`, nca_multi_tri.F90:161-377), in flux units: with Planck
    given as radiance the reference's /pi and *pi land on the emission
    terms as pi * B.  Side-neighbour fields carry a trailing side axis."""
    dxm = dx_s.sum(-1) / 3.0
    b_layer = PI * (b_top + b_bot) / 2.0
    tauz = kabs * dz

    hc_top = 2.0 * atop / dxm
    asp_top = torch.clamp(dz / hc_top, 0.11, 11.0)
    tauhx_m = kabs * dxm * _H
    eps_top = interpol_emis(tables, tauhx_m, tauz, side=False)
    f_top = interpol_corr(tables, asp_top, tauz, side=False)

    hc_bot = 2.0 * abot / dxm
    asp_bot = torch.clamp(dz / hc_bot, 0.11, 11.0)
    eps_bot = interpol_emis(tables, tauhx_m, tauz, side=False)
    f_bot = interpol_corr(tables, asp_bot, tauz, side=False)

    tauhx_s = kabs[..., None] * dx_s * _H
    eps_s = interpol_emis(tables, tauhx_s, tauz[..., None], side=True)
    # the reference uses the BOTTOM aspect for the side correction (the
    # in-scope `asp` at nca_multi_tri.F90:277)
    f_s = interpol_corr(tables, asp_bot[..., None], tauhx_s, side=True)

    w1, w2 = _determine_weights(dz, hc_top, kabs_top)
    l_dn = w1 * edn_top_s.sum(-1) / 3.0 + w2 * edn_top
    abs_dn = l_dn * atop * eps_top * f_top
    em_dn = -b_layer * atop * eps_top * f_top

    f1, f2 = _side_split(kabs_s, dz[..., None], dx_s)
    gain_s = area_s * eps_s * f_s
    abs_dns = ((f1 * edn_top_s + f2 * edn_bot_s) * gain_s).sum(-1)
    em_dns = (-b_layer[..., None] * gain_s).sum(-1)

    w1, w2 = _determine_weights(dz, hc_bot, kabs_bot)
    l_up = w1 * eup_bot_s.sum(-1) / 3.0 + w2 * eup_bot
    abs_up = l_up * abot * eps_bot * f_bot
    em_up = -b_layer * abot * eps_bot * f_bot

    abs_ups = ((f1 * eup_bot_s + f2 * eup_top_s) * gain_s).sum(-1)
    em_ups = (-b_layer[..., None] * gain_s).sum(-1)

    return (abs_up + em_up + abs_dn + em_dn + (abs_ups + em_ups + abs_dns + em_dns) / 2.0) / vol


def _tables_on(tables, device):
    return NcaTables.load(device=device) if tables is None else tables


def nca_neighbours(mesh) -> np.ndarray:
    """(nc, 3) side neighbour of each cell of a TriMesh, the cell itself at
    open boundaries (`get_neigh_face_info`)."""
    own = np.arange(mesh.ncell)[:, None]
    return np.where(mesh.nbr >= 0, mesh.nbr, own)


def nca_exchange(mesh, pmesh, device) -> GhostExchange:
    """The ghost-cell exchange of `nca_icon` on a `parallel.mesh.Mesh`:
    each rank's cells read their `nca_neighbours`, one value per cell."""
    nbr = nca_neighbours(mesh)
    return GhostExchange(pmesh, nbr, np.ones(nbr.shape, bool), 1, device)


def nca_icon(mesh, dz, kabs, planck, edn, eup, tables: NcaTables | None = None, exchange=None):
    """NCA absorption of a TriMesh wedge column stack [W/m3]: kabs (nz, nc)
    [1/m], planck (nz+1, nc) radiance [W/m2/sr], edn / eup (nz+1, nc)
    [W/m2].  Vertical neighbours fall back to the own cell at TOA and the
    surface, side neighbours at open boundaries (`nca_neighbours`).  With
    an `exchange` (`nca_exchange`, built once per decomposition), the
    fields are its rank's range of cells (`Mesh.cell_range`) and the
    neighbours' values come in one ghost-cell exchange."""
    dev = kabs.device
    tables = _tables_on(tables, dev)
    t = lambda a: torch.as_tensor(a, dtype=ireals, device=dev)
    kabs, planck, edn, eup = t(kabs), t(planck), t(edn), t(eup)
    nz = kabs.shape[0]
    dzc = torch.broadcast_to(t(np.asarray(dz, np.float32)).reshape(-1), (nz,))[:, None]
    fields = torch.stack([kabs, edn[:-1], eup[:-1], edn[1:], eup[1:]])
    if exchange is None:
        cells = slice(None)
        nbrs = fields[:, :, torch.as_tensor(nca_neighbours(mesh), device=dev)]  # (5, nz, nc, 3)
    else:
        cells = slice(*exchange.mesh.cell_range(mesh.ncell))
        nbrs = exchange.gather(fields)

    kabs_top = torch.cat([kabs[:1], kabs[:-1]], dim=0)
    kabs_bot = torch.cat([kabs[1:], kabs[-1:]], dim=0)
    dx_s = t(mesh.side_len[cells])[None]
    area = t(mesh.area[cells])[None]
    area_s = dx_s * dzc[..., None]
    vol = area * dzc
    return nca_heating_rate(tables, dx_s, dzc, area, area, area_s, vol, kabs, kabs_top, kabs_bot,
                            edn[:-1], eup[1:], planck[:-1], planck[1:], *nbrs)


def nca_structured(grid, kabs, planck, edn, eup, tables: NcaTables | None = None, pmesh=None):
    """NCA absorption on the structured fish-mesh grid [W/m3]: side
    neighbours through the periodic roll exchange (T0(i, j) side s <->
    T1(i+di, j+dj) side s).  kabs (nz, 2, nx, ny); planck / edn / eup
    (nz+1, 2, nx, ny).  With a `parallel.mesh.Mesh` `pmesh`, `grid` and the
    fields are this rank's (x, y) block and the rolls one halo exchange."""
    dev = kabs.device
    tables = _tables_on(tables, dev)
    t = lambda a: torch.as_tensor(a, dtype=ireals, device=dev)
    kabs, planck, edn, eup = t(kabs), t(planck), t(edn), t(eup)
    dzc = t(grid.dz)[:, None, None, None]

    def gather(fld):  # (5, nz, 2, nx, ny) -> (5, nz, 2, nx, ny, 3)
        items = []
        for di, dj in SIDE_OFFSETS:
            items += [(fld[:, :, 1], -di, -dj), (fld[:, :, 0], di, dj)]
        got = roll2_many(items, pmesh)
        return torch.stack([torch.stack(got[2 * s:2 * s + 2], dim=2) for s in range(3)], dim=-1)

    kabs_top = torch.cat([kabs[:1], kabs[:-1]], dim=0)
    kabs_bot = torch.cat([kabs[1:], kabs[-1:]], dim=0)
    dx_s = t(grid.side_lengths).reshape(1, 1, 1, 1, 3)
    area = t(grid.area_tri)
    area_s = dx_s * dzc[..., None]
    vol = area * dzc
    nbrs = gather(torch.stack([kabs, edn[:-1], eup[:-1], edn[1:], eup[1:]]))
    return nca_heating_rate(tables, dx_s, dzc, area, area, area_s, vol, kabs, kabs_top, kabs_bot,
                            edn[:-1], eup[1:], planck[:-1], planck[1:], *nbrs)
