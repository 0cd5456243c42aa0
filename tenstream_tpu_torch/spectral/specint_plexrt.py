"""Spectral integration on the wedge-mesh solvers (port of
`tenstream_tpu/spectral/specint_plexrt.py`; reference
`specint/specint_plexrt.F90`, and `rrtmg/rrtmg/plexrt_rrtmg.F90` for
ICON grids).

Per g-point the background column's gas optics are broadcast onto the
wedge grid and merged with the 3-D cloud, and the weighted fluxes are
summed.  It works on the structured `PlexrtSolver` and on the
unstructured `PlexrtSolverIcon`.  The g-points go in chunks of
`band_chunk`: each chunk's optical properties are one (B, ...) tensor and
the chunk is one `solve_lanes` call, each lane converging on its own (the
JAX package's `jax.vmap` of the monochromatic solve).  No delta scaling
and no warm start, as in the JAX package.  On a decomposed solver
(`set_mesh`) every cell field, lwc and reliq included, is the rank's part,
and so are the results; the chunks are the same on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.core.types import ireals
from tenstream_tpu_torch.spectral.gasoptics import cloud_optprops
from tenstream_tpu_torch.spectral.specint import _merge_cloud, gas_backend


class PlexSpectralResult(NamedTuple):
    edir: Optional[torch.Tensor]  # structured (nz+1, 2, nx, ny); icon (nz+1, nc) [W/m2]
    edn: torch.Tensor
    eup: torch.Tensor
    abso: torch.Tensor  # cell-shaped [W/m3]


def specint_plexrt(solver, atm: Atmosphere, albedo: float, lthermal: bool, lsolar: bool,
                   specint="ecckd", lwc=None, reliq=None, max_gpt: Optional[int] = None,
                   band_chunk: int = 8) -> PlexSpectralResult:
    """Full-spectrum wedge solve on the solver's device.  lwc (cell-shaped,
    [g/m3]) and reliq ([um], scalar or cell-shaped, default 10) give the
    liquid cloud; `max_gpt` limits each spectrum to its first g-points;
    the sun comes from `solver.set_angles`.  Cell-shaped means the solver's
    cells: on a mesh, this rank's."""
    dev = solver.device
    backend = gas_backend(specint, dev)
    t = lambda a: torch.as_tensor(a, dtype=ireals, device=dev)
    cell_shape = solver.cell_shape()
    nz = cell_shape[0]
    dz3 = solver.cell_dz()
    area = solver.areas()
    if nz != atm.nlay:
        raise ValueError(f"plex grid nz {nz} must match atm.nlay {atm.nlay}")
    lvl_shape = (nz + 1,) + cell_shape[1:]
    col = lambda a: a.reshape(a.shape[:2] + (1,) * (len(cell_shape) - 1)).to(dev, ireals)

    reff = lwc_t = None
    if lwc is not None:
        lwc_t = t(lwc)
        reff = t(reliq if reliq is not None else 10.0)
        if reff.dim() == 0:
            reff = torch.full(cell_shape, float(reff), dtype=ireals, device=dev)

    def chunk_fields(sp, gsel, kind):
        """(kabs, ksca, g) of g-points `gsel`, (B,) + cell shape."""
        ones = torch.ones(cell_shape, dtype=ireals, device=dev)
        tau_g, w0_g, g_g = (col(a[gsel]) * ones for a in (sp.tau, sp.w0, sp.g))
        if lwc_t is not None:
            if hasattr(backend, "cloud_optprops_gpt"):
                tc, wc, gc = backend.cloud_optprops_gpt(kind, lwc_t, reff, dz3, gsel=gsel)
            else:
                tc, wc, gc = (a[None] for a in cloud_optprops(lwc_t, reff, dz3))
            tau, w0, gg = _merge_cloud(tau_g, w0_g, g_g, tc, wc, gc)
        else:
            tau, w0, gg = tau_g, w0_g, g_g
        kext = tau / dz3
        return kext * (1.0 - w0), kext * w0, gg

    acc = {}
    zeros = lambda shape: torch.zeros(shape, dtype=ireals, device=dev)

    def add(name, a):
        acc[name] = a if name not in acc else acc[name] + a

    def run(sp, solar: bool):
        ngpt = sp.tau.shape[0] if max_gpt is None else min(max_gpt, sp.tau.shape[0])
        has_planck = (not solar) and sp.planck is not None
        for lo in range(0, ngpt, band_chunk):
            gsel = slice(lo, min(lo + band_chunk, ngpt))
            kabs, ksca, gg = chunk_fields(sp, gsel, "sw" if solar else "lw")
            planck = None
            if has_planck:
                planck = col(sp.planck[gsel]) * torch.ones(lvl_shape, dtype=ireals, device=dev)
            toa = sp.weight[gsel] if solar else None
            # the weight is the g-point's beam irradiance; the solver applies
            # the E0 * mu TOA projection itself
            sol = solver.solve_lanes(not solar, solar, kabs, ksca, gg, albedo, planck=planck,
                                     edirTOA=toa)
            if solar:
                add("edir", zeros(lvl_shape) if sol.edir is None else sol.edir.sum(0))
            add("edn", sol.edn.sum(0))
            add("eup", sol.eup.sum(0))
            add("abso", sol.abso.sum(0))

    if lsolar and solver._sundir is not None:
        run(backend.solar(atm), True)
    if lthermal:
        run(backend.thermal(atm), False)

    edir = acc["edir"] / area if "edir" in acc else None
    return PlexSpectralResult(edir, acc.get("edn", zeros(lvl_shape)) / area,
                              acc.get("eup", zeros(lvl_shape)) / area,
                              acc.get("abso", zeros(cell_shape)))
