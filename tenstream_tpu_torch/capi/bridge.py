"""Python side of the port's C API (`tenstream_tpu_torch_capi.c`), the
counterpart of the JAX package's `capi/capi_bridge.py` with the same
functions, scheme names, mockup tables, merged-grid `specint` and solver
cache key.

It receives flat float32 byte buffers from C, drives the port's solver on
the device the C host chose (`tenstream_tpu_torch_set_device`, default
"cuda"), and returns results as bytes.  One global solver instance, as the
reference C wrapper's module-level state (`c_wrapper/f2c_pprts.F90:95-128`).

With `TENSTREAM_TPU_TORCH_CAPI_LOG` set to a file path, every solve and
specint call appends one JSON line to it: the call, its wall [s] (device
work synchronised), the kernel launches it made and, on the card, its peak
device memory [GiB].
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

ONED = ("2str", "schwarzschild", "disort")
# card memory [bytes] that one g-point lane of specint's chunk holds per level cell of the
# solve grid (the BiCGStab vectors, its preconditioner's levels, the orbit coefficients): a
# call on a 256 x 256 slab of 68 merged layers peaked at 33.60 GiB in chunks of 8 on an H100,
# and ran its 80 GB out in chunks of 16
LANE_CELL_BYTES = 1000

_state = {}


def _f32(buf, shape):
    return np.frombuffer(buf, np.float32).reshape(shape).copy()


def _device(name: str) -> torch.device:
    """The asked device; "cuda" without CUDA raises, never falls back."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"tenstream_tpu_torch: device {name!r} asked for, but CUDA is not "
                           "available (tenstream_tpu_torch_set_device(\"cpu\") solves on the CPU)")
    return dev


def _band_chunk(dev: torch.device, cells: int) -> int:
    """specint's g-points per chunk: the JAX bridge's 16 where the card
    holds them (`LANE_CELL_BYTES` per lane and level cell), else the
    largest power of two below it that fits in 3/4 of the card's memory.
    It reads the card's total memory, not its free memory, so every
    process on one kind of card chunks a call alike."""
    chunk = 16
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        while chunk > 1 and chunk * cells * LANE_CELL_BYTES > 0.75 * total:
            chunk //= 2
    return chunk


def _solver(grid, solver_name: str, device):
    from tenstream_tpu_torch.optprop.facade import OptProp
    from tenstream_tpu_torch.optprop.lut import load_or_create_lut, mockup_axes
    from tenstream_tpu_torch.pprts.solver import PprtsSolver

    if solver_name in ONED:
        return PprtsSolver(grid, solver_type=solver_name)
    lut = load_or_create_lut(solver_name, mockup_axes(True), mockup_axes(False), n_photons=2000,
                             device=device)
    return PprtsSolver(grid, OptProp(lut, device=device))


class _logged:
    """Times a call and counts its kernel launches into the log file."""

    def __init__(self, call: str, device):
        self.call, self.device = call, device
        self.path = os.environ.get("TENSTREAM_TPU_TORCH_CAPI_LOG")

    def __enter__(self):
        if self.path:
            from tenstream_tpu_torch.pprts import cuda_ops

            self.before = dict(cuda_ops.LAUNCHES)
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.path and exc[0] is None:
            from tenstream_tpu_torch.pprts import cuda_ops

            peak = None
            if self.device.type == "cuda":
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
            wall = time.perf_counter() - self.t0
            launches = {k: v - self.before.get(k, 0) for k, v in cuda_ops.LAUNCHES.items()}
            with open(self.path, "a") as fh:
                fh.write(json.dumps(dict(call=self.call, wall_s=wall, launches=launches,
                                         device=str(self.device), peak_gib=peak)) + "\n")


def init(nz, nx, ny, dx, dy, dz_bytes, phi0, theta0, solver_name, device="cuda"):
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles

    dev = _device(device)
    grid = Grid.create(nz, nx, ny, dx, dy, _f32(dz_bytes, (nz,)), device=dev)
    solver = _solver(grid, solver_name, dev)
    solver.set_angles(sundir_from_angles(phi0, theta0))
    _state.update(solver=solver, dims=(nz, nx, ny), device=dev)
    return 0


def set_optical_properties(albedo, kabs_b, ksca_b, g_b, planck_b):
    nz, nx, ny = _state["dims"]
    kabs, ksca, g = (_f32(b, (nz, nx, ny)) for b in (kabs_b, ksca_b, g_b))
    planck = None if planck_b is None else _f32(planck_b, (nz + 1, nx, ny))
    _state["solver"].set_optical_properties(albedo, kabs, ksca, g, planck=planck)
    return 0


def solve(lthermal, lsolar, edirTOA):
    with _logged("solve", _state["device"]):
        _state["solver"].solve(lthermal=bool(lthermal), lsolar=bool(lsolar), edirTOA=edirTOA)
    return 0


def _bytes(x):
    return None if x is None else np.ascontiguousarray(x.detach().cpu().numpy(),
                                                       np.float32).tobytes()


def get_result():
    return tuple(_bytes(x) for x in _state["solver"].get_result())


def destroy():
    _state.clear()
    return 0


def specint(nz, nx, ny, dx, dy, phi0, theta0, albedo_thermal, albedo_solar, specname,
            solver_name, plev_b, tlev_b, lwc_b, reliq_b, iwc_b, reice_b, lthermal, lsolar,
            device="cuda"):
    """Full-spectrum heating-rate solve (reference `f2c_pprts_rrtmg`,
    `c_wrapper/f2c_pprts_rrtm.F90:48-161`): merge the host slab with the
    background atmosphere, run gas-optics spectral integration for the
    requested kinds, return broadband results on the MERGED grid.

    As the JAX bridge: pressures in Pa (not hPa), TOA-first ordering (the
    solver's z convention), float32 buffers; lwc/iwc are g/kg like the
    reference and converted via layer air density.  On the card the
    g-points go in chunks of `_band_chunk`, 16 where they fit.  Returns (nz_merged,
    edir, edn, eup, abso) with flux shapes (nz_merged+1, nx, ny) and abso
    (nz_merged, nx, ny), all bytes."""
    from tenstream_tpu_torch.atm import setup_tenstr_atm
    from tenstream_tpu_torch.core.types import R_DRY_AIR
    from tenstream_tpu_torch.pprts.grid import Grid
    from tenstream_tpu_torch.pprts.sun import sundir_from_angles
    from tenstream_tpu_torch.spectral.specint import specint_pprts

    dev = _device(device)
    plev = _f32(plev_b, (nz + 1, nx, ny)).astype(np.float64)
    tlev = _f32(tlev_b, (nz + 1, nx, ny)).astype(np.float64)
    kw = {}
    rho = (0.5 * (plev[:-1] + plev[1:])) / (R_DRY_AIR * 0.5 * (tlev[:-1] + tlev[1:]))  # kg/m3
    if lwc_b is not None:
        kw["lwc"] = _f32(lwc_b, (nz, nx, ny)) * rho  # g/kg -> g/m3
        if reliq_b is not None:
            kw["reliq"] = _f32(reliq_b, (nz, nx, ny))
    if iwc_b is not None:
        kw["iwc"] = _f32(iwc_b, (nz, nx, ny)) * rho
        if reice_b is not None:
            kw["reice"] = _f32(reice_b, (nz, nx, ny))
    atm = setup_tenstr_atm(plev, tlev, **kw)

    # the key holds the FULL grid geometry: a matching (nlay, nx, ny) with
    # drifted dz (evolving plev/tlev) or other dx/dy must rebuild the
    # solver, or fluxes would be computed on stale layer thicknesses
    dz_arr = np.asarray(atm.dz, np.float32)
    key = ("specint_solver", atm.nlay, nx, ny, solver_name, dx, dy, hash(dz_arr.tobytes()),
           str(dev))
    if _state.get("specint_key") != key:
        grid = Grid.create(atm.nlay, nx, ny, dx, dy, dz_arr, device=dev)
        _state["specint_key"] = key
        _state["specint_solver"] = _solver(grid, solver_name, dev)
    solver = _state["specint_solver"]
    solver.set_angles(sundir_from_angles(phi0, theta0))

    shp_lvl = (atm.nlay + 1, nx, ny)
    edir = torch.zeros(shp_lvl, dtype=torch.float32, device=dev)
    edn, eup = torch.zeros_like(edir), torch.zeros_like(edir)
    abso = torch.zeros((atm.nlay, nx, ny), dtype=torch.float32, device=dev)
    chunk = _band_chunk(dev, (atm.nlay + 1) * nx * ny)
    # the reference runs thermal and solar as separate sub-solves with
    # their own broadband albedos (`compute_thermal` / `compute_solar`)
    with _logged("specint", dev):
        if lthermal:
            r = specint_pprts(solver, atm, albedo_thermal, lthermal=True, lsolar=False,
                              specint=specname, band_chunk=chunk)
            edn += r.edn
            eup += r.eup
            abso += r.abso
        if lsolar:
            r = specint_pprts(solver, atm, albedo_solar, lthermal=False, lsolar=True,
                              specint=specname, band_chunk=chunk)
            if r.edir is not None:
                edir += r.edir
            edn += r.edn
            eup += r.eup
            abso += r.abso
    return (int(atm.nlay), _bytes(edir), _bytes(edn), _bytes(eup), _bytes(abso))
