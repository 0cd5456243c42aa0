"""Spectral integration driver: full-spectrum fluxes and heating rates
through the 3-D solver (port of the 3-D path of
`tenstream_tpu/spectral/specint.py::specint_pprts`; reference
`specint/specint_pprts.F90:88-210`, whose drivers loop g-points one by
one).

The g-points are solved in chunks of `band_chunk` bands: the optical
properties of a chunk are built as one (B, Nz, Nx, Ny) tensor on the
device and the whole per-band solve runs once for the chunk
(`PprtsSolver.solve_lanes`, the counterpart of the JAX package's
`jax.vmap`).  Never the whole spectrum at once: a chunk's fields are
built when it is solved.

Warm starts: per-chunk diffuse states and relaxation omegas are cached
across calls (`specint_cache`).  After the first solve of a spectrum the
bands are regrouped by their measured iteration counts (hard with hard)
and the grouping is frozen; a regrouped chunk gathers its warm states
band by band from the previous chunks.

Buildings (`buildings=` or attached to the solver) put the solve on
dense coefficients (kernel K3 on the card); their faces emit the per-band
Planck of `Buildings.temp`, and `buildings.fluxes` receives the spectrally
integrated face fluxes.  Partial cloudiness (`cld_frac` or `atm.cfrac`)
goes through McICA subcolumns drawn by the port's copy of JAX's threefry
(`core/prng.py`), so both packages draw the same subcolumns.  With `time`
and positive `max_solution_err` / `max_solution_time`, band chunks whose
extrapolated absorption error stays small are skipped and their cached
contribution reused (the adaptive spectral skip).

On a solver decomposed over ranks (`PprtsSolver.set_mesh`) every field
here is the rank's (x, y) block: the inputs (lwc, cld_frac, albedo_2d,
...) and the result.  McICA draws each column's numbers by its global
position, the adaptive skip decides on the global absorption change, and
the difficulty order (the same on every rank, as the iteration counts are
global) is taken from rank 0.  The warm cache stays per rank.

On a 1-D solver ("2str", "schwarzschild", "disort") the g-points go through
the batched column solvers instead (`_specint_1d`): two-stream columns, or
DISORT columns for "disort", in chunks of `band_chunk` g-points whose sums
add up in g-point order.  Like the JAX package, "schwarzschild" runs
two-stream thermal columns here (Schwarzschild is reached through
`PprtsSolver.solve`), no surface Planck is passed, and `bands`, the warm
cache and the adaptive skip do not apply.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.core.prng import Threefry
from tenstream_tpu_torch.core.types import PI, ireals
from tenstream_tpu_torch.ops.delta_scale import delta_scale
from tenstream_tpu_torch.ops.disort import disort_fluxes
from tenstream_tpu_torch.ops.twostream import delta_eddington_twostream
from tenstream_tpu_torch.pprts.adaptive import SolutionErrorTracker, abso_change_maxnorm
from tenstream_tpu_torch.pprts.buildings import building_incoming_from_fields, face_masks
from tenstream_tpu_torch.pprts.solver import _ONED_SOLVERS, PprtsSolver, Solution
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
from tenstream_tpu_torch.spectral.gasoptics import (
    GrayGasOptics,
    SpectralOptProps,
    SyntheticCKD,
    cloud_optprops,
)
from tenstream_tpu_torch.spectral.mcica import mcica_subcolumns
from tenstream_tpu_torch.spectral.repwvl import RepwvlOptics
from tenstream_tpu_torch.spectral.rrtmg_sw import RrtmgSwOptics

_BACKENDS = {"gray": GrayGasOptics, "synthck": SyntheticCKD, "ecckd": EcckdGasOptics,
             "rrtmg_sw": RrtmgSwOptics, "repwvl": RepwvlOptics}


def gas_backend(specint, device):
    """The gas-optics backend `specint` names (an object passes through);
    ecCKD, whose per-cell work scales with the columns, runs on `device`."""
    if not isinstance(specint, str):
        return specint
    cls = _BACKENDS[specint]
    return cls(device=device) if cls is EcckdGasOptics else cls()


class SpectralResult(NamedTuple):
    edir: Optional[torch.Tensor]  # (nz_solve+1, Nx, Ny) [W/m2]
    edn: torch.Tensor
    eup: torch.Tensor
    abso: torch.Tensor  # (nz_solve, Nx, Ny) [W/m3]


def _merge_cloud(tau_g, w0_g, g_g, tau_c, w0_c, g_c):
    """Combine gas and cloud optical properties per cell."""
    tau = tau_g + tau_c
    tau_safe = torch.clamp(tau, min=1e-30)
    w0 = (w0_g * tau_g + w0_c * tau_c) / tau_safe
    sca = torch.clamp(w0 * tau, min=1e-30)
    g = (g_g * w0_g * tau_g + g_c * w0_c * tau_c) / sca
    return tau, w0, g


def _to_kfields(tau, w0, g, dz3d):
    kext = tau / dz3d
    return kext * (1.0 - w0), kext * w0, g


def resolve_cache_mode(mode: str, ngpt: int, ndiff: int, nz_solve: int, nx: int,
                       ny: int) -> str:
    """The cache mode `specint_cache=auto` resolves to: f32 while the
    spectrum's f32 warm states (solar and thermal) stay under 1.5 GB, bf16
    under 4 GB, else off (the JAX package's rule)."""
    if mode != "auto":
        return mode
    f32_bytes_total = 2 * ngpt * ndiff * (nz_solve + 1) * nx * ny * 4
    return "f32" if f32_bytes_total < 1.5e9 else "bf16" if f32_bytes_total < 4e9 else "off"


def _specint_1d(solver, backend, atm, a2d, lthermal: bool, lsolar: bool, band_chunk: int,
                fields) -> "SpectralResult":
    """The spectral integration through the batched column solvers: each
    chunk of g-points is one more batch dimension of the two-stream (or,
    for "disort", the DISORT) columns.  `fields(sp, kind, gsel)` gives the
    chunk's delta-scaled (kabs, ksca, g), each (B, nz, nx, ny)."""
    grid = solver.lgrid
    dev = solver.device
    dz = grid.dz3d[:, None]  # (nz, 1, nx, ny) against (nz, B, nx, ny)
    nstr = solver.options.get_int("disort_streams", 8)
    use_disort = solver.solver_type == "disort"
    mu = solver.sun.mu if solver.sun is not None else 1.0
    lanes = lambda a: a.movedim(0, 1)  # g-points to a batch dim after z

    def spectrum(sp: SpectralOptProps, solar: bool):
        """(S, Edn, Eup, abso) summed over the g-points in chunk order;
        solar two-stream fluxes still in tilted-plane units."""
        total = None
        ngpt = sp.tau.shape[0]
        for lo in range(0, ngpt, band_chunk):
            gsel = slice(lo, min(lo + band_chunk, ngpt))
            kabs, ksca, g = (lanes(a) for a in fields(sp, "sw" if solar else "lw", gsel))
            kext = kabs + ksca
            dtau = kext * dz
            w0 = ksca / torch.clamp(kext, min=1e-30)
            planck = None
            if not solar:
                planck = sp.planck[gsel].to(dev, ireals)
                planck = lanes(planck[..., None, None].expand(tuple(planck.shape) + (
                    grid.nx, grid.ny)) if planck.dim() == 2 else planck)
            toa = sp.weight[gsel].to(dev, ireals)[:, None, None] if solar else 0.0
            if use_disort:
                S, Edn, Eup = disort_fluxes(dtau, w0, g, mu if solar else None, toa, a2d[None],
                                            planck=planck, nstreams=nstr)
                # S is in tilted-plane units, the diffuse fluxes horizontal
                S = S * mu if solar else S
            else:
                S, Edn, Eup = delta_eddington_twostream(dtau, w0, g, mu if solar else -1.0, toa,
                                                        a2d[None], planck=planck)
            net = (S[:-1] - S[1:]) + (Edn[:-1] - Edn[1:]) + (Eup[1:] - Eup[:-1])
            part = tuple(a.sum(1) for a in (S, Edn, Eup, net / dz))
            total = part if total is None else tuple(a + b for a, b in zip(total, part))
        return total

    nz, nx, ny = grid.nz, grid.nx, grid.ny
    edir = torch.zeros((nz + 1, nx, ny), dtype=ireals, device=dev)
    edn, eup = torch.zeros_like(edir), torch.zeros_like(edir)
    abso = torch.zeros((nz, nx, ny), dtype=ireals, device=dev)
    if lsolar and solver.sun is not None and solver.sun.sun_up:
        S, Edn, Eup, ab = spectrum(backend.solar(atm), True)
        scale = 1.0 if use_disort else mu
        edir, edn, eup, abso = (edir + S * scale, edn + Edn * scale, eup + Eup * scale,
                                abso + ab * scale)
    if lthermal:
        _, Edn, Eup, ab = spectrum(backend.thermal(atm), False)
        edn, eup, abso = edn + Edn, eup + Eup, abso + ab
    return SpectralResult(edir, edn, eup, abso)


def specint_pprts(
    solver: PprtsSolver,
    atm: Atmosphere,
    albedo: float,
    lthermal: bool,
    lsolar: bool,
    specint="synthck",
    lwc=None,
    reliq=None,
    iwc=None,
    reice=None,
    extra_tau=None,
    extra_w0=None,
    extra_g=None,
    band_chunk: int = 16,
    albedo_2d=None,
    time: Optional[float] = None,
    max_solution_err: float = 0.0,
    max_solution_time: float = 0.0,
    cld_frac=None,
    mcica_seed: int = 712,
    overlap: str = "maxrand",
    buildings=None,
    bands: Optional[Tuple[int, int]] = None,
) -> SpectralResult:
    """Full-spectrum solve on the solver's device.  The solver's grid
    z-axis must match atm.nlay; sun angles must be set for solar.

    `specint` is a backend name ("ecckd", "rrtmg_sw", "repwvl", "synthck",
    "gray") or a backend object (`EcckdGasOptics(n_gpt=32)`,
    `RepwvlOptics(n_wvl=50)`); "rrtmg_sw" is solar only.  lwc/reliq/iwc/reice (nlay, nx,
    ny) default to the atmosphere's fields.  `bands=(lo, hi)` restricts
    the loop to g-points [lo, hi) (a partial spectral integral).

    `buildings` (a `pprts.buildings.Buildings` with `temp`, not `planck`)
    is attached to the solver; its face fluxes land in `buildings.fluxes`.
    `cld_frac` (nlay, nx, ny) in [0, 1] (default `atm.cfrac`) turns on
    McICA with `overlap` ('maxrand', 'max', 'random') and the subcolumns
    of `mcica_seed`.  `time` [s] with positive `max_solution_err` /
    `max_solution_time` turns on the adaptive spectral skip (which keeps
    the natural band order: no difficulty regroup).

    Solver options read here: `specint_cache` (auto | f32 | bf16 | off |
    host), `specint_band_group` (regroup by difficulty, default on),
    `specint_band_seed` (seed a cold chunk from the previous chunk) and
    `specint_warm_extrapolate` (x0 = 2 x(t-1) - x(t-2), with the f32
    cache)."""
    grid = solver.lgrid
    mesh = solver._mesh
    scheme = solver.scheme
    dev = solver.device
    backend = gas_backend(specint, dev)
    nz, nx, ny = grid.nz, grid.nx, grid.ny
    nzs = solver.nz_solve  # results and warm states live on the solve grid
    if atm.nlay != nz:
        raise ValueError(f"atmosphere layers {atm.nlay} != grid nz {nz}")
    opts = solver.options
    tdev = lambda a: torch.as_tensor(a, dtype=ireals, device=dev)

    # buildings: attached, with a per-g-point face Planck from their
    # temperature (reference `ecckd/ecckd_pprts.F90:339-448`)
    if buildings is None:
        buildings = solver._buildings
    pb_gpt = None  # (ngpt_thermal,) or (ngpt_thermal, nz, nx, ny)
    if buildings is not None:
        if buildings.planck is not None:
            raise ValueError("specint_pprts computes the per-band building emission from "
                             "buildings.temp; provide temperatures, not planck (reference "
                             "CHKERR, ecckd/ecckd_pprts.F90:350-352)")
        solver.set_buildings(buildings)
        if lthermal and buildings.temp is not None:
            if not hasattr(backend, "planck_at"):
                raise NotImplementedError(
                    f"backend {type(backend).__name__} has no planck_at(); thermal building "
                    "emission needs a per-g-point Planck function (use specint='ecckd')")
            pb_gpt = tdev(backend.planck_at(buildings.temp.cpu().numpy()))

    if lwc is None and atm.lwc is not None:
        lwc, reliq = atm.lwc, atm.reliq
    if iwc is None and atm.iwc is not None:
        iwc, reice = atm.iwc, atm.reice
    if cld_frac is None and atm.cfrac is not None:
        cld_frac = atm.cfrac

    # McICA: the condensate becomes its in-cloud value, and per-g-point
    # binary masks scale the cloud optical depths in batched_fields (cloud
    # tau is linear in condensate at a fixed effective radius)
    mcica_masks: Dict[str, torch.Tensor] = {}
    if cld_frac is not None:
        f_cld = torch.clamp(tdev(cld_frac), 0.0, 1.0)
        f_safe = torch.clamp(f_cld, min=1e-6)
        if lwc is not None:
            lwc = tdev(lwc) / f_safe
        if iwc is not None:
            iwc = tdev(iwc) / f_safe

    def mcica_mask(kind: str, ngpt: int):
        """The whole spectrum's (ngpt, nz, nx, ny) subcolumn masks of one
        kind, drawn once per call."""
        if kind not in mcica_masks:
            key = Threefry.from_seed(mcica_seed).fold_in(0 if kind == "sw" else 1)
            block = None
            if mesh is not None:
                block = (mesh.block(solver.grid.nx, solver.grid.ny),
                         (solver.grid.nx, solver.grid.ny))
            mcica_masks[kind] = mcica_subcolumns(key, f_cld, ngpt, overlap=overlap,
                                                 block=block).to(ireals)
        return mcica_masks[kind]

    dz3d = grid.dz3d
    a2d = (torch.full((nx, ny), float(albedo), dtype=ireals, device=dev) if albedo_2d is None
           else tdev(albedo_2d))
    if lwc is not None:
        lwc = tdev(lwc)
        reff_cells = tdev(reliq) if reliq is not None else torch.full_like(lwc, 10.0)
    if iwc is not None:
        iwc = tdev(iwc)
        reice_cells = tdev(reice) if reice is not None else torch.full_like(iwc, 30.0)
    has_gpt_clouds = lwc is not None and hasattr(backend, "cloud_optprops_gpt")
    has_gpt_ice = iwc is not None and hasattr(backend, "ice_optprops_gpt")
    if lwc is not None and not has_gpt_clouds:
        # band-independent geometric-optics water cloud
        tau_c, w0_c, g_c = (a[None] for a in cloud_optprops(lwc, reff_cells, dz3d))
    elif lwc is None:
        tau_c = w0_c = g_c = torch.zeros((1, nz, nx, ny), dtype=ireals, device=dev)

    def to3d(a):
        """(ngpt, nlay) column fields broadcast to (ngpt, nlay, nx, ny) on
        the device; per-column (ngpt, nlay, nx, ny) fields pass through."""
        a = a.to(dev, ireals)
        return a[..., None, None].expand(tuple(a.shape) + (nx, ny)) if a.dim() == 2 else a

    def pick(a, gsel):
        return a[gsel] if isinstance(gsel, slice) else a[torch.as_tensor(gsel)]

    def batched_fields(sp: SpectralOptProps, kind: str, gsel):
        """The chunk's delta-scaled (kabs, ksca, g), (B, nz, nx, ny): gas
        columns broadcast to 3-D, merged with liquid and ice clouds
        (per-gpoint optics when the backend provides them)."""
        tau, w0, g = (to3d(pick(a, gsel)) for a in (sp.tau, sp.w0, sp.g))
        if has_gpt_clouds:
            tc, wc, gc = backend.cloud_optprops_gpt(kind, lwc, reff_cells, dz3d, gsel=gsel)
        else:
            tc, wc, gc = tau_c, w0_c, g_c
        mcmask = None if cld_frac is None else pick(mcica_mask(kind, sp.tau.shape[0]), gsel)
        if mcmask is not None and lwc is not None:
            tc = tc * mcmask
        tau, w0, g = _merge_cloud(tau, w0, g, tc, wc, gc)
        if has_gpt_ice:
            ti, wi, gi = backend.ice_optprops_gpt(kind, iwc, reice_cells, dz3d, gsel=gsel)
            if mcmask is not None:
                ti = ti * mcmask
            tau, w0, g = _merge_cloud(tau, w0, g, ti, wi, gi)
        if extra_tau is not None:
            # spectrally gray extra optical properties (aerosols, canopies)
            te = tdev(extra_tau)
            we = torch.zeros_like(te) if extra_w0 is None else tdev(extra_w0)
            ge = torch.zeros_like(te) if extra_g is None else tdev(extra_g)
            tau, w0, g = _merge_cloud(tau, w0, g, te[None], we[None], ge[None])
        return delta_scale(*_to_kfields(tau, w0, g, dz3d[None]))

    if solver.solver_type in _ONED_SOLVERS:
        if buildings is not None:
            raise ValueError(f"buildings need a 3-D solver (got solver_type="
                             f"{solver.solver_type!r})")
        return _specint_1d(solver, backend, atm, a2d, lthermal, lsolar, band_chunk,
                           batched_fields)

    acc: Dict[str, torch.Tensor] = {}
    host_pending: List[tuple] = []
    adaptive = time is not None and max_solution_err > 0 and max_solution_time > 0

    def add(name, contrib):
        acc[name] = contrib if name not in acc else acc[name] + contrib

    def store_host(entry):
        key, host, event, om, niter, res, tol = entry
        if event is not None:
            event.synchronize()
        solver.solutions[key] = Solution(None, host, None, om, niter, res, diff_tol=tol)

    def run_chunks(sp: SpectralOptProps, solar: bool, uid_tag: str):
        ngpt = sp.tau.shape[0]
        g_lo, g_hi = 0, ngpt
        if bands is not None:
            g_lo, g_hi = max(0, bands[0]), min(ngpt, bands[1])
        has_planck = sp.planck is not None
        # cross-band seeding of a cold chunk from the previous chunk's
        # states (off by default: measured net-negative for BiCGStab)
        band_seed = opts.get_bool("specint_band_seed", False)
        extrapolate = opts.get_bool("specint_warm_extrapolate", False)
        extrap_states = solver._extrap_states
        last_x = None

        # difficulty-grouped chunks: a chunk's lanes share the loop, so
        # after the first solve the bands are reordered by their niter and
        # the grouping is frozen (chunk cache keys stay stable); off under
        # the adaptive skip, whose trackers are kept per chunk
        group_opt = (band_chunk > 1 and not adaptive
                     and opts.get_bool("specint_band_group", True))
        order = solver._band_order.get(uid_tag) if group_opt else None
        band_rows = solver._band_rows.setdefault(uid_tag, {})
        gids_all = np.arange(g_lo, g_hi)
        if order is not None:
            known = [g for g in order if g_lo <= g < g_hi]
            # bands outside the recorded order append in natural order
            extra = [g for g in gids_all if g not in set(known)]
            gids_all = np.asarray(known + extra, dtype=np.int64)
        groups = [gids_all[i:i + band_chunk] for i in range(0, len(gids_all), band_chunk)]
        group_niters = []

        def gather_prev(gids):
            """Warm (x0, omega0) gathered band by band across the previous
            chunk boundaries, or None if a band has no cached state."""
            xs, oms = [], []
            for gg in gids:
                ent = band_rows.get(int(gg))
                if ent is None:
                    return None
                key, row = ent
                sol = solver.solutions.get(key)
                if sol is None or sol.ediff is None:
                    return None
                xs.append(sol.ediff[row].to(dev, ireals))
                oms.append(sol.diff_omega[row])
            return torch.stack(xs), oms

        cache_mode = resolve_cache_mode(opts.get("specint_cache", "auto"), ngpt, scheme.ndiff,
                                        nzs, nx, ny)

        for gsel_ids in groups:
            nb = len(gsel_ids)
            lo = int(gsel_ids[0])
            natural = bool(np.all(np.diff(gsel_ids) == 1)) if nb > 1 else True
            gsel = slice(lo, int(gsel_ids[-1]) + 1) if natural else np.asarray(gsel_ids)
            cache_key = ((uid_tag, lo) if natural and order is None
                         else (uid_tag, tuple(int(gg) for gg in gsel_ids)))
            prev = solver.solutions.get(cache_key)
            diff_name, abso_name = ("ediff_solar", "abso_solar") if solar else (
                "ediff_thermal", "abso_thermal")

            if adaptive and cache_key in solver._spectral_cache:
                tracker = solver._spectral_trackers.setdefault(cache_key, SolutionErrorTracker())
                if not tracker.need_new_solution(time, max_solution_err, max_solution_time):
                    c_edir, c_ediff, c_abso = solver._spectral_cache[cache_key]
                    if c_edir is not None:
                        add("edir", tdev(c_edir))
                    add(diff_name, tdev(c_ediff))
                    add(abso_name, tdev(c_abso))
                    solver._spectral_skips += 1
                    continue

            warm = prev is not None and prev.ediff is not None
            om0 = list(prev.diff_omega) if prev is not None else [1.0] * nb
            x0 = None
            if warm:
                x0 = prev.ediff.to(dev, ireals)
                # time-stepping extrapolation (opt-in, f32 cache)
                old = extrap_states.get(cache_key) if extrapolate else None
                if old is not None and tuple(old.shape) == tuple(x0.shape):
                    x0 = 2.0 * x0 - old.to(dev, ireals)
            else:
                gathered = gather_prev(gsel_ids) if prev is None else None
                if gathered is not None:  # regrouped chunk: row-gathered
                    x0, om0 = gathered
                elif band_seed and last_x is not None and last_x.shape[0] == nb:
                    x0 = last_x
            if x0 is not None and x0.shape[0] != nb:  # trailing partial chunk
                x0, om0 = x0[:nb], om0[:nb]

            planck_b = to3d(pick(sp.planck, gsel)) if has_planck else None
            psrfc_b = None
            if sp.planck_srfc is not None:
                ps = pick(sp.planck_srfc, gsel).to(dev, ireals)
                psrfc_b = ps if ps.dim() == 3 else ps[:, None, None].expand(nb, nx, ny)
            toa_b = pick(sp.weight, gsel) if solar else None
            kabs_b, ksca_b, g_b = batched_fields(sp, "sw" if solar else "lw", gsel)
            pb_b = None
            if pb_gpt is not None and has_planck:
                pb_b = pick(pb_gpt, gsel)
                if pb_b.dim() == 1:  # one building temperature
                    pb_b = pb_b[:, None, None, None].expand(nb, nz, nx, ny)
            r = solver.solve_lanes(has_planck, solar, kabs_b, ksca_b, g_b, a2d, planck=planck_b,
                                   planck_srfc=psrfc_b, edirTOA=toa_b, x0=x0, omega0=om0,
                                   planck_bldg=pb_b)
            del kabs_b, ksca_b, g_b, planck_b, pb_b
            # the per-lane counts are host numbers already; the convergence
            # check runs once at the end of the call
            solver._pending_convergence[cache_key] = (r.niter, r.res, r.tol)
            for pos, gg in enumerate(gsel_ids):
                band_rows[int(gg)] = (cache_key, pos)
            if group_opt and order is None:
                group_niters.append((gsel_ids, r.niter))
            last_x = r.ediff

            if cache_mode == "host":
                # the copy to pinned host memory overlaps the next chunk;
                # it is waited for one chunk later
                if r.ediff.device.type == "cuda":
                    host = torch.empty(r.ediff.shape, dtype=r.ediff.dtype, pin_memory=True)
                    host.copy_(r.ediff, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                else:
                    host, event = r.ediff.clone(), None
                host_pending.append((cache_key, host, event, r.omega, r.niter, r.res, r.tol))
                if len(host_pending) > 1:
                    store_host(host_pending.pop(0))
            else:
                x_keep = {"off": None, "bf16": r.ediff.to(torch.bfloat16)}.get(cache_mode,
                                                                               r.ediff)
                if (extrapolate and cache_mode == "f32"
                        and prev is not None and prev.ediff is not None):
                    extrap_states[cache_key] = prev.ediff  # x(t-1) for the next step
                solver.solutions[cache_key] = Solution(None, x_keep, None, r.omega, r.niter,
                                                       r.res, diff_tol=r.tol)

            # accumulate in [W], convert at the end
            contrib = (None if r.edir is None else r.edir.sum(0), r.ediff.sum(0), r.abso.sum(0))
            if contrib[0] is not None:
                add("edir", contrib[0])
            add(diff_name, contrib[1])
            add(abso_name, contrib[2])
            if adaptive:
                # host copies: the skip cache would otherwise pin three
                # flux fields per chunk in device memory
                host = tuple(None if c is None else c.cpu().numpy() for c in contrib)
                tracker = solver._spectral_trackers.setdefault(cache_key, SolutionErrorTracker())
                old = solver._spectral_cache.get(cache_key)
                tracker.record(time, 0.0 if old is None else
                               abso_change_maxnorm(host[2], old[2], mesh))
                solver._spectral_cache[cache_key] = host

        # freeze the difficulty grouping from the first solve's per-band
        # iteration counts (a stable sort, as in the JAX package)
        if group_opt and order is None and group_niters:
            if sum(len(g) for g, _ in group_niters) == len(gids_all):
                nit = np.concatenate([np.asarray(n, np.float32) for _, n in group_niters])
                gid_cat = np.concatenate([g for g, _ in group_niters])
                order_new = gid_cat[np.argsort(nit, kind="stable")]
                if mesh is not None:
                    order_new = mesh.broadcast(torch.as_tensor(order_new)).numpy()
                solver._band_order[uid_tag] = order_new
        elif group_opt and order is not None:
            # the regrouped keys carry all warm states now; drop this
            # uid_tag's orphaned pre-regroup chunk solutions
            live = {key for key, _ in band_rows.values()}
            for k in list(solver.solutions):
                if isinstance(k, tuple) and len(k) == 2 and k[0] == uid_tag and k not in live:
                    del solver.solutions[k]
        while host_pending:
            store_host(host_pending.pop(0))

    if lsolar and solver.sun is not None and solver.sun.sun_up:
        run_chunks(backend.solar(atm), True, "solar")
    if lthermal:
        run_chunks(backend.thermal(atm), False, "thermal")

    # the one deferred convergence check of the whole call
    solver.check_convergence()

    diff_scale = solver._diff_scale_to_wm2()
    inward = scheme.diff_inward()
    mu = float(solver.sun.mu) if (lsolar and solver.sun is not None) else 1.0
    zeros = lambda shape: torch.zeros(shape, dtype=ireals, device=dev)

    def diff_to_edn_eup(name, scale_mu):
        e = acc.get(name, zeros((scheme.ndiff, nzs + 1, nx, ny))) * diff_scale
        top = range(scheme.difftop.dof)
        edn_ = sum(e[d] for d in top if inward[d]) / scheme.difftop.area_divider
        eup_ = sum(e[d] for d in top if not inward[d]) / scheme.difftop.area_divider
        return edn_ * scale_mu, eup_ * scale_mu

    edn_s, eup_s = diff_to_edn_eup("ediff_solar", mu)
    edn_t, eup_t = diff_to_edn_eup("ediff_thermal", 1.0)
    abso = (acc.get("abso_solar", zeros((nzs, nx, ny))) * mu
            + acc.get("abso_thermal", zeros((nzs, nx, ny))))
    edir = None
    if "edir" in acc:
        e = acc["edir"] * solver._dir_scale_to_wm2()
        edir = e[: scheme.dirtop.dof].sum(0) / scheme.dirtop.area_divider * mu
    if buildings is not None:
        fluxes = _building_fluxes(solver, acc, mu, pb_gpt)
        buildings.fluxes = fluxes
        solver._buildings.fluxes = fluxes
    return SpectralResult(edir, edn_s + edn_t, eup_s + eup_t, abso)


def _building_fluxes(solver: PprtsSolver, acc: Dict[str, torch.Tensor], mu: float,
                     pb_gpt: Optional[torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-face fluxes [W/m2] from the spectrally accumulated [W] fields:
    incoming is linear in the fields, so one extraction equals the
    reference's per-band accumulation (`ecckd_pprts.F90:440-448`); the
    faces emit the sum of the per-g-point Planck values."""
    b, grid, scheme, sun = solver._buildings, solver.lgrid, solver.scheme, solver.sun
    mesh = solver._mesh
    zeros = torch.zeros((scheme.ndiff, grid.nz + 1, grid.nx, grid.ny), dtype=ireals,
                        device=solver.device)
    ediff_tot = acc.get("ediff_solar", zeros) * mu + acc.get("ediff_thermal", zeros)
    edir_tot = acc["edir"] * mu if "edir" in acc else None
    ef, inc = building_incoming_from_fields(
        scheme, b, ediff_tot, edir_tot, grid.az, grid.dx, grid.dy, grid.dz3d,
        xinc=sun.xinc if sun is not None else 1, yinc=sun.yinc if sun is not None else 1,
        mesh=mesh)
    B_tot = 0.0 if pb_gpt is None else pb_gpt.sum(0)
    out = {}
    for k, m in face_masks(b, mesh).items():
        zero = torch.zeros_like(inc[k])
        outgoing = b.albedo * inc[k] + (1.0 - b.albedo) * PI * B_tot
        out[k] = dict(edir=torch.where(m, ef[k], zero), incoming=torch.where(m, inc[k], zero),
                      outgoing=torch.where(m, outgoing, zero))
    return out
