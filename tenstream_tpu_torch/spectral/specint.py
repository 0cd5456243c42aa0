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

Not ported (each raises NotImplementedError naming its ROADMAP item):
McICA (`cld_frac`) and the adaptive spectral skip (M13), buildings (the
M10 remainder), the 1-D solver types (M12), the rrtmg_sw and repwvl
backends (M14).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.atm import Atmosphere
from tenstream_tpu_torch.core.types import ireals
from tenstream_tpu_torch.ops.delta_scale import delta_scale
from tenstream_tpu_torch.pprts.solver import PprtsSolver, Solution
from tenstream_tpu_torch.spectral.ecckd import EcckdGasOptics
from tenstream_tpu_torch.spectral.gasoptics import (
    GrayGasOptics,
    SpectralOptProps,
    SyntheticCKD,
    cloud_optprops,
)

_BACKENDS = {"gray": GrayGasOptics, "synthck": SyntheticCKD, "ecckd": EcckdGasOptics}
_UNPORTED_BACKENDS = {"rrtmg_sw": "M14", "repwvl": "M14"}


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


def _refuse_unported(solver, atm, specint, cld_frac, time, max_solution_err,
                     max_solution_time, buildings):
    if isinstance(specint, str) and specint in _UNPORTED_BACKENDS:
        raise NotImplementedError(f"gas optics {specint!r} is not ported "
                                  f"(ROADMAP {_UNPORTED_BACKENDS[specint]})")
    if solver.solver_type in ("2str", "schwarzschild", "disort"):
        raise NotImplementedError("the 1-D spectral path is not ported (ROADMAP M12)")
    if cld_frac is not None or atm.cfrac is not None:
        raise NotImplementedError("partial cloudiness (McICA, cld_frac) is not ported "
                                  "(ROADMAP M13)")
    if time is not None and max_solution_err > 0 and max_solution_time > 0:
        raise NotImplementedError("the adaptive spectral skip is not ported (ROADMAP M13)")
    if buildings is not None or solver._buildings is not None:
        raise NotImplementedError("buildings in specint_pprts are not ported yet "
                                  "(ROADMAP M10 remainder)")


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
    buildings=None,
    bands: Optional[Tuple[int, int]] = None,
) -> SpectralResult:
    """Full-spectrum solve on the solver's device.  The solver's grid
    z-axis must match atm.nlay; sun angles must be set for solar.

    `specint` is a backend name ("ecckd", "synthck", "gray") or a backend
    object (`EcckdGasOptics(n_gpt=32)`).  lwc/reliq/iwc/reice (nlay, nx,
    ny) default to the atmosphere's fields.  `bands=(lo, hi)` restricts
    the loop to g-points [lo, hi) (a partial spectral integral).

    Solver options read here: `specint_cache` (auto | f32 | bf16 | off |
    host), `specint_band_group` (regroup by difficulty, default on),
    `specint_band_seed` (seed a cold chunk from the previous chunk) and
    `specint_warm_extrapolate` (x0 = 2 x(t-1) - x(t-2), with the f32
    cache)."""
    _refuse_unported(solver, atm, specint, cld_frac, time, max_solution_err, max_solution_time,
                     buildings)
    backend = _BACKENDS[specint]() if isinstance(specint, str) else specint
    grid = solver.grid
    scheme = solver.scheme
    dev = solver.device
    nz, nx, ny = grid.nz, grid.nx, grid.ny
    nzs = solver.nz_solve  # results and warm states live on the solve grid
    if atm.nlay != nz:
        raise ValueError(f"atmosphere layers {atm.nlay} != grid nz {nz}")
    opts = solver.options
    tdev = lambda a: torch.as_tensor(np.asarray(a), dtype=ireals, device=dev)

    if lwc is None and atm.lwc is not None:
        lwc, reliq = atm.lwc, atm.reliq
    if iwc is None and atm.iwc is not None:
        iwc, reice = atm.iwc, atm.reice

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
        tau, w0, g = _merge_cloud(tau, w0, g, tc, wc, gc)
        if has_gpt_ice:
            ti, wi, gi = backend.ice_optprops_gpt(kind, iwc, reice_cells, dz3d, gsel=gsel)
            tau, w0, g = _merge_cloud(tau, w0, g, ti, wi, gi)
        if extra_tau is not None:
            # spectrally gray extra optical properties (aerosols, canopies)
            te = tdev(extra_tau)
            we = torch.zeros_like(te) if extra_w0 is None else tdev(extra_w0)
            ge = torch.zeros_like(te) if extra_g is None else tdev(extra_g)
            tau, w0, g = _merge_cloud(tau, w0, g, te[None], we[None], ge[None])
        return delta_scale(*_to_kfields(tau, w0, g, dz3d[None]))

    acc: Dict[str, torch.Tensor] = {}
    host_pending: List[tuple] = []

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
        # the grouping is frozen (chunk cache keys stay stable)
        group_opt = band_chunk > 1 and opts.get_bool("specint_band_group", True)
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
            r = solver.solve_lanes(has_planck, solar, kabs_b, ksca_b, g_b, a2d, planck=planck_b,
                                   planck_srfc=psrfc_b, edirTOA=toa_b, x0=x0, omega0=om0)
            del kabs_b, ksca_b, g_b, planck_b
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
            if r.edir is not None:
                add("edir", r.edir.sum(0))
            add("ediff_solar" if solar else "ediff_thermal", r.ediff.sum(0))
            add("abso_solar" if solar else "abso_thermal", r.abso.sum(0))

        # freeze the difficulty grouping from the first solve's per-band
        # iteration counts (a stable sort, as in the JAX package)
        if group_opt and order is None and group_niters:
            if sum(len(g) for g, _ in group_niters) == len(gids_all):
                nit = np.concatenate([np.asarray(n, np.float32) for _, n in group_niters])
                gid_cat = np.concatenate([g for g, _ in group_niters])
                solver._band_order[uid_tag] = gid_cat[np.argsort(nit, kind="stable")]
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
    return SpectralResult(edir, edn_s + edn_t, eup_s + eup_t, abso)
