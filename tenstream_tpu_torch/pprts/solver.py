"""The pprts solver driver: init / set optical properties / solve / result
(port of `tenstream_tpu/pprts/solver.py`, restricted to the 3-D solve).

One solve runs: coefficient assembly -> direct z-scan -> sources ->
BiCGStab with the two-level preconditioner -> Richardson polish ->
absorption.  The diffuse coefficients are stored per symmetry orbit
(`OrbitCoeff`) unless buildings are attached, `pprts_orbit_coeffs` is off
or the LUT is not symmetrized; then they are the dense (src, dst) field.
Whenever the solver's tensors are on the card the diffuse solve goes
through the CUDA kernels of `pprts/cuda_ops.py`: K1 and K2 on orbit
coefficients, K3 on dense ones.

Units: the solve works in [W] per stream dof (face-area scaled power);
`get_result` converts to [W/m2], with the TOA tilt factor sun.mu on solar
solutions only.  A combined solar+thermal request runs as two
sub-solves, recombined in `get_result`.

The solver lives on its grid's device (`Grid.create(..., device=...)`);
the `OptProp` has to be on the same device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.core.types import PI, TINY, ireals
from tenstream_tpu_torch.ops.delta_scale import delta_scale
from tenstream_tpu_torch.ops.twostream import delta_eddington_twostream
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.pprts.absorption import calc_flx_div
from tenstream_tpu_torch.pprts.buildings import (
    Buildings,
    building_incoming_from_fields,
    building_sources,
    face_masks,
    mask_coeffs,
)
from tenstream_tpu_torch.pprts.coeffs import assemble_coeffs, determine_1d_layers
from tenstream_tpu_torch.pprts.ediff import solve_bicgstab, solve_richardson
from tenstream_tpu_torch.pprts.edir import inner_iter_policy, solve_edir
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.operators import dir2diff_source, direct_surface_reflection
from tenstream_tpu_torch.pprts.sources import thermal_source
from tenstream_tpu_torch.pprts.sun import SunInfo, suninfo_from_sundir

# option -> ROADMAP item that ports it
_UNPORTED_BOOL_OPTIONS = {
    "pprts_geometric_coeffs": "M13",
}


def _twostream_guess(scheme, grid, kabs, ksca, g, albedo2d, mu0, incSolar,
                     planck=None, planck_srfc=None) -> torch.Tensor:
    """Cold-start guess for the diffuse solve from the exact two-stream
    column solution, in the solve's [W] units.

    Top stream dofs carry the per-column Edn/Eup split by hemisphere-bin
    weight; for "zsplit" side groups the (dn, up) halves carry the
    hemisphere flux of the matching vertical stream, other side styles the
    isotropic estimate."""
    kext = torch.clamp(kabs + ksca, min=TINY)
    _, Edn, Eup = delta_eddington_twostream(
        kext * grid.dz3d, ksca / kext, g, mu0, incSolar, albedo2d,
        planck=planck, planck_srfc=planck_srfc)  # (nz+1, nx, ny) [W/m2], untilted
    s = scheme
    inward = s.diff_inward()
    wtop = s.difftop_weights()
    wside = s.diffside_weights()
    nt, ns = s.difftop.dof, s.diffside.dof
    iso = 0.25 * (Edn[:-1] + Eup[:-1] + Edn[1:] + Eup[1:])
    dn_lay = 0.5 * (Edn[:-1] + Edn[1:])
    up_lay = 0.5 * (Eup[:-1] + Eup[1:])
    zsplit = s._side_style() == "zsplit"
    zeros_lvl = torch.zeros((1, grid.nx, grid.ny), dtype=ireals, device=kabs.device)
    rows = []
    for d in range(s.ndiff):
        if d < nt:
            rows.append((Edn if inward[d] else Eup) * (grid.az * float(wtop[d])))
        else:
            a = grid.dy if d < nt + ns else grid.dx
            j = (d - nt) % ns
            area = a * grid.dz3d / s.diffside.area_divider
            # zsplit bins [o_dn, i_dn, o_up, i_up]: the first half tracks
            # Eup, the second Edn
            F = (up_lay if j < ns // 2 else dn_lay) if zsplit else iso
            rows.append(torch.cat([F * area * float(wside[j]), zeros_lvl], dim=0))
    return torch.stack(rows, dim=0)


class Solution(NamedTuple):
    """Cached per-uid state; `ediff` warm-starts the next solve of the uid."""

    edir: Optional[torch.Tensor]  # [W]
    ediff: torch.Tensor  # [W]
    abso: torch.Tensor  # [W/m3]
    diff_omega: float
    niter_diff: int  # BiCGStab + polish iterations
    diff_res: float = 0.0  # final diffuse residual norm
    diff_tol: float = 0.0  # max(rtol * |b|, atol) it was checked against
    thermal: Optional["Solution"] = None  # thermal half of a solar+thermal request
    niter_bicgstab: int = 0
    niter_polish: int = 0
    host_syncs: int = 0  # device -> host scalar transfers of the diffuse solve


def _validate_optprops(fields: Dict[str, torch.Tensor]) -> None:
    """Input sanity checks (reference `src/pprts.F90:1831-1859`)."""
    for name, x in fields.items():
        if not bool(torch.isfinite(x).all()):
            raise ValueError(f"non-finite values in {name}")
        lo, hi = float(x.min()), float(x.max())
        if name != "g" and lo < 0.0:
            raise ValueError(f"negative values in {name} (min {lo:.3e})")
        if name == "g" and (lo < -1.0 or hi > 1.0):
            raise ValueError("asymmetry parameter g outside [-1,1]")


class PprtsSolver:
    """3-D solver for one stream scheme (3_10 on the main path)."""

    def __init__(self, grid: Grid, optprop: OptProp, options: Optional[Options] = None,
                 solver_type: Optional[str] = None):
        if optprop is None or (solver_type or optprop.scheme.name) in (
                "2str", "disort", "schwarzschild"):
            raise NotImplementedError(
                "the 1-D column solvers (2str, disort, schwarzschild) are not ported (ROADMAP M12)")
        if optprop.device != grid.device:
            raise ValueError(f"OptProp on {optprop.device}, grid on {grid.device}")
        self.grid = grid
        self.opp = optprop
        self.device = grid.device
        self.scheme = optprop.scheme
        self.solver_type = solver_type or self.scheme.name
        self.options = options or Options()
        for key, item in _UNPORTED_BOOL_OPTIONS.items():
            if self.options.get_bool(key, False):
                raise NotImplementedError(f"option {key} is not ported (ROADMAP {item})")
        if self.options.get_int("atm_collapse", 0) > 1:
            raise NotImplementedError(
                "atm_collapse is not ported (ROADMAP M10); it cannot combine with buildings or "
                "diff_guess_2str")
        if self.options.get("diff_solver", "bicgstab") not in ("bicgstab", "richardson"):
            raise ValueError("diff_solver must be 'bicgstab' or 'richardson', got "
                             f"{self.options.get('diff_solver')!r}")
        self.sun: Optional[SunInfo] = None
        self.solutions: Dict[Any, Solution] = {}
        self._pending_convergence: Dict[Any, Tuple[int, float, float]] = {}
        self._atm: Dict[str, Any] = {}
        self._l1d = determine_1d_layers(grid.dz3d, grid.dx,
                                        self.options.get_float("twostr_ratio", 2.0))
        self._buildings: Optional[Buildings] = None

    # ------------------------------------------------------------------
    def set_angles(self, sundir) -> None:
        self.sun = suninfo_from_sundir(sundir)

    def set_mesh(self, mesh) -> None:
        raise NotImplementedError("multi-device solves are not ported (ROADMAP M19)")

    def set_buildings(self, buildings: Optional[Buildings]) -> None:
        """Attach `pprts.buildings.Buildings` (None detaches); its tensors
        move to the solver's device.  Buildings force the dense
        coefficient form."""
        if buildings is not None:
            if tuple(buildings.solid.shape) != (self.grid.nz, self.grid.nx, self.grid.ny):
                raise ValueError(f"buildings.solid {tuple(buildings.solid.shape)} != grid "
                                 f"{(self.grid.nz, self.grid.nx, self.grid.ny)}")
            buildings = buildings.to(self.device)
        self._buildings = buildings

    def set_optical_properties(self, albedo: float, kabs, ksca, g, planck=None,
                               planck_srfc=None, albedo_2d=None,
                               ldelta_scaling: bool = True) -> None:
        """Store (optionally delta-scaled) optical properties.
        kabs/ksca/g: (Nz, Nx, Ny); planck: (Nz+1, Nx, Ny) [W/m2/sr]."""
        dev = self.device
        t = lambda a: None if a is None else torch.as_tensor(a, dtype=ireals, device=dev)
        kabs, ksca, g, planck, planck_srfc = map(t, (kabs, ksca, g, planck, planck_srfc))
        if self.options.get_bool("pprts_validate", True):
            fields = dict(kabs=kabs, ksca=ksca, g=g)
            if planck is not None:
                fields["planck"] = planck
            _validate_optprops(fields)
        if self.options.get_bool("pprts_delta_scale", ldelta_scaling):
            kabs, ksca, g = delta_scale(kabs, ksca, g)
        a2d = (torch.full((self.grid.nx, self.grid.ny), float(albedo), dtype=ireals, device=dev)
               if albedo_2d is None else t(albedo_2d))
        self._atm = dict(kabs=kabs, ksca=ksca, g=g, albedo2d=a2d, planck=planck,
                         planck_srfc=planck_srfc)

    # ------------------------------------------------------------------
    def _run(self, lthermal: bool, lsolar: bool, edirTOA: float,
             x0: Optional[torch.Tensor], omega0: float) -> Solution:
        """One mono solve: assembly, edir, sources, diffuse solve, absorption."""
        atm, scheme, grid, sun, opts = self._atm, self.scheme, self.grid, self.sun, self.options
        kabs, ksca, g, albedo2d = atm["kabs"], atm["ksca"], atm["g"], atm["albedo2d"]
        planck = atm["planck"]
        l1d = np.asarray(self._l1d, bool)
        precond = opts.get("diff_precond", "two_level")
        max_iter = opts.get_int("ksp_max_it", 3000)
        rtol = opts.get_float("ksp_rtol", 1e-5)
        atol = opts.get_float("ksp_atol", 1e-8)
        n_inner = opts.get_int("edir_inner_iter", 0)
        if n_inner <= 0:
            n_inner, edir_aitken, edir_cleanup = inner_iter_policy(
                float(sun.theta) if sun is not None else 0.0)
        else:
            edir_aitken = opts.get_bool("edir_aitken", False)
            edir_cleanup = opts.get_bool("edir_cleanup", True)

        guess_2str = opts.get_bool("diff_guess_2str", False)
        buildings = self._buildings
        # buildings mask single cells, which breaks the orbit symmetry
        orbit_coeffs = (opts.get_bool("pprts_orbit_coeffs", True) and buildings is None
                        and getattr(self.opp, "_solver_orbit_idx", None) is not None)
        # bf16 iteration coefficients: near-conservative transmissions lose
        # their last bits, and the error compounds over deep stacks of thin
        # 1-D layers, so it is off by default
        compress_coeffs = opts.get_bool("pprts_coeff_bf16", False)
        if compress_coeffs and orbit_coeffs:
            raise NotImplementedError(
                "pprts_coeff_bf16 on orbit coefficients is not ported: kernels K1 and K2 read "
                "float32 (ROADMAP K1/K2 bf16); it runs on dense coefficients "
                "(pprts_orbit_coeffs=False or buildings)")

        # per-layer (Nz, 1, 1) thickness keeps the aspect ratio per layer,
        # which lets the LUT lookup take the one-hot path
        dz3d = grid.dz[:, None, None] if grid.dz.dim() == 1 else grid.dz3d
        dz_full = dz3d.expand(grid.nz, grid.nx, grid.ny)
        coeffs, (a11, a12, _, _, _) = assemble_coeffs(
            scheme, self.opp, kabs, ksca, g, dz3d, grid.dx, l1d, sun, need_dir=lsolar,
            orbit=orbit_coeffs)
        if buildings is not None:
            coeffs = mask_coeffs(coeffs, buildings)

        edir = cdiv_dir = None
        b = torch.zeros((scheme.ndiff, grid.nz + 1, grid.nx, grid.ny), dtype=ireals,
                        device=self.device)
        sun_on = bool(lsolar and sun is not None and sun.sun_up)
        if sun_on:
            fac = edirTOA * grid.az / scheme.dirtop.area_divider
            inc = torch.full((scheme.dirtop.dof, grid.nx, grid.ny), fac, dtype=ireals,
                             device=self.device)
            edir = solve_edir(scheme, coeffs.dir2dir, inc, sun.xinc, sun.yinc,
                              n_inner=n_inner, aitken=edir_aitken, cleanup=edir_cleanup)
            b = b + dir2diff_source(scheme, coeffs.dir2diff, edir, sun.xinc, sun.yinc)
            b = b + direct_surface_reflection(scheme, edir, albedo2d)
            # reduced now, so the direct coefficient fields are freed
            # before the diffuse solve
            cdiv_dir = torch.clamp(1.0 - coeffs.dir2dir.sum(dim=1) - coeffs.dir2diff.sum(dim=1),
                                   0.0, 1.0)
        # sources and emissivities read the float32 blocks even when the
        # iteration's coefficients are compressed
        diff2diff_f32 = coeffs.diff2diff
        del coeffs
        diff2diff = diff2diff_f32.to(torch.bfloat16) if compress_coeffs else diff2diff_f32

        if buildings is not None:
            # emission is on with a static face Planck, or (thermal) with a
            # face temperature, whose per-band Planck the spectral
            # integration supplies; a mono solve has none and emits zero
            emit = buildings.planck is not None or (lthermal and buildings.temp is not None)
            planck_bldg = buildings.planck if buildings.planck is not None else (
                torch.zeros_like(dz_full) if emit else None)
            with_sun = sun is not None and lsolar
            b = b + building_sources(
                scheme, buildings, edir, grid.az, dz3d=grid.dz3d, dx=grid.dx, dy=grid.dy,
                xinc=sun.xinc if with_sun else 1, yinc=sun.yinc if with_sun else 1,
                planck=planck_bldg)

        b_th = None
        if lthermal and planck is not None:
            b_th = thermal_source(scheme, diff2diff_f32, planck, kabs, dz_full, grid.dx, grid.dy,
                                  albedo2d, l1d, planck_srfc=atm["planck_srfc"])
            b = b + b_th
        del diff2diff_f32

        if guess_2str and x0 is None:
            thermal = lthermal and planck is not None
            x0 = _twostream_guess(
                scheme, grid, kabs, ksca, g, albedo2d, sun.mu if sun_on else 0.5,
                edirTOA if sun_on else 0.0, planck=planck if thermal else None,
                planck_srfc=atm["planck_srfc"] if thermal else None)

        tol = max(rtol * float(torch.linalg.vector_norm(b)), atol)
        syncs = 1
        if opts.get("diff_solver", "bicgstab") == "bicgstab":
            ediff, niter_b, res, s = solve_bicgstab(
                scheme, diff2diff, b, albedo2d, x0=x0, rtol=rtol, atol=atol,
                maxiter=max_iter, precond=precond)
            # convergence-guaranteed polish: exits after one step when
            # BiCGStab already converged
            ediff, niter_p, omega, res_p, s2 = solve_richardson(
                scheme, diff2diff, b, albedo2d, x0=ediff, omega0=omega0, rtol=rtol,
                atol=atol, max_iter=max_iter, precond=precond, tol=tol)
            res = min(res, res_p)
            syncs += s + s2
        else:
            niter_b = 0
            ediff, niter_p, omega, res, s = solve_richardson(
                scheme, diff2diff, b, albedo2d, x0=x0, omega0=omega0, rtol=rtol,
                atol=atol, max_iter=max_iter, precond=precond)
            syncs += s

        abso = calc_flx_div(scheme, diff2diff, ediff, grid.volumes(), l1d, kabs, dz_full,
                            a11, a12, sun=sun, edir=edir, b_thermal=b_th, cdiv_dir=cdiv_dir)
        return Solution(edir, ediff, abso, omega, niter_b + niter_p, res, tol,
                        niter_bicgstab=niter_b, niter_polish=niter_p, host_syncs=syncs)

    def solve(self, lthermal: bool, lsolar: bool, edirTOA: float = 0.0, uid: Any = 0) -> Solution:
        """Run one (monochromatic / single-band) solve; `uid` keys the
        solution cache for warm starts."""
        if not self._atm:
            raise RuntimeError("call set_optical_properties first")
        if lsolar and self.sun is None:
            raise RuntimeError("call set_angles before a solar solve")
        lsolar_eff = bool(lsolar and self.sun.sun_up)
        lthermal_eff = bool(lthermal and self._atm["planck"] is not None)
        if lsolar_eff and lthermal_eff:
            sol_s = self._solve_mono(False, True, edirTOA, (uid, "solar"))
            sol_t = self._solve_mono(True, False, 0.0, (uid, "thermal"))
            sol = sol_s._replace(thermal=sol_t)
            self.solutions[uid] = sol
            return sol
        return self._solve_mono(lthermal, lsolar, edirTOA, uid)

    def _solve_mono(self, lthermal, lsolar, edirTOA, uid) -> Solution:
        prev = self.solutions.get(uid)
        x0 = prev.ediff.to(ireals) if prev is not None else None
        omega0 = prev.diff_omega if prev is not None else 1.0
        sol = self._run(lthermal, lsolar, float(edirTOA), x0, omega0)
        self._pending_convergence[uid] = (sol.niter_diff, sol.diff_res, sol.diff_tol)
        self.solutions[uid] = self._maybe_compress(sol)
        return sol

    def _maybe_compress(self, sol: Solution) -> Solution:
        """With `pprts_compress_solutions`, cached solutions are kept in
        bfloat16; warm starts and `get_result` read them as float32."""
        if not self.options.get_bool("pprts_compress_solutions", False):
            return sol
        cast = lambda a: None if a is None else a.to(torch.bfloat16)
        return sol._replace(edir=cast(sol.edir), ediff=cast(sol.ediff), abso=cast(sol.abso))

    def check_convergence(self, uid=None) -> None:
        """Raise for every pending solve whose residual is above 1.5 x its
        tolerance (reference abort-on-incomplete default); a no-op with
        accept_incomplete_solve=True."""
        if self.options.get_bool("accept_incomplete_solve", False):
            return
        max_it = self.options.get_int("ksp_max_it", 3000)
        keys = list(self._pending_convergence) if uid is None else (
            [uid] if uid in self._pending_convergence else [])
        failed = []
        for k in keys:
            niter, res, tol = self._pending_convergence.pop(k)
            if res > 1.5 * tol or not math.isfinite(res):
                failed.append(f"uid={k!r}: niter={niter}/max_it={max_it}, residual "
                              f"{res:.3e} vs tol {tol:.3e}")
        if failed:
            raise RuntimeError(
                "diffuse solve did not converge (" + "; ".join(failed) + "); set "
                "accept_incomplete_solve=True to tolerate")

    # ------------------------------------------------------------------
    def _scale_to_wm2(self, ndof: int, ntop: int, top_divider: float, side_dof: int,
                      side_divider: float) -> torch.Tensor:
        """1 / (face area per dof): converts [W] -> [W/m2]."""
        g = self.grid
        rows = []
        for d in range(ndof):
            if d < ntop:
                area = torch.full((g.nz + 1, g.nx, g.ny), g.az / top_divider, dtype=ireals,
                                  device=self.device)
            else:
                a = g.dy if d < ntop + side_dof else g.dx
                area = torch.cat([a * g.dz3d / side_divider,
                                  torch.ones((1, g.nx, g.ny), dtype=ireals, device=self.device)],
                                 dim=0)
            rows.append(1.0 / area)
        return torch.stack(rows, 0)

    def _dir_scale_to_wm2(self) -> torch.Tensor:
        s = self.scheme
        return self._scale_to_wm2(s.ndir, s.dirtop.dof, s.dirtop.area_divider,
                                  s.dirside.dof, s.dirside.area_divider)

    def _diff_scale_to_wm2(self) -> torch.Tensor:
        # the reference scales y-faces by difftop's divider
        # (`src/pprts.F90:3975`); like the JAX package we use diffside's
        s = self.scheme
        return self._scale_to_wm2(s.ndiff, s.difftop.dof, s.difftop.area_divider,
                                  s.diffside.dof, s.diffside.area_divider)

    def get_result(self, uid: Any = 0):
        """(edir, edn, eup, abso): fluxes in [W/m2] on the (Nz+1, Nx, Ny)
        levels and absorption in [W/m3]; edir is None for thermal-only."""
        self.check_convergence()
        sol = self.solutions[uid]
        s = self.scheme

        def extract(part: Solution):
            ediff_wm2 = part.ediff.to(ireals) * self._diff_scale_to_wm2()
            inward = s.diff_inward()
            edn = sum(ediff_wm2[d] for d in range(s.difftop.dof) if inward[d]) / s.difftop.area_divider
            eup = sum(ediff_wm2[d] for d in range(s.difftop.dof) if not inward[d]) / s.difftop.area_divider
            abso = part.abso.to(ireals)
            edir = None
            if part.edir is not None:
                edir_wm2 = part.edir.to(ireals) * self._dir_scale_to_wm2()
                edir = edir_wm2[: s.dirtop.dof].sum(0) / s.dirtop.area_divider
                mu = self.sun.mu  # TOA tilt rescale, solar solutions only
                edir, edn, eup, abso = edir * mu, edn * mu, eup * mu, abso * mu
            return edir, edn, eup, abso

        edir, edn, eup, abso = extract(sol)
        if sol.thermal is not None:
            _, edn_t, eup_t, abso_t = extract(sol.thermal)
            edn, eup, abso = edn + edn_t, eup + eup_t, abso + abso_t
        return edir, edn, eup, abso

    def get_building_fluxes(self, uid: Any = 0) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-face radiation on exposed building faces [W/m2]: dicts keyed
        by face kind ('roof', 'floor', 'wall_x_low', 'wall_x_high',
        'wall_y_low', 'wall_y_high') of (Nz, Nx, Ny) fields `edir`,
        `incoming`, `outgoing` that are nonzero on exposed faces of solid
        cells.  outgoing = albedo * incoming + (1 - albedo) * pi * B_face."""
        if self._buildings is None:
            raise RuntimeError("no buildings attached (set_buildings)")
        b, g, sol = self._buildings, self.grid, self.solutions[uid]
        masks = face_masks(b)
        zeros = lambda: torch.zeros((g.nz, g.nx, g.ny), dtype=ireals, device=self.device)
        edir_f = {k: zeros() for k in masks}
        incoming = {k: zeros() for k in masks}
        for part in (sol,) if sol.thermal is None else (sol, sol.thermal):
            mu = self.sun.mu if part.edir is not None else 1.0
            ef, inc = building_incoming_from_fields(
                self.scheme, b, part.ediff.to(ireals) * mu,
                None if part.edir is None else part.edir.to(ireals) * mu,
                g.az, g.dx, g.dy, g.dz3d,
                xinc=self.sun.xinc if self.sun is not None else 1,
                yinc=self.sun.yinc if self.sun is not None else 1)
            for k in masks:
                edir_f[k] = edir_f[k] + ef[k]
                incoming[k] = incoming[k] + inc[k]

        B_face = b.planck if b.planck is not None else 0.0
        out = {}
        for k, m in masks.items():
            zero = torch.zeros_like(incoming[k])
            outgoing = b.albedo * incoming[k] + (1.0 - b.albedo) * PI * B_face
            out[k] = dict(edir=torch.where(m, edir_f[k], zero),
                          incoming=torch.where(m, incoming[k], zero),
                          outgoing=torch.where(m, outgoing, zero))
        return out
