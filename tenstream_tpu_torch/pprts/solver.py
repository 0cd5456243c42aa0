"""The pprts solver driver: init / set optical properties / solve / result
(port of `tenstream_tpu/pprts/solver.py`).

The 1-D solver types ("2str", "schwarzschild", "disort") solve every
column at once through `pprts/oned.py` and `ops/disort.py` and need no
OptProp; what follows is the 3-D solve.

A solve runs on a chunk of B bands (lanes) at once, the counterpart of the
JAX package's `jax.vmap` of its solve program: (atm_collapse) ->
coefficient assembly -> direct z-scan -> sources -> BiCGStab with the
two-level preconditioner -> Richardson polish -> absorption, each stage
on the whole chunk (`solve_lanes`, which `specint_pprts` calls).  A
single-band `solve` is a chunk of one.  The diffuse coefficients are
stored per symmetry orbit (`OrbitCoeff`) unless buildings are attached,
`pprts_orbit_coeffs` is off or the LUT is not symmetrized; then they are
the dense (src, dst) field.  Whenever the solver's tensors are on the
card the diffuse solve goes through the CUDA kernels of
`pprts/cuda_ops.py`: K1 and K2 on orbit coefficients, K3 on dense ones.

With `atm_collapse` K the top K (1-D) layers fold into one super-layer
(reference `-atm_collapse`); states and results then live on the solve
grid of `nz_solve` layers.

Units: the solve works in [W] per stream dof (face-area scaled power);
`get_result` converts to [W/m2], with the TOA tilt factor sun.mu on solar
solutions only.  A combined solar+thermal request runs as two
sub-solves, recombined in `get_result`.

The solver lives on its grid's device (`Grid.create(..., device=...)`);
the `OptProp` has to be on the same device.

Decomposed over ranks (`set_mesh` with a `parallel.mesh.Mesh`, one
process per GPU) the solver is built on the global `Grid` and everything
it takes and gives per cell is the rank's (x, y) block, as each MPI rank
of the reference feeds its subdomain: `set_optical_properties` takes the
blocks that `parallel.mesh.scatter_global` / `shard_fields` return, and
`get_result` returns the rank's block (`parallel.mesh.gather_to_host`
assembles the global field).  Halos come from the neighbouring ranks, and
every convergence decision reads global residuals.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.config import Options
from tenstream_tpu_torch.core.types import PI, TINY, ireals
from tenstream_tpu_torch.ops.delta_scale import delta_scale
from tenstream_tpu_torch.ops.disort import disort_fluxes
from tenstream_tpu_torch.ops.eddington import eddington_coeff_ec
from tenstream_tpu_torch.ops.planck import b_eff
from tenstream_tpu_torch.ops.twostream import delta_eddington_twostream
from tenstream_tpu_torch.optprop.facade import OptProp
from tenstream_tpu_torch.parallel.mesh import check_mesh
from tenstream_tpu_torch.pprts.absorption import calc_flx_div
from tenstream_tpu_torch.pprts.buildings import (
    Buildings,
    building_incoming_from_fields,
    building_sources,
    face_masks,
    mask_coeffs,
)
from tenstream_tpu_torch.pprts.coeffs import (
    CoeffFields,
    assemble_coeffs,
    determine_1d_layers,
    fold_eddington_adding,
    fold_thermal_emission,
    onedee_blocks_collapsed,
)
from tenstream_tpu_torch.pprts.ediff import lane_norms, solve_bicgstab, solve_richardson
from tenstream_tpu_torch.pprts.edir import inner_iter_policy, solve_edir
from tenstream_tpu_torch.pprts.geometric import dir2dir_geometric, zlev_from_dz
from tenstream_tpu_torch.pprts.grid import Grid
from tenstream_tpu_torch.pprts.oned import solve_schwarzschild_columns, solve_twostream_columns
from tenstream_tpu_torch.pprts.operators import dir2diff_source, direct_surface_reflection
from tenstream_tpu_torch.pprts.sources import thermal_source
from tenstream_tpu_torch.pprts.sun import SunInfo, suninfo_from_sundir
from tenstream_tpu_torch.streams import get_scheme

_ONED_SOLVERS = ("2str", "schwarzschild", "disort")

# option -> ROADMAP item that ports it: a bool option raises when on, an
# integer option when it is set at all
_UNPORTED_BOOL_OPTIONS = {
    "debug_nans": "M4 remainder",
}
_UNPORTED_SET_OPTIONS = {
    # the JAX package's z-slab assembly only bounds memory; the port always
    # assembles in one call, with the same result
    "pprts_assembly_z_slab": "M4 remainder",
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


class LaneSolution(NamedTuple):
    """The result of a chunk of B bands: fields with a leading lane dim,
    per-lane lists of the solve's numbers."""

    edir: Optional[torch.Tensor]  # (B, ndir, nz_solve+1, Nx, Ny) [W]
    ediff: torch.Tensor  # (B, ndiff, nz_solve+1, Nx, Ny) [W]
    abso: torch.Tensor  # (B, nz_solve, Nx, Ny) [W/m3]
    omega: List[float]
    niter: List[int]  # BiCGStab + polish iterations
    res: List[float]
    tol: List[float]
    niter_bicgstab: List[int]
    niter_polish: List[int]
    host_syncs: int  # for the whole chunk


def _validate_optprops(fields: Dict[str, torch.Tensor], mesh=None) -> None:
    """Input sanity checks (reference `src/pprts.F90:1831-1859`); on a
    mesh over the whole domain, so that every rank raises or none."""
    for name, x in fields.items():
        bad = (~torch.isfinite(x)).any().float()
        stats = torch.stack([bad, -x.min(), x.max()])
        if mesh is not None:
            stats = mesh.all_reduce(stats, "max")
        bad, lo, hi = stats.tolist()
        if bad > 0:
            raise ValueError(f"non-finite values in {name}")
        lo = -lo
        if name != "g" and lo < 0.0:
            raise ValueError(f"negative values in {name} (min {lo:.3e})")
        if name == "g" and (lo < -1.0 or hi > 1.0):
            raise ValueError("asymmetry parameter g outside [-1,1]")


class PprtsSolver:
    """Solver driver.  `solver_type` selects the solver like the
    reference's `-solver` option: a stream scheme name ("3_10", ...) runs
    the 3-D solver on the OptProp's tables; "2str" runs delta-Eddington
    two-stream columns ("schwarzschild", or the option `schwarzschild`,
    takes the thermal part to Schwarzschild columns) and "disort" the
    multi-stream columns (`disort_streams` per hemisphere, default 8);
    the 1-D types need no OptProp."""

    def __init__(self, grid: Grid, optprop: Optional[OptProp] = None,
                 options: Optional[Options] = None, solver_type: Optional[str] = None):
        if optprop is not None and optprop.device != grid.device:
            raise ValueError(f"OptProp on {optprop.device}, grid on {grid.device}")
        self.grid = grid
        self.opp = optprop
        self.device = grid.device
        self.solver_type = solver_type or (optprop.scheme.name if optprop else "2str")
        if optprop is not None:
            self.scheme = optprop.scheme
        else:
            self.scheme = get_scheme("2str")
            if self.solver_type not in _ONED_SOLVERS:
                raise ValueError(f"solver_type {self.solver_type!r} needs an OptProp/LUT")
        self.options = options or Options()
        self._refuse_unported_options()
        self.sun: Optional[SunInfo] = None
        self.solutions: Dict[Any, Solution] = {}
        self._pending_convergence: Dict[Any, Tuple[int, float, float]] = {}
        self._atm: Dict[str, Any] = {}
        self._l1d = determine_1d_layers(grid.dz3d, grid.dx,
                                        self.options.get_float("twostr_ratio", 2.0))
        self._buildings: Optional[Buildings] = None
        self._oned_results: Dict[Any, tuple] = {}  # uid -> (S, edn, eup, abso) of a 1-D solve
        # `specint_pprts` state: the frozen difficulty order per spectrum,
        # each band's (chunk key, row), the x(t-1) of the extrapolation
        self._band_order: Dict[str, np.ndarray] = {}
        self._band_rows: Dict[str, Dict[int, Tuple[Any, int]]] = {}
        self._extrap_states: Dict[Any, torch.Tensor] = {}
        # the adaptive spectral skip: per chunk key, the host copies of the
        # last (edir, ediff, abso) contributions and the error tracker
        self._spectral_cache: Dict[Any, tuple] = {}
        self._spectral_trackers: Dict[Any, Any] = {}
        self._spectral_skips = 0
        self._mesh = None
        self.lgrid = grid  # this rank's block of the grid (the grid without a mesh)

    def _refuse_unported_options(self) -> None:
        """Raise for an option the port does not read (checked at
        construction and again at every solve, as options may be set
        later)."""
        for key, item in _UNPORTED_BOOL_OPTIONS.items():
            if self.options.get_bool(key, False):
                raise NotImplementedError(f"option {key} is not ported (ROADMAP {item})")
        for key, item in _UNPORTED_SET_OPTIONS.items():
            if key in self.options:
                raise NotImplementedError(f"option {key} is not ported (ROADMAP {item})")
        if self.options.get("diff_solver", "bicgstab") not in ("bicgstab", "richardson"):
            raise ValueError("diff_solver must be 'bicgstab' or 'richardson', got "
                             f"{self.options.get('diff_solver')!r}")

    # ------------------------------------------------------------------
    def set_angles(self, sundir) -> None:
        self.sun = suninfo_from_sundir(sundir)
        self._sundir_raw = torch.as_tensor(np.asarray(sundir), dtype=ireals, device=self.device)

    def set_terrain(self, h_srfc) -> None:
        """Surface height field (Nx, Ny) [m] of a terrain-following grid.
        With `pprts_geometric_coeffs` the direct transfer blocks of the
        3-D layers are computed on the tilted cells (`pprts/geometric.py`)."""
        self._h_srfc = torch.as_tensor(h_srfc, dtype=ireals, device=self.device)

    def set_mesh(self, mesh) -> None:
        """Decompose the solve over a `parallel.mesh.Mesh` (None undoes it):
        from here on the solver's fields are this rank's (x, y) block of
        the grid (`lgrid`), and the solution cache starts empty.  Raises
        without a process group whose backend takes the solver's tensors
        (NCCL or gloo on the card, gloo on the CPU), or where the layout
        does not divide the grid."""
        self.solutions.clear()
        self._pending_convergence.clear()
        if mesh is None:
            self._mesh, self.lgrid = None, self.grid
            return
        check_mesh(mesh, self.device)
        g = self.grid
        sx, sy = mesh.block(g.nx, g.ny)
        dz = g.dz if g.dz.dim() == 1 else g.dz[:, sx, sy].contiguous()
        self._mesh = mesh
        self.lgrid = Grid(g.nz, sx.stop - sx.start, sy.stop - sy.start, g.dx, g.dy, dz)

    def set_buildings(self, buildings: Optional[Buildings]) -> None:
        """Attach `pprts.buildings.Buildings` (None detaches); its tensors
        move to the solver's device.  Buildings force the dense
        coefficient form."""
        if buildings is not None:
            lg = self.lgrid
            if tuple(buildings.solid.shape) != (lg.nz, lg.nx, lg.ny):
                raise ValueError(f"buildings.solid {tuple(buildings.solid.shape)} != grid "
                                 f"{(lg.nz, lg.nx, lg.ny)}")
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
            _validate_optprops(fields, self._mesh)
        if self.options.get_bool("pprts_delta_scale", ldelta_scaling):
            kabs, ksca, g = delta_scale(kabs, ksca, g)
        a2d = (torch.full((self.lgrid.nx, self.lgrid.ny), float(albedo), dtype=ireals, device=dev)
               if albedo_2d is None else t(albedo_2d))
        self._atm = dict(kabs=kabs, ksca=ksca, g=g, albedo2d=a2d, planck=planck,
                         planck_srfc=planck_srfc)

    # ------------------------------------------------------------------
    @property
    def nz_solve(self) -> int:
        """Layers of the solve grid: grid.nz, less K - 1 with
        atm_collapse K (results and warm-start states live on it)."""
        K = self.options.get_int("atm_collapse", 0)
        return self.grid.nz - (K - 1 if K > 1 else 0)

    def _dz_solve(self) -> torch.Tensor:
        """dz3d on the solve grid (atm_collapse folds the top K layers
        into one)."""
        K = self.options.get_int("atm_collapse", 0)
        dz3 = self.lgrid.dz3d
        if K > 1:
            dz3 = torch.cat([dz3[:K].sum(0, keepdim=True), dz3[K:]], dim=0)
        return dz3

    def _collapse(self, K: int, lthermal: bool, lsolar: bool, kabs, ksca, g, planck, dz3d):
        """Fold the top K (1-D) layers into one super-layer by the exact
        adding method (reference `-atm_collapse`, `src/pprts.F90:685-705,
        2080-2198`).  Fields are (B, Nz, ...).  Returns the reduced
        (kabs, ksca, g, planck, dz3d), the folded set and, thermal, the
        super-layer's emission (top, bottom)."""
        sun = self.sun
        mu_c = float(sun.mu) if (lsolar and sun is not None and sun.sun_up) else 1.0
        kext_s = kabs[:, :K] + ksca[:, :K]
        tz_s = kext_s * dz3d[:K]
        w0_s = ksca[:, :K] / torch.clamp(kext_s, min=TINY)
        edd_s = eddington_coeff_ec(tz_s, w0_s, g[:, :K], mu_c)  # each (B, K, Nx, Ny)
        layer_first = lambda a: torch.movedim(a, 1, 0)
        folded = fold_eddington_adding(*map(layer_first, edd_s))
        emission = None
        if lthermal:
            # per-layer B_eff emission rows folded through the same exact
            # interface recursion, in-stack scattering included
            a11_s, a12_s = edd_s[0], edd_s[1]
            tau_abs = kabs[:, :K] * dz3d[:K]
            emis_s = torch.clamp(1.0 - a11_s - a12_s, 0.0, 1.0)
            bt = b_eff(planck[:, 1:K + 1], planck[:, :K], tau_abs) * emis_s
            bb = b_eff(planck[:, :K], planck[:, 1:K + 1], tau_abs) * emis_s
            emission = fold_thermal_emission(*map(layer_first, (a11_s, a12_s, bt, bb)))
        # the super-layer keeps the total optical depth; its blocks are
        # overwritten with the folded set after assembly
        dz0 = dz3d[:K].sum(0, keepdim=True)
        cat = lambda top, rest: torch.cat([top, rest], dim=1)
        kabs = cat((kabs[:, :K] * dz3d[:K]).sum(1, keepdim=True) / dz0, kabs[:, K:])
        ksca = cat((ksca[:, :K] * dz3d[:K]).sum(1, keepdim=True) / dz0, ksca[:, K:])
        g = cat(g[:, :1], g[:, K:])
        if planck is not None:
            planck = cat(planck[:, :1], planck[:, K:])
        return kabs, ksca, g, planck, torch.cat([dz0, dz3d[K:]], dim=0), folded, emission

    def solve_lanes(self, lthermal: bool, lsolar: bool, kabs, ksca, g, albedo2d,
                    planck=None, planck_srfc=None, edirTOA=None,
                    x0: Optional[torch.Tensor] = None, omega0=None,
                    planck_bldg=None) -> LaneSolution:
        """One solve of a chunk of B bands (lanes), the counterpart of the
        JAX package's `jax.vmap` of its solve program.

        kabs/ksca/g (B, Nz, Nx, Ny), already delta-scaled; albedo2d (Nx,
        Ny); planck (B, Nz+1, Nx, Ny) and planck_srfc (B, Nx, Ny) for a
        thermal solve; edirTOA (B,) per-lane TOA irradiance [W/m2] for a
        solar one; x0 (B, ndiff, nz_solve+1, Nx, Ny) and omega0 (B,) warm
        starts; planck_bldg (B, Nz, Nx, Ny) the building faces' per-lane
        Planck emission [W/m2/sr] of a thermal solve with `Buildings.temp`
        (the JAX package's 10th vmapped input).  Every stage runs on the
        whole chunk; the diffuse solve iterates each lane until it
        converges or stalls, then freezes it.
        """
        atm = dict(kabs=kabs, ksca=ksca, g=g, planck=planck, planck_srfc=planck_srfc,
                   planck_bldg=planck_bldg)
        dev = self.device
        for k, v in atm.items():
            if v is not None:
                atm[k] = torch.as_tensor(v, dtype=ireals, device=dev)
        nb = atm["kabs"].shape[0]
        toa = (torch.zeros(nb, dtype=ireals, device=dev) if edirTOA is None
               else torch.as_tensor(edirTOA, dtype=ireals, device=dev).reshape(nb))
        a2d = torch.as_tensor(albedo2d, dtype=ireals, device=dev)
        om0 = [1.0] * nb if omega0 is None else [float(o) for o in omega0]
        return self._run(lthermal, lsolar, atm, a2d, toa, x0, om0)

    def _run(self, lthermal: bool, lsolar: bool, atm: Dict[str, Any], albedo2d: torch.Tensor,
             edirTOA: torch.Tensor, x0: Optional[torch.Tensor], omega0) -> LaneSolution:
        """The solve of a chunk: (collapse), assembly, edir, sources,
        diffuse solve, absorption; fields carry a leading lane dim."""
        self._refuse_unported_options()
        scheme, grid, sun, opts = self.scheme, self.lgrid, self.sun, self.options
        mesh = self._mesh
        kabs, ksca, g, planck = atm["kabs"], atm["ksca"], atm["g"], atm["planck"]
        nb = kabs.shape[0]
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
        K = opts.get_int("atm_collapse", 0)
        folded = emission = None
        if K > 1:
            if not bool(l1d[:K].all()):
                raise ValueError(f"atm_collapse={K}: the collapsed region must be 1-D layers "
                                 "(reference forces l1d there, src/pprts.F90:703)")
            if buildings is not None:
                raise ValueError("atm_collapse cannot combine with buildings")
            if guess_2str:
                raise ValueError("atm_collapse cannot combine with diff_guess_2str")
            l1d = np.concatenate([[True], l1d[K:]])
            kabs, ksca, g, planck, dz3d, folded, emission = self._collapse(
                K, lthermal, lsolar, kabs, ksca, g, planck, dz3d)
        nz_r = dz3d.shape[0]
        dz_full = dz3d.expand(nz_r, grid.nx, grid.ny)

        coeffs, (a11, a12, _, _, _) = assemble_coeffs(
            scheme, self.opp, kabs, ksca, g, dz3d, grid.dx, l1d, sun, need_dir=lsolar,
            orbit=orbit_coeffs)
        if folded is not None:
            # the super-layer's analytic blocks become the adding-folded
            # (asymmetric) set
            dd0, df0, ff0 = onedee_blocks_collapsed(scheme, folded)
            ff = coeffs.diff2diff
            if orbit_coeffs:
                ff = ff.set_layer0(ff0)
            else:
                ff[..., 0, :, :] = ff0
            if coeffs.dir2dir is not None:
                coeffs.dir2dir[..., 0, :, :] = dd0
                coeffs.dir2diff[..., 0, :, :] = df0
            coeffs = CoeffFields(coeffs.dir2dir, coeffs.dir2diff, ff)
        if (opts.get_bool("pprts_geometric_coeffs", False) and lsolar and sun is not None
                and sun.sun_up and coeffs.dir2dir is not None and scheme.dirtop.dof == 1):
            # terrain-tilted analytic direct transport replaces the LUT's
            # dir2dir outside the 1-D layers
            zlev = zlev_from_dz(grid.dz3d, getattr(self, "_h_srfc", None))
            dd_geo = dir2dir_geometric(zlev, grid.dx, grid.dy, self._sundir_raw, kabs + ksca,
                                       mesh=mesh)
            mask = torch.as_tensor(l1d, device=self.device)[None, None, None, :, None, None]
            coeffs = CoeffFields(torch.where(mask, coeffs.dir2dir, dd_geo), coeffs.dir2diff,
                                 coeffs.diff2diff)
        if buildings is not None:
            coeffs = mask_coeffs(coeffs, buildings)

        edir = cdiv_dir = None
        b = torch.zeros((nb, scheme.ndiff, nz_r + 1, grid.nx, grid.ny), dtype=ireals,
                        device=self.device)
        sun_on = bool(lsolar and sun is not None and sun.sun_up)
        if sun_on:
            fac = edirTOA * grid.az / scheme.dirtop.area_divider
            inc = fac[:, None, None, None].expand(nb, scheme.dirtop.dof, grid.nx, grid.ny)
            edir = solve_edir(scheme, coeffs.dir2dir, inc.contiguous(), sun.xinc, sun.yinc,
                              n_inner=n_inner, aitken=edir_aitken, cleanup=edir_cleanup,
                              mesh=mesh)
            b = b + dir2diff_source(scheme, coeffs.dir2diff, edir, sun.xinc, sun.yinc, mesh)
            b = b + direct_surface_reflection(scheme, edir, albedo2d)
            # reduced now, so the direct coefficient fields are freed
            # before the diffuse solve
            cdiv_dir = torch.clamp(1.0 - coeffs.dir2dir.sum(dim=-4) - coeffs.dir2diff.sum(dim=-4),
                                   0.0, 1.0)
        # sources and emissivities read the float32 blocks even when the
        # iteration's coefficients are compressed
        diff2diff_f32 = coeffs.diff2diff
        del coeffs
        diff2diff = diff2diff_f32.to(torch.bfloat16) if compress_coeffs else diff2diff_f32

        if buildings is not None:
            # emission is on with a static face Planck, or (thermal) with a
            # face temperature, whose per-lane Planck the spectral
            # integration supplies; a mono solve has none and emits zero
            emit = buildings.planck is not None or (lthermal and buildings.temp is not None)
            planck_bldg = atm.get("planck_bldg")
            if planck_bldg is None:
                planck_bldg = buildings.planck if buildings.planck is not None else (
                    torch.zeros_like(dz_full) if emit else None)
            with_sun = sun is not None and lsolar
            # one call for the chunk: the face masks are built once, the
            # reflected beam and the emission carry the lane dim
            b = b + building_sources(
                scheme, buildings, edir, grid.az, dz3d=grid.dz3d, dx=grid.dx, dy=grid.dy,
                xinc=sun.xinc if with_sun else 1, yinc=sun.yinc if with_sun else 1,
                planck=planck_bldg if emit else None, mesh=mesh)

        b_th = None
        if lthermal and planck is not None:
            c_top, c_bot = (None, None) if emission is None else emission
            b_th = thermal_source(scheme, diff2diff_f32, planck, kabs, dz_full, grid.dx, grid.dy,
                                  albedo2d, l1d, planck_srfc=atm["planck_srfc"],
                                  collapse_btop=c_top, collapse_bbot=c_bot, mesh=mesh)
            b = b + b_th
        del diff2diff_f32

        if guess_2str and x0 is None:
            # the two-stream column guess, lane by lane (a cold-start
            # option of single-band solves; the collapse refuses it)
            thermal = lthermal and planck is not None
            ps = atm["planck_srfc"]
            x0 = torch.stack([_twostream_guess(
                scheme, grid, kabs[i], ksca[i], g[i], albedo2d, sun.mu if sun_on else 0.5,
                float(edirTOA[i]) if sun_on else 0.0, planck=planck[i] if thermal else None,
                planck_srfc=None if (ps is None or not thermal) else ps[i]) for i in range(nb)])

        tol = [max(rtol * q, atol) for q in lane_norms(b, mesh).tolist()]
        syncs = 1
        if opts.get("diff_solver", "bicgstab") == "bicgstab":
            ediff, niter_b, res, s = solve_bicgstab(
                scheme, diff2diff, b, albedo2d, x0=x0, rtol=rtol, atol=atol,
                maxiter=max_iter, precond=precond, mesh=mesh)
            # convergence-guaranteed polish: a lane that BiCGStab already
            # converged takes one step
            ediff, niter_p, omega, res_p, s2 = solve_richardson(
                scheme, diff2diff, b, albedo2d, x0=ediff, omega0=omega0, rtol=rtol,
                atol=atol, max_iter=max_iter, precond=precond, tol=tol, mesh=mesh)
            # NaN-propagating, as jnp.minimum: Python's min(a, nan) is a
            res = [math.nan if math.isnan(a) or math.isnan(c) else min(a, c)
                   for a, c in zip(res, res_p)]
            syncs += s + s2
        else:
            niter_b = [0] * nb
            ediff, niter_p, omega, res, s = solve_richardson(
                scheme, diff2diff, b, albedo2d, x0=x0, omega0=omega0, rtol=rtol,
                atol=atol, max_iter=max_iter, precond=precond, mesh=mesh)
            syncs += s

        abso = calc_flx_div(scheme, diff2diff, ediff, dz_full * grid.az, l1d, kabs, dz_full,
                            a11, a12, sun=sun, edir=edir, b_thermal=b_th, cdiv_dir=cdiv_dir,
                            mesh=mesh)
        return LaneSolution(edir, ediff, abso, omega, [a + c for a, c in zip(niter_b, niter_p)],
                            res, tol, niter_b, niter_p, syncs)

    def solve(self, lthermal: bool, lsolar: bool, edirTOA: float = 0.0, uid: Any = 0) -> Solution:
        """Run one (monochromatic / single-band) solve; `uid` keys the
        solution cache for warm starts."""
        if not self._atm:
            raise RuntimeError("call set_optical_properties first")
        if lsolar and self.sun is None:
            raise RuntimeError("call set_angles before a solar solve")
        if self.solver_type in _ONED_SOLVERS:
            return self._solve_1d(lthermal, lsolar, edirTOA, uid)
        lsolar_eff = bool(lsolar and self.sun.sun_up)
        lthermal_eff = bool(lthermal and self._atm["planck"] is not None)
        if lsolar_eff and lthermal_eff:
            sol_s = self._solve_mono(False, True, edirTOA, (uid, "solar"))
            sol_t = self._solve_mono(True, False, 0.0, (uid, "thermal"))
            sol = sol_s._replace(thermal=sol_t)
            self.solutions[uid] = sol
            return sol
        return self._solve_mono(lthermal, lsolar, edirTOA, uid)

    def _solve_1d(self, lthermal, lsolar, edirTOA, uid) -> Solution:
        """The column solvers (reference `src/pprts.F90:2606-2652` through
        `src/pprts_1D_solvers.F90`): fluxes in horizontal [W/m2], kept per
        uid for `get_result`."""
        atm, g = self._atm, self.lgrid
        dz3d = g.dz3d
        sun_on = bool(lsolar and self.sun is not None and self.sun.sun_up)
        thermal_on = bool(lthermal and atm["planck"] is not None)
        lvl = lambda: torch.zeros((g.nz + 1, g.nx, g.ny), dtype=ireals, device=self.device)
        S = None
        if self.solver_type == "disort":
            kext = atm["kabs"] + atm["ksca"]
            dtau = kext * dz3d
            w0 = atm["ksca"] / torch.clamp(kext, min=TINY)
            nstr = self.options.get_int("disort_streams", 8)
            edn, eup = lvl(), lvl()
            if sun_on:
                S_t, edn_s, eup_s = disort_fluxes(dtau, w0, atm["g"], self.sun.mu, float(edirTOA),
                                                  atm["albedo2d"], nstreams=nstr)
                # S is in tilted-plane units, the diffuse fluxes horizontal
                S = S_t * self.sun.mu
                edn, eup = edn + edn_s, eup + eup_s
            if thermal_on:
                _, edn_t, eup_t = disort_fluxes(dtau, w0, atm["g"], None, 0.0, atm["albedo2d"],
                                                planck=atm["planck"],
                                                planck_srfc=atm["planck_srfc"], nstreams=nstr)
                edn, eup = edn + edn_t, eup + eup_t
            net = (edn - eup) + (S if S is not None else 0.0)
            abso = (net[:-1] - net[1:]) / dz3d
        else:
            edn = eup = None
            abso = torch.zeros((g.nz, g.nx, g.ny), dtype=ireals, device=self.device)
            if sun_on:
                S, edn_s, eup_s, abso_s = solve_twostream_columns(
                    atm["kabs"], atm["ksca"], atm["g"], dz3d, self.sun.mu, float(edirTOA),
                    atm["albedo2d"])
                # tilted -> horizontal units here, so that thermal fluxes
                # (absolute units) add in the same solve
                mu = self.sun.mu
                S, edn, eup, abso = S * mu, edn_s * mu, eup_s * mu, abso + abso_s * mu
            if thermal_on:
                if self.options.get_bool("schwarzschild", self.solver_type == "schwarzschild"):
                    edn_t, eup_t, abso_t = solve_schwarzschild_columns(
                        atm["kabs"], dz3d, atm["albedo2d"], atm["planck"],
                        planck_srfc=atm["planck_srfc"])
                else:
                    _, edn_t, eup_t, abso_t = solve_twostream_columns(
                        atm["kabs"], atm["ksca"], atm["g"], dz3d, -1.0, 0.0, atm["albedo2d"],
                        planck=atm["planck"], planck_srfc=atm["planck_srfc"])
                edn = edn_t if edn is None else edn + edn_t
                eup = eup_t if eup is None else eup + eup_t
                abso = abso + abso_t
            if edn is None:
                edn, eup = lvl(), lvl()
        self._oned_results[uid] = (S, edn, eup, abso)
        sol = Solution(S, edn, abso, 1.0, 0)
        self.solutions[uid] = sol
        return sol

    def _solve_mono(self, lthermal, lsolar, edirTOA, uid) -> Solution:
        """A single band: a chunk of one lane."""
        prev = self.solutions.get(uid)
        x0 = prev.ediff.to(ireals)[None] if prev is not None else None
        omega0 = prev.diff_omega if prev is not None else 1.0
        atm = self._atm
        lane = lambda a: None if a is None else a[None]
        r = self._run(lthermal, lsolar,
                      dict(kabs=lane(atm["kabs"]), ksca=lane(atm["ksca"]), g=lane(atm["g"]),
                           planck=lane(atm["planck"]), planck_srfc=lane(atm["planck_srfc"])),
                      atm["albedo2d"],
                      torch.full((1,), float(edirTOA), dtype=ireals, device=self.device),
                      x0, [omega0])
        sol = Solution(None if r.edir is None else r.edir[0], r.ediff[0], r.abso[0],
                       r.omega[0], r.niter[0], r.res[0], r.tol[0],
                       niter_bicgstab=r.niter_bicgstab[0], niter_polish=r.niter_polish[0],
                       host_syncs=r.host_syncs)
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
            # a band chunk records per-lane lists; every lane is held to
            # its own tolerance
            per_lane = zip(*(v if isinstance(v, (list, tuple)) else [v] for v in (niter, res, tol)))
            for lane, (n, r, t) in enumerate(per_lane):
                if r > 1.5 * t or not math.isfinite(r):
                    name = f"uid={k!r}" + (f" lane {lane}" if isinstance(res, (list, tuple)) else "")
                    failed.append(f"{name}: niter={n}/max_it={max_it}, residual "
                                  f"{r:.3e} vs tol {t:.3e}")
        if failed:
            raise RuntimeError(
                "diffuse solve did not converge (" + "; ".join(failed) + "); set "
                "accept_incomplete_solve=True to tolerate")

    # ------------------------------------------------------------------
    def _scale_to_wm2(self, ndof: int, ntop: int, top_divider: float, side_dof: int,
                      side_divider: float) -> torch.Tensor:
        """1 / (face area per dof): converts [W] -> [W/m2]."""
        g = self.lgrid
        dz3 = self._dz_solve()
        rows = []
        for d in range(ndof):
            if d < ntop:
                area = torch.full((self.nz_solve + 1, g.nx, g.ny), g.az / top_divider,
                                  dtype=ireals, device=self.device)
            else:
                a = g.dy if d < ntop + side_dof else g.dx
                area = torch.cat([a * dz3 / side_divider,
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
        levels and absorption in [W/m3]; edir is None for thermal-only.  On
        a mesh, the rank's block."""
        if self.solver_type in _ONED_SOLVERS:
            return self._oned_results[uid]
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
        b, g, sol = self._buildings, self.lgrid, self.solutions[uid]
        masks = face_masks(b, self._mesh)
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
                yinc=self.sun.yinc if self.sun is not None else 1, mesh=self._mesh)
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
