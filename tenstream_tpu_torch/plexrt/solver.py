"""TenStream solve on the structured extruded-triangle grid (port of
`tenstream_tpu/plexrt/solver.py`; reference `plexrt/plex_rt.F90`: direct
sweep `create_edir_mat`:2579, diffuse solve `solve_plex_rt`:2408, sources
`create_edir_src_vec`:1547 / `create_ediff_src_vec`:1795, absorption
:3547-3953, results `plexrt_get_result`:4179).

Fields live on the structured (orientation, ix, iy) axes
(`plexrt.mesh`); a neighbour exchange is `torch.roll`, the transfer
operator a per-cell (src x dst) contraction, the direct solve a sweep
over layers with `n_inner` side-exchange sweeps each, the diffuse solve
BiCGStab on A(x) = x - S(x) (`ops/krylov.py`, the default) or the plain
fixed point.  Both orientations read the same canonical wedge table (the
rotated triangle at phi + 180).  Stream states are in [W]; `get_result`
converts to W/m2 on the triangle areas.

Decomposed (`set_mesh`): the fish mesh's trailing (nx, ny) axes split
into the (x, y) blocks of a `parallel.mesh.Mesh`, as the cube solver's;
every roll across x or y becomes a halo exchange of the rank's block
(all planes of one step in one exchange), and the diffuse iteration's
sums are all-reduced, so each rank feeds and reads its block.

Lanes: `solve_lanes` solves a leading batch of independent
monochromatic problems (the g-points of a spectral chunk) in one pass of
every step, each lane with its own convergence, as the JAX package's
`jax.vmap` of `solve` does.  `solve` is a chunk of one.

State layout (B lanes)
  edir  : (B, nz+1, 2, nx, ny)        through the z-faces
  ediff z-faces E: (B, 2, nz+1, 2, nx, ny)   dof 0 Edn, dof 1 Eup
  ediff side faces F: (B, 4, nz, 3, nx, ny) on the T0 owner,
        dofs [to-T1 dn, to-T1 up, to-T0 dn, to-T0 up]
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tenstream_tpu_torch.core.types import PI, TINY, ireals
from tenstream_tpu_torch.ops.krylov import bicgstab_tree
from tenstream_tpu_torch.ops.planck import b_eff
from tenstream_tpu_torch.parallel.mesh import check_mesh
from tenstream_tpu_torch.plexrt.mesh import SIDE_OFFSETS, PlexGrid, roll2_many
from tenstream_tpu_torch.plexrt.optprop import NDIFF, WedgeOptProp


class PlexSolution(NamedTuple):
    edir: Optional[torch.Tensor]  # (nz+1, 2, nx, ny) [W] through z-faces
    edn: torch.Tensor  # (nz+1, 2, nx, ny) [W]
    eup: torch.Tensor
    abso: torch.Tensor  # (nz, 2, nx, ny) [W/m3]
    # diffuse-solve convergence: ints / floats from `solve`, (B,) tensors
    # from `solve_lanes`
    niter_diff: Any = 0
    diff_res: Any = 0.0
    diff_tol: Any = 0.0


def contract(v: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """out[d] = sum_s v[s] C[s, d] per cell: v (S, ...), C (S, D, ...) ->
    (D, ...), one multiply-add of a (D, ...) field per source (no (S, D,
    ...) temporary)."""
    out = C[0] * v[0]
    for s in range(1, v.shape[0]):
        out.addcmul_(C[s], v[s])
    return out


def _lane_sum(a: torch.Tensor) -> torch.Tensor:
    """Per-lane sum of squares, (B,)."""
    return (a * a).sum(dim=tuple(range(1, a.dim())))


def iterate_diffuse(G_for, E0, F0, solver: str, max_iter: int, rtol: float, reduce=None):
    """Drive the affine diffuse map G((E, F)) = S(E, F) + b (lanes
    leading) to convergence.  `G_for(lanes)` gives G on a subset of the
    lanes (an index tensor; None: all of them).  `reduce` sums per-lane
    partial sums over the ranks of a decomposed state, so that every rank
    reads the same sums and a lane leaves the batch on every rank in the
    same step.

    'fixedpoint': x <- G(x) until the update norm falls below rtol times
    the state norm (the reference's explicit-SOR analogue); a lane that
    stops leaves the batch, so later steps run on the lanes still going.
    'bicgstab': matrix-free Krylov on A(x) = x - S(x) = b with b = G(0)
    (reference KSPFBCGS, `plexrt/plex_rt.F90:2228`).  Returns (E, F,
    niter, res, tol), the last three (B,) tensors."""
    if solver == "bicgstab":
        G = G_for(None)
        bvec = G((torch.zeros_like(E0), torch.zeros_like(F0)))

        def A(x):
            GE, GF = G(x)
            return (x[0] - GE + bvec[0], x[1] - GF + bvec[1])

        (E, F), niter, res, tol = bicgstab_tree(A, bvec, x0=(E0, F0), rtol=rtol, atol=1e-8,
                                                maxiter=max_iter, reduce=reduce)
        return E, F, niter, res, tol
    if solver != "fixedpoint":
        raise ValueError(f"unknown diff_solver {solver!r} (bicgstab | fixedpoint)")

    nb, dev = E0.shape[0], E0.device
    E_out, F_out = E0.clone(), F0.clone()
    res_out = torch.full((nb,), float("inf"), dtype=ireals, device=dev)
    it_h = [0] * nb
    live = list(range(nb)) if max_iter > 0 else []  # lanes still iterating, in batch order
    G, E, F = G_for(None), E0, F0
    while live:
        E2, F2 = G((E, F))
        sums = torch.stack([_lane_sum(E2 - E) + _lane_sum(F2 - F), _lane_sum(E2) + _lane_sum(F2)])
        sums = sums if reduce is None else reduce(sums)
        res2 = torch.sqrt(sums[0])
        cont = res2 > rtol * torch.clamp(torch.sqrt(sums[1]), min=1e-10)
        cont_h = cont.tolist()  # the step's one host sync
        keep = []
        for j, lane in enumerate(live):
            it_h[lane] += 1
            if it_h[lane] < max_iter and cont_h[j]:
                keep.append(j)
        if len(keep) < len(live):
            done = torch.as_tensor([j for j in range(len(live)) if j not in keep], device=dev)
            lanes = torch.as_tensor([live[j] for j in done.tolist()], device=dev)
            E_out[lanes], F_out[lanes], res_out[lanes] = E2[done], F2[done], res2[done]
            live = [live[j] for j in keep]
            if live:
                kept = torch.as_tensor(keep, device=dev)
                E2, F2 = E2[kept], F2[kept]
                G = G_for(torch.as_tensor(live, device=dev))
        E, F = E2, F2
    norm2 = _lane_sum(E_out) + _lane_sum(F_out)
    tol = rtol * torch.clamp(torch.sqrt(norm2 if reduce is None else reduce(norm2)), min=1e-10)
    niter = torch.as_tensor(it_h, dtype=torch.int64, device=dev)
    return E_out, F_out, niter, res_out, tol


class WedgeSolverBase:
    """What both wedge solvers share: sun, optical properties, the solve
    sequence over lanes and the results.  Subclasses give the mesh
    (`_coeffs`, `_solve_edir`, `_sources`, `_diff_op`, `_diff_divergence`,
    `cell_shape`, `_state_zeros`, `_volumes`, `areas`)."""

    def __init__(self, opp: WedgeOptProp, n_inner: int, diff_iters: int, diff_rtol: float,
                 diff_solver: str, device):
        self.opp = opp
        self.device = opp.device if device is None else torch.device(device)
        self.n_inner = n_inner
        self.diff_iters = diff_iters
        self.diff_rtol = diff_rtol
        self.diff_solver = diff_solver
        self._sundir = None
        self._albedo = 0.0
        self._kabs = self._ksca = self._g = self._planck = self._planck_srfc = None
        self._pmesh = None

    def _attach(self, mesh) -> None:
        """Check and keep the `parallel.mesh.Mesh` of `set_mesh`."""
        if mesh is not None:
            check_mesh(mesh, self.device)
        self._pmesh = mesh

    def cell_dz(self) -> torch.Tensor:
        """Every cell's layer thickness [m], in this rank's `cell_shape`."""
        shape = self.cell_shape()
        return self._dz.reshape((shape[0],) + (1,) * (len(shape) - 1)) * torch.ones(
            shape, dtype=ireals, device=self.device)

    def _reduce(self):
        """The sum over the ranks of per-lane partial sums (None undecomposed)."""
        return None if self._pmesh is None else self._pmesh.all_reduce

    def set_angles(self, sundir) -> None:
        self._sundir = np.asarray(sundir, np.float64)

    def _t(self, a):
        return None if a is None else torch.as_tensor(a, dtype=ireals, device=self.device)

    def set_optical_properties(self, albedo, kabs, ksca, g, planck=None, planck_srfc=None):
        self._albedo = albedo
        self._kabs, self._ksca, self._g = self._t(kabs), self._t(ksca), self._t(g)
        self._planck, self._planck_srfc = self._t(planck), self._t(planck_srfc)

    def _sun_angles(self) -> Tuple[float, float, float]:
        s = self._sundir / np.linalg.norm(self._sundir)
        theta = float(np.rad2deg(np.arccos(np.clip(-s[2], -1.0, 1.0))))
        phi = float(np.rad2deg(np.arctan2(s[0], s[1])))  # photon azimuth
        mu = float(max(-s[2], 1e-6))
        return phi, theta, mu

    def _mu(self) -> torch.Tensor:
        sd = np.asarray(self._sundir, np.float64)
        return torch.tensor(abs(sd[2]) / np.linalg.norm(sd), dtype=ireals)

    def solve(self, lthermal: bool, lsolar: bool, edirTOA: float = 0.0):
        """Monochromatic solve of the stored optical properties; edirTOA is
        the beam's irradiance on the horizontal plane at TOA [W/m2]."""
        lane = lambda a: None if a is None else a[None]
        toa = torch.tensor([edirTOA], dtype=torch.float64)
        sol = self.solve_lanes(lthermal, lsolar, lane(self._kabs), lane(self._ksca),
                               lane(self._g), self._albedo, planck=lane(self._planck),
                               planck_srfc=lane(self._planck_srfc), edirTOA=toa)
        first = lambda a: None if a is None else a[0]
        return sol._replace(edir=first(sol.edir), edn=sol.edn[0], eup=sol.eup[0],
                            abso=sol.abso[0], niter_diff=int(sol.niter_diff[0]),
                            diff_res=float(sol.diff_res[0]), diff_tol=float(sol.diff_tol[0]))

    def solve_lanes(self, lthermal: bool, lsolar: bool, kabs, ksca, g, albedo, planck=None,
                    planck_srfc=None, edirTOA=None):
        """B independent solves at once: kabs/ksca/g (B,) + cell shape,
        planck (B,) + level shape, edirTOA (B,).  Returns a solution whose
        fields lead with B and whose niter / res / tol are (B,) tensors."""
        f = dict(kabs=self._t(kabs), ksca=self._t(ksca), g=self._t(g), planck=self._t(planck),
                 planck_srfc=self._t(planck_srfc))
        nb = f["kabs"].shape[0]
        need_dir = bool(lsolar and self._sundir is not None and -self._sundir[2] > 1e-6)
        f2f, d2d, d2f = self._coeffs(f, need_dir)

        edir = sides = None
        dir_net = torch.zeros((nb,) + self.cell_shape(), dtype=ireals, device=self.device)
        if need_dir:
            toa = torch.as_tensor(0.0 if edirTOA is None else edirTOA, dtype=torch.float64)
            toa = toa.expand(nb).to(self.device) if toa.dim() == 0 else toa.to(self.device)
            edir, dir_net, sides = self._solve_edir(d2d, toa)[:3]
        del d2d
        bE, bF = self._state_zeros(nb)
        if need_dir or lthermal:
            self._sources(bE, bF, f2f, d2f if need_dir else None, sides, edir, f, albedo)
        del d2f, sides
        dir_sfc = (edir[:, -1] if edir is not None else
                   torch.zeros((nb,) + self.cell_shape()[1:], dtype=ireals, device=self.device))

        def G_for(lanes):
            if lanes is None:
                ff, b, ds = f2f, (bE, bF), dir_sfc
            else:
                ff, b, ds = f2f.index_select(2, lanes), (bE[lanes], bF[lanes]), dir_sfc[lanes]
            return lambda x: self._diff_op(ff, x[0], x[1], b, albedo, ds)

        E, F, niter, res, tol = iterate_diffuse(G_for, *self._state_zeros(nb), self.diff_solver,
                                                self.diff_iters, self.diff_rtol, self._reduce())
        diff_net = self._diff_divergence(E, F, bE, bF, f2f)
        abso = (dir_net + diff_net) / self._volumes()
        return PlexSolution(edir, E[:, 0], E[:, 1], abso, niter_diff=niter, diff_res=res,
                            diff_tol=tol)

    def get_result(self, sol: PlexSolution):
        """(edir, edn, eup, abso) in W/m2 / W/m3 per triangle column."""
        a = self.areas()
        edir = None if sol.edir is None else sol.edir / a
        return edir, sol.edn / a, sol.eup / a, sol.abso


# Direct-stream bookkeeping per wedge scheme (the diffuse side, 8
# streams, is the same for both; reference `src/boxmc_wedge_18_8.inc`).
#   n_top: streams per z-face (1 whole face | 3 corner quads)
#   n_q: streams per side face (1 | 4 quads)
#   bot_dst: bottom-exit dir dofs, corner-ordered so that layer k's bottom
#            stream feeds the same corner's top stream of k+1
#   u_flip: quad permutation under the 180-degree partner rotation
_DIR_CFG = {
    "5_8": dict(n_top=1, n_q=1, side0=1, bot_dst=(4,), u_flip=(0,)),
    "18_8": dict(n_top=3, n_q=4, side0=3, bot_dst=(15, 16, 17), u_flip=(1, 0, 3, 2)),
}


class PlexrtSolver(WedgeSolverBase):
    """Monochromatic wedge-mesh solver on a `PlexGrid` (wedge_5_8 or
    wedge_18_8: the scheme follows the optprop tables).  `device`
    defaults to the tables' device.  `grid` is the global grid, `lgrid`
    this rank's block of it (the grid itself undecomposed)."""

    def __init__(self, grid: PlexGrid, opp: WedgeOptProp, n_inner: int = 24,
                 diff_iters: int = 300, diff_rtol: float = 1e-5,
                 diff_solver: str = "bicgstab", device=None):
        super().__init__(opp, n_inner, diff_iters, diff_rtol, diff_solver, device)
        self.grid = self.lgrid = grid
        self.scheme = getattr(opp.lut, "scheme", "5_8")
        if self.scheme not in _DIR_CFG:
            raise ValueError(f"unsupported wedge solver scheme {self.scheme}")
        self._dcfg = _DIR_CFG[self.scheme]
        self._dz = torch.as_tensor(grid.dz, dtype=ireals, device=self.device)

    def set_mesh(self, mesh) -> None:
        """Decompose the solve over a `parallel.mesh.Mesh` (None undoes it):
        from here on every field is this rank's (x, y) block of the trailing
        (nx, ny) axes (`Mesh.block`, the JAX package's `P(..., "x", "y")`),
        in `set_optical_properties`, `solve_lanes` and the results."""
        self._attach(mesh)
        g = self.grid
        if mesh is None:
            self.lgrid = g
            return
        sx, sy = mesh.block(g.nx, g.ny)
        self.lgrid = PlexGrid.create(g.nz, sx.stop - sx.start, sy.stop - sy.start, g.dx, g.dy,
                                     g.dz)

    def _rolls(self, items):
        """`roll2` of each (a, di, dj) item, on a mesh in one halo exchange."""
        return roll2_many(items, self._pmesh)

    def cell_shape(self):
        """This rank's cell shape (nz, 2, nx, ny)."""
        g = self.lgrid
        return (g.nz, 2, g.nx, g.ny)

    def _state_zeros(self, nb):
        g = self.lgrid
        z = lambda *s: torch.zeros((nb,) + s, dtype=ireals, device=self.device)
        return z(2, g.nz + 1, 2, g.nx, g.ny), z(4, g.nz, 3, g.nx, g.ny)

    def _volumes(self):
        return torch.as_tensor(self.lgrid.volumes(), dtype=ireals, device=self.device)

    def areas(self):
        """A triangle column's area [m2]."""
        return self.lgrid.area_tri

    def _coeffs(self, f, need_dir: bool):
        """Channels-first (src, dst, B, nz, 2, nx, ny) coefficient fields."""
        g = self.lgrid
        dz3 = self._dz[:, None, None, None]
        kext = f["kabs"] + f["ksca"]
        tauz = kext * dz3
        w0 = f["ksca"] / torch.clamp(kext, min=TINY)
        aspect = dz3 / float(np.float32(g.dx))
        f2f = self.opp.diff_coeffs(tauz, w0, f["g"], aspect)
        d2d = d2f = None
        if need_dir:
            phi, theta, _ = self._sun_angles()
            # orientation 1 is the 180-degree rotated triangle
            phi_cell = (torch.tensor(phi, dtype=ireals) + torch.tensor(
                [0.0, 180.0], dtype=ireals)[:, None, None]).to(self.device)
            d2d, d2f = self.opp.dir_coeffs(tauz, w0, f["g"], aspect, phi_cell, theta)
        return f2f, d2d, d2f

    def _solve_edir(self, d2d, toa):
        """Layer sweep top -> bottom with `n_inner` side-exchange sweeps
        per layer.  Returns edir through the z-faces (B, nz+1, 2, nx, ny),
        the per-cell net direct deposition (B, nz, 2, nx, ny) and every
        layer's full source vector (nsrc, B, nz, 2, nx, ny)."""
        g = self.lgrid
        cfg = self._dcfg
        n_top, n_q, side0, u_flip = cfg["n_top"], cfg["n_q"], cfg["side0"], cfg["u_flip"]
        nb = toa.shape[0]
        # TOA source: the beam on the horizontal top faces,
        # E0 * area * mu (`plexrt/plex_rt.F90:1617-1623`); 18_8 splits the
        # top face into 3 corner quads of equal area
        val = (toa * g.area_tri / n_top).to(ireals) * self._mu().to(self.device)
        top = val[None, :, None, None, None].expand(n_top, nb, 2, g.nx, g.ny)
        top0 = top
        bots, nets, vs = [], [], []
        for k in range(g.nz):
            C = d2d[:, :, :, k]  # (nsrc, ndir, B, 2, nx, ny)
            I = torch.zeros((3 * n_q, nb, 2, g.nx, g.ny), dtype=ireals, device=self.device)
            for it in range(self.n_inner + 1):
                v = torch.cat([top, I], dim=0)
                out = contract(v, C)  # (ndir, B, 2, nx, ny)
                if it == self.n_inner:
                    break
                # inflow through side s of orientation o is the side-s
                # outflow of the partner cell; quad-resolved sides flip
                # their u order under the 180-degree partner rotation
                items = []
                for s in range(3):
                    di, dj = SIDE_OFFSETS[s]
                    o = out[[side0 + n_q * s + u_flip[q] for q in range(n_q)]]
                    items += [(o[:, :, 1], -di, -dj), (o[:, :, 0], di, dj)]
                got = self._rolls(items)
                I = torch.cat([torch.stack(got[2 * s:2 * s + 2], dim=2) for s in range(3)])
            # bottom corner k feeds the same corner's top stream of k+1
            bot = out[list(cfg["bot_dst"])]
            bots.append(bot.sum(0))
            nets.append(v.sum(0) - out.sum(0))
            vs.append(v)
            top = bot
        edir = torch.stack([top0.sum(0)] + bots, dim=1)
        return edir, torch.stack(nets, dim=1), torch.stack(vs, dim=2)

    def _gather_in(self, E, F):
        """Per-cell incoming 8-vector in wedge dof order, (8, B, nz, 2, nx, ny)."""
        ins = [E[:, 0, :-1]]
        got = self._rolls([(F[:, :2, :, s],) + SIDE_OFFSETS[s] for s in range(3)])
        for s in range(3):
            ins.append(torch.stack([F[:, 2, :, s], got[s][:, 0]], dim=2))
            ins.append(torch.stack([F[:, 3, :, s], got[s][:, 1]], dim=2))
        ins.append(E[:, 1, 1:])
        return torch.stack(ins, dim=0)

    def _scatter(self, bE, bF, src):
        """Add per-cell outgoing (8, B, nz, 2, nx, ny) onto the face fields."""
        bE[:, 1, :-1] += src[0]
        bE[:, 0, 1:] += src[7]
        got = self._rolls([(src[1 + 2 * s:3 + 2 * s, :, :, 1], -SIDE_OFFSETS[s][0],
                            -SIDE_OFFSETS[s][1]) for s in range(3)])
        for s in range(3):
            bF[:, 0, :, s] += src[1 + 2 * s][:, :, 0]
            bF[:, 1, :, s] += src[2 + 2 * s][:, :, 0]
            bF[:, 2, :, s] += got[s][0]
            bF[:, 3, :, s] += got[s][1]

    def _diff_op(self, f2f, E, F, b, albedo, dir_sfc):
        """One application of the transfer operator plus sources."""
        out = contract(self._gather_in(E, F), f2f)  # (8, B, nz, 2, nx, ny)
        Eup_new = torch.zeros_like(E[:, 1])
        Eup_new[:, :-1] = out[0]
        Edn_new = torch.zeros_like(E[:, 0])
        Edn_new[:, 1:] = out[7]
        Fn = []
        got = self._rolls([(out[1 + 2 * s:3 + 2 * s, :, :, 1], -SIDE_OFFSETS[s][0],
                            -SIDE_OFFSETS[s][1]) for s in range(3)])
        for s in range(3):
            o_dn, o_up = out[1 + 2 * s], out[2 + 2 * s]
            Fn.append(torch.stack([o_dn[:, :, 0], o_up[:, :, 0], got[s][0], got[s][1]], dim=1))
        F_new = torch.stack(Fn, dim=3) + b[1]
        E_new = torch.stack([Edn_new, Eup_new], dim=1) + b[0]
        # surface albedo closure: Lambertian reflection of (Edn + direct)
        E_new[:, 1, -1] += albedo * (E_new[:, 0, -1] + dir_sfc)
        # TOA: no incoming diffuse
        E_new[:, 0, 0] = 0.0
        return E_new, F_new

    def _sources(self, bE, bF, f2f, d2f, vs_dir, edir, f, albedo):
        """Diffuse sources from direct scattering and thermal emission,
        added onto the zero fields bE, bF.  Emission enters whenever a
        Planck field is set, as in the JAX package."""
        g = self.lgrid
        if d2f is not None and vs_dir is not None:
            self._scatter(bE, bF, contract(vs_dir, d2f))
        if f["planck"] is not None:
            dz3 = self._dz[:, None, None, None]
            tauz = f["kabs"] * dz3
            b0, b1 = f["planck"][:, :-1], f["planck"][:, 1:]
            btop = b_eff(b1, b0, tauz)
            bbot = b_eff(b0, b1, tauz)
            emis = torch.clamp(1.0 - f2f.sum(1), 0.0, 1.0)  # (8 src, B, nz, 2, nx, ny)
            # emission per dof [W]: top / bottom full hemisphere on
            # area_tri, sides half a hemisphere each on their quad area
            at = PI * g.area_tri
            em = []
            for d in range(NDIFF):
                if d == 0:
                    val = btop * at * emis[0]
                elif d == 7:
                    val = bbot * at * emis[7]
                else:
                    s, up = (d - 1) // 2, (d - 1) % 2
                    area = g.side_lengths[s] * dz3
                    val = (btop if up else bbot) * PI * area * 0.5 * emis[d]
                em.append(val)
            self._scatter(bE, bF, torch.stack(em, dim=0))
            bsfc = f["planck"][:, -1] if f["planck_srfc"] is None else f["planck_srfc"]
            bE[:, 1, -1] += (1.0 - albedo) * PI * g.area_tri * bsfc

    def _diff_divergence(self, E, F, bE, bF, f2f):
        """Net diffuse power deposited per cell: inflows - outflows, less
        the power injected by the sources (emission counts negative)."""
        v = self._gather_in(E, F)
        out = contract(v, f2f)
        src_tot = bE[:, 1, :-1] + bE[:, 0, 1:]
        t1_parts = self._rolls([(bF[:, 2, :, s] + bF[:, 3, :, s],) + SIDE_OFFSETS[s]
                                for s in range(3)])
        for s in range(3):
            t0_part = bF[:, 0, :, s] + bF[:, 1, :, s]
            src_tot = src_tot + torch.stack([t0_part, t1_parts[s]], dim=2)
        return v.sum(0) - out.sum(0) - src_tot

    def nca_absorption(self, sol: PlexSolution, tables=None) -> torch.Tensor:
        """3-D-corrected thermal heating rates by the Neighbouring Column
        Approximation [W/m3] (reference `-plexrt_nca`)."""
        if self._planck is None:
            raise RuntimeError("NCA is a thermal correction: set planck first")
        from tenstream_tpu_torch.plexrt.nca import nca_structured

        a = self.lgrid.area_tri
        return nca_structured(self.lgrid, self._kabs, self._planck, sol.edn / a, sol.eup / a,
                              tables, self._pmesh)
