"""Wedge solver on unstructured triangle meshes, ICON grids (port of
`tenstream_tpu/plexrt/solver_unstructured.py`; reference
`plexrt/plex_rt.F90` on DMPlex meshes built by
`plexrt/icon_plex_utils.F90`).

Same physics and the same solve sequence as `plexrt.solver.PlexrtSolver`
(`WedgeSolverBase`); the mesh is a `plexrt.icon.TriMesh` and every
neighbour exchange is one gather through its flat (cell, side) index
table.  Lateral domain boundaries are open (vacuum): inflow gathers give
exact zeros there, and direct side outflow through them leaves the
domain (`plex_rt.F90:4341`).

Decomposed (`set_mesh`): the flat cell axis splits into contiguous
ranges, one per rank in rank order (`parallel.mesh.cell_partition`, the
JAX package's `P(..., ("x", "y"), ...)`); every neighbour gather reads the
rank's own side values and a ghost ring that one `GhostExchange` per
sweep brings from the neighbouring ranks, never the whole side field.

State layout (B lanes, nc = ncell_local: every cell undecomposed)
  edir            : (B, nz+1, nc)
  ediff z-faces E : (B, 2, nz+1, nc)    dof 0 Edn, dof 1 Eup
  ediff side OUT F: (B, 2, nz, nc, 3)   [dn, up] outflow per cell side
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from tenstream_tpu_torch.core.types import PI, TINY, ireals
from tenstream_tpu_torch.ops.planck import b_eff
from tenstream_tpu_torch.parallel.mesh import GhostExchange
from tenstream_tpu_torch.plexrt.icon import TriMesh
from tenstream_tpu_torch.plexrt.nca import nca_exchange, nca_icon
from tenstream_tpu_torch.plexrt.optprop import NDIFF, WedgeOptProp
from tenstream_tpu_torch.plexrt.param_phi import canonical_azimuth_map
from tenstream_tpu_torch.plexrt.solver import PlexSolution, WedgeSolverBase, contract


class PlexrtSolverIcon(WedgeSolverBase):
    """Monochromatic wedge_5_8 solve on a TriMesh extruded over nz layers
    of thickness dz (TOA -> surface).  `device` defaults to the tables'
    device.  Per-cell fields are (..., nc) with nc this rank's cells
    (`ncell_local`; every cell undecomposed)."""

    def __init__(self, mesh: TriMesh, dz, opp: WedgeOptProp, n_inner: int = 24,
                 diff_iters: int = 1000, diff_rtol: float = 1e-5,
                 diff_solver: str = "bicgstab", device=None):
        super().__init__(opp, n_inner, diff_iters, diff_rtol, diff_solver, device)
        self.mesh = mesh
        self.dz = (np.broadcast_to(np.asarray(dz, np.float32).ravel(), (np.size(dz),)).copy()
                   if np.ndim(dz) else np.asarray([dz], np.float32))
        self.nz = self.dz.shape[0]
        self._dz = torch.as_tensor(self.dz, dtype=ireals, device=self.device)

        # per-cell apex in the cell-local frame (side 0 = AB on +x, unit
        # AB) for the param-phi azimuth map (`plexrt/param_phi.py`)
        v = mesh.verts[mesh.tris]
        ab = v[:, 1] - v[:, 0]
        ac = v[:, 2] - v[:, 0]
        L = np.maximum(np.linalg.norm(ab, axis=-1), 1e-30)
        abh = ab / L[:, None]
        cx = (ac * abh).sum(-1) / L
        cy = (ac[:, 1] * abh[:, 0] - ac[:, 0] * abh[:, 1]) / L
        self._apex = (cx, np.maximum(cy, 1e-6))
        self.set_mesh(None)
        if hasattr(opp, "bind_cells"):
            # shape-blended tables (`WedgeOptPropShaped`) map the raw azimuth
            # onto each table's own shape: no single-table azimuth map here
            self._table_apex = (1.0, 1.0)
            self._use_param_phi = False
            return
        # the table's triangle (canonical right triangle (1, 1) unless a
        # shape-aware table was traced for this mesh): the azimuth map
        # targets this shape
        self._table_apex = tuple(getattr(opp.lut, "apex", (1.0, 1.0)))
        self._use_param_phi = bool(np.max(np.abs(cx - self._table_apex[0])) > 1e-3
                                   or np.max(np.abs(cy - self._table_apex[1])) > 1e-3)
        # a strongly different table shape costs ~10-16% flux error even
        # with the azimuth map (PARITY.md)
        dev = float(max(np.max(np.abs(cx - self._table_apex[0])),
                        np.max(np.abs(cy - self._table_apex[1]))))
        if dev > 0.15:
            warnings.warn(
                f"mesh cell shapes deviate from the coefficient table's triangle by up to "
                f"{dev:.2f} (apex units) -- measured ~10-16% flux error at deviation 0.5 "
                f"(PARITY.md); a shape-aware table is the one traced at the mesh's mean shape "
                f"(plexrt.optprop.wedge_lut_for_mesh)", stacklevel=2)

    def set_mesh(self, mesh) -> None:
        """Decompose the solve over a `parallel.mesh.Mesh` (None undoes it):
        from here on every per-cell field is this rank's range of the flat
        cell axis (`Mesh.cell_range`), in `set_optical_properties`,
        `solve_lanes` and the results.  The per-cell constants and the
        shape-blended tables' weights are sliced to it, and the side
        exchange gathers the ghost cells' values from their ranks."""
        self._attach(mesh)
        m = self.mesh
        lo, hi = (0, m.ncell) if mesh is None else mesh.cell_range(m.ncell)
        self.ncell_local = hi - lo
        t = lambda a, dt=ireals: torch.as_tensor(np.ascontiguousarray(a[lo:hi]), dtype=dt,
                                                 device=self.device)
        self._ex_mask = t(m.exchange_mask())  # (nc, 3)
        self._area = t(m.area)  # (nc,)
        self._side_len = t(m.side_len)  # (nc, 3)
        self._phi_rot = t(m.phi_rot)  # (nc,)
        self._wedge_C = tuple(t(c) for c in self._apex)
        if hasattr(self.opp, "bind_cells"):
            self.opp.bind_cells(*(c[lo:hi] for c in self._apex))
        if mesh is None:
            self._ex = self._nca_ex = None
            self._ex_idx = torch.as_tensor(m.exchange_index().reshape(-1), device=self.device)
        else:
            self._ex = GhostExchange(mesh, m.exchange_index(), m.nbr >= 0, 3, self.device)
            self._ex_idx = self._ex.index_local.reshape(-1)  # into own sides, then ghosts
            self._nca_ex = nca_exchange(m, mesh, self.device)

    def cell_shape(self):
        """This rank's cell shape (nz, nc)."""
        return (self.nz, self.ncell_local)

    def _state_zeros(self, nb):
        nz, nc = self.nz, self.ncell_local
        z = lambda *s: torch.zeros((nb,) + s, dtype=ireals, device=self.device)
        return z(2, nz + 1, nc), z(2, nz, nc, 3)

    def _volumes(self):
        return self._dz[:, None] * self._area[None]

    def areas(self):
        """This rank's triangle columns' areas [m2], (1, nc)."""
        return self._area[None]

    def _exchange(self, out_side: torch.Tensor) -> torch.Tensor:
        """in[..., c, s] = out[..., nbr[c, s], nbr_side[c, s]], exactly 0 at
        open boundaries.  out_side: (..., nc, 3); decomposed, one exchange
        of the ghost sides with the neighbouring ranks."""
        flat = out_side.reshape(out_side.shape[:-2] + (-1,))
        if self._ex is not None:
            flat = self._ex.exchange(flat)
        got = torch.index_select(flat, -1, self._ex_idx).reshape(out_side.shape)
        return got * self._ex_mask

    def _coeffs(self, f, need_dir: bool):
        """Channels-first (src, dst, B, nz, nc) coefficient fields."""
        dz3 = self._dz[:, None]
        kext = f["kabs"] + f["ksca"]
        tauz = kext * dz3
        w0 = f["ksca"] / torch.clamp(kext, min=TINY)
        # characteristic horizontal length of the canonical triangle
        aspect = dz3 / torch.sqrt(2.0 * self._area)[None, :]
        f2f = self.opp.diff_coeffs(tauz, w0, f["g"], aspect)
        d2d = d2f = None
        if need_dir:
            phi, theta, _ = self._sun_angles()
            # the sun azimuth in each cell's frame: the cell is the
            # canonical triangle rotated by phi_rot (the structured mesh's
            # T1, at phi + 180, pins the sign)
            phi_cell = torch.tensor(phi, dtype=ireals, device=self.device) + self._phi_rot[None]
            if self._use_param_phi:
                # shape-aware azimuth: the canonical table at the azimuth
                # with the same param-phi coordinate
                phi_cell = canonical_azimuth_map(phi_cell, self._wedge_C[0][None],
                                                 self._wedge_C[1][None], *self._table_apex)
            d2d, d2f = self.opp.dir_coeffs(tauz, w0, f["g"], aspect, phi_cell, theta)
        return f2f, d2d, d2f

    def _solve_edir(self, d2d, toa):
        """Layer sweep with `n_inner` side-exchange sweeps per layer.
        Returns edir through the z-faces (B, nz+1, nc), the per-cell net
        direct deposition (B, nz, nc), the side inflows (3, B, nz, nc) and
        the direct side outflow through open boundaries, which leaves the
        domain (B, nz, nc)."""
        nb, nc = toa.shape[0], self.ncell_local
        mu = self._mu().to(self.device)
        top0 = self._area[None] * toa.to(ireals)[:, None] * mu  # (B, nc)
        top = top0
        bots, nets, sides, escaped = [], [], [], []
        for k in range(self.nz):
            C = d2d[:, :, :, k]  # (4, 5, B, nc)
            I = torch.zeros((3, nb, nc), dtype=ireals, device=self.device)
            for it in range(self.n_inner + 1):
                v = torch.cat([top[None], I], dim=0)
                out = contract(v, C)  # (5, B, nc)
                if it == self.n_inner:
                    break
                I = self._exchange(out[1:4].movedim(0, -1)).movedim(-1, 0)
            bot = out[4]
            escaped.append((out[1:4].movedim(0, -1) * (1.0 - self._ex_mask)).sum(-1))
            bots.append(bot)
            nets.append(top + I.sum(0) - out.sum(0))
            sides.append(I)
            top = bot
        edir = torch.stack([top0] + bots, dim=1)
        return (edir, torch.stack(nets, dim=1), torch.stack(sides, dim=2),
                torch.stack(escaped, dim=1))

    def _gather_in(self, E, F):
        """Per-cell incoming 8-vector in wedge dof order, (8, B, nz, nc)."""
        inflow = self._exchange(F)
        in_dn, in_up = inflow[:, 0], inflow[:, 1]
        ins = [E[:, 0, :-1]]
        for s in range(3):
            ins += [in_dn[..., s], in_up[..., s]]
        ins.append(E[:, 1, 1:])
        return torch.stack(ins, dim=0)

    @staticmethod
    def _scatter(bE, bF, src):
        """Add per-cell outgoing (8, B, nz, nc) onto the face fields."""
        bE[:, 1, :-1] += src[0]
        bE[:, 0, 1:] += src[7]
        dn = torch.stack([src[1 + 2 * s] for s in range(3)], dim=-1)
        up = torch.stack([src[2 + 2 * s] for s in range(3)], dim=-1)
        bF += torch.stack([dn, up], dim=1)

    def _diff_op(self, f2f, E, F, b, albedo, dir_sfc):
        out = contract(self._gather_in(E, F), f2f)  # (8, B, nz, nc)
        Eup_new = torch.zeros_like(E[:, 1])
        Eup_new[:, :-1] = out[0]
        Edn_new = torch.zeros_like(E[:, 0])
        Edn_new[:, 1:] = out[7]
        F_dn = torch.stack([out[1 + 2 * s] for s in range(3)], dim=-1)
        F_up = torch.stack([out[2 + 2 * s] for s in range(3)], dim=-1)
        F_new = torch.stack([F_dn, F_up], dim=1) + b[1]
        E_new = torch.stack([Edn_new, Eup_new], dim=1) + b[0]
        E_new[:, 1, -1] += albedo * (E_new[:, 0, -1] + dir_sfc)
        E_new[:, 0, 0] = 0.0
        return E_new, F_new

    def _sources(self, bE, bF, f2f, d2f, sides_dir, edir, f, albedo):
        if d2f is not None and edir is not None:
            v = torch.cat([edir[:, :-1][None], sides_dir], dim=0)  # (4, B, nz, nc)
            self._scatter(bE, bF, contract(v, d2f))
        if f["planck"] is not None:
            dz3 = self._dz[:, None]
            tauz = f["kabs"] * dz3
            b0, b1 = f["planck"][:, :-1], f["planck"][:, 1:]
            btop = b_eff(b1, b0, tauz)
            bbot = b_eff(b0, b1, tauz)
            emis = torch.clamp(1.0 - f2f.sum(1), 0.0, 1.0)  # (8 src, B, nz, nc)
            em = []
            for d in range(NDIFF):
                if d == 0:
                    val = btop * PI * self._area[None] * emis[0]
                elif d == 7:
                    val = bbot * PI * self._area[None] * emis[7]
                else:
                    s, up = (d - 1) // 2, (d - 1) % 2
                    area = self._side_len[None, :, s] * dz3
                    val = (btop if up else bbot) * PI * area * 0.5 * emis[d]
                em.append(val)
            self._scatter(bE, bF, torch.stack(em, dim=0))
            bsfc = f["planck"][:, -1] if f["planck_srfc"] is None else f["planck_srfc"]
            bE[:, 1, -1] += (1.0 - albedo) * PI * self._area * bsfc

    def _diff_divergence(self, E, F, bE, bF, f2f):
        v = self._gather_in(E, F)
        out = contract(v, f2f)
        src_tot = bE[:, 1, :-1] + bE[:, 0, 1:] + bF.sum(dim=(1, -1))
        return v.sum(0) - out.sum(0) - src_tot

    def nca_absorption(self, sol: PlexSolution, tables=None) -> torch.Tensor:
        """3-D-corrected thermal heating rates by the Neighbouring Column
        Approximation [W/m3] (reference `-plexrt_nca`); needs planck."""
        if self._planck is None:
            raise RuntimeError("NCA is a thermal correction: set planck first")
        a = self._area[None]
        return nca_icon(self.mesh, self.dz, self._kabs, self._planck, sol.edn / a, sol.eup / a,
                        tables, self._nca_ex)
