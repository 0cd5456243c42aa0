"""Buildings: solid cells with reflecting / emitting faces (port of
`tenstream_tpu/pprts/buildings.py`; reference `src/buildings.F90` and its
hooks in the solver, `src/pprts.F90:3188-3212, :4989-5082, :5986-6249`).

Buildings are a dense boolean `solid` cell mask plus albedo / Planck
fields.  Coefficient masking and the source terms are `where` operations
over the whole grid; exposed faces derive from the mask by shifts.
Masking single cells breaks the orbit symmetry of the diffuse
coefficients, so a solver with buildings works on the dense coefficient
form (kernel K3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from tenstream_tpu_torch.core.types import PI, ireals
from tenstream_tpu_torch.pprts.coeffs import CoeffFields
from tenstream_tpu_torch.pprts.operators import roll_xy
from tenstream_tpu_torch.streams import StreamScheme


@dataclass
class Buildings:
    solid: torch.Tensor  # (Nz, Nx, Ny) bool: cell is inside a building
    albedo: float = 0.2  # building face albedo
    planck: Optional[torch.Tensor] = None  # (Nz, Nx, Ny) face Planck [W/m2/sr]
    # face temperature [K] (scalar or (Nz, Nx, Ny)); stored only: the
    # full-spectrum integration derives the per-band Planck emission from it
    temp: Optional[torch.Tensor] = None
    # spectrally integrated per-face fluxes [W/m2], filled by the
    # full-spectrum integration: face kind -> dict(edir, incoming, outgoing)
    fluxes: Optional[dict] = None

    def __post_init__(self):
        self.solid = torch.as_tensor(self.solid, dtype=torch.bool)
        dev = self.solid.device
        if self.planck is not None:
            self.planck = torch.as_tensor(self.planck, dtype=ireals, device=dev)
        if self.temp is not None:
            self.temp = torch.as_tensor(self.temp, dtype=ireals, device=dev)

    @property
    def device(self) -> torch.device:
        return self.solid.device

    def to(self, device) -> "Buildings":
        """The same buildings with their tensors on `device` (self when
        they are there already)."""
        dev, here = torch.device(device), self.solid.device
        if dev.type == here.type and dev.index in (None, here.index):
            return self
        mv = lambda t: None if t is None else t.to(device)
        return Buildings(mv(self.solid), self.albedo, mv(self.planck), mv(self.temp), self.fluxes)

    def exposed_top(self) -> torch.Tensor:
        """Faces where radiation travelling down hits a roof: cell solid,
        cell above (k-1) not solid (TOA-adjacent roofs included)."""
        s = self.solid
        above = torch.cat([torch.zeros_like(s[:1]), s[:-1]], dim=0)
        return s & ~above

    def exposed_bottom(self) -> torch.Tensor:
        s = self.solid
        below = torch.cat([s[1:], torch.zeros_like(s[:1])], dim=0)
        return s & ~below

    def exposed_side(self, axis: int, low: bool, mesh=None) -> torch.Tensor:
        """Exposed vertical walls: cell solid, horizontal neighbour not.
        axis: 1 = x, 2 = y; low=True is the XMIN/YMIN wall (at face index
        i / j), low=False the XMAX/YMAX wall (face i+1 / j+1).  Periodic
        horizontally, like the solver; with a `mesh`, `solid` is this
        rank's block and the neighbour across its edge comes by halo."""
        s = self.solid
        return s & ~roll_xy(s, 1 if low else -1, axis - 3, mesh)


def mask_coeffs(coeffs: CoeffFields, b: Buildings) -> CoeffFields:
    """Zero all transfer blocks of solid cells: nothing propagates through
    a building.  The diffuse field has to be in dense form."""
    m = b.solid[None, None]  # broadcast over (src, dst)
    zero = lambda c: None if c is None else c.masked_fill(m, 0.0)
    return CoeffFields(zero(coeffs.dir2dir), zero(coeffs.dir2diff), zero(coeffs.diff2diff))


def face_masks(b: Buildings, mesh=None) -> Dict[str, torch.Tensor]:
    """Exposed-face boolean masks keyed by face kind."""
    return {
        "roof": b.exposed_top(),
        "floor": b.exposed_bottom(),
        "wall_x_low": b.exposed_side(1, True, mesh),
        "wall_x_high": b.exposed_side(1, False, mesh),
        "wall_y_low": b.exposed_side(2, True, mesh),
        "wall_y_high": b.exposed_side(2, False, mesh),
    }


def building_incoming_from_fields(
    scheme: StreamScheme,
    b: Buildings,
    ediff: torch.Tensor,  # (ndiff, Nz+1, Nx, Ny) [W], mu-scaled if solar
    edir: Optional[torch.Tensor],  # (ndir, Nz+1, Nx, Ny) [W] or None
    az: float,
    dx: float,
    dy: float,
    dz3d: torch.Tensor,
    xinc: int = 1,
    yinc: int = 1,
    mesh=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Per-face direct and total incoming radiation [W/m2] on exposed
    building faces from raw stream-resolved [W] flux fields.  Returns
    (edir_faces, incoming) dicts of unmasked (Nz, Nx, Ny) fields keyed by
    face kind; linear in the fields."""
    nt = scheme.difftop.dof
    ntd = scheme.dirtop.dof
    inward = scheme.diff_inward()
    axis = scheme.diff_axis()
    dir_axis = scheme.dir_axis()
    wall_area = {
        "wall_x_low": dy * dz3d, "wall_x_high": dy * dz3d,
        "wall_y_low": dx * dz3d, "wall_y_high": dx * dz3d,
    }
    zeros = lambda: torch.zeros(tuple(dz3d.shape), dtype=ireals, device=ediff.device)
    kinds = ("roof", "floor", "wall_x_low", "wall_x_high", "wall_y_low", "wall_y_high")
    edir_f = {k: zeros() for k in kinds}
    incoming = {k: zeros() for k in kinds}

    # roofs/floors: vertical streams at the z-face of the solid cell
    edn_W = sum(ediff[d] for d in range(nt) if inward[d])
    eup_W = sum(ediff[d] for d in range(nt) if not inward[d])
    incoming["roof"] = incoming["roof"] + edn_W[:-1] / az
    incoming["floor"] = incoming["floor"] + eup_W[1:] / az
    if edir is not None:
        ed = edir[:ntd].sum(0)
        edir_f["roof"] = edir_f["roof"] + ed[:-1] / az
        incoming["roof"] = incoming["roof"] + ed[:-1] / az

    # walls: side streams arriving at the exposed vertical faces.  Side
    # fields store x-face i at column index i, layer slot k.
    for ax, (klo, khi) in ((1, ("wall_x_low", "wall_x_high")),
                           (2, ("wall_y_low", "wall_y_high"))):
        side = [d for d in range(nt, scheme.ndiff) if axis[d] == ax]
        into_pos = sum(ediff[d, :-1] for d in side if inward[d])  # moving +axis: low wall
        into_neg = sum(ediff[d, :-1] for d in side if not inward[d])  # high wall (face i+1)
        incoming[klo] = incoming[klo] + into_pos / wall_area[klo]
        incoming[khi] = incoming[khi] + roll_xy(into_neg, -1, ax - 3, mesh) / wall_area[khi]
        if edir is not None and scheme.dirside.dof > 0:
            beam_pos = (xinc == 1) if ax == 1 else (yinc == 1)
            side_dir = sum(edir[d, :-1] for d in range(scheme.ndir) if dir_axis[d] == ax)
            if beam_pos:
                v = side_dir / wall_area[klo]
                edir_f[klo] = edir_f[klo] + v
                incoming[klo] = incoming[klo] + v
            else:
                v = roll_xy(side_dir, -1, ax - 3, mesh) / wall_area[khi]
                edir_f[khi] = edir_f[khi] + v
                incoming[khi] = incoming[khi] + v
    return edir_f, incoming


def building_sources(
    scheme: StreamScheme,
    b: Buildings,
    edir: Optional[torch.Tensor],  # ([B,] ndir, Nz+1, Nx, Ny) [W]
    az: float,
    dz3d: Optional[torch.Tensor] = None,  # (Nz, Nx, Ny) layer thickness [m]
    dx: float = 0.0,
    dy: float = 0.0,
    xinc: int = 1,
    yinc: int = 1,
    planck: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Diffuse source ([B,] ndiff, Nz+1, Nx, Ny) from building faces:
    reflection of the direct beam and thermal emission -- roofs plus, when
    the scheme carries side streams and `dz3d` is given, the exposed
    vertical walls.  `planck` ([B,] Nz, Nx, Ny) overrides `b.planck` (a
    per-band emission); None with `b.planck` None means no emission.  A
    leading lane dim B on `edir` or `planck` gives one source per lane (a
    band chunk); the face masks do not depend on the lane and are built
    once."""
    b_planck = planck if planck is not None else b.planck
    inward = scheme.diff_inward()
    ntd = scheme.dirtop.dof
    axis = scheme.diff_axis()
    dir_axis = scheme.dir_axis()
    roof = b.exposed_top()  # (Nz, Nx, Ny): roof at z-face index k
    nz = roof.shape[0]
    zero = torch.zeros((), dtype=ireals, device=roof.device)
    lead = ()
    if edir is not None and edir.dim() == 5:
        lead = tuple(edir.shape[:1])
    elif b_planck is not None and b_planck.dim() == 4:
        lead = tuple(b_planck.shape[:1])

    out = torch.zeros(lead + (scheme.ndiff, nz + 1) + tuple(roof.shape[1:]), dtype=ireals,
                      device=roof.device)
    wtop = scheme.difftop_weights()
    for d in range(scheme.difftop.dof):
        if inward[d]:
            continue  # only upward dofs are emitted / reflected at roofs
        w = float(wtop[d])
        if edir is not None:
            edir_dn = edir[..., :ntd, :-1, :, :].sum(-4)  # direct arriving at face k
            out[..., d, :-1, :, :] += torch.where(roof, edir_dn * b.albedo * w, zero)
        if b_planck is not None:
            out[..., d, :-1, :, :] += torch.where(roof, b_planck * (1.0 - b.albedo) * PI * az * w,
                                                  zero)

    if scheme.diffside.dof == 0 or dz3d is None:
        return out

    # vertical walls: side stream fields store the dof of x-face i (between
    # columns i-1, i) at column index i, layer slot k; a wall contribution
    # of cell (k, i, j) therefore lands at column i (low wall, outward
    # dofs) or i+1 (high wall, inward dofs; periodic roll).  `ax` 1 / 2 is
    # the x / y axis of a cell field, dim ax - 3 counted from the end.
    wside = scheme.diffside_weights()
    nt, ns = scheme.difftop.dof, scheme.diffside.dof
    wall_len = {1: dy, 2: dx}

    for ax in (1, 2):
        dim = ax - 3
        low_wall = b.exposed_side(ax, True, mesh)  # a beam moving +axis hits this wall
        high_wall = b.exposed_side(ax, False, mesh)
        beam_pos = (xinc == 1) if ax == 1 else (yinc == 1)
        if edir is not None:
            # direct power crossing the wall face: the face value at column
            # i is the flux at x-face i; the beam-facing wall sits at face
            # i (beam +x) or i+1 (beam -x)
            side_dir = sum(edir[..., d, :-1, :, :] for d in range(scheme.ndir)
                           if dir_axis[d] == ax)
            hit_low = torch.where(low_wall, side_dir, zero)
            hit_high = torch.where(high_wall, roll_xy(side_dir, -1, dim, mesh), zero)
        emit = None
        if b_planck is not None:
            emit = b_planck * (1.0 - b.albedo) * PI * (wall_len[ax] * dz3d)
        for d in range(nt, scheme.ndiff):
            if axis[d] != ax:
                continue
            w = float(wside[(d - nt) % ns])
            contrib = torch.zeros(lead + tuple(roof.shape), dtype=ireals, device=roof.device)
            if not inward[d]:
                # outward dof (moving -axis): sourced by the low wall at face i
                if edir is not None and beam_pos:
                    contrib = contrib + hit_low * b.albedo * w
                if emit is not None:
                    contrib = contrib + torch.where(low_wall, emit * w, zero)
                out[..., d, :-1, :, :] += contrib
            else:
                # inward dof: sourced by the high wall at face i+1
                if edir is not None and not beam_pos:
                    contrib = contrib + hit_high * b.albedo * w
                if emit is not None:
                    contrib = contrib + torch.where(high_wall, emit * w, zero)
                out[..., d, :-1, :, :] += roll_xy(contrib, 1, dim, mesh)
    return out
