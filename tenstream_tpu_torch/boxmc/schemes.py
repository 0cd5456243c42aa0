"""Per-scheme photon source sampling and destination classification (the
port's own copy of `tenstream_tpu/boxmc/schemes.py`: pure numpy data,
tested equal to the JAX package's schemes in
`tests/test_torch_boxmc_tracer.py`).

Parity: the reference's per-scheme include files
(`src/boxmc_3_10.inc`, `boxmc_1_2.inc`, `boxmc_3_6.inc`, ...) define
`init_dir_photon / update_dir_stream / init_diff_photon /
update_diff_stream` for each stream geometry.  Here each scheme is a small
data-driven table instead of code: a source spec (face + angular window)
per src stream and a classification rule (face + direction signs -> dst).

Geometry: axis-aligned box [0,dx] x [0,dy] x [0,dz].  z is ALTITUDE
(grid level k maps to the box's top face; k+1 to the bottom face).  The
canonical sun octant moves toward (+x, +y, -z) — the reference computes
LUTs for azimuth phi in [0,90] and unfolds other octants by symmetry
(`src/optprop.F90:1009-1045`); we do the same.

Faces: 0 TOP(z=dz), 1 BOT(z=0), 2 XMIN, 3 XMAX, 4 YMIN, 5 YMAX.

Diffuse stream order per scheme matches `tenstream_tpu_torch.streams`
(which matches the reference BoxMC destination numbering; for 3_10 see
`src/boxmc_3_10.inc:36-64`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

TOP, BOT, XMIN, XMAX, YMIN, YMAX = range(6)

# inward unit normal per face
_FACE_NORMAL = np.array(
    [
        [0.0, 0.0, -1.0],  # TOP: into the box is -z
        [0.0, 0.0, 1.0],
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
    ]
)


@dataclass(frozen=True)
class DiffSrc:
    face: int
    zsign: int = 0  # -1 down hemisphere, +1 up hemisphere, 0 unrestricted
    # azimuth sector restriction for top/bot-face sources
    # (0: +y, 1: -x, 2: -y, 3: +x), or None for the full azimuth circle
    phi_sector: Optional[int] = None
    # tangential-quadrant restriction q = 2*(t1<0) + (t2<0) with the
    # face tangentials (top/bot: (x,y); x-sides: (y,z); y-sides: (x,z)),
    # reference `init_diff_photon_3_24` phi windows
    quadrant: Optional[int] = None
    # window on the cosine wrt the face normal: mu = sqrt(U(lo^2, hi^2))
    # (reference `interv_R` sampling, e.g. `boxmc_3_30.inc:354-356`)
    mu_min: float = 0.0
    mu_max: float = 1.0


@dataclass(frozen=True)
class BoxScheme:
    name: str
    ndir: int
    ndiff: int
    # direct source faces, in dir-dof order (canonical sun octant)
    dir_src_faces: Tuple[int, ...]
    # diffuse sources, in diff-dof order
    diff_srcs: Tuple[DiffSrc, ...]
    # classification tables:
    #   dir_dst_by_face[face]  -> dir dst index or -1
    #   diff_dst_by_face_zsign[face][0 (down) /1 (up)] -> diff dst index
    dir_dst_by_face: Tuple[int, ...]
    diff_dst_by_face_zsign: Tuple[Tuple[int, int], ...]
    # optional sub-face source rectangles per dir src, as (u0,u1,v0,v1)
    # fractions of the face's in-plane coords (u,v per `_sample_on_face`:
    # top/bot faces u->x,v->y; x-faces u->z,v->y; y-faces u->x,v->z)
    dir_src_rects: Optional[Tuple[Tuple[float, float, float, float], ...]] = None
    # positional direct classification: "quad8" = top/bot quadrants +
    # side z-halves (reference `update_dir_stream_8_10`)
    dir_classify: Optional[str] = None
    # azimuth-sector destination tables for top/bot-face diffuse exits
    # (reference `update_diff_stream_3_16`): [face 0 sectors, face 1
    # sectors], each a 4-tuple of dst dofs indexed by sector id
    diff_top_sector_dst: Optional[Tuple[Tuple[int, int, int, int], Tuple[int, int, int, int]]] = None
    # general per-face angular classification (overrides the tables
    # above when set): 6-tuple of (mode, dsts) with mode in
    #   "zsign"       dsts = (dn_dst, up_dst)
    #   "quad"        dsts = (q0, q1, q2, q3) by tangential-sign quadrant
    #   "quad_main"   dsts = (main, q0..q3), main when |mu_n| >= alim
    #   "sector_main" dsts = (main, s0..s3), axis sectors (+y,-x,-y,+x)
    # (reference `update_diff_stream_3_24/_3_30/_8_18`)
    diff_face_class: Optional[Tuple[Tuple[str, Tuple[int, ...]], ...]] = None
    alim: float = 0.75


def _mk_1_2() -> BoxScheme:
    """1 direct + 2 diffuse streams: vertical transport only."""
    return BoxScheme(
        name="1_2",
        ndir=1,
        ndiff=2,
        dir_src_faces=(TOP,),
        diff_srcs=(DiffSrc(BOT, 0), DiffSrc(TOP, 0)),
        # any side-exit is re-binned into the vertical streams by z-direction
        dir_dst_by_face=(-1, 0, 0, 0, 0, 0),
        diff_dst_by_face_zsign=(
            (0, 0),  # TOP: Eup
            (1, 1),  # BOT: Edn
            (1, 0),  # XMIN: down->Edn, up->Eup (periodic re-entry equivalence)
            (1, 0),
            (1, 0),
            (1, 0),
        ),
    )


def _mk_3_6() -> BoxScheme:
    """3 direct + 6 diffuse (one stream per face), `src/boxmc_3_6.inc`."""
    return BoxScheme(
        name="3_6",
        ndir=3,
        ndiff=6,
        dir_src_faces=(TOP, XMIN, YMIN),
        diff_srcs=(
            DiffSrc(BOT, 0),  # Eup
            DiffSrc(TOP, 0),  # Edn
            DiffSrc(XMAX, 0),  # -x
            DiffSrc(XMIN, 0),  # +x
            DiffSrc(YMAX, 0),  # -y
            DiffSrc(YMIN, 0),  # +y
        ),
        dir_dst_by_face=(-1, 0, -1, 1, -1, 2),
        diff_dst_by_face_zsign=(
            (0, 0),
            (1, 1),
            (2, 2),  # XMIN exit = stream moving -x
            (3, 3),
            (4, 4),
            (5, 5),
        ),
    )


def _mk_3_10() -> BoxScheme:
    """3 direct + 10 diffuse streams, `src/boxmc_3_10.inc:36-64`.

    Diffuse dofs: [0 Eup, 1 Edn, 2 (-x,dn), 3 (+x,dn), 4 (-x,up), 5 (+x,up),
                   6 (-y,dn), 7 (+y,dn), 8 (-y,up), 9 (+y,up)].
    """
    return BoxScheme(
        name="3_10",
        ndir=3,
        ndiff=10,
        dir_src_faces=(TOP, XMIN, YMIN),
        diff_srcs=(
            DiffSrc(BOT, 0),
            DiffSrc(TOP, 0),
            DiffSrc(XMAX, -1),
            DiffSrc(XMIN, -1),
            DiffSrc(XMAX, +1),
            DiffSrc(XMIN, +1),
            DiffSrc(YMAX, -1),
            DiffSrc(YMIN, -1),
            DiffSrc(YMAX, +1),
            DiffSrc(YMIN, +1),
        ),
        dir_dst_by_face=(-1, 0, -1, 1, -1, 2),
        diff_dst_by_face_zsign=(
            (0, 0),
            (1, 1),
            (2, 4),  # XMIN: down -> dof2, up -> dof4
            (3, 5),
            (6, 8),
            (7, 9),
        ),
    )


def _mk_8_10() -> BoxScheme:
    """8 direct (4 top quadrants + 2 z-half side pairs) + the 3_10
    diffuse set, `src/boxmc_8_10.inc:20-80`."""
    base = _mk_3_10()
    half = 0.5
    return BoxScheme(
        name="8_10",
        ndir=8,
        ndiff=10,
        dir_src_faces=(TOP, TOP, TOP, TOP, XMIN, XMIN, YMIN, YMIN),
        diff_srcs=base.diff_srcs,
        dir_dst_by_face=(-1, -1, -1, -1, -1, -1),  # positional classify
        diff_dst_by_face_zsign=base.diff_dst_by_face_zsign,
        dir_src_rects=(
            (0.0, half, 0.0, half),  # top quadrant x<=,y<=  (T1)
            (half, 1.0, 0.0, half),  # x>, y<=               (T2)
            (0.0, half, half, 1.0),  # x<=, y>               (T3)
            (half, 1.0, half, 1.0),  # x>, y>                (T4)
            (0.0, half, 0.0, 1.0),  # XMIN lower-z half      (T5)
            (half, 1.0, 0.0, 1.0),  # XMIN upper-z half      (T6)
            (0.0, 1.0, 0.0, half),  # YMIN lower-z half      (T7)
            (0.0, 1.0, half, 1.0),  # YMIN upper-z half      (T8)
        ),
        dir_classify="quad8",
    )


def _sector_diff_srcs():
    """difftop sources for sectored schemes: dofs (2s, 2s+1) are the
    (Eup from bottom, Edn from top) pair of azimuth sector s, sectors
    ordered (+y, -x, -y, +x) as in `update_diff_stream_3_16`."""
    out = []
    for sector in range(4):
        out.append(DiffSrc(BOT, 0, phi_sector=sector))
        out.append(DiffSrc(TOP, 0, phi_sector=sector))
    return tuple(out)


def _mk_3_16() -> BoxScheme:
    """3 direct + 16 diffuse: 8 sectored top streams + the 3_10 side set
    (`src/boxmc_3_16.inc`)."""
    base = _mk_3_10()
    side_srcs = base.diff_srcs[2:]
    # side dofs shift by +6 relative to 3_10 (8 top dofs instead of 2)
    side_tbl = tuple(
        (a + 6 if a >= 2 else a, b + 6 if b >= 2 else b)
        for (a, b) in base.diff_dst_by_face_zsign[2:]
    )
    return BoxScheme(
        name="3_16",
        ndir=3,
        ndiff=16,
        dir_src_faces=(TOP, XMIN, YMIN),
        diff_srcs=_sector_diff_srcs() + side_srcs,
        dir_dst_by_face=(-1, 0, -1, 1, -1, 2),
        diff_dst_by_face_zsign=((0, 0), (1, 1)) + side_tbl,
        # top exits: Eup dof = 2*sector, bot exits: Edn dof = 2*sector+1
        diff_top_sector_dst=((0, 2, 4, 6), (1, 3, 5, 7)),
    )


def _mk_8_16() -> BoxScheme:
    """8 direct (quadrants) + 16 sectored-top diffuse streams."""
    b316 = _mk_3_16()
    b810 = _mk_8_10()
    return BoxScheme(
        name="8_16",
        ndir=8,
        ndiff=16,
        dir_src_faces=b810.dir_src_faces,
        diff_srcs=b316.diff_srcs,
        dir_dst_by_face=(-1, -1, -1, -1, -1, -1),
        diff_dst_by_face_zsign=b316.diff_dst_by_face_zsign,
        dir_src_rects=b810.dir_src_rects,
        dir_classify="quad8",
        diff_top_sector_dst=b316.diff_top_sector_dst,
    )


_ALIM = 0.75  # angular limit of the "main" streams (reference alim_3_30)


def _quad_pairs(face_out: int, face_in: int, mu_max: float = 1.0):
    """(out, in)-interleaved quadrant source pairs for one face pair."""
    out = []
    for q in range(4):
        out.append(DiffSrc(face_out, quadrant=q, mu_max=mu_max))
        out.append(DiffSrc(face_in, quadrant=q, mu_max=mu_max))
    return out


def _mk_3_24() -> BoxScheme:
    """3 direct + 24 diffuse: 4 azimuth-quadrant streams on every face
    (`src/boxmc_3_24.inc:36-135`, quadrant classification
    `update_diff_stream_3_24:365`)."""
    srcs = (
        tuple(_quad_pairs(BOT, TOP))
        + tuple(_quad_pairs(XMAX, XMIN))
        + tuple(_quad_pairs(YMAX, YMIN))
    )
    return BoxScheme(
        name="3_24",
        ndir=3,
        ndiff=24,
        dir_src_faces=(TOP, XMIN, YMIN),
        diff_srcs=srcs,
        dir_dst_by_face=(-1, 0, -1, 1, -1, 2),
        diff_dst_by_face_zsign=((0, 0), (1, 1), (8, 8), (9, 9), (16, 16), (17, 17)),
        diff_face_class=(
            ("quad", (0, 2, 4, 6)),
            ("quad", (1, 3, 5, 7)),
            ("quad", (8, 10, 12, 14)),
            ("quad", (9, 11, 13, 15)),
            ("quad", (16, 18, 20, 22)),
            ("quad", (17, 19, 21, 23)),
        ),
    )


def _mk_3_30() -> BoxScheme:
    """3 direct + 30 diffuse: a main stream (mu >= alim) plus 4 quadrant
    streams on every face (`src/boxmc_3_30.inc:297-360,425-600`)."""

    def grp(face_out, face_in):
        return (
            DiffSrc(face_out, mu_min=_ALIM),
            DiffSrc(face_in, mu_min=_ALIM),
        ) + tuple(_quad_pairs(face_out, face_in, mu_max=_ALIM))

    srcs = grp(BOT, TOP) + grp(XMAX, XMIN) + grp(YMAX, YMIN)
    return BoxScheme(
        name="3_30",
        ndir=3,
        ndiff=30,
        dir_src_faces=(TOP, XMIN, YMIN),
        diff_srcs=srcs,
        dir_dst_by_face=(-1, 0, -1, 1, -1, 2),
        diff_dst_by_face_zsign=((0, 0), (1, 1), (10, 10), (11, 11), (20, 20), (21, 21)),
        diff_face_class=(
            ("quad_main", (0, 2, 4, 6, 8)),
            ("quad_main", (1, 3, 5, 7, 9)),
            ("quad_main", (10, 12, 14, 16, 18)),
            ("quad_main", (11, 13, 15, 17, 19)),
            ("quad_main", (20, 22, 24, 26, 28)),
            ("quad_main", (21, 23, 25, 27, 29)),
        ),
        alim=_ALIM,
    )


def _mk_8_18() -> BoxScheme:
    """8 direct (quadrant sub-faces) + 18 diffuse: main + 4 azimuth
    sectors on top/bot, z-split sides (`src/boxmc_8_18.inc:19-180`)."""
    b810 = _mk_8_10()
    top = (DiffSrc(BOT, mu_min=_ALIM), DiffSrc(TOP, mu_min=_ALIM))
    for s in range(4):
        top += (
            DiffSrc(BOT, phi_sector=s, mu_max=_ALIM),
            DiffSrc(TOP, phi_sector=s, mu_max=_ALIM),
        )
    sides = (
        DiffSrc(XMAX, -1), DiffSrc(XMIN, -1), DiffSrc(XMAX, +1), DiffSrc(XMIN, +1),
        DiffSrc(YMAX, -1), DiffSrc(YMIN, -1), DiffSrc(YMAX, +1), DiffSrc(YMIN, +1),
    )
    return BoxScheme(
        name="8_18",
        ndir=8,
        ndiff=18,
        dir_src_faces=b810.dir_src_faces,
        diff_srcs=top + sides,
        dir_dst_by_face=(-1, -1, -1, -1, -1, -1),
        diff_dst_by_face_zsign=((0, 0), (1, 1), (10, 12), (11, 13), (14, 16), (15, 17)),
        dir_src_rects=b810.dir_src_rects,
        dir_classify="quad8",
        diff_face_class=(
            ("sector_main", (0, 2, 4, 6, 8)),
            ("sector_main", (1, 3, 5, 7, 9)),
            ("zsign", (10, 12)),
            ("zsign", (11, 13)),
            ("zsign", (14, 16)),
            ("zsign", (15, 17)),
        ),
        alim=_ALIM,
    )


def _mk_8_12() -> BoxScheme:
    """8 direct + 12 diffuse: two full-azimuth mu rings (split at
    mu = 0.5) on top/bot, z-split sides (`src/boxmc_8_12.inc`)."""
    b810 = _mk_8_10()
    alim = 0.5
    top = (
        DiffSrc(BOT, mu_min=alim), DiffSrc(TOP, mu_min=alim),
        DiffSrc(BOT, mu_max=alim), DiffSrc(TOP, mu_max=alim),
    )
    sides = (
        DiffSrc(XMAX, -1), DiffSrc(XMIN, -1), DiffSrc(XMAX, +1), DiffSrc(XMIN, +1),
        DiffSrc(YMAX, -1), DiffSrc(YMIN, -1), DiffSrc(YMAX, +1), DiffSrc(YMIN, +1),
    )
    return BoxScheme(
        name="8_12",
        ndir=8,
        ndiff=12,
        dir_src_faces=b810.dir_src_faces,
        diff_srcs=top + sides,
        dir_dst_by_face=(-1, -1, -1, -1, -1, -1),
        diff_dst_by_face_zsign=((0, 0), (1, 1), (4, 6), (5, 7), (8, 10), (9, 11)),
        dir_src_rects=b810.dir_src_rects,
        dir_classify="quad8",
        diff_face_class=(
            ("ring", (0, 2)),
            ("ring", (1, 3)),
            ("zsign", (4, 6)),
            ("zsign", (5, 7)),
            ("zsign", (8, 10)),
            ("zsign", (9, 11)),
        ),
        alim=alim,
    )


BOX_SCHEMES = {
    s.name: s
    for s in (
        _mk_1_2(), _mk_3_6(), _mk_3_10(), _mk_8_10(), _mk_3_16(), _mk_8_16(),
        _mk_3_24(), _mk_3_30(), _mk_8_18(), _mk_8_12(),
    )
}


def get_box_scheme(name: str) -> BoxScheme:
    if name not in BOX_SCHEMES:
        raise KeyError(
            f"BoxMC scheme {name!r} not implemented; available: {sorted(BOX_SCHEMES)}"
        )
    return BOX_SCHEMES[name]


def face_normal(face: int) -> np.ndarray:
    return _FACE_NORMAL[face]
