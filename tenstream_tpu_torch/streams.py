"""Stream-scheme definitions for the cube solvers (the port's own copy of
`tenstream_tpu/streams.py`: pure numpy data, tested equal to the JAX
package's tables in `tests/test_torch_streams.py`).

Parity: reference `src/pprts.F90:256-450` (per-scheme `is_inward` masks and
dof counts) and the BoxMC `.inc` stream geometries (e.g.
`src/boxmc_3_10.inc:20-64`).  A scheme "A_B" has A direct and B diffuse
streams per cell, grouped as

  direct : [dirtop dofs | dirside-x dofs | dirside-y dofs]
  diffuse: [difftop dofs | diffside-x dofs | diffside-y dofs]

`is_inward` semantics (reference `t_dof`, `src/pprts_base.F90:171`):
for top dofs, inward == downward (+z index direction); for side dofs,
inward == toward increasing x (resp. y).  The state arrays index streams
by the face at the low-index side of a cell: top stream dof at level k
lives on the z-face above cell-layer k; a side stream dof at column i
lives on the x-face between cells i-1 and i (periodic).

`area_divider` splits the face area across the dofs sharing it
(`src/pprts.F90:362-368` for 8_10: dirtop divider 4, dirside 2).

Stream <-> LUT numbering: the flattened diffuse dof order here equals the
BoxMC destination numbering of the reference schemes (checked against
`src/boxmc_3_10.inc:36-64`), so transfer matrices are indexed [src, dst]
with both in dof order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class DofGroup:
    is_inward: Tuple[bool, ...]
    area_divider: int = 1

    @property
    def dof(self) -> int:
        return len(self.is_inward)

    @property
    def streams(self) -> int:
        # reference: difftop%streams = dof/2 (up/down pairs), dir streams = dof
        return max(1, self.dof)


@dataclass(frozen=True)
class StreamScheme:
    """Static description of one solver scheme (replaces the reference's
    13 `t_solver_*` derived types with data).

    Angular sub-structure of the dof groups is described by styles:

    top_style (difftop dofs come in adjacent (up, dn) pairs):
      * "pairs"       plain pairs, no angular substructure (1_2, 3_6, 3_10)
      * "sector"      4 azimuth-sector pairs (+y,-x,-y,+x), `boxmc_3_16.inc`
      * "sector_main" main pair (mu >= alim) + 4 sector pairs, `boxmc_8_18.inc`
      * "quad"        4 azimuth-quadrant pairs, `boxmc_3_24.inc`
      * "quad_main"   main pair + 4 quadrant pairs, `boxmc_3_30.inc`

    side_style (per side-axis group, (out, in)-interleaved):
      * "none" / "plain"  no dofs / one (out, in) pair (3_6)
      * "zsplit"      (out,in) x (dn, up) halves: [o_dn,i_dn,o_up,i_up]
      * "quad"        (out,in) x 4 quadrants of the face tangentials
      * "quad_main"   (out,in) x (main + 4 quadrants)

    Quadrant numbering (mirrors `update_diff_stream_3_24`): for a face
    with ordered tangential axes (t1, t2), q = 2*(t1<0) + (t2<0).
    Tangentials: top/bot faces (x, y); x-side faces (y, z); y-side
    faces (x, z).
    """

    name: str
    dirtop: DofGroup
    dirside: DofGroup
    difftop: DofGroup
    diffside: DofGroup
    # True when the difftop dofs are azimuth-sectored (+y,-x,-y,+x) x
    # (up,dn) pairs (3_16 / 8_16 style); equivalent to top_style="sector"
    sectored_top: bool = False
    top_style: str = ""
    side_style: str = ""
    # angular limit separating the "main" stream from sector/quadrant
    # streams (reference alim_3_30 / the .75 literal in boxmc_8_18.inc)
    alim: float = 0.75

    def _top_style(self) -> str:
        if self.top_style:
            return self.top_style
        return "sector" if self.sectored_top else "pairs"

    def _side_style(self) -> str:
        if self.side_style:
            return self.side_style
        ns = self.diffside.dof
        if ns == 0:
            return "none"
        if ns == 2:
            return "plain"
        if ns == 4:
            return "zsplit"
        raise ValueError(f"{self.name}: cannot infer side_style for dof {ns}")

    # ---- counts ---------------------------------------------------------
    @property
    def ndir(self) -> int:
        return self.dirtop.dof + 2 * self.dirside.dof

    @property
    def ndiff(self) -> int:
        return self.difftop.dof + 2 * self.diffside.dof

    # ---- offset/direction tables (numpy, used at trace time) ------------
    def dir_src_offsets(self) -> np.ndarray:
        """(ndir, 3) int offsets (dz, dx, dy) of each direct src face
        relative to cell (k,i,j), for canonical sun orientation
        xinc=yinc=1 (reference sweep reads src top at k, x-side at face i,
        y-side at face j: `src/pprts_explicit.F90:399-413` with
        i+1-xinc == i for xinc=1)."""
        out = []
        for _ in range(self.dirtop.dof):
            out.append((0, 0, 0))
        for _ in range(self.dirside.dof):
            out.append((0, 0, 0))
        for _ in range(self.dirside.dof):
            out.append((0, 0, 0))
        return np.array(out, np.int32)

    def diff_axis(self) -> np.ndarray:
        """(ndiff,) axis id per diffuse dof: 0=z(top), 1=x-side, 2=y-side."""
        return np.array(
            [0] * self.difftop.dof + [1] * self.diffside.dof + [2] * self.diffside.dof,
            np.int32,
        )

    def diff_inward(self) -> np.ndarray:
        """(ndiff,) bool: inward flag per diffuse dof."""
        return np.array(
            list(self.difftop.is_inward)
            + list(self.diffside.is_inward) * 2,
            bool,
        )

    def dir_axis(self) -> np.ndarray:
        return np.array(
            [0] * self.dirtop.dof + [1] * self.dirside.dof + [2] * self.dirside.dof,
            np.int32,
        )

    def dir_switch_perm(self, switch_x: bool, switch_y: bool) -> np.ndarray:
        """Direct-dof permutation unfolding the LUT's canonical sun octant
        for schemes with sub-face direct streams (reference
        `dir2dir8_coeff_symmetry`, `src/optprop.F90`: east switch swaps
        top-quadrants 0<->1, 2<->3; north switch swaps 0<->2, 1<->3;
        side dofs unchanged).  Identity for single-top-dof schemes."""
        perm = np.arange(self.ndir)
        if self.dirtop.dof == 4:
            if switch_x:
                perm[:4] = perm[[1, 0, 3, 2]]
            if switch_y:
                perm[:4] = perm[[2, 3, 0, 1]]
        return perm

    # pair layouts: list of (kind, id) per adjacent dof pair
    def _top_pairs(self):
        st = self._top_style()
        if st == "pairs":
            return [("plain", p) for p in range(self.difftop.dof // 2)]
        if st == "sector":
            return [("sector", s) for s in range(4)]
        if st == "sector_main":
            return [("main", 0)] + [("sector", s) for s in range(4)]
        if st == "quad":
            return [("quad", q) for q in range(4)]
        if st == "quad_main":
            return [("main", 0)] + [("quad", q) for q in range(4)]
        if st == "ring":
            # two full-azimuth mu rings split at alim (boxmc_8_12.inc)
            return [("main", 0), ("ring", 0)]
        raise ValueError(f"unknown top_style {st!r}")

    def _side_pairs(self):
        st = self._side_style()
        if st == "none":
            return []
        if st == "plain":
            return [("plain", 0)]
        if st == "zsplit":
            return [("zh", 0), ("zh", 1)]  # dn half, up half
        if st == "quad":
            return [("quad", q) for q in range(4)]
        if st == "quad_main":
            return [("main", 0)] + [("quad", q) for q in range(4)]
        raise ValueError(f"unknown side_style {st!r}")

    @staticmethod
    def _apply_pair_map(perm, base, pairs, id_map, swap_in_pair=False):
        """Write the dof permutation of a (pair-structured) block: pair p
        maps to the pair holding id_map(kind, id); optionally the (a, b)
        dofs within the pair swap."""
        for p, (kind, pid) in enumerate(pairs):
            kind2, pid2 = id_map(kind, pid)
            p2 = pairs.index((kind2, pid2))
            a, b = base + 2 * p, base + 2 * p + 1
            a2, b2 = base + 2 * p2, base + 2 * p2 + 1
            perm[a], perm[b] = (b2, a2) if swap_in_pair else (a2, b2)

    def _mirror_perm(self, op: str) -> np.ndarray:
        """Diffuse-dof permutation under one cube symmetry:
        op in ('mx', 'my', 'mz', 'mxy')."""
        nt, ns = self.difftop.dof, self.diffside.dof
        perm = np.arange(self.ndiff)

        # --- top block: tangentials (t1, t2) = (x, y) -------------------
        sec_mx = {1: 3, 3: 1}  # -x <-> +x sectors
        sec_my = {0: 2, 2: 0}
        sec_mxy = {0: 3, 3: 0, 1: 2, 2: 1}

        def top_map(kind, pid):
            if kind in ("plain", "main", "ring"):
                return (kind, pid)  # azimuthally symmetric bins
            if kind == "sector":
                m = {"mx": sec_mx, "my": sec_my, "mxy": sec_mxy, "mz": {}}[op]
                return (kind, m.get(pid, pid))
            # quad: q = 2*(t1<0) + (t2<0); t1 flip -> q^2, t2 flip -> q^1,
            # t1<->t2 swap -> exchange (+,-) and (-,+)
            if op == "mx":
                return (kind, pid ^ 2)
            if op == "my":
                return (kind, pid ^ 1)
            if op == "mxy":
                return (kind, {1: 2, 2: 1}.get(pid, pid))
            return (kind, pid)

        self._apply_pair_map(perm, 0, self._top_pairs(), top_map,
                             swap_in_pair=(op == "mz"))

        # --- side blocks ------------------------------------------------
        if ns:
            spairs = self._side_pairs()
            xlo, ylo = nt, nt + ns

            def side_map(flip_axis, flip_t1, flip_t2):
                def f(kind, pid):
                    if kind == "zh":  # zsplit halves: z flip swaps them
                        return (kind, pid ^ 1) if flip_t2 else (kind, pid)
                    if kind == "quad":
                        q = pid
                        if flip_t1:
                            q ^= 2
                        if flip_t2:
                            q ^= 1
                        return (kind, q)
                    return (kind, pid)  # plain / main
                return f, flip_axis

            if op == "mxy":
                # x<->y group exchange; quadrant index is preserved
                # (x-side tangentials (y,z) map onto y-side (x,z))
                perm[xlo : xlo + ns], perm[ylo : ylo + ns] = (
                    np.arange(ylo, ylo + ns),
                    np.arange(xlo, xlo + ns),
                )
            else:
                # action per group: (flip own axis, flip t1, flip t2)
                # x-sides: t = (y, z); y-sides: t = (x, z)
                acts = {
                    "mx": (((True, False, False)), ((False, True, False))),
                    "my": (((False, True, False)), ((True, False, False))),
                    "mz": (((False, False, True)), ((False, False, True))),
                }[op]
                for lo, (fa, f1, f2) in zip((xlo, ylo), acts):
                    fmap, swap = side_map(fa, f1, f2)
                    self._apply_pair_map(perm, lo, spairs, fmap,
                                         swap_in_pair=swap)
        return perm

    def diff_switch_perm(self, switch_x: bool, switch_y: bool) -> np.ndarray:
        """Diffuse-dst permutation unfolding the LUT sun octant
        (reference `dir3_to_diff10/16_coeff_symmetry`,
        `src/optprop.F90:1009+`): the composition of the x/y mirror
        permutations for the switched axes."""
        perm = np.arange(self.ndiff)
        if switch_x:
            perm = self._mirror_perm("mx")[perm]
        if switch_y:
            perm = self._mirror_perm("my")[perm]
        return perm

    def diff_mirror_perms(self) -> Dict[str, list]:
        """Cube-symmetry dof permutations for LUT symmetrization
        (x-mirror, y-mirror, z-mirror, x<->y exchange), generated from
        the group styles."""
        return {op: list(self._mirror_perm(op)) for op in ("mx", "my", "mz", "mxy")}

    def dir_mirror_perm_xy(self) -> list:
        """Direct-dof permutation under the x<->y exchange (pairs with
        the LUT's phi -> 90-phi mirror)."""
        perm = np.arange(self.ndir)
        if self.dirtop.dof == 4:
            perm[[1, 2]] = [2, 1]  # quadrants (x>,y<=) <-> (x<=,y>)
        if self.dirside.dof:
            nt, ns = self.dirtop.dof, self.dirside.dof
            perm[nt : nt + ns], perm[nt + ns : nt + 2 * ns] = (
                perm[nt + ns : nt + 2 * ns].copy(),
                perm[nt : nt + ns].copy(),
            )
        return list(perm)

    # ---- Lambertian bin weights ----------------------------------------
    def _pair_weights(self, pairs) -> np.ndarray:
        if not pairs:
            return np.zeros((0,))
        has_main = any(k == "main" for k, _ in pairs)
        if has_main:
            # main stream: mu in [alim, 1] of a cosine-weighted hemisphere
            # carries 1 - alim^2; a full outer ring alim^2, each
            # sector/quadrant alim^2/4
            w = {"main": 1.0 - self.alim**2, "ring": self.alim**2}
            return np.array([w.get(k, self.alim**2 / 4.0) for k, _ in pairs])
        return np.full((len(pairs),), 1.0 / len(pairs))

    def difftop_weights(self) -> np.ndarray:
        """(difftop.dof,) fraction of the hemisphere each dof's bin
        carries (pair members share the weight; one hemisphere's dofs
        sum to 1).  Used to split Lambertian emission/reflection."""
        return np.repeat(self._pair_weights(self._top_pairs()), 2)

    def diffside_weights(self) -> np.ndarray:
        """(diffside.dof,) per-dof bin weights of one side group."""
        return np.repeat(self._pair_weights(self._side_pairs()), 2)

    def diffside_bsrc_top(self) -> np.ndarray:
        """(diffside.dof,) fraction of the side emission taken from the
        layer-top Planck value (vs layer-bottom), by the bin's z sense
        (reference `set_thermal_source` iside > dof/2 -> btop,
        `src/pprts.F90:4920-4924`)."""
        st = self._side_style()
        if st == "none":
            return np.zeros((0,))
        if st == "plain":
            return np.array([0.0, 1.0])
        if st == "zsplit":
            return np.array([0.0, 0.0, 1.0, 1.0])
        # quadrants: q = 2*(t1<0) + (t2<0) with t2 = z
        quad = np.repeat([1.0, 0.0, 1.0, 0.0], 2)
        if st == "quad":
            return quad
        return np.concatenate([[0.5, 0.5], quad])  # quad_main

    def diff_inv_dof(self) -> np.ndarray:
        """(ndiff,) index of the same stream with opposite direction
        (reference `inv_dof`, `src/pprts_explicit.F90:1001-1014`).
        Streams come in adjacent (out, in) pairs in every scheme."""
        inv = np.arange(self.ndiff)
        axis = self.diff_axis()
        inward = self.diff_inward()
        # pair adjacent dofs with opposite direction within the same group
        i = 0
        while i < self.ndiff - 1:
            if axis[i] == axis[i + 1] and inward[i] != inward[i + 1]:
                inv[i], inv[i + 1] = i + 1, i
                i += 2
            else:
                i += 1
        return inv


def _grp(mask, divider=1) -> DofGroup:
    return DofGroup(tuple(mask), divider)


# Scheme registry, masks verbatim from reference `src/pprts.F90:256-450`.
F, T = False, True
SCHEMES: Dict[str, StreamScheme] = {
    "1_2": StreamScheme("1_2", _grp([T]), _grp([]), _grp([F, T]), _grp([])),
    "2str": StreamScheme("2str", _grp([T]), _grp([]), _grp([F, T]), _grp([])),
    "disort": StreamScheme("disort", _grp([T]), _grp([]), _grp([F, T]), _grp([])),
    "3_6": StreamScheme("3_6", _grp([T]), _grp([T]), _grp([F, T]), _grp([F, T])),
    "3_10": StreamScheme("3_10", _grp([T]), _grp([T]), _grp([F, T]), _grp([F, T, F, T])),
    "3_16": StreamScheme(
        "3_16", _grp([T]), _grp([T]), _grp([F, T] * 4), _grp([F, T, F, T]),
        sectored_top=True,
    ),
    "3_24": StreamScheme(
        "3_24", _grp([T]), _grp([T]), _grp([F, T] * 4), _grp([F, T] * 4),
        top_style="quad", side_style="quad",
    ),
    "3_30": StreamScheme(
        "3_30", _grp([T]), _grp([T]), _grp([F, T] * 5), _grp([F, T] * 5),
        top_style="quad_main", side_style="quad_main",
    ),
    "8_10": StreamScheme(
        "8_10", _grp([T] * 4, 4), _grp([T] * 2, 2), _grp([F, T]), _grp([F, T, F, T])
    ),
    "8_12": StreamScheme(
        "8_12", _grp([T] * 4, 4), _grp([T] * 2, 2), _grp([F, T] * 2), _grp([F, T, F, T]),
        top_style="ring", side_style="zsplit", alim=0.5,
    ),
    "8_16": StreamScheme(
        "8_16", _grp([T] * 4, 4), _grp([T] * 2, 2), _grp([F, T] * 4), _grp([F, T, F, T]),
        sectored_top=True,
    ),
    "8_18": StreamScheme(
        "8_18", _grp([T] * 4, 4), _grp([T] * 2, 2), _grp([F, T] * 5), _grp([F, T, F, T]),
        top_style="sector_main", side_style="zsplit",
    ),
}


def get_scheme(name: str) -> StreamScheme:
    if name not in SCHEMES:
        raise KeyError(f"unknown scheme {name!r}; known: {sorted(SCHEMES)}")
    return SCHEMES[name]
