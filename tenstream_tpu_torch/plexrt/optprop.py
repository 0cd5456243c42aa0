"""Wedge transfer-coefficient tables, their creation and batched lookups
(port of `tenstream_tpu/plexrt/optprop.py`; reference `t_optprop_wedge`,
`src/optprop.F90:150-173`, with the `LUT_param_phi` shape handling).

One canonical table over (tau, w0, aspect, g [, phi, theta]) serves both
orientations of the structured mesh (the rotated triangle at phi + 180)
and, through `phi_rot` and the param-phi azimuth map, every cell of an
unstructured one.  Tables are cached as npz files under the JAX
package's cache key, so either package loads the other's.  A missing
table is traced with the wedge photon tracer (`plexrt.wedge_boxmc`),
every source of the table in one photon loop, with the JAX package's
per-entry keys: the port's tables equal JAX's up to float32 rounding.
Shape-blended tables (`WedgeOptPropShaped`) cover meshes whose cells
differ in shape.

On a decomposed solve (the solvers' `set_mesh`) nothing here changes:
the lookups are per cell and take the rank's cells, and
`WedgeOptPropShaped.bind_cells` is given the rank's cells' shapes.  Table
creation stays undecomposed, as in the JAX package, and runs before
`set_mesh`.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from tenstream_tpu_torch.core import prng
from tenstream_tpu_torch.core.types import ireals
from tenstream_tpu_torch.ops.interp import fractional_index, interp_multilinear_cf
from tenstream_tpu_torch.plexrt.param_phi import canonical_azimuth_map
from tenstream_tpu_torch.plexrt.wedge_boxmc import NDIFF, WedgeGroup, trace_wedge

_CACHE_VERSION = 2  # the JAX package's: file names of cached tables match
PHOTONS_PER_BATCH = 1 << 26  # photons traced in one loop when no chunk is given
_CKPT_EVERY = 64  # chunks between checkpoint writes of an unfinished job, as in JAX
DEFAULT_LUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data", "luts")


@dataclass(frozen=True)
class WedgeAxes:
    tau: np.ndarray
    w0: np.ndarray
    aspect: np.ndarray
    g: np.ndarray
    phi: Optional[np.ndarray] = None  # direct only, degrees in [0, 360]
    theta: Optional[np.ndarray] = None

    def hash(self) -> str:
        h = hashlib.sha256()
        for a in (self.tau, self.w0, self.aspect, self.g, self.phi, self.theta):
            if a is not None:
                h.update(np.asarray(a, np.float64).tobytes())
        h.update(bytes([_CACHE_VERSION]))
        return h.hexdigest()[:16]


# Per scheme: the direct sources (tracer dof indices; the bottom is never a
# source for a downward sun), each source's face, and each face's dst dofs
# (a straight-line direct photon never re-exits its own entry face).
_SCHEME_DIR = {
    "5_8": {
        "ndir": 5,
        "srcs": list(range(4)),  # top, AB, BC, CA
        "src_face": [0, 2, 3, 4],  # tracer face ids (0 top, 2..4 sides)
        "face_dsts": {0: [0], 2: [1], 3: [2], 4: [3]},
    },
    "18_8": {
        "ndir": 18,
        "srcs": list(range(15)),  # 3 top corners + 12 side quads
        "src_face": [0, 0, 0] + [2] * 4 + [3] * 4 + [4] * 4,
        "face_dsts": {0: [0, 1, 2], 2: [3, 4, 5, 6], 3: [7, 8, 9, 10],
                      4: [11, 12, 13, 14]},
    },
}


def n_dir_src(scheme: str = "5_8") -> int:
    return len(_SCHEME_DIR[scheme]["srcs"])


class WedgeLUT(NamedTuple):
    daxes: WedgeAxes
    faxes: WedgeAxes
    dir2dir: torch.Tensor  # (nt, nw, na, ng, nphi, nth, n_dir_src, ndir)
    dir2diff: torch.Tensor  # (..., n_dir_src, NDIFF)
    diff2diff: torch.Tensor  # (nt, nw, na, ng, NDIFF, NDIFF)
    scheme: str = "5_8"
    # apex C of the traced triangle in units of |AB| (canonical: (1, 1))
    apex: tuple = (1.0, 1.0)


def test_axes() -> WedgeAxes:
    return WedgeAxes(
        tau=np.array([1e-10, 0.1, 0.5, 1.5, 4.0, 15.0], np.float32),
        w0=np.array([0.0, 0.5, 0.9, 0.99999], np.float32),
        aspect=np.array([0.4, 1.0, 2.5], np.float32),
        g=np.array([0.0, 0.5, 0.85], np.float32),
        phi=np.linspace(0.0, 360.0, 7).astype(np.float32),
        theta=np.array([0.0, 40.0, 75.0], np.float32),
    )


def production_axes() -> tuple:
    """Axes of the committed production-intermediate table
    (`data/luts/WEDGE_LUT_5_8_9be52d897f4748f4.npz`, 4000 photons):
    direct tau 12 x w0 7 x aspect 8 x g 3 x phi 9 x theta 6, diffuse g 4."""
    daxes = WedgeAxes(
        tau=np.array([1e-10, 1e-2, 0.05, 0.15, 0.4, 0.8, 1.5, 3.0,
                      6.0, 12.0, 30.0, 100.0], np.float32),
        w0=np.array([0.0, 0.35, 0.6, 0.8, 0.9, 0.95, 0.99999], np.float32),
        aspect=np.array([0.15, 0.3, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0], np.float32),
        g=np.array([0.0, 0.45, 0.85], np.float32),
        phi=np.linspace(0.0, 360.0, 9).astype(np.float32),
        theta=np.array([0.0, 20.0, 40.0, 55.0, 67.5, 80.0], np.float32),
    )
    faxes = WedgeAxes(daxes.tau, daxes.w0, daxes.aspect,
                      np.array([0.0, 0.25, 0.5, 0.85], np.float32))
    return daxes, faxes


def default_axes() -> WedgeAxes:
    """The full-density wedge parameter space (the committed
    `data/luts/WEDGE_LUT_5_8_2557284b9366b4c4.npz` at 4000 photons):
    tau 13 x w0 8 x aspect 8 x g 4 x phi 13 x theta 7."""
    return WedgeAxes(
        tau=np.array([1e-10, 1e-3, 1e-2, 0.05, 0.15, 0.4, 0.8, 1.5,
                      3.0, 6.0, 12.0, 30.0, 100.0], np.float32),
        w0=np.array([0.0, 0.35, 0.6, 0.8, 0.9, 0.95, 0.99, 0.99999], np.float32),
        aspect=np.array([0.15, 0.3, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0], np.float32),
        g=np.array([0.0, 0.25, 0.5, 0.85], np.float32),
        phi=np.linspace(0.0, 360.0, 13).astype(np.float32),
        theta=np.array([0.0, 15.0, 30.0, 42.5, 55.0, 67.5, 80.0], np.float32),
    )


def wedge_lut_path(daxes: WedgeAxes, faxes: WedgeAxes, n_photons: int, basename=None,
                   scheme: str = "5_8", apex=None) -> str:
    """The cache file the JAX package's `load_or_create_wedge_lut` names."""
    apex_key = "" if apex is None else "{:.4f},{:.4f}".format(*(float(v) for v in apex))
    key = hashlib.sha256((daxes.hash() + faxes.hash() + str(n_photons) + apex_key).encode()
                         ).hexdigest()[:16]
    return os.path.join(basename or DEFAULT_LUT_DIR, f"WEDGE_LUT_{scheme}_{key}.npz")


def _grid(axes: WedgeAxes, ldir: bool) -> list:
    """The flat entry parameters (tau, w0, aspect, g [, phi, theta]) of an
    axes grid, float32, in JAX's meshgrid order."""
    grids = [axes.tau, axes.w0, axes.aspect, axes.g] + ([axes.phi, axes.theta] if ldir else [])
    return [np.asarray(m.ravel(), np.float32) for m in np.meshgrid(*grids, indexing="ij")]


def _trace_jobs(jobs, n_photons: int, scheme: str = "5_8", chunk: Optional[int] = None,
                verbose: bool = False, apex=None, max_iter: int = 3000, ckpt_dir=None,
                device="cuda"):
    """Trace every entry of every job (axes, src, ldir, seed), all jobs in
    one photon loop per chunk of entries.  Entry i of a job hashes under
    fold_in(PRNGKey(seed), i), as JAX's `_trace_grid` keys it, so results do
    not depend on the chunking.  A chunk is `chunk` entries of the jobs'
    pending entries laid end to end (default: PHOTONS_PER_BATCH photons).

    With `ckpt_dir`, each job has the checkpoint file JAX's
    `create_wedge_lut` gives its source there (`dir_<src>.npz` or
    `diff_<src>.npz`: T and S of its first `done_lo` entries), written when
    the job is done and every _CKPT_EVERY chunks; a rerun resumes each job
    after its rows, from a file of either package.  Returns (T, S) per job,
    (entries, ndir) and (entries, NDIFF), numpy float32."""
    flat = [_grid(ax, ldir) for ax, _, ldir, _ in jobs]
    sizes = [f[0].shape[0] for f in flat]
    chunk = chunk or max(1, PHOTONS_PER_BATCH // int(n_photons))
    bases = [prng.Threefry.from_seed(seed).words(device) for *_, seed in jobs]
    paths = [None if ckpt_dir is None else
             os.path.join(ckpt_dir, f"{'dir' if ldir else 'diff'}_{src}.npz")
             for _, src, ldir, _ in jobs]
    ndir = _SCHEME_DIR[scheme]["ndir"]
    Ts = [np.zeros((n, ndir), np.float32) for n in sizes]  # filled up to done[j]
    Ss = [np.zeros((n, NDIFF), np.float32) for n in sizes]
    done = [0] * len(jobs)
    for j, path in enumerate(paths):
        if path is not None and os.path.exists(path):
            z = np.load(path)
            done[j] = int(z["done_lo"])
            Ts[j][:done[j]], Ss[j][:done[j]] = z["T"][:done[j]], z["S"][:done[j]]
            if verbose:
                print(f"  wedge trace: job {j} resumes at {done[j]}/{sizes[j]}", flush=True)

    def save_ckpt(j):
        tmp = paths[j][:-len(".npz")] + ".tmp.npz"  # np.savez appends .npz
        np.savez(tmp, T=Ts[j][:done[j]], S=Ss[j][:done[j]], done_lo=done[j])
        os.replace(tmp, paths[j])

    t = lambda a: torch.as_tensor(a, device=device)
    queue = [[j, done[j]] for j in range(len(jobs)) if done[j] < sizes[j]]
    n_chunks = 0
    while queue:
        take, room = [], chunk  # (job, lo, hi) ranges of this chunk
        while queue and room:
            j, a = queue[0]
            b = min(sizes[j], a + room)
            take.append((j, a, b))
            room -= b - a
            if b == sizes[j]:
                queue.pop(0)
            else:
                queue[0][1] = b
        groups = []
        for j, a, b in take:
            _, src, ldir, _ = jobs[j]
            keys = prng.fold_in_keys(bases[j], torch.arange(a, b, device=device))
            p = [t(f[a:b]) for f in flat[j]]
            ang = p[4:] if ldir else [torch.zeros_like(p[0])] * 2
            groups.append(WedgeGroup(keys, src, ldir, p[0], p[1], p[3], p[2], *ang))
        out = trace_wedge(groups, n_photons, max_iter, scheme, apex=apex)
        n_chunks += 1
        for (j, a, b), (T, S) in zip(take, out):
            Ts[j][a:b], Ss[j][a:b] = T.cpu().numpy(), S.cpu().numpy()
            done[j] = b
            if paths[j] is not None and (b == sizes[j] or n_chunks % _CKPT_EVERY == 0):
                save_ckpt(j)
        if verbose:
            print(f"  wedge trace: {sum(done)}/{sum(sizes)} entries", flush=True)
    return list(zip(Ts, Ss))


def _sanitize_dir_tables(daxes: WedgeAxes, d2d: np.ndarray, d2f: np.ndarray,
                         scheme: str = "5_8", apex=None) -> None:
    """Make downwind source rows interpolation-safe (in place; JAX
    `_sanitize_dir_tables`).  A side face is a direct inflow only where the
    sun has an inward component; at downwind (phi, theta) points the traced
    photons exit straight back out.  Zero each source's own-face columns
    and replace every downwind grid point by its nearest valid phi (same
    theta), or the nearest valid theta when a whole phi circle is invalid
    (the reference's `LUT_param_phi` valid-range bookkeeping)."""
    phis = np.deg2rad(np.asarray(daxes.phi, np.float64))
    thetas = np.deg2rad(np.asarray(daxes.theta, np.float64))
    PH, TH = np.meshgrid(phis, thetas, indexing="ij")
    d = np.stack([np.sin(PH) * np.sin(TH), np.cos(PH) * np.sin(TH), -np.cos(TH)], axis=-1)
    cx, cy = apex if apex is not None else (1.0, 1.0)
    Lbc, Lca = np.hypot(cx - 1.0, cy), np.hypot(cx, cy)
    # inward face normals by tracer face id (0 top, 2 AB, 3 BC, 4 CA)
    face_normal = {0: (0.0, 0.0, -1.0), 2: (0.0, 1.0, 0.0),
                   3: (-cy / Lbc, (cx - 1.0) / Lbc, 0.0), 4: (cy / Lca, -cx / Lca, 0.0)}
    cfg = _SCHEME_DIR[scheme]
    nphi, nth = len(phis), len(thetas)
    for s, face in enumerate(cfg["src_face"]):
        d2d[..., s, cfg["face_dsts"][face]] = 0.0
        valid = d @ np.asarray(face_normal[face]) > 1e-6  # (nphi, nth)
        for it in range(nth):
            v = valid[:, it]
            if v.all() or not v.any():
                continue
            vi = np.where(v)[0]
            for ip in np.where(~v)[0]:
                dist = np.minimum(np.abs(vi - ip), nphi - np.abs(vi - ip))  # circular
                j = vi[np.argmin(dist)]
                d2d[..., ip, it, s, :] = d2d[..., j, it, s, :]
                d2f[..., ip, it, s, :] = d2f[..., j, it, s, :]
        row_ok = valid.any(axis=0)  # whole theta rows invalid (grazing)
        if row_ok.any() and not row_ok.all():
            ok = np.where(row_ok)[0]
            for it in np.where(~row_ok)[0]:
                j = ok[np.argmin(np.abs(ok - it))]
                d2d[..., :, it, s, :] = d2d[..., :, j, s, :]
                d2f[..., :, it, s, :] = d2f[..., :, j, s, :]


def create_wedge_lut(daxes: WedgeAxes, faxes: WedgeAxes, n_photons: int = 5000, seed: int = 0,
                     verbose: bool = False, scheme: str = "5_8", apex=None,
                     chunk: Optional[int] = None, max_iter: int = 3000, ckpt_dir=None,
                     device="cuda") -> WedgeLUT:
    """Trace a wedge table (JAX `create_wedge_lut`), on `device`: direct
    source s under seed + s, diffuse source s under seed + 100 + s, all in
    one photon loop per chunk.  `apex=(cx, cy)` traces the general triangle
    A=(0,0) B=(1,0) C=(cx, cy) instead of the canonical right triangle; the
    mirror symmetrization of the diffuse table applies to the canonical
    shape only.  Grids of 50,000 direct entries or more checkpoint each
    source to `ckpt_dir` in JAX's layout and resume from it.  The tracer
    counts its work in `wedge_boxmc.STATS`."""
    cfg = _SCHEME_DIR[scheme]
    nsrc, ndir = len(cfg["srcs"]), cfg["ndir"]
    nd = tuple(len(a) for a in (daxes.tau, daxes.w0, daxes.aspect, daxes.g, daxes.phi,
                                daxes.theta))
    nf = tuple(len(a) for a in (faxes.tau, faxes.w0, faxes.aspect, faxes.g))
    if int(np.prod(nd)) < 50_000:
        ckpt_dir = None  # small grids retrace in seconds
    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
    jobs = ([(daxes, src, True, seed + src) for src in cfg["srcs"]]
            + [(faxes, src, False, seed + 100 + src) for src in range(NDIFF)])
    out = _trace_jobs(jobs, n_photons, scheme, chunk, verbose, apex, max_iter, ckpt_dir, device)
    d2d = np.stack([T.reshape(nd + (ndir,)) for T, _ in out[:nsrc]], axis=-2)
    d2f = np.stack([S.reshape(nd + (NDIFF,)) for _, S in out[:nsrc]], axis=-2)
    f2f = np.stack([S.reshape(nf + (NDIFF,)) for _, S in out[nsrc:]], axis=-2)

    _sanitize_dir_tables(daxes, d2d, d2f, scheme, apex=apex)
    if apex is None:
        # the right isoceles triangle's mirror about the axis through B swaps
        # AB <-> BC and fixes top / bot / CA: averaging the diffuse table with
        # its mirror image makes the symmetry exact
        perm = np.array([0, 3, 4, 1, 2, 5, 6, 7])
        f2f[:] = 0.5 * (f2f + f2f[..., perm, :][..., :, perm])
    # phi is periodic: the 360-degree column equals 0 degrees
    if np.isclose(daxes.phi[0], 0.0) and np.isclose(daxes.phi[-1], 360.0):
        d2d[..., -1, :, :, :] = d2d[..., 0, :, :, :]
        d2f[..., -1, :, :, :] = d2f[..., 0, :, :, :]
    for name, tab in (("dir2dir", d2d), ("dir2diff", d2f), ("diff2diff", f2f)):
        if not np.isfinite(tab).all():
            raise FloatingPointError(f"wedge LUT {name} has non-finite entries")
        if not (tab.sum(-1) <= 1.0 + 1e-3).all():
            raise FloatingPointError(f"wedge LUT {name} row sums exceed 1")
    t = lambda a: torch.as_tensor(a, device=device)
    return WedgeLUT(daxes, faxes, t(d2d), t(d2f), t(f2f), scheme,
                    tuple(float(v) for v in apex) if apex is not None else (1.0, 1.0))


def load_or_create_wedge_lut(daxes: Optional[WedgeAxes] = None,
                             faxes: Optional[WedgeAxes] = None, n_photons: int = 5000,
                             basename: Optional[str] = None, scheme: str = "5_8", apex=None,
                             device="cuda", verbose: bool = False, chunk: Optional[int] = None,
                             max_iter: Optional[int] = None) -> WedgeLUT:
    """The wedge table of these axes (defaults: the test axes, diffuse axes
    from the direct ones) on `device`: loaded from its cache file, or traced
    on `device` and written there (with a checkpoint directory beside it).
    chunk / max_iter default to $WEDGE_CHUNK / $WEDGE_MAX_ITER (3000) and
    are not part of the cache key, as in JAX."""
    daxes = daxes or test_axes()
    faxes = faxes or WedgeAxes(daxes.tau, daxes.w0, daxes.aspect, daxes.g)
    if chunk is None and os.environ.get("WEDGE_CHUNK"):
        chunk = int(os.environ["WEDGE_CHUNK"])
    if max_iter is None:
        max_iter = int(os.environ.get("WEDGE_MAX_ITER", "3000"))
    path = wedge_lut_path(daxes, faxes, n_photons, basename, scheme, apex)
    apex_t = tuple(float(v) for v in apex) if apex is not None else (1.0, 1.0)
    if os.path.exists(path):
        z = np.load(path)
        t = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
        return WedgeLUT(daxes, faxes, t("dir2dir"), t("dir2diff"), t("diff2diff"), scheme, apex_t)
    root = os.path.dirname(path)
    os.makedirs(root, exist_ok=True)
    ckpt_dir = os.path.join(root, os.path.basename(path)[:-len(".npz")].replace(
        "WEDGE_LUT_", "ckpt_WEDGE_"))
    lut = create_wedge_lut(daxes, faxes, n_photons, verbose=verbose, scheme=scheme, apex=apex,
                           chunk=chunk, max_iter=max_iter, ckpt_dir=ckpt_dir, device=device)
    np.savez_compressed(path, dir2dir=lut.dir2dir.cpu().numpy(),
                        dir2diff=lut.dir2diff.cpu().numpy(), diff2diff=lut.diff2diff.cpu().numpy())
    return lut


def _apexes(mesh):
    """Per-cell apex (cx, |cy|) in the cell-local canonical frame (side 0
    = AB on +x, unit AB), numpy float64."""
    v = mesh.verts[mesh.tris]  # (nc, 3, 2)
    ab = v[:, 1] - v[:, 0]
    ac = v[:, 2] - v[:, 0]
    L = np.maximum(np.linalg.norm(ab, axis=-1), 1e-30)
    abh = ab / L[:, None]
    cx = (ac * abh).sum(-1) / L
    cy = np.abs(ac[:, 1] * abh[:, 0] - ac[:, 0] * abh[:, 1]) / L
    return cx, cy


def mesh_cell_shapes(mesh):
    """Per-cell apex (cx, cy), cy at least 1e-6."""
    cx, cy = _apexes(mesh)
    return cx, np.maximum(cy, 1e-6)


def wedge_lut_for_mesh(mesh, daxes=None, faxes=None, n_photons: int = 5000, basename=None,
                       device="cuda", verbose: bool = False) -> WedgeLUT:
    """The shape-aware table for an unstructured mesh: traced (or loaded)
    at the mesh's area-weighted mean cell shape instead of the canonical
    right triangle; the solver's param-phi azimuth map handles each cell's
    residual deviation from it."""
    cx, cy = _apexes(mesh)
    w = mesh.area / mesh.area.sum()
    apex = (float((cx * w).sum()), float(np.maximum((cy * w).sum(), 1e-3)))
    return load_or_create_wedge_lut(daxes, faxes, n_photons, basename, apex=apex, device=device,
                                    verbose=verbose)


def wedge_optprop_for_mesh(mesh, daxes=None, faxes=None, n_photons: int = 5000, basename=None,
                           verbose: bool = False, shape_tol: float = 0.05, device="cuda"):
    """Shape coverage for any triangle mesh (JAX `wedge_optprop_for_mesh`;
    the reference's triangle-shape LUT axes realized as per-cell table
    blending).  A mesh whose apexes spread by at most `shape_tol` in both
    coordinates gets one mean-shape table (`wedge_lut_for_mesh`); a wider
    spread gets the 2 or 4 tables at the corners of its apex bounding box,
    blended per cell (`WedgeOptPropShaped`)."""
    cx, cy = mesh_cell_shapes(mesh)
    w = mesh.area / mesh.area.sum()
    lo = (float(cx.min()), float(cy.min()))
    hi = (float(cx.max()), float(cy.max()))
    span = (hi[0] - lo[0], hi[1] - lo[1])
    if max(span) <= shape_tol:
        return WedgeOptProp(wedge_lut_for_mesh(mesh, daxes, faxes, n_photons, basename, device,
                                               verbose))
    xs = [lo[0], hi[0]] if span[0] > shape_tol else [float((cx * w).sum())]
    ys = [lo[1], hi[1]] if span[1] > shape_tol else [float((cy * w).sum())]
    luts = [load_or_create_wedge_lut(daxes, faxes, n_photons, basename, apex=(ax, ay),
                                     device=device, verbose=verbose)
            for ay in ys for ax in xs]
    opp = WedgeOptPropShaped(luts)
    opp.bind_cells(cx, cy)
    return opp


class WedgeOptProp:
    """Batched coefficient lookups on one wedge table, on the table's
    device (or `device`)."""

    def __init__(self, lut: WedgeLUT, device=None):
        self.device = lut.diff2diff.device if device is None else torch.device(device)
        self.lut = lut
        self._d2d = lut.dir2dir.to(self.device, ireals)
        self._d2f = lut.dir2diff.to(self.device, ireals)
        self._f2f = lut.diff2diff.to(self.device, ireals)
        ax = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self._faxes = [ax(a) for a in (lut.faxes.tau, lut.faxes.w0, lut.faxes.aspect,
                                       lut.faxes.g)]
        self._daxes = [ax(a) for a in (lut.daxes.tau, lut.daxes.w0, lut.daxes.aspect,
                                       lut.daxes.g, lut.daxes.phi, lut.daxes.theta)]

    @staticmethod
    def _fracs(axes, tauz, w0, g, aspect):
        return [fractional_index(a, x) for a, x in zip(axes, (tauz, w0, aspect, g))]

    def diff_coeffs(self, tauz, w0, g, aspect):
        """(NDIFF src, NDIFF dst, ...), channels-first."""
        return interp_multilinear_cf(self._f2f, self._fracs(self._faxes, tauz, w0, g, aspect))

    def dir_coeffs(self, tauz, w0, g, aspect, phi_deg, theta_deg):
        """(n_dir_src, ndir, ...) and (n_dir_src, NDIFF, ...), channels-first.
        phi wraps periodically (pass per-cell phi: the T1
        orientation adds 180 upstream)."""
        dev = self.device
        phi = torch.remainder(torch.as_tensor(phi_deg, dtype=ireals, device=dev), 360.0)
        theta = torch.as_tensor(theta_deg, dtype=ireals, device=dev)
        fr = self._fracs(self._daxes[:4], tauz, w0, g, aspect) + [
            fractional_index(self._daxes[4], phi), fractional_index(self._daxes[5], theta)]
        return interp_multilinear_cf(self._d2d, fr), interp_multilinear_cf(self._d2f, fr)


class WedgeOptPropShaped:
    """Per-cell shape interpolation over K shape-sample wedge tables (JAX
    `WedgeOptPropShaped`).  Each table is shape-exact at its apex;
    `bind_cells` computes each mesh cell's bilinear weights in (cx, cy) apex
    space (clipped to the samples' hull).  A lookup evaluates every table
    and blends them, each table mapping the raw cell azimuth onto its own
    shape with the param-phi map, so solvers pass the unmapped azimuth.
    Coefficients are channels-first with the cell axis last, as
    `WedgeOptProp` returns them."""

    def __init__(self, luts, device=None):
        if not luts:
            raise ValueError("WedgeOptPropShaped needs at least one shape-sample table")
        self.luts = list(luts)
        self.tabs = [WedgeOptProp(lut, device) for lut in self.luts]
        self.device = self.tabs[0].device
        self.apexes = np.asarray([tuple(lut.apex) for lut in self.luts], np.float64)
        self.lut = self.luts[0]  # scheme and axes
        self._w = None
        self._cells = None

    def bind_cells(self, cx, cy) -> None:
        xs = np.unique(self.apexes[:, 0])
        ys = np.unique(self.apexes[:, 1])
        u = (np.clip((cx - xs[0]) / (xs[-1] - xs[0]), 0.0, 1.0)
             if len(xs) > 1 else np.zeros_like(cx))
        v = (np.clip((cy - ys[0]) / (ys[-1] - ys[0]), 0.0, 1.0)
             if len(ys) > 1 else np.zeros_like(cy))
        ws = []
        for lut in self.luts:
            ax, ay = lut.apex
            wx = np.where(np.isclose(ax, xs[0]), 1.0 - u, u) if len(xs) > 1 else np.ones_like(u)
            wy = np.where(np.isclose(ay, ys[0]), 1.0 - v, v) if len(ys) > 1 else np.ones_like(v)
            ws.append(wx * wy)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=ireals, device=self.device)
        self._w = t(np.stack(ws))  # (K, nc)
        self._cells = (t(cx), t(cy))

    def _weights(self):
        if self._w is None:
            raise RuntimeError("call bind_cells(cx, cy) first")
        return self._w

    def _blend(self, parts):
        w = self._weights()
        out = None
        for k, p in enumerate(parts):
            out = p * w[k] if out is None else out + p * w[k]
        return out

    def diff_coeffs(self, tauz, w0, g, aspect):
        self._weights()
        return self._blend([t.diff_coeffs(tauz, w0, g, aspect) for t in self.tabs])

    def dir_coeffs(self, tauz, w0, g, aspect, phi_deg, theta_deg):
        """phi_deg: the RAW cell azimuth (phi + phi_rot), unmapped."""
        self._weights()
        cx, cy = self._cells
        dd_parts, df_parts = [], []
        for t in self.tabs:
            ax, ay = t.lut.apex
            phi_k = canonical_azimuth_map(torch.as_tensor(phi_deg, dtype=ireals, device=self.device),
                                          cx[None, :], cy[None, :], float(ax), float(ay))
            dd, df = t.dir_coeffs(tauz, w0, g, aspect, phi_k, theta_deg)
            dd_parts.append(dd)
            df_parts.append(df)
        return self._blend(dd_parts), self._blend(df_parts)
