"""Wedge transfer-coefficient tables and batched lookups (port of the
lookup half of `tenstream_tpu/plexrt/optprop.py`; reference
`t_optprop_wedge`, `src/optprop.F90:150-173`).

One canonical table over (tau, w0, aspect, g [, phi, theta]) serves both
orientations of the structured mesh (the rotated triangle at phi + 180)
and, through `phi_rot` and the param-phi azimuth map, every cell of an
unstructured one.  The tables are the committed npz files the JAX
package made with its wedge photon tracer: the port computes the same
cache key and loads them by name.  Making a table needs that tracer,
which is not ported yet (ROADMAP §1, "M18 remainder"): a cache miss, table
creation and the shape-blended tables raise `NotImplementedError`
naming it, and nothing traces or takes another table instead.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from tenstream_tpu_torch.core.types import ireals
from tenstream_tpu_torch.ops.interp import fractional_index, interp_multilinear_cf

_CACHE_VERSION = 2  # the JAX package's: file names of cached tables match
NDIFF = 8  # diffuse streams of both wedge schemes (5_8, 18_8)
TRACER_ITEM = "ROADMAP §1, M18 remainder: the wedge photon tracer and wedge table creation"
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


def load_or_create_wedge_lut(daxes: Optional[WedgeAxes] = None,
                             faxes: Optional[WedgeAxes] = None, n_photons: int = 5000,
                             basename: Optional[str] = None, scheme: str = "5_8", apex=None,
                             device="cuda") -> WedgeLUT:
    """Load the committed wedge table of these axes (defaults: the test
    axes, diffuse axes from the direct ones) onto `device`.  A table that
    is not on disk raises: making it needs the wedge tracer."""
    daxes = daxes or test_axes()
    faxes = faxes or WedgeAxes(daxes.tau, daxes.w0, daxes.aspect, daxes.g)
    path = wedge_lut_path(daxes, faxes, n_photons, basename, scheme, apex)
    if not os.path.exists(path):
        raise NotImplementedError(
            f"no wedge table {path} for these axes, {n_photons} photons, scheme {scheme}, apex "
            f"{apex}; making one needs the wedge tracer, which is not ported ({TRACER_ITEM})")
    z = np.load(path)
    t = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
    apex_t = tuple(float(v) for v in apex) if apex is not None else (1.0, 1.0)
    return WedgeLUT(daxes, faxes, t("dir2dir"), t("dir2diff"), t("diff2diff"), scheme, apex_t)


def create_wedge_lut(*args, **kwargs):
    """Tracing a wedge table (JAX `create_wedge_lut`) is not ported."""
    raise NotImplementedError(f"create_wedge_lut traces with the wedge photon tracer ({TRACER_ITEM})")


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
                       device="cuda") -> WedgeLUT:
    """The table traced at the mesh's area-weighted mean cell shape, if it
    is committed; otherwise this raises (making it needs the tracer)."""
    cx, cy = _apexes(mesh)
    w = mesh.area / mesh.area.sum()
    apex = (float((cx * w).sum()), float(np.maximum((cy * w).sum(), 1e-3)))
    return load_or_create_wedge_lut(daxes, faxes, n_photons, basename, apex=apex, device=device)


def wedge_optprop_for_mesh(*args, **kwargs):
    """Shape-blended tables (JAX `wedge_optprop_for_mesh`) are not ported."""
    raise NotImplementedError(
        f"wedge_optprop_for_mesh blends shape-exact tables that the wedge tracer makes "
        f"({TRACER_ITEM})")


class WedgeOptPropShaped:
    """Per-cell blending over shape-sample tables (JAX
    `WedgeOptPropShaped`): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"WedgeOptPropShaped blends shape-exact tables that the wedge tracer makes "
            f"({TRACER_ITEM})")


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
