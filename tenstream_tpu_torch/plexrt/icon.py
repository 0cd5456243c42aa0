"""Unstructured triangle meshes (ICON grids) for the wedge solver (port
of `tenstream_tpu/plexrt/icon.py`, numpy only; reference
`plexrt/icon_grid.F90`, `read_icon_grid_file`:303, and
`plexrt/icon_plex_utils.F90`).

The mesh is three flat index tables:

    tris (nc, 3)      vertex indices per cell
    nbr (nc, 3)       neighbor cell per side (-1 = open boundary)
    nbr_side (nc, 3)  that side's local index within the neighbor

and every neighbor exchange in the solver is one gather
`out[nbr, nbr_side]`.  Boundary sides receive zero inflow (vacuum lateral
boundary, reference `plex_rt.F90:4341`).  Transfer coefficients come
from the canonical-wedge table at the sun azimuth rotated into each
cell's frame (`phi_rot`); cells whose shape is not the table's go
through the param-phi azimuth map (`plexrt.param_phi`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TriMesh:
    verts: np.ndarray  # (nv, 2) planar coordinates [m]
    tris: np.ndarray  # (nc, 3) vertex indices, ccw
    nbr: np.ndarray  # (nc, 3) neighbor cell id per side, -1 = boundary
    nbr_side: np.ndarray  # (nc, 3) side index within the neighbor

    def __post_init__(self):
        t = self.tris
        v = self.verts
        # side s connects vertex s -> vertex (s+1)%3
        a = v[t[:, [0, 1, 2]]]
        b = v[t[:, [1, 2, 0]]]
        self.side_vec = b - a  # (nc, 3, 2)
        self.side_len = np.linalg.norm(self.side_vec, axis=-1)
        x = v[t][:, :, 0]
        y = v[t][:, :, 1]
        self.area = 0.5 * np.abs(
            (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
        )
        # orientation of side 0 relative to the canonical triangle's
        # side 0 (A->B along +x): rotation angle of the cell frame
        self.phi_rot = np.rad2deg(
            np.arctan2(self.side_vec[:, 0, 1], self.side_vec[:, 0, 0])
        )

    @property
    def ncell(self) -> int:
        return self.tris.shape[0]

    def exchange_index(self) -> np.ndarray:
        """(nc, 3) flat gather index into a (nc*3,) per-side field:
        idx = nbr * 3 + nbr_side (boundary sides -> index 0, masked by
        `exchange_mask`)."""
        idx = self.nbr * 3 + self.nbr_side
        return np.where(self.nbr >= 0, idx, 0)

    def exchange_mask(self) -> np.ndarray:
        return (self.nbr >= 0).astype(np.float32)


def _build_adjacency(tris: np.ndarray) -> tuple:
    """Neighbor tables from shared vertex pairs."""
    nc = tris.shape[0]
    edge_map = {}
    nbr = -np.ones((nc, 3), np.int64)
    nbr_side = np.zeros((nc, 3), np.int64)
    for c in range(nc):
        for s in range(3):
            key = tuple(sorted((int(tris[c, s]), int(tris[c, (s + 1) % 3]))))
            if key in edge_map:
                c2, s2 = edge_map.pop(key)
                nbr[c, s] = c2
                nbr_side[c, s] = s2
                nbr[c2, s2] = c
                nbr_side[c2, s2] = s
            else:
                edge_map[key] = (c, s)
    return nbr, nbr_side


def trimesh_from_points(verts: np.ndarray, tris: np.ndarray) -> TriMesh:
    nbr, nbr_side = _build_adjacency(np.asarray(tris))
    return TriMesh(np.asarray(verts, np.float64), np.asarray(tris, np.int64),
                   nbr, nbr_side)


def trimesh_from_structured(nx: int, ny: int, dx: float, dy: float) -> TriMesh:
    """The fish-mesh triangulation as an unstructured TriMesh (each
    rectangle split along its ll->ur diagonal; non-periodic).

    Cell order: c = 2*(i*ny + j) + o with o=0 the lower-right triangle
    (canonical orientation) and o=1 its 180-degree partner.
    """
    nv = (nx + 1) * (ny + 1)
    vid = lambda i, j: i * (ny + 1) + j
    verts = np.zeros((nv, 2))
    for i in range(nx + 1):
        for j in range(ny + 1):
            verts[vid(i, j)] = (i * dx, j * dy)
    tris = []
    for i in range(nx):
        for j in range(ny):
            A, B, C, D = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            # T0: A,B,C  (side0 = AB along +x, canonical)
            tris.append((A, B, C))
            # T1: C,D,A  (T0 rotated by 180: side0 = CD along -x)
            tris.append((C, D, A))
    return trimesh_from_points(verts, np.asarray(tris))


def trimesh_equilateral(nx: int, ny: int, edge: float) -> TriMesh:
    """Equilateral-triangle lattice (the ICON ideal cell shape): skewed
    rows of up/down triangles, `nx` rhombi per row, `ny` rows
    (non-periodic).  Cell order: c = 2*(i*ny + j) + o, o=0 up / o=1
    down."""
    h = edge * np.sqrt(3.0) / 2.0
    nv = (nx + 1) * (ny + 1)
    vid = lambda i, j: i * (ny + 1) + j
    verts = np.zeros((nv, 2))
    for i in range(nx + 1):
        for j in range(ny + 1):
            verts[vid(i, j)] = ((i + 0.5 * j) * edge, j * h)
    tris = []
    for i in range(nx):
        for j in range(ny):
            # up triangle: base on row j, apex on row j+1
            tris.append((vid(i, j), vid(i + 1, j), vid(i, j + 1)))
            # down triangle: base on row j+1, apex on row j (the 180-
            # degree partner, like T1 of the structured mesh)
            tris.append((vid(i + 1, j + 1), vid(i, j + 1), vid(i + 1, j)))
    return trimesh_from_points(verts, np.asarray(tris))


def rotate_mesh(mesh: TriMesh, angle_deg: float) -> TriMesh:
    """Rigidly rotate the mesh in the horizontal plane (tests)."""
    a = np.deg2rad(angle_deg)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return trimesh_from_points(mesh.verts @ R.T, mesh.tris)


# ---------------------------------------------------------------------------
# ICON grid file IO
# ---------------------------------------------------------------------------

def read_icon_grid(path: str, earth_radius: float = 6371e3) -> TriMesh:
    """Read an ICON grid file into a TriMesh.

    Reads the same variables as the reference
    (`icon_grid.F90:read_icon_grid_file`:303): vertex_of_cell (3, nc)
    1-based, adjacent_cell_of_edge (2, ne), edge_of_cell (3, nc), and
    vertex positions (cartesian_x/y/z_vertices on the unit sphere, or
    vlon/vlat).  The sphere is locally projected onto the tangent plane
    at the domain centroid (ICON LES domains are regional).
    """
    data = _load_any_netcdf(path)

    voc = np.asarray(data["vertex_of_cell"], np.int64)
    if voc.shape[0] == 3:
        voc = voc.T  # (nc, 3)
    voc = voc - 1  # 1-based -> 0-based

    if "cartesian_x_vertices" in data:
        xyz = np.stack(
            [np.asarray(data[f"cartesian_{c}_vertices"], np.float64)
             for c in ("x", "y", "z")], axis=-1)
        xyz /= np.maximum(np.linalg.norm(xyz, axis=-1, keepdims=True), 1e-30)
        center = xyz.mean(0)
        center /= np.linalg.norm(center)
        # geographically-aligned tangent-plane basis: x = local east,
        # y = local north (falls back to an arbitrary frame at the poles)
        pole = np.array([0.0, 0.0, 1.0])
        east = np.cross(pole, center)
        if np.linalg.norm(east) < 1e-6:
            east = np.array([1.0, 0.0, 0.0])
        east /= np.linalg.norm(east)
        north = np.cross(center, east)
        verts = np.stack([xyz @ east, xyz @ north], axis=-1) * earth_radius
    elif "vlon" in data:
        lon = np.asarray(data["vlon"], np.float64)
        lat = np.asarray(data["vlat"], np.float64)
        lon0, lat0 = lon.mean(), lat.mean()
        verts = np.stack(
            [(lon - lon0) * np.cos(lat0) * earth_radius,
             (lat - lat0) * earth_radius], axis=-1)
    else:
        raise ValueError("no vertex coordinates found in ICON grid file")

    if "adjacent_cell_of_edge" in data and "edge_of_cell" in data:
        ace = np.asarray(data["adjacent_cell_of_edge"], np.int64)
        eoc = np.asarray(data["edge_of_cell"], np.int64)
        if ace.shape[0] == 2:
            ace = ace.T
        if eoc.shape[0] == 3:
            eoc = eoc.T
        ace = ace - 1
        eoc = eoc - 1
        nc = voc.shape[0]
        nbr = -np.ones((nc, 3), np.int64)
        nbr_side = np.zeros((nc, 3), np.int64)
        # side s of cell c uses edge eoc[c, s]; the neighbor is the other
        # adjacent cell of that edge
        edge_side_of = {}
        for c in range(nc):
            for s in range(3):
                e = int(eoc[c, s])
                if e in edge_side_of:
                    c2, s2 = edge_side_of[e]
                    nbr[c, s] = c2
                    nbr_side[c, s] = s2
                    nbr[c2, s2] = c
                    nbr_side[c2, s2] = s
                else:
                    edge_side_of[e] = (c, s)
        mesh = TriMesh(verts, voc, nbr, nbr_side)
    else:
        mesh = trimesh_from_points(verts, voc)
    return mesh


def _load_any_netcdf(path: str) -> dict:
    """Read every variable of a NetCDF3 or NetCDF4/HDF5 file."""
    try:
        from tenstream_tpu_torch.utils.io import ncinfo, ncload

        names = ncinfo(path)
        return {n: ncload(path, n) for n in names}
    except Exception:
        from tenstream_tpu_torch.utils.hdf5reader import read_all

        return read_all(path)


def write_icon_grid(path: str, mesh: TriMesh) -> None:
    """Write a TriMesh in the ICON grid-file variable layout (NetCDF3
    via `utils.io.ncwrite`) — round-trips through `read_icon_grid` and
    documents the subset of the format the reader consumes."""
    from tenstream_tpu_torch.utils.io import ncwrite

    nc = mesh.ncell
    # unique edges + adjacency
    edges = {}
    eoc = np.zeros((nc, 3), np.int64)
    for c in range(nc):
        for s in range(3):
            key = tuple(sorted((int(mesh.tris[c, s]), int(mesh.tris[c, (s + 1) % 3]))))
            if key not in edges:
                edges[key] = len(edges)
            eoc[c, s] = edges[key]
    ne = len(edges)
    ev = np.zeros((ne, 2), np.int64)
    for (v1, v2), e in edges.items():
        ev[e] = (v1, v2)
    ace = -np.ones((ne, 2), np.int64)
    for c in range(nc):
        for s in range(3):
            e = eoc[c, s]
            ace[e, 1 if ace[e, 0] >= 0 else 0] = c
    # planar verts onto a tiny patch of the unit sphere tangent at x-axis
    R = 6371e3
    x = mesh.verts[:, 0] / R
    y = mesh.verts[:, 1] / R
    cx = np.cos(np.hypot(x, y))
    fields = {
        "vertex_of_cell": (mesh.tris + 1).T.astype(np.int32),
        "edge_of_cell": (eoc + 1).T.astype(np.int32),
        "edge_vertices": (ev + 1).T.astype(np.int32),
        "adjacent_cell_of_edge": (ace + 1).T.astype(np.int32),
        "cells_of_vertex": np.zeros((6, mesh.verts.shape[0]), np.int32),
        "cell_index": np.arange(1, nc + 1, dtype=np.int32),
        "edge_index": np.arange(1, ne + 1, dtype=np.int32),
        "vertex_index": np.arange(1, mesh.verts.shape[0] + 1, dtype=np.int32),
        # local tangent-plane embedding near the equator at lon 0:
        # east = +y axis of the plane, north = +z
        "cartesian_x_vertices": cx,
        "cartesian_y_vertices": x,
        "cartesian_z_vertices": y,
    }
    for name, arr in fields.items():
        ncwrite(path, name, arr)
