"""The port's wedge-mesh geometry and file IO against the JAX package:
`utils/io.py` (NetCDF3), `utils/hdf5reader.py`, `plexrt/mesh.py`,
`plexrt/icon.py` and `plexrt/param_phi.py`.

Gates: index tables, topology and integer data equal; float64 geometry
equal (both packages run the same numpy code); files written by either
package read by the other with equal topology; the float32 param-phi maps
within 1e-6 (radians or degrees, relative to the value's magnitude).
No JAX solve: the file takes a few seconds."""

import numpy as np
import pytest
import torch

from tenstream_tpu.plexrt import icon as jicon
from tenstream_tpu.plexrt import mesh as jmesh
from tenstream_tpu.plexrt import param_phi as jpp
from tenstream_tpu.utils import hdf5reader as jh5
from tenstream_tpu.utils import io as jio
from tenstream_tpu_torch.plexrt import icon as ticon
from tenstream_tpu_torch.plexrt import mesh as tmesh
from tenstream_tpu_torch.plexrt import param_phi as tpp
from tenstream_tpu_torch.utils import hdf5reader as th5
from tenstream_tpu_torch.utils import io as tio
import torch_jax_cache  # noqa: F401  (one XLA compile per program per run)

PP_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(mod):
    return {
        "structured": mod.trimesh_from_structured(4, 3, 80.0, 120.0),
        "equilateral": mod.trimesh_equilateral(3, 4, 150.0),
        "rotated": mod.rotate_mesh(mod.trimesh_from_structured(3, 3, 100.0, 100.0), 33.0),
    }


def test_plexgrid_geometry_equal():
    dz = np.array([300.0, 200.0, 100.0], np.float32)
    j = jmesh.fish_mesh(3, 4, 5, 80.0, 120.0, dz)
    t = tmesh.fish_mesh(3, 4, 5, 80.0, 120.0, dz)
    assert (t.nx, t.ny, t.nz, t.dx, t.dy) == (j.nx, j.ny, j.nz, j.dx, j.dy)
    assert t.area_tri == j.area_tri and t.side_lengths == j.side_lengths
    assert t.ncell_horiz == j.ncell_horiz
    np.testing.assert_array_equal(t.volumes(), j.volumes())
    np.testing.assert_array_equal(t.dz3d(), j.dz3d())
    assert tmesh.SIDE_OFFSETS == jmesh.SIDE_OFFSETS


@pytest.mark.parametrize("s", [0, 1, 2])
def test_side_exchange_rolls_equal(s):
    a = np.random.default_rng(s).random((2, 3, 5, 6)).astype(np.float32)
    for name in ("side_to_t1", "side_from_t1"):
        want = np.asarray(getattr(jmesh, name)(a, s))
        got = getattr(tmesh, name)(torch.as_tensor(a), s).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["structured", "equilateral", "rotated"])
def test_trimesh_tables_equal(kind):
    j, t = _meshes(jicon)[kind], _meshes(ticon)[kind]
    for name in ("verts", "tris", "nbr", "nbr_side", "side_vec", "side_len", "area", "phi_rot"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    np.testing.assert_array_equal(t.exchange_index(), j.exchange_index())
    np.testing.assert_array_equal(t.exchange_mask(), j.exchange_mask())
    assert t.exchange_mask().dtype == j.exchange_mask().dtype


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_icon_file_read_by_the_other_package(tmp_path, writer):
    """An ICON grid file (NetCDF3, the reader's variable layout) written by
    one package is read by the other: equal topology, the same geometry up
    to the tangent-plane projection's rounding."""
    wmod, rmod = (jicon, ticon) if writer == "jax" else (ticon, jicon)
    m = wmod.trimesh_from_structured(3, 4, 80.0, 120.0)
    path = str(tmp_path / "icon_grid.nc")
    wmod.write_icon_grid(path, m)
    got = rmod.read_icon_grid(path)
    same = wmod.read_icon_grid(path)
    for name in ("tris", "nbr", "nbr_side"):
        np.testing.assert_array_equal(getattr(got, name), getattr(m, name), err_msg=name)
        np.testing.assert_array_equal(getattr(got, name), getattr(same, name), err_msg=name)
    np.testing.assert_array_equal(got.verts, same.verts)
    np.testing.assert_allclose(got.area, m.area, rtol=1e-4)
    np.testing.assert_allclose(got.side_len, m.side_len, rtol=1e-4)


def test_ncwrite_ncload_across_packages(tmp_path):
    path = str(tmp_path / "diag.nc")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    tio.ncwrite(path, "edir", a, dim_names=("z", "x"), attrs={"units": b"W/m2"})
    jio.ncwrite(path, "edn", 2 * a, dim_names=("z", "x"))
    tio.ncwrite(path, "albedo", np.float64(0.2))
    tio.ncwrite(path, "cells", np.arange(5, dtype=np.int64))
    for mod in (jio, tio):
        np.testing.assert_array_equal(mod.ncload(path, "edir"), a)
        np.testing.assert_array_equal(mod.ncload(path, "edn"), 2 * a)
        np.testing.assert_allclose(mod.ncload(path, "albedo"), [0.2])
        assert mod.ncload(path, "cells").dtype == np.int32
        assert mod.ncload(path, "edir", with_attrs=True)[1]["units"] == b"W/m2"
    assert tio.ncinfo(path) == jio.ncinfo(path)
    with pytest.raises(ValueError):
        tio.ncwrite(path, "bad", np.zeros((4, 4)), dim_names=("z", "x"))
    with pytest.raises(KeyError):
        tio.ncload(path, "missing")


def _hdf5_bytes(arrays: dict) -> bytes:
    """A minimal HDF5 file in the layout the reader parses: a version-2
    superblock, version-2 object headers, compact links in the root group
    and contiguous datasets (what netCDF4 writes for small variables)."""
    buf = bytearray(b"\x89HDF\r\n\x1a\n" + bytes([2]) + bytes(39))

    def ohdr(msgs):
        body = b"".join(bytes([t]) + len(p).to_bytes(2, "little") + b"\x00" + p for t, p in msgs)
        return b"OHDR" + bytes([2, 2]) + len(body).to_bytes(4, "little") + body

    links = []
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        data_at = len(buf)
        buf += a.tobytes()
        cls, bits = (1, 0) if a.dtype.kind == "f" else (0, 0x08 if a.dtype.kind == "i" else 0)
        space = bytes([2, a.ndim, 0, 0]) + b"".join(int(n).to_bytes(8, "little") for n in a.shape)
        dtype = bytes([0x10 | cls, bits, 0, 0]) + a.dtype.itemsize.to_bytes(4, "little")
        layout = (bytes([3, 1]) + data_at.to_bytes(8, "little")
                  + a.nbytes.to_bytes(8, "little"))
        header_at = len(buf)
        buf += ohdr([(0x01, space), (0x03, dtype), (0x08, layout)])
        links.append(bytes([1, 0, len(name)]) + name.encode() + header_at.to_bytes(8, "little"))
    root_at = len(buf)
    buf += ohdr([(0x06, link) for link in links])
    buf[40:48] = root_at.to_bytes(8, "little")
    return bytes(buf)


def test_hdf5_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    arrays = {"tau": rng.random((2, 3)).astype(np.float32), "cells": np.arange(7, dtype=np.int32),
              "lon": rng.random(5), "flags": np.array([1, 2, 250], np.uint8)}
    path = tmp_path / "vars.nc4"
    path.write_bytes(_hdf5_bytes(arrays))
    got, want = th5.read_all(str(path)), jh5.read_all(str(path))
    assert sorted(got) == sorted(want) == sorted(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(got[k], a)
        assert got[k].dtype == want[k].dtype == a.dtype
    bad = tmp_path / "not_hdf5.nc"
    bad.write_bytes(b"CDF\x01" + bytes(60))
    for mod in (th5, jh5):
        with pytest.raises(ValueError):
            mod.MiniH5(str(bad))


def test_icon_grid_from_hdf5_matches_jax(tmp_path):
    """An ICON grid in a NetCDF4 (HDF5) file: `read_icon_grid` falls back
    to the HDF5 reader, in both packages, with equal results."""
    m = ticon.trimesh_from_structured(3, 2, 100.0, 100.0)
    nc3 = str(tmp_path / "grid.nc")
    ticon.write_icon_grid(nc3, m)
    names = ("vertex_of_cell", "edge_of_cell", "adjacent_cell_of_edge", "cartesian_x_vertices",
             "cartesian_y_vertices", "cartesian_z_vertices")
    h5 = tmp_path / "grid_nc4.nc"
    h5.write_bytes(_hdf5_bytes({n: tio.ncload(nc3, n) for n in names}))
    got, want = ticon.read_icon_grid(str(h5)), jicon.read_icon_grid(str(h5))
    for name in ("tris", "nbr", "nbr_side", "verts", "area"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.nbr, m.nbr)


_SHAPES = [(1.0, 1.0), (0.5, 0.866025), (0.2, 0.7), (0.85, 1.6)]


@pytest.mark.parametrize("fn", ["param_phi_from_azimuth", "azimuth_from_param_phi",
                                "canonical_azimuth_map", "triangle_angles"])
def test_param_phi_matches_jax(fn):
    rng = np.random.default_rng(11)
    for cx, cy in _SHAPES:
        Cx = (cx + 0.05 * rng.standard_normal(64)).astype(np.float32)
        Cy = np.abs(cy + 0.05 * rng.standard_normal(64)).astype(np.float32) + 0.05
        if fn == "param_phi_from_azimuth":
            args = (rng.uniform(-np.pi, np.pi, 64).astype(np.float32), Cx, Cy)
        elif fn == "azimuth_from_param_phi":
            args = (rng.uniform(-2.0, 2.0, 64).astype(np.float32), Cx, Cy)
        elif fn == "canonical_azimuth_map":
            args = (rng.uniform(-400.0, 400.0, 64).astype(np.float32), Cx, Cy, 1.0, 1.0)
        else:
            args = (Cx, Cy)
        want = getattr(jpp, fn)(*args)
        got = getattr(tpp, fn)(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                 for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=PP_RTOL,
                                       atol=PP_RTOL * float(np.abs(w).max()))


def test_canonical_map_identity_on_congruent_cells():
    phi = torch.linspace(-180.0, 540.0, 97)
    out = tpp.canonical_azimuth_map(phi, torch.full_like(phi, 1.0), torch.full_like(phi, 1.0),
                                    1.0, 1.0)
    wrapped = torch.remainder(out - phi + 180.0, 360.0) - 180.0
    assert float(wrapped.abs().max()) < 1e-3
