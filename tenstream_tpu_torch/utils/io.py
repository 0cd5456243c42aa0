"""Scene dump / replay, classic NetCDF3 read and write, and XDMF export
(port of `tenstream_tpu/utils/io.py`).

  * Scene dump / replay (`dump_scene`, `load_scene`, `dump_specint_input`,
    `load_specint_input`): npz archives with the JAX package's format tag,
    the reference's `dump_input` / `load_input_dump` of its specint programs
    (`specint/specint_pprts.F90:213+`).
  * NetCDF (`ncwrite`, `ncload`, `ncinfo`): the reference's
    `src/netcdfio.fypp:61-128`, on scipy's `netcdf_file` (no libnetcdf).
  * XDMF (`write_xdmf_grid`): fields on a regular grid as XDMF XML over raw
    float32 binaries (ParaView / VisIt read them), the reference's
    `src/xdmf_export.F90` without HDF5.

numpy (and scipy for NetCDF) only.  A file written by either package is
read by the other.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

_FORMAT = "tenstream_tpu_scene_v1"  # the JAX package's tag: each reads the other's archives


def _host(v) -> np.ndarray:
    """numpy of an array, a tensor (any device) or a scalar."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def dump_scene(path: str, **arrays) -> None:
    """Write named arrays (and scalars) as a replayable scene archive;
    None values are left out."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __format__=_FORMAT, **{
        k: _host(v) for k, v in arrays.items() if v is not None})


def load_scene(path: str) -> Dict[str, np.ndarray]:
    z = np.load(path, allow_pickle=False)
    if not hasattr(z, "files") or "__format__" not in z.files or str(z["__format__"]) != _FORMAT:
        raise ValueError(f"{path} is not a {_FORMAT} archive")
    return {k: z[k] for k in z.files if k != "__format__"}


def dump_specint_input(path: str, atm, sundir=None, **kw) -> None:
    """Dump a full specint input set (atmosphere and solve parameters) as a
    replayable archive: atmosphere fields with an `atm_` prefix, gas vmrs
    with `gas_`, everything else (albedo, edirTOA, lwc overrides, dx/dy,
    ...) as given."""
    fields = dict(
        atm_plev=atm.plev, atm_tlev=atm.tlev, atm_zlev=atm.zlev,
        atm_lwc=atm.lwc, atm_reliq=atm.reliq, atm_iwc=atm.iwc,
        atm_reice=atm.reice, atm_cfrac=atm.cfrac,
        atm_skin_temperature=atm.skin_temperature,
    )
    for name, vmr in atm.gases.items():
        fields[f"gas_{name}"] = vmr
    if sundir is not None:
        fields["sundir"] = _host(sundir)
    fields.update(kw)
    dump_scene(path, **fields)


def load_specint_input(path: str):
    """Load a `dump_specint_input` archive: (atm: Atmosphere, params: dict)
    with params every entry that is not the atmosphere's."""
    from tenstream_tpu_torch.atm import Atmosphere

    data = load_scene(path)
    gases = {k[4:]: v for k, v in data.items() if k.startswith("gas_")}
    opt = lambda k: data.get(f"atm_{k}")
    atm = Atmosphere(
        plev=data["atm_plev"], tlev=data["atm_tlev"], zlev=data["atm_zlev"],
        gases=gases, lwc=opt("lwc"), reliq=opt("reliq"), iwc=opt("iwc"),
        reice=opt("reice"), cfrac=opt("cfrac"), skin_temperature=opt("skin_temperature"),
    )
    params = {k: v for k, v in data.items() if not (k.startswith("atm_") or k.startswith("gas_"))}
    return atm, params

_NC_DTYPES = {
    np.dtype(np.float64): np.float64,
    np.dtype(np.float32): np.float32,
    np.dtype(np.int32): np.int32,
    np.dtype(np.int16): np.int16,
    np.dtype(np.int8): np.int8,
}


def _nc_cast(arr: np.ndarray) -> np.ndarray:
    """Cast to a classic-NetCDF3 representable dtype."""
    if arr.dtype in _NC_DTYPES:
        return arr
    if arr.dtype.kind in "iu":
        return arr.astype(np.int32)
    try:
        return arr.astype(np.float32)
    except (TypeError, ValueError):
        raise TypeError(f"cannot store dtype {arr.dtype} in NetCDF3")


def ncwrite(path, name, arr, dim_names=None, attrs=None, global_attrs=None):
    """Write or replace one variable in a classic NetCDF3 file, creating
    the file if needed and keeping its other variables.  Dimensions are
    shared by name; `dim_names` defaults to `{name}_dim{i}`.  Scalars are
    stored as rank-1 arrays of length 1."""
    from scipy.io import netcdf_file

    arr = _nc_cast(np.atleast_1d(np.asarray(arr)))
    if dim_names is None:
        dim_names = tuple(f"{name}_dim{i}" for i in range(arr.ndim))
    if len(dim_names) != arr.ndim:
        raise ValueError("dim_names rank mismatch")

    # read-modify-rewrite: scipy's append mode cannot add dimensions
    old_vars, old_gattrs = {}, {}
    if os.path.exists(path):
        with netcdf_file(path, "r", mmap=False) as f:
            old_gattrs = dict(f._attributes)
            for k, v in f.variables.items():
                old_vars[k] = (tuple(v.dimensions), np.array(v[:]), dict(v._attributes))
    old_vars[name] = (tuple(dim_names), arr, dict(attrs or {}))

    # validate the dimension table before touching the file
    dim_sizes = {}
    for k, (dims, data, _) in old_vars.items():
        for dn, size in zip(dims, data.shape):
            if dim_sizes.setdefault(dn, int(size)) != int(size):
                raise ValueError(f"dimension {dn!r} size conflict: {dim_sizes[dn]} vs {size}")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with netcdf_file(tmp, "w") as f:
        if global_attrs:
            old_gattrs.update(global_attrs)
        f._attributes.update(old_gattrs)
        for dn, size in dim_sizes.items():
            f.createDimension(dn, size)
        for k, (dims, data, vattrs) in old_vars.items():
            var = f.createVariable(k, data.dtype, dims)
            var[:] = data
            var._attributes.update(vattrs)
    os.replace(tmp, path)  # a failed write never clobbers the file


def ncload(path, name, with_attrs=False):
    """Read one variable, in native byte order."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        if name not in f.variables:
            raise KeyError(f"{name!r} not in {path}: {sorted(f.variables)}")
        v = f.variables[name]
        data = np.array(v[:])
        data = data.astype(data.dtype.newbyteorder("="))
        if with_attrs:
            return data, dict(v._attributes)
        return data


def ncinfo(path):
    """name -> (dims, shape) of a NetCDF3 file's variables."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        return {k: (tuple(v.dimensions), tuple(v.shape)) for k, v in f.variables.items()}


def write_xdmf_grid(basename: str, fields: Dict[str, np.ndarray], dx: float = 1.0,
                    dy: float = 1.0, dz: float = 1.0) -> str:
    """Write 2-D (Nx, Ny) or 3-D (Nz, Nx, Ny) fields (arrays or tensors) on
    a regular grid as XDMF and raw float32 binaries `<basename>_<name>.bin`.
    Returns the path of the .xmf file."""
    base = os.path.abspath(basename)
    os.makedirs(os.path.dirname(base), exist_ok=True)
    grids = []
    for name, arr in fields.items():
        arr = np.ascontiguousarray(np.asarray(_host(arr), np.float32))
        binpath = f"{base}_{name}.bin"
        arr.tofile(binpath)
        if arr.ndim == 2:
            dims = f"{arr.shape[0]} {arr.shape[1]}"
            topo = f'<Topology TopologyType="2DCoRectMesh" Dimensions="{dims}"/>'
            geom = ('<Geometry GeometryType="Origin_DxDy">'
                    '<DataItem Dimensions="2">0 0</DataItem>'
                    f'<DataItem Dimensions="2">{dx} {dy}</DataItem></Geometry>')
        else:
            dims = f"{arr.shape[0]} {arr.shape[1]} {arr.shape[2]}"
            topo = f'<Topology TopologyType="3DCoRectMesh" Dimensions="{dims}"/>'
            geom = ('<Geometry GeometryType="Origin_DxDyDz">'
                    '<DataItem Dimensions="3">0 0 0</DataItem>'
                    f'<DataItem Dimensions="3">{dz} {dx} {dy}</DataItem></Geometry>')
        grids.append(
            f'<Grid Name="{name}" GridType="Uniform">{topo}{geom}'
            f'<Attribute Name="{name}" Center="Node">'
            f'<DataItem Format="Binary" DataType="Float" Precision="4" '
            f'Dimensions="{dims}">{os.path.basename(binpath)}</DataItem>'
            "</Attribute></Grid>")
    xml = ('<?xml version="1.0" ?>\n<Xdmf Version="3.0"><Domain>' + "".join(grids)
           + "</Domain></Xdmf>\n")
    xmf = base + ".xmf"
    with open(xmf, "w") as f:
        f.write(xml)
    return xmf
