"""Classic NetCDF3 read and write (port of the NetCDF part of
`tenstream_tpu/utils/io.py`: `ncwrite`, `ncload`, `ncinfo`; reference
`src/netcdfio.fypp:61-128`).

numpy and scipy's `netcdf_file` only, no libnetcdf.  A file written by
either package is read by the other.  The scene dump / replay and XDMF
helpers of the JAX module are not ported yet (ROADMAP, M20).
"""

from __future__ import annotations

import os

import numpy as np

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
