"""Minimal NetCDF-4 read and write through h5py.

Counterpart of makani_tpu/utils/nctools.py: NetCDF-4 files are HDF5 files
with dimension scales, so h5py reads them and writes files that netCDF4 and
xarray (h5netcdf) open. h5py is imported inside each function, through
utils/imports.import_optional: the module imports without it, and a function
called without it raises ImportError naming what it was for.
"""

import numpy as np

from makani_tpu_torch.utils.imports import import_optional

_NC_PROPERTIES = np.bytes_("version=2,makani_tpu=1")


def _h5py(what):
    return import_optional("h5py", what, hint="NetCDF files are HDF5 files")


def write_netcdf(path, variables, dims, global_attrs=None):
    """Write a NetCDF-4-compatible file.

    variables: {name: (dim_names_tuple, ndarray, attrs_dict_or_None)}
    dims: {dim_name: 1d coordinate array}
    """
    h5py = _h5py(f"writing NetCDF {path}")
    with h5py.File(path, "w") as f:
        # netCDF4 signature attribute
        f.attrs["_NCProperties"] = _NC_PROPERTIES
        for name, values in dims.items():
            d = f.create_dataset(name, data=np.asarray(values))
            d.make_scale(name)
        for name, (var_dims, data, attrs) in variables.items():
            v = f.create_dataset(name, data=np.asarray(data, dtype=np.float32))
            for i, dim in enumerate(var_dims):
                v.dims[i].attach_scale(f[dim])
            if attrs:
                for k, a in attrs.items():
                    v.attrs[k] = a
        if global_attrs:
            for k, a in global_attrs.items():
                f.attrs[k] = a


def read_netcdf_var(path, name):
    h5py = _h5py(f"reading NetCDF {path}")
    with h5py.File(path, "r") as f:
        return f[name][...]


def var_shape(path, name):
    """Shape of a variable without reading it."""
    h5py = _h5py(f"reading NetCDF {path}")
    with h5py.File(path, "r") as f:
        return tuple(f[name].shape)


def create_netcdf(path, name, shape, dim_names, dims=None, dtype="f4",
                  chunks=None, var_attrs=None):
    """Create a NetCDF-4 file with one empty N-d variable for sliced writes."""
    h5py = _h5py(f"writing NetCDF {path}")
    with h5py.File(path, "w") as f:
        f.attrs["_NCProperties"] = _NC_PROPERTIES
        for i, dn in enumerate(dim_names):
            coord = None if dims is None else dims.get(dn)
            if coord is None:
                coord = np.arange(shape[i], dtype=np.float64)
            d = f.create_dataset(dn, data=np.asarray(coord))
            d.make_scale(dn)
        v = f.create_dataset(name, shape=shape, dtype=dtype, chunks=chunks,
                             fillvalue=np.nan if dtype in ("f4", "f8") else 0)
        for i, dn in enumerate(dim_names):
            v.dims[i].attach_scale(f[dn])
        if var_attrs:
            for k, a in var_attrs.items():
                v.attrs[k] = a


def write_prediction_file(output_path, data, extra_dims=None):
    """Write predictions shaped (time, var, lat, lon) in the fork's layout:
    one 'var{i}' variable per channel over dims (dim0, dim1, dim2)."""
    T, V, H, W = data.shape
    dims = {
        "dim0": np.arange(T, dtype=np.int16),
        "dim1": np.arange(H, dtype=np.int16),
        "dim2": np.arange(W, dtype=np.int16),
    }
    if extra_dims:
        dims.update(extra_dims)
    variables = {
        f"var{i}": (("dim0", "dim1", "dim2"), data[:, i], None) for i in range(V)
    }
    write_netcdf(output_path, variables, dims)
