"""Merged yearly (time, variable, lat, lon) training files from per-variable
ERA5 and HYCOM NetCDF files.

    python3 -m makani_tpu_torch.tools.create_merged --year 2015 --output data/2015.nc \\
        --source-root ./source [--variables u10 v10 mslp:msl sst ssh@HYCOM] \\
        [--partial ssh] [--num-smooths 80]

Counterpart of makani_tpu/tools/create_merged.py, the fork's ERA5 + HYCOM
merge: a 6-hourly time axis in days since 2000 (leap years included), an
`f{i:02d}` attribute naming each variable on `fields`, latitudes descending
(ECMWF's convention) in the output, ssh above 15 taken as missing, and
missing values filled by repeated four-neighbour means (`fill_nans_2d`). The
read, fill and write loop streams time chunks, so a 0.25-degree year never
has to fit in memory. `--partial` writes only the named variables into an
existing layout. Files go through utils/nctools; h5py is imported on use
(utils/imports.import_optional).
"""

import argparse
import os
import warnings
from dataclasses import dataclass

import numpy as np

from makani_tpu_torch.utils import nctools as nct
from makani_tpu_torch.utils import timetools as tt
from makani_tpu_torch.utils.imports import import_optional


@dataclass
class Variable:
    name: str            # output name, recorded in the f{i:02d} attribute
    source: str          # "ERA5" | "HYCOM"
    src_var: str         # variable name inside the source file

    @classmethod
    def parse(cls, spec):
        """'name[:src_var][@SOURCE]' -> Variable (source ERA5 by default)."""
        source = "ERA5"
        if "@" in spec:
            spec, source = spec.split("@", 1)
        name, _, src_var = spec.partition(":")
        return cls(name=name, source=source.upper(), src_var=src_var or name)


DEFAULT_VARIABLES = ["u10", "v10", "mslp:msl", "sst", "ssh@HYCOM"]


def is_leap(year):
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def source_path(root, var, year):
    """The fork's directory layout of the sources."""
    if var.source == "HYCOM":
        return os.path.join(root, "HYCOM", var.name, f"{var.name}_{year}.nc")
    if var.source == "ERA5":
        return os.path.join(root, "ERA5", str(year), f"ERA5_{var.name}_{year}_6h.nc")
    raise ValueError(f"Unknown source {var.source} for variable {var.name}")


def fill_nans_2d(field, num_smooths):
    """Fill NaNs by Jacobi iterations of the four-neighbour mean with the
    valid data held fixed. Longitude wraps, latitude does not; cells that no
    iteration reaches take the field's mean."""
    filled = np.array(field, dtype=np.float64)
    nanmask = np.isnan(filled)
    if not nanmask.any():
        return field
    for _ in range(num_smooths):
        up = np.empty_like(filled)
        up[1:] = filled[:-1]
        up[0] = np.nan
        down = np.empty_like(filled)
        down[:-1] = filled[1:]
        down[-1] = np.nan
        left = np.roll(filled, 1, axis=1)
        right = np.roll(filled, -1, axis=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            nm = np.nanmean(np.stack([up, down, left, right]), axis=0)
        upd = nanmask & ~np.isnan(nm)
        filled[upd] = nm[upd]
    rest = np.isnan(filled)
    if rest.any():
        filled[rest] = np.nanmean(filled[~rest]) if (~rest).any() else 0.0
    return filled.astype(field.dtype)


def run(year, output, source_root, variables, partial=None, num_smooths=80,
        time_chunk=64, dlat=0.25, overwrite=True):
    variables = [Variable.parse(v) if isinstance(v, str) else v for v in variables]
    nt = 1460 + 4 * is_leap(year)
    time = tt.year_start_days2000(year) + 0.25 * np.arange(nt)
    lat = np.arange(-90.0, 90.0 + dlat / 2, dlat)
    lon = np.arange(0.0, 360.0, dlat)
    ny, nx, nv = len(lat), len(lon), len(variables)
    shape = (nt, nv, ny, nx)

    if not overwrite and os.path.exists(output):
        print(f"{output} exists; use overwrite")
        return

    h5py = import_optional("h5py", f"create_merged of {output}",
                           hint="NetCDF-4 files are HDF5 files")
    print(f"creating {output} shape={shape}")
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    nct.create_netcdf(
        output, "fields", shape,
        ["time", "variable", "latitude", "longitude"],
        dims={
            "time": time,
            "variable": np.arange(nv),
            # latitudes descending (ECMWF)
            "latitude": lat[::-1].copy(),
            "longitude": lon,
        },
        chunks=(min(time_chunk, nt), 1, ny, nx),
    )
    for i, v in enumerate(variables):
        nct.write_netcdf_attr(output, "fields", f"f{i:02d}", v.name)

    # the sources checked first, so a bad path fails before hours of writes
    todo = [(i, v) for i, v in enumerate(variables)
            if not partial or v.name in partial]
    for i, v in enumerate(variables):
        if (i, v) not in todo:
            print(f"skipping {v.name} (partial write)")
    for _, v in todo:
        path = source_path(source_root, v, year)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        sshape = [s for s in nct.var_shape(path, v.src_var) if s != 1]
        if sshape != [nt, ny, nx]:
            raise ValueError(f"{path}:{v.src_var} shape {sshape} != {[nt, ny, nx]}")

    for ivar, v in todo:
        path = source_path(source_root, v, year)
        print(f"{v.name}: merging from {path}")
        with h5py.File(path, "r") as src:
            dset = src[v.src_var]
            for t0 in range(0, nt, time_chunk):
                t1 = min(t0 + time_chunk, nt)
                chunk = np.asarray(dset[t0:t1]).reshape(t1 - t0, ny, nx)
                chunk = chunk.astype(np.float32)
                if v.name == "ssh":
                    chunk[chunk > 15] = np.nan
                if np.isnan(chunk).any():
                    for it in range(chunk.shape[0]):
                        chunk[it] = fill_nans_2d(chunk[it], num_smooths)
                # latitudes descending (ECMWF)
                nct.write_netcdf_slice(
                    output, "fields", chunk[:, None, ::-1, :],
                    (slice(t0, t1), slice(ivar, ivar + 1)),
                )
    print("done")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--year", type=int, required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--source-root", default="./source")
    p.add_argument("--variables", nargs="+", default=DEFAULT_VARIABLES,
                   help="specs: name[:src_var][@SOURCE]")
    p.add_argument("--partial", nargs="*", default=None,
                   help="only (re)write these variables into the file")
    p.add_argument("--num-smooths", type=int, default=80)
    p.add_argument("--time-chunk", type=int, default=64)
    p.add_argument("--dlat", type=float, default=0.25)
    args = p.parse_args(argv)
    run(args.year, args.output or f"./data/{args.year}.nc", args.source_root,
        args.variables, partial=args.partial, num_smooths=args.num_smooths,
        time_chunk=args.time_chunk, dlat=args.dlat)


if __name__ == "__main__":
    main()
