"""ERA5 downloads through the Copernicus CDS API.

    python3 -m makani_tpu_torch.tools.get_era5_data --output_dir DIR --years 2018 2019 \\
        [--pressure_level 500 850] [--hourly_subsample 6] [--resolution 0.25] \\
        [--overwrite] [--dry_run]

Counterpart of makani_tpu/tools/get_era5_data.py: monthly NetCDF
retrievals of the analysis pressure-level state (u, v, w, z, t, q on each
requested level) and of the surface fields (10u, 10v, 100u, 100v, 2t, sp,
msl, tcwv) into <output_dir>/raw/, planned up front (`build_plan`) so that
a rerun skips what is there and --dry_run lists the plan without reaching
the CDS queue. The `cdsapi` package (and a configured ~/.cdsapirc) is
needed only to download; without it the download raises makani_tpu's
RuntimeError.
"""

import argparse
import os

# MARS parameter codes (the ERA5 parameter database): u, v, w, z, t, q
PL_PARAMS = "131/132/135.128/129.128/130.128/133.128"
# 10u, 10v, 100u, 100v, 2t, sp, msl, tcwv
SFC_PARAMS = "165.128/166.128/246.228/247.228/167.128/134.128/151.128/137.128"


def build_plan(output_dir, years, pressure_levels, hourly_subsample, resolution, overwrite):
    """(target path, request) of each monthly retrieval still to make: files
    already there are left out unless `overwrite`."""
    base = os.path.join(output_dir, "raw")
    times = [f"{t:02d}:00" for t in range(0, 24, hourly_subsample)]
    common = {
        "class": "ea",
        "expver": "1",
        "stream": "oper",
        "type": "an",
        "grid": [resolution, resolution],
        "format": "netcdf",
        "time": times,
    }

    plan = []
    for year in years:
        for month in range(1, 13):
            date = f"{year}-{month:02d}-01/to/{year}-{month:02d}-31"
            for pl in pressure_levels:
                path = os.path.join(base, f"pl_{pl}_{year}-{month:02d}.nc")
                req = dict(common, levtype="pl", levelist=str(pl), param=PL_PARAMS, date=date)
                plan.append((path, req))
            path = os.path.join(base, f"sfc_{year}-{month:02d}.nc")
            plan.append((path, dict(common, levtype="sfc", param=SFC_PARAMS, date=date)))

    # no side effects: a file to download again is removed by main() just
    # before its retrieval, so --dry_run --overwrite deletes nothing
    todo = []
    for path, req in plan:
        if os.path.isfile(path) and not overwrite:
            continue
        todo.append((path, req))
    return todo


def main(args):
    plan = build_plan(args.output_dir, args.years, args.pressure_level,
                      args.hourly_subsample, args.resolution, args.overwrite)
    print(f"{len(plan)} retrievals to run")
    if args.dry_run:
        for path, _ in plan:
            print(path)
        return

    try:
        import cdsapi
    except ImportError as e:
        raise RuntimeError(
            "ERA5 download requires the 'cdsapi' package and a configured "
            "~/.cdsapirc (https://cds.climate.copernicus.eu/how-to-api); "
            "it is not installed in this environment"
        ) from e

    os.makedirs(os.path.join(args.output_dir, "raw"), exist_ok=True)
    client = cdsapi.Client()
    for path, req in plan:
        if os.path.isfile(path):  # to download again (--overwrite)
            os.remove(path)
        print(f"Downloading {os.path.basename(path)}")
        client.retrieve("reanalysis-era5-complete", req, path)
    print("Done!")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Output directory (files land in <output_dir>/raw).")
    parser.add_argument("--years", type=int, nargs="+", required=True, help="Years to download.")
    parser.add_argument("--pressure_level", type=int, nargs="+", default=list(range(50, 1050, 50)),
                        help="Pressure levels [hPa].")
    parser.add_argument("--hourly_subsample", type=int, default=1,
                        help="Temporal subsampling in hours.")
    parser.add_argument("--resolution", type=float, default=0.25,
                        help="Spatial resolution in degrees.")
    parser.add_argument("--overwrite", action="store_true", help="Re-download existing files.")
    parser.add_argument("--dry_run", action="store_true",
                        help="Print the retrieval plan and exit.")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
