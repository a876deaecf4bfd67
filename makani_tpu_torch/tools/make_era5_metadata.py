"""Write an ERA5 dataset descriptor (data.json).

    python3 -m makani_tpu_torch.tools.make_era5_metadata --output DIR/data.json \\
        [--nlat 721] [--nlon 1440] [--dhours 6]

Counterpart of makani_tpu/tools/make_era5_metadata.py, the same bytes: the
channel list, the lat/lon coordinates, the grid type and the time step. The
defaults give the canonical 73 channels and q on the 0.25-degree 721x1440
grid.
"""

import argparse
import json
import os

import numpy as np

SURFACE = ["u10m", "v10m", "u100m", "v100m", "t2m", "sp", "msl", "tcwv"]
LEVELS = [50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000]
VARS3D = ["z", "u", "v", "t", "q"]


def era5_channel_names(surface=SURFACE, levels=LEVELS, vars3d=VARS3D):
    names = list(surface)
    for var in vars3d:
        for lev in levels:
            names.append(f"{var}{lev}")
    return names


def make_metadata(output, nlat=721, nlon=1440, dhours=6, h5_path="fields",
                  channels=None, name="era5", description="ERA5 reanalysis subset"):
    lat = np.linspace(90.0, -90.0, nlat).tolist()
    lon = (np.arange(nlon) * (360.0 / nlon)).tolist()
    channels = channels or era5_channel_names()
    metadata = {
        "dataset_name": name,
        "attrs": {"description": description},
        "h5_path": h5_path,
        "dims": ["time", "channel", "lat", "lon"],
        "dhours": dhours,
        "coords": {
            "grid_type": "equiangular",
            "lat": lat,
            "lon": lon,
            "channel": channels,
        },
    }
    with open(output, "w") as f:
        json.dump(metadata, f)
    return metadata


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", default="./datasets/era5/data.json")
    parser.add_argument("--nlat", default=721, type=int)
    parser.add_argument("--nlon", default=1440, type=int)
    parser.add_argument("--dhours", default=6, type=int)
    args = parser.parse_args(argv)
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    meta = make_metadata(args.output, args.nlat, args.nlon, args.dhours)
    print(f"wrote {args.output}: {len(meta['coords']['channel'])} channels")


if __name__ == "__main__":
    main()
