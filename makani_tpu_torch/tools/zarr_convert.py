"""Yearly HDF5 files converted to zarr stores.

    python3 -m makani_tpu_torch.tools.zarr_convert --input_dir DIR --output_dir DIR \\
        [--dataset_path fields] [--metadata_json_path data.json] [--time_chunk 4] \\
        [--overwrite]

Counterpart of makani_tpu/tools/zarr_convert.py: the (T, C, H, W) array is
streamed in time chunks through the zarr API (no dask or xarray), and the
channel, lat and lon coordinates of data.json, where given, become the
array's attributes, so data/zarr_helper.ZarrDataset reads the ????.zarr
stores. zarr and h5py are imported on use (utils/imports.import_optional);
without zarr the CLI exits with makani_tpu's message.
"""

import argparse
import glob
import json
import os
import shutil

import numpy as np

from makani_tpu_torch.utils.imports import import_optional


def convert_file(src, dst, dataset_path="fields", metadata=None, time_chunk=4, overwrite=False):
    """One HDF5 file -> one zarr store; returns the destination path."""
    h5py = import_optional("h5py", f"zarr_convert of {src}",
                           hint="tools/zarr_convert.py reads HDF5 files")
    zarr = import_optional("zarr", f"zarr_convert of {src}",
                           hint="keep the HDF5 or npy formats (tools/h5_convert.py)")

    if os.path.exists(dst):
        if not overwrite:
            print(f"File {dst} already exists, skipping.", flush=True)
            return dst
        shutil.rmtree(dst)

    with h5py.File(src, "r") as f:
        ds = f[dataset_path]
        T, C, H, W = ds.shape
        root = zarr.open_group(dst, mode="w")
        create = root.create_array if hasattr(root, "create_array") else root.create_dataset
        out = create(dataset_path, shape=ds.shape, dtype=ds.dtype,
                     chunks=(min(time_chunk, T), C, H, W))
        for t0 in range(0, T, time_chunk):
            out[t0: t0 + time_chunk] = ds[t0: t0 + time_chunk]

        # coordinates (channel names, lat/lon) from data.json
        if metadata is not None:
            coords = metadata.get("coords", {})
            attrs = {
                "channel": coords.get("channel", []),
                "lat": list(np.asarray(coords.get("lat", [])).tolist()),
                "lon": list(np.asarray(coords.get("lon", [])).tolist()),
                "grid_type": coords.get("grid_type", "equiangular"),
            }
            out.attrs.update({k: v for k, v in attrs.items() if v})
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", type=str, required=True,
                        help="Directory with yearly ????.h5 files.")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Directory for ????.zarr stores.")
    parser.add_argument("--dataset_path", type=str, default="fields")
    parser.add_argument("--metadata_json_path", type=str, default=None,
                        help="Optional data.json for coordinate attrs.")
    parser.add_argument("--time_chunk", type=int, default=4)
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)

    try:
        import zarr  # noqa: F401
    except ImportError:
        raise SystemExit(
            "zarr is not installed in this environment; install it or keep "
            "the HDF5/native formats (tools/h5_convert.py, "
            "native_loader.convert_h5_to_bin).")

    metadata = None
    if args.metadata_json_path:
        with open(args.metadata_json_path) as f:
            metadata = json.load(f)

    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(args.input_dir, "????.h5")))
    if not files:
        raise SystemExit(f"no ????.h5 files in {args.input_dir}")
    for src in files:
        year = os.path.splitext(os.path.basename(src))[0]
        dst = os.path.join(args.output_dir, f"{year}.zarr")
        print(f"Converting {src} -> {dst}", flush=True)
        convert_file(src, dst, args.dataset_path, metadata, args.time_chunk, args.overwrite)


if __name__ == "__main__":
    main()
