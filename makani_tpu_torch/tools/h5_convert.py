"""Rechunk or convert yearly HDF5 datasets for fast windowed reads.

    python3 -m makani_tpu_torch.tools.h5_convert --src DIR_OR_FILE --dst DIR_OR_FILE \\
        [--dataset_path fields] [--chunk_channels 1] [--dtype float32]

Counterpart of makani_tpu/tools/h5_convert.py: the same datasets, dtypes,
chunks and attributes. A chunk holds one (sample, channel) plane by default,
the loader's read unit; the file's other datasets and its attributes are
copied. h5py is imported on use (utils/imports.import_optional).
"""

import argparse
import glob
import os

import numpy as np

from makani_tpu_torch.utils.imports import import_optional


def _h5py(what):
    return import_optional("h5py", what, hint="tools/h5_convert.py reads and writes HDF5")


def convert_file(src, dst, dataset_path="fields", chunk_channels=1, batch=4, dtype=None):
    h5py = _h5py(f"h5_convert of {src}")
    with h5py.File(src, "r") as fi, h5py.File(dst, "w") as fo:
        ds = fi[dataset_path]
        T, C, H, W = ds.shape
        out_dtype = np.dtype(dtype) if dtype else ds.dtype
        chunks = (1, min(chunk_channels, C), H, W)
        out = fo.create_dataset(dataset_path, shape=ds.shape, dtype=out_dtype, chunks=chunks)
        for t0 in range(0, T, batch):
            out[t0: t0 + batch] = ds[t0: t0 + batch].astype(out_dtype)
        for key in fi.keys():
            if key != dataset_path:
                fi.copy(key, fo)
        for k, v in fi.attrs.items():
            fo.attrs[k] = v
    return dst


def convert_dir(src_dir, dst_dir, dataset_path="fields", **kwargs):
    os.makedirs(dst_dir, exist_ok=True)
    outs = []
    for src in sorted(glob.glob(os.path.join(src_dir, "????.h5"))):
        dst = os.path.join(dst_dir, os.path.basename(src))
        outs.append(convert_file(src, dst, dataset_path, **kwargs))
    return outs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--dataset_path", default="fields")
    parser.add_argument("--chunk_channels", default=1, type=int)
    parser.add_argument("--dtype", default=None)
    args = parser.parse_args(argv)
    if os.path.isdir(args.src):
        outs = convert_dir(args.src, args.dst, args.dataset_path,
                           chunk_channels=args.chunk_channels, dtype=args.dtype)
    else:
        outs = [convert_file(args.src, args.dst, args.dataset_path,
                             chunk_channels=args.chunk_channels, dtype=args.dtype)]
    print(f"converted {len(outs)} files")


if __name__ == "__main__":
    main()
