"""Rewrite yearly HDF5 files with the dataset at an aligned offset, for
O_DIRECT reads.

    python3 -m makani_tpu_torch.tools.h5_align --input_dir DIR --output_dir DIR \\
        [--dataset_path fields] [--batch_size 32] [--align_size_bytes 4096] \\
        [--transpose] [--overwrite] [--verify_integrity]

Counterpart of makani_tpu/tools/h5_align.py: each file is written again
with a user block and HDF5's alignment threshold and interval, so the
contiguous dataset starts on a multiple of align_size_bytes; its data is
copied in time batches, or as NHWC with --transpose. --verify_integrity
prints each file's dataset offset and whether it is aligned. h5py is
imported on use (utils/imports.import_optional).
"""

import argparse
import glob
import os

import numpy as np

from makani_tpu_torch.utils.imports import import_optional


def _h5py(what):
    return import_optional("h5py", what, hint="tools/h5_align.py reads and writes HDF5")


def align_file(ifname, ofname, dataset_path="fields", batch_size=32,
               align_size_bytes=4096, transpose=False):
    h5py = _h5py(f"h5_align of {ifname}")
    with h5py.File(ifname, "r") as fin:
        src = fin[dataset_path]
        shape = src.shape
        dtype = src.dtype
        if transpose:
            shape = (shape[0], shape[2], shape[3], shape[1])

        with h5py.File(ofname, "w", userblock_size=max(512, align_size_bytes),
                       alignment_threshold=align_size_bytes,
                       alignment_interval=align_size_bytes) as fout:
            dst = fout.create_dataset(dataset_path, shape, dtype=dtype)
            for t0 in range(0, shape[0], batch_size):
                t1 = min(t0 + batch_size, shape[0])
                data = src[t0:t1]
                if transpose:
                    data = np.transpose(data, (0, 2, 3, 1))
                dst[t0:t1] = data


def verify_file(fname, dataset_path="fields", align_size_bytes=4096):
    """(shape, offset, aligned) of the file's dataset."""
    h5py = _h5py(f"h5_align --verify_integrity of {fname}")
    with h5py.File(fname, "r") as f:
        ds = f[dataset_path]
        offset = ds.id.get_offset()
        aligned = offset is not None and offset % align_size_bytes == 0
        return ds.shape, offset, aligned


def main(args):
    files = sorted(glob.glob(os.path.join(args.input_dir, "*.h5")))
    if not files:
        raise IOError(f"no h5 files in {args.input_dir}")
    os.makedirs(args.output_dir, exist_ok=True)

    for ifname in files:
        ofname = os.path.join(args.output_dir, os.path.basename(ifname))
        if args.verify_integrity:
            shape, offset, ok = verify_file(ifname, args.dataset_path, args.align_size_bytes)
            print(f"{ifname}: shape={shape} offset={offset} aligned={ok}", flush=True)
            continue
        if os.path.exists(ofname) and not args.overwrite:
            print(f"File {ofname} already exists, skipping.", flush=True)
            continue
        print(f"Converting {ifname} -> {ofname}", flush=True)
        align_file(ifname, ofname, args.dataset_path, args.batch_size,
                   args.align_size_bytes, args.transpose)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--dataset_path", type=str, default="fields")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--align_size_bytes", type=int, default=4096)
    parser.add_argument("--verify_integrity", action="store_true")
    parser.add_argument("--transpose", action="store_true")
    parser.add_argument("--overwrite", action="store_true")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
