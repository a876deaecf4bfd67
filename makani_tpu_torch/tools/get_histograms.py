"""Per-channel histograms of a directory of yearly HDF5 files.

    python3 -m makani_tpu_torch.tools.get_histograms --data_dir DIR --output_dir DIR \\
        [--dataset_path fields] [--bins 100] [--workers 4]

Counterpart of makani_tpu/tools/get_histograms.py, the same bytes: each
file is read in time chunks of about 1 GiB (a 73-channel 0.25-degree year
never has to fit in memory), once for the channels' ranges and once for the
counts, one file a task in a spawned process pool. Writes histograms.npy
(C, bins) and histogram_bin_edges.npy (C, bins + 1). h5py is imported on
use (utils/imports.import_optional).
"""

import argparse
import glob
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from makani_tpu_torch.utils.imports import import_optional

# bytes a streamed read holds: 73 x 721 x 1440 float32 is ~300 MB a step,
# so 3 steps a read
_DEFAULT_CHUNK_BYTES = 1 << 30


def _h5py(what):
    return import_optional("h5py", what, hint="tools/get_histograms.py reads yearly HDF5 files")


def _chunk_steps(ds):
    bytes_per_step = int(np.prod(ds.shape[1:])) * ds.dtype.itemsize
    return max(1, _DEFAULT_CHUNK_BYTES // max(bytes_per_step, 1))


def _channel_minmax(args):
    path, dataset_path = args
    with _h5py(f"get_histograms of {path}").File(path, "r") as f:
        ds = f[dataset_path]
        step = _chunk_steps(ds)
        mins = np.full(ds.shape[1], np.inf, dtype=np.float64)
        maxs = np.full(ds.shape[1], -np.inf, dtype=np.float64)
        for t0 in range(0, ds.shape[0], step):
            block = ds[t0: t0 + step]
            np.minimum(mins, block.min(axis=(0, 2, 3)), out=mins)
            np.maximum(maxs, block.max(axis=(0, 2, 3)), out=maxs)
    return mins, maxs


def _file_histogram(args):
    path, dataset_path, edges = args
    with _h5py(f"get_histograms of {path}").File(path, "r") as f:
        ds = f[dataset_path]
        C = ds.shape[1]
        step = _chunk_steps(ds)
        counts = np.zeros((C, edges.shape[1] - 1), dtype=np.int64)
        for t0 in range(0, ds.shape[0], step):
            block = ds[t0: t0 + step]
            for c in range(C):
                counts[c] += np.histogram(block[:, c].ravel(), bins=edges[c])[0]
    return counts


def compute_histograms(data_dir, output_dir, dataset_path="fields", bins=100, workers=4):
    files = sorted(glob.glob(os.path.join(data_dir, "????.h5")))
    if not files:
        raise IOError(f"no yearly h5 files in {data_dir}")
    os.makedirs(output_dir, exist_ok=True)

    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        mm = list(ex.map(_channel_minmax, [(f, dataset_path) for f in files]))
        mins = np.min([m for m, _ in mm], axis=0)
        maxs = np.max([m for _, m in mm], axis=0)
        edges = np.stack([np.linspace(mins[c], maxs[c], bins + 1) for c in range(len(mins))])
        counts = list(ex.map(_file_histogram, [(f, dataset_path, edges) for f in files]))
    hist = np.sum(counts, axis=0)

    np.save(os.path.join(output_dir, "histograms.npy"), hist)
    np.save(os.path.join(output_dir, "histogram_bin_edges.npy"), edges)
    return hist, edges


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--dataset_path", default="fields")
    parser.add_argument("--bins", default=100, type=int)
    parser.add_argument("--workers", default=4, type=int)
    args = parser.parse_args(argv)
    compute_histograms(args.data_dir, args.output_dir, args.dataset_path, args.bins,
                       args.workers)
    print(f"histograms written to {args.output_dir}")


if __name__ == "__main__":
    main()
