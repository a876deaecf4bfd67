"""Normalization statistics of a directory of yearly HDF5 files.

    python3 -m makani_tpu_torch.tools.get_stats --data_dir DIR --output_dir DIR \\
        [--dataset_path fields] [--quadrature_rule naive] [--batch 8] [--workers 4]

Counterpart of makani_tpu/tools/get_stats.py, the same bytes in each file:
a file's samples are reduced to quadrature-weighted spatial means and
variances (utils/grids.grid_quadrature_weights) accumulated by Welford's
update, as are the differences of consecutive samples; the files' partial
statistics are merged in file order (a process pool, spawned, reads the
files where workers > 1). The seven files, the npy contract the loss and
the loader read:
  global_means.npy, global_stds.npy        (1, C, 1, 1)
  mins.npy, maxs.npy                       (1, C, 1, 1)
  time_means.npy                           (1, C, H, W)
  time_diff_means.npy, time_diff_stds.npy  (1, C, 1, 1)
h5py is imported on use (utils/imports.import_optional).
"""

import argparse
import glob
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from makani_tpu_torch.utils.grids import grid_quadrature_weights
from makani_tpu_torch.utils.imports import import_optional


def _file_stats(args):
    path, dataset_path, quadrature_rule, batch = args
    h5py = import_optional("h5py", f"get_stats of {path}",
                           hint="tools/get_stats.py reads yearly HDF5 files")
    with h5py.File(path, "r") as f:
        ds = f[dataset_path]
        T, C, H, W = ds.shape
        qw = grid_quadrature_weights(quadrature_rule, (H, W), normalize=True)[None, None]

        count = 0
        mean = np.zeros((C,), np.float64)
        m2 = np.zeros((C,), np.float64)
        mins = np.full((C,), np.inf)
        maxs = np.full((C,), -np.inf)
        tsum = np.zeros((C, H, W), np.float64)
        dcount = 0
        dmean = np.zeros((C,), np.float64)
        dm2 = np.zeros((C,), np.float64)

        prev = None
        for t0 in range(0, T, batch):
            chunk = np.asarray(ds[t0: t0 + batch], dtype=np.float64)
            # quadrature-weighted spatial means per sample
            smean = np.sum(chunk * qw, axis=(-2, -1))  # (B, C)
            svar = np.sum((chunk - smean[..., None, None]) ** 2 * qw, axis=(-2, -1))
            for b in range(chunk.shape[0]):
                count += 1
                delta = smean[b] - mean
                mean += delta / count
                m2 += svar[b] + delta * (smean[b] - mean)
            mins = np.minimum(mins, chunk.min(axis=(0, 2, 3)))
            maxs = np.maximum(maxs, chunk.max(axis=(0, 2, 3)))
            tsum += chunk.sum(axis=0)

            # time differences
            block = chunk if prev is None else np.concatenate([prev[None], chunk], axis=0)
            diffs = np.diff(block, axis=0)
            if diffs.shape[0] > 0:
                dsmean = np.sum(diffs * qw, axis=(-2, -1))
                dsvar = np.sum((diffs - dsmean[..., None, None]) ** 2 * qw, axis=(-2, -1))
                for b in range(diffs.shape[0]):
                    dcount += 1
                    delta = dsmean[b] - dmean
                    dmean += delta / dcount
                    dm2 += dsvar[b] + delta * (dsmean[b] - dmean)
            prev = chunk[-1]

    return dict(count=count, mean=mean, m2=m2, mins=mins, maxs=maxs, tsum=tsum,
                dcount=dcount, dmean=dmean, dm2=dm2)


def _merge(a, b):
    """Welford merge of two partial statistics."""
    if a is None:
        return b
    n = a["count"] + b["count"]
    delta = b["mean"] - a["mean"]
    mean = a["mean"] + delta * b["count"] / n
    m2 = a["m2"] + b["m2"] + delta**2 * a["count"] * b["count"] / n

    dn = a["dcount"] + b["dcount"]
    ddelta = b["dmean"] - a["dmean"]
    dmean = a["dmean"] + (ddelta * b["dcount"] / dn if dn > 0 else 0.0)
    dm2 = a["dm2"] + b["dm2"] + (ddelta**2 * a["dcount"] * b["dcount"] / dn if dn > 0 else 0.0)

    return dict(
        count=n, mean=mean, m2=m2,
        mins=np.minimum(a["mins"], b["mins"]),
        maxs=np.maximum(a["maxs"], b["maxs"]),
        tsum=a["tsum"] + b["tsum"],
        dcount=dn, dmean=dmean, dm2=dm2,
    )


def compute_stats(data_dir, output_dir, dataset_path="fields",
                  quadrature_rule="naive", batch=8, workers=4):
    files = sorted(glob.glob(os.path.join(data_dir, "????.h5")))
    if not files:
        raise IOError(f"no yearly h5 files in {data_dir}")
    os.makedirs(output_dir, exist_ok=True)

    jobs = [(f, dataset_path, quadrature_rule, batch) for f in files]
    total = None
    if workers > 1 and len(files) > 1:
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            for part in ex.map(_file_stats, jobs):
                total = _merge(total, part)
    else:
        for job in jobs:
            total = _merge(total, _file_stats(job))

    C = total["mean"].shape[0]
    var = total["m2"] / total["count"]
    dvar = total["dm2"] / max(total["dcount"], 1)

    np.save(os.path.join(output_dir, "global_means.npy"),
            total["mean"].reshape(1, C, 1, 1).astype(np.float32))
    np.save(os.path.join(output_dir, "global_stds.npy"),
            np.sqrt(var).reshape(1, C, 1, 1).astype(np.float32))
    np.save(os.path.join(output_dir, "mins.npy"),
            total["mins"].reshape(1, C, 1, 1).astype(np.float32))
    np.save(os.path.join(output_dir, "maxs.npy"),
            total["maxs"].reshape(1, C, 1, 1).astype(np.float32))
    np.save(os.path.join(output_dir, "time_means.npy"),
            (total["tsum"] / total["count"])[None].astype(np.float32))
    np.save(os.path.join(output_dir, "time_diff_means.npy"),
            total["dmean"].reshape(1, C, 1, 1).astype(np.float32))
    np.save(os.path.join(output_dir, "time_diff_stds.npy"),
            np.sqrt(dvar).reshape(1, C, 1, 1).astype(np.float32))

    return output_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True, type=str)
    parser.add_argument("--output_dir", required=True, type=str)
    parser.add_argument("--dataset_path", default="fields", type=str)
    parser.add_argument("--quadrature_rule", default="naive", type=str)
    parser.add_argument("--batch", default=8, type=int)
    parser.add_argument("--workers", default=4, type=int)
    args = parser.parse_args(argv)
    compute_stats(args.data_dir, args.output_dir, args.dataset_path,
                  args.quadrature_rule, args.batch, args.workers)
    print(f"stats written to {args.output_dir}")


if __name__ == "__main__":
    main()
