"""A yearly multi-channel HDF5 file assembled from per-variable sources,
read in parallel over time ranges.

    python3 -m makani_tpu_torch.tools.parallel_copy --plan plan.json \\
        --dest 1979.h5 --n-channels 73 [--workers 8] [--batch 64]

Counterpart of makani_tpu/tools/parallel_copy.py. The plan is a JSON list of
the channels' sources:

    [{"src": "/data/u10_1979.nc", "var": "u", "channel": 0},
     {"src": "/data/v10_1979.nc", "var": "v", "channel": 1}, ...]

A spawned process pool reads (and decompresses) each source's time ranges;
this process alone writes them into the destination's 'fields' dataset
(HDF5 has no safe concurrent writers without MPI-IO), at most 2 x workers
blocks ahead of it. Sources are read with h5py: NetCDF-4 files are HDF5
files; NetCDF-3 sources must be converted first. h5py is imported on use
(utils/imports.import_optional).
"""

import argparse
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from makani_tpu_torch.utils.imports import import_optional


def _h5py(what):
    return import_optional("h5py", what, hint="NetCDF-4 sources are HDF5 files")


def _read_range(src, var, t0, t1):
    """src[var][t0:t1], singleton level axes squeezed."""
    with _h5py(f"parallel_copy of {src}").File(src, "r") as fs:
        block = fs[var][t0:t1]
    # NetCDF (t, 1, lat, lon) layouts
    while block.ndim > 3:
        block = block.squeeze(1)
    return block


def parallel_copy(plan, dest, n_channels, dataset_path="fields", workers=4, batch=64):
    """Parallel reads, one writer; returns `dest`."""
    h5py = _h5py(f"parallel_copy into {dest}")
    # the destination sized from the first source
    first = plan[0]
    with h5py.File(first["src"], "r") as f:
        v = f[first["var"]]
        n_time = v.shape[0]
        spatial = v.shape[-2:]

    if not os.path.exists(dest):
        with h5py.File(dest, "w") as f:
            f.create_dataset(dataset_path, (n_time, n_channels, *spatial), dtype="f4")

    work = [(entry, t0, min(t0 + batch, n_time))
            for entry in plan for t0 in range(0, n_time, batch)]

    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as ex, \
            h5py.File(dest, "r+") as fd:
        vdst = fd[dataset_path]
        # bounded read-ahead: finished blocks do not pile up in memory when
        # the readers outpace the writer
        depth = max(2 * workers, 2)
        inflight = []
        for entry, t0, t1 in work:
            if len(inflight) >= depth:
                fut, ch, w0, w1 = inflight.pop(0)
                vdst[w0:w1, ch] = fut.result()
            inflight.append((ex.submit(_read_range, entry["src"], entry["var"], t0, t1),
                             int(entry["channel"]), t0, t1))
        for fut, ch, w0, w1 in inflight:
            vdst[w0:w1, ch] = fut.result()
    return dest


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--plan", type=str, required=True,
                        help="JSON list of {src, var, channel} entries")
    parser.add_argument("--dest", type=str, required=True)
    parser.add_argument("--n-channels", type=int, required=True)
    parser.add_argument("--dataset_path", type=str, default="fields")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--batch", type=int, default=64)
    args = parser.parse_args(argv)
    with open(args.plan) as f:
        plan = json.load(f)
    parallel_copy(plan, args.dest, args.n_channels, args.dataset_path, args.workers, args.batch)
    print(f"assembled {args.dest}")


if __name__ == "__main__":
    main()
