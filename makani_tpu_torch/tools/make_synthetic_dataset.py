"""Write a synthetic ERA5-like dataset: yearly files, stats and data.json.

Counterpart of makani_tpu/tools/make_synthetic_dataset.py: for the same
arguments it writes the same files, byte for byte. Run it as

    python -m makani_tpu_torch.tools.make_synthetic_dataset --output DIR \
        [--nlat 36 --nlon 72 --channels 4 --samples 24 --valid-samples N \
         --years 1 --mode random|ar --format h5|bin|both --invariants --seed 333]

Two field modes:

- ``random`` (default): iid standard-normal samples, cheap and shape-correct.
- ``ar``: learnable stationary dynamics for convergence drives, spatially
  smooth unit-variance fields evolving as
      x[t+1] = a * roll_lon(x[t], shift) + sqrt(1 - a^2) * smooth_noise,
  so a training run drives the one-step MSE from ~1 toward the 1 - a^2
  noise floor.

``--format`` selects yearly HDF5 (``h5``), raw npy shards for the native
loader (``bin``), or both. ``--invariants`` also writes synthetic
orography.nc and land_sea_mask.nc (NetCDF-4, through h5py);
``invariant_fields`` returns the same two fields as arrays, for a caller that
saves them as .npy. h5py is imported only by the HDF5 and NetCDF writers, so
``--format bin`` without ``--invariants`` runs without it.
"""

import argparse
import json
import os

import numpy as np

from makani_tpu_torch.utils.imports import import_optional

DEFAULT_CHANNELS = ["u10m", "v10m", "t2m", "z500"]

AR_COEF = 0.95        # stationary AR(1) coefficient
AR_SHIFT = 3          # longitude roll per step (grid points)


def _smooth_fields(rng, n_channels, img_shape, coarse=(24, 48)):
    """Unit-variance spatially smooth random fields: coarse gaussian noise
    bilinearly upsampled to the target grid (periodic in longitude)."""
    H, W = img_shape
    ch, cw = min(coarse[0], H), min(coarse[1], W)
    c = rng.randn(n_channels, ch, cw).astype(np.float32)
    # separable linear interp, W on the coarse grid first (cheap), then H;
    # longitude wraps, latitude clamps
    xi = np.arange(W) * (cw / W)
    x0 = np.floor(xi).astype(np.int64) % cw
    x1 = (x0 + 1) % cw
    fx = (xi - np.floor(xi)).astype(np.float32)[None, None, :]
    row = c[:, :, x0] * (1 - fx) + c[:, :, x1] * fx          # (C, ch, W)
    yi = np.linspace(0, ch - 1, H)
    y0 = np.floor(yi).astype(np.int64)
    y1 = np.minimum(y0 + 1, ch - 1)
    fy = (yi - y0).astype(np.float32)[None, :, None]
    f = row[:, y0] * (1 - fy) + row[:, y1] * fy              # (C, H, W)
    std = f.reshape(n_channels, -1).std(axis=1).reshape(-1, 1, 1)
    return f / np.maximum(std, 1e-6)


def _writers(fname_base, fmt, shape):
    """Yield (write(t, sample), close()) sinks for the requested formats."""
    sinks = []
    closers = []
    if fmt in ("h5", "both"):
        h5py = import_optional("h5py", "writing the h5 format")
        f = h5py.File(fname_base + ".h5", "w")
        ds = f.create_dataset("fields", shape=shape, dtype=np.float32)
        sinks.append(lambda t, x, ds=ds: ds.__setitem__(t, x))
        closers.append(f.close)
    if fmt in ("bin", "both"):
        mm = np.lib.format.open_memmap(
            fname_base + ".npy", mode="w+", dtype=np.float32, shape=shape)
        sinks.append(lambda t, x, mm=mm: mm.__setitem__(t, x))
        closers.append(lambda mm=mm: mm.flush())
    return sinks, closers


def make_dataset(path, img_shape=(36, 72), channels=DEFAULT_CHANNELS,
                 n_samples_per_year=24, n_years=1, start_year=2018, dhours=6,
                 seed=333, mode="random", fmt="h5", n_valid_samples=None,
                 invariants=False):
    rng = np.random.RandomState(seed)
    n_channels = len(channels)

    train_dir = os.path.join(path, "train")
    valid_dir = os.path.join(path, "test")
    stats_dir = os.path.join(path, "stats")
    for d in (train_dir, valid_dir, stats_dir):
        os.makedirs(d, exist_ok=True)

    for i, d in enumerate([train_dir, valid_dir]):
        n_samples = n_samples_per_year if (i == 0 or n_valid_samples is None) \
            else n_valid_samples
        for y in range(n_years):
            year = start_year + i * n_years + y
            base = os.path.join(d, f"{year}")
            shape = (n_samples, n_channels, *img_shape)
            sinks, closers = _writers(base, fmt, shape)
            if mode == "random":
                for t in range(n_samples):
                    x = rng.randn(n_channels, *img_shape).astype(np.float32)
                    for w in sinks:
                        w(t, x)
            else:  # ar
                a, b = AR_COEF, float(np.sqrt(1.0 - AR_COEF**2))
                x = _smooth_fields(rng, n_channels, img_shape)
                for t in range(n_samples):
                    for w in sinks:
                        w(t, x)
                    x = a * np.roll(x, AR_SHIFT, axis=-1) \
                        + b * _smooth_fields(rng, n_channels, img_shape)
            for c in closers:
                c()

    np.save(os.path.join(stats_dir, "global_means.npy"), np.zeros((1, n_channels, 1, 1), np.float32))
    np.save(os.path.join(stats_dir, "global_stds.npy"), np.ones((1, n_channels, 1, 1), np.float32))
    np.save(os.path.join(stats_dir, "mins.npy"), -4 * np.ones((1, n_channels, 1, 1), np.float32))
    np.save(os.path.join(stats_dir, "maxs.npy"), 4 * np.ones((1, n_channels, 1, 1), np.float32))
    np.save(os.path.join(stats_dir, "time_means.npy"), np.zeros((1, n_channels, *img_shape), np.float32))
    np.save(os.path.join(stats_dir, "time_diff_means.npy"), np.zeros((1, n_channels, 1, 1), np.float32))
    # AR mode: Var(x[t+1]-x[t]) = 2*(1 - a*corr(x, roll(x))) — near 2(1-a)
    # for smooth fields; unit works for both modes' weighting purposes
    np.save(os.path.join(stats_dir, "time_diff_stds.npy"), np.ones((1, n_channels, 1, 1), np.float32))

    if invariants:
        make_invariants(path, img_shape, seed=seed + 1)

    lat = np.linspace(90, -90, img_shape[0]).tolist()
    lon = np.arange(0, 360, 360.0 / img_shape[1]).tolist()
    metadata = {
        "dataset_name": "synthetic",
        "attrs": {"description": f"synthetic {mode} dataset for smoke tests/drives"},
        "h5_path": "fields",
        "dims": ["time", "channel", "lat", "lon"],
        "dhours": dhours,
        "coords": {
            "grid_type": "equiangular",
            "lat": lat,
            "lon": lon,
            "channel": list(channels),
        },
    }
    with open(os.path.join(path, "data.json"), "w") as f:
        json.dump(metadata, f)

    return path


def invariant_fields(img_shape, seed=334):
    """(orography, land-sea mask): the synthetic invariant fields, (H, W)
    float32 each, that make_invariants writes."""
    rng = np.random.RandomState(seed)
    oro = _smooth_fields(rng, 1, img_shape)[0]
    lsm = (_smooth_fields(rng, 1, img_shape)[0] > 0.2).astype(np.float32)
    return oro, lsm


def make_invariants(path, img_shape, seed=334):
    """Synthetic orography + land-sea mask NetCDF files (HDF5 containers,
    readable by utils/conditioning_inputs._read_var)."""
    h5py = import_optional("h5py", "writing the invariant .nc files")
    inv_dir = os.path.join(path, "invariant")
    os.makedirs(inv_dir, exist_ok=True)
    oro, lsm = invariant_fields(img_shape, seed)
    with h5py.File(os.path.join(inv_dir, "orography.nc"), "w") as f:
        f.create_dataset("Z", data=oro[None].astype(np.float32))
    with h5py.File(os.path.join(inv_dir, "land_sea_mask.nc"), "w") as f:
        f.create_dataset("lsm", data=lsm[None])
    return inv_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", default="./datasets/synthetic", type=str)
    parser.add_argument("--nlat", default=36, type=int)
    parser.add_argument("--nlon", default=72, type=int)
    parser.add_argument("--samples", default=24, type=int)
    parser.add_argument("--valid-samples", default=None, type=int,
                        help="samples per valid year (default: same as --samples)")
    parser.add_argument("--years", default=1, type=int)
    parser.add_argument("--channels", default=",".join(DEFAULT_CHANNELS), type=str,
                        help="comma list of names, or an integer N for c0..cN-1")
    parser.add_argument("--mode", default="random", choices=["random", "ar"])
    parser.add_argument("--format", default="h5", choices=["h5", "bin", "both"],
                        dest="fmt", help="h5 multifiles, native-loader npy shards, or both")
    parser.add_argument("--invariants", action="store_true",
                        help="also write synthetic orography.nc + land_sea_mask.nc")
    parser.add_argument("--seed", default=333, type=int)
    args = parser.parse_args(argv)
    chans = ([f"c{i}" for i in range(int(args.channels))]
             if args.channels.isdigit() else args.channels.split(","))
    make_dataset(args.output, img_shape=(args.nlat, args.nlon),
                 channels=chans, n_samples_per_year=args.samples,
                 n_years=args.years, mode=args.mode, fmt=args.fmt,
                 n_valid_samples=args.valid_samples, seed=args.seed,
                 invariants=args.invariants)
    print(f"wrote synthetic dataset to {args.output}")


if __name__ == "__main__":
    main()
