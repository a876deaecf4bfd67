"""Static conditioning inputs: orography and land-sea mask.

Counterpart of makani_tpu/utils/conditioning_inputs.py. A ``.npy`` file is
read with numpy; any other file is read as NetCDF-4, which is an HDF5
container, through h5py, imported only in that branch so that a machine
without h5py reads ``.npy`` invariants.
"""

import numpy as np

from makani_tpu_torch.utils.imports import import_optional


def _read_var(path, names):
    if str(path).endswith(".npy"):
        return np.load(path)
    h5py = import_optional("h5py", f"reading {path}")
    with h5py.File(path, "r") as f:
        for name in names:
            if name in f:
                arr = f[name][...]
                # drop singleton leading (time) dims
                while arr.ndim > 2:
                    arr = arr[0]
                return arr
        raise KeyError(f"None of {names} found in {path}; keys: {list(f.keys())}")


def get_orography(orography_path):
    """Surface geopotential normalized to [0, 1]."""
    orography = np.asarray(_read_var(orography_path, ["Z", "z", "orog", "orography"]),
                           dtype=np.float64)
    orography = (orography - orography.min()) / (orography.max() - orography.min())
    return orography


def get_land_mask(land_mask_path):
    """Land-sea mask in [0, 1]."""
    return np.asarray(_read_var(land_mask_path, ["lsm", "LSM", "land_sea_mask"]))
