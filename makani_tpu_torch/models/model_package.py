"""Self-contained inference model packages.

Counterpart of makani_tpu/models/model_package.py. An experiment dir is a
package: config.json (the resolved params), copies of the orography, the
land-sea mask and the normalization stats, metadata.json (the entrypoint),
and the best checkpoint (training_checkpoints/best_ckpt, the port's format,
utils/checkpoint). `load_model_package` rebuilds the serial model;
`ModelWrapper` appends the zenith channel computed from wall-clock time, so
a caller passes (fields, time) only; `TimeLoop` steps physical fields.

The invariant files: makani_tpu copies the orography and the land mask to
orography.nc and land_mask.nc whatever their format. The port reads a file
by its suffix (utils/conditioning_inputs: .npy with numpy, anything else as
NetCDF through h5py), so it keeps makani_tpu's names for NetCDF sources and
names .npy sources orography.npy and land_mask.npy: a package made from
.npy invariants loads without h5py (ROADMAP, Queue 3).
"""

import datetime
import json
import os
import shutil

import numpy as np
import torch

from makani_tpu_torch.models.model_registry import get_model
from makani_tpu_torch.utils.checkpoint import restore_checkpoint
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.yparams import ParamsBase
from makani_tpu_torch.utils.zenith_angle import cos_zenith_angle

THIS_MODULE = "makani_tpu_torch.models.model_package"
MODEL_PACKAGE_CHECKPOINT_PATH = "training_checkpoints/best_ckpt"
MINS_FILE = "mins.npy"
MAXS_FILE = "maxs.npy"
MEANS_FILE = "global_means.npy"
STDS_FILE = "global_stds.npy"


def _invariant_file(stem, source):
    """The package's name of an invariant: `stem`.npy for a .npy source,
    `stem`.nc (makani_tpu's name) for any other."""
    return stem + (".npy" if str(source).endswith(".npy") else ".nc")


class LocalPackage:
    def __init__(self, root):
        self.root = root

    def get(self, path):
        return os.path.join(self.root, path)


class ModelWrapper:
    """forward(x, time): the model on x (B, C, H, W) with the zenith channel
    of wall-clock `time` appended where the config adds it."""

    def __init__(self, model, params, device):
        self.model = model
        self.params = params
        self.device = device
        nlat = params.img_shape_x
        nlon = params.img_shape_y
        self.lats = 90 - 180 * np.arange(nlat) / (nlat - 1)
        self.lons = 360 * np.arange(nlon) / nlon
        self.add_zenith = params.get("add_zenith", False)

    @torch.inference_mode()
    def __call__(self, x, time):
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        z = None
        if self.add_zenith:
            lon_grid, lat_grid = np.meshgrid(self.lons, self.lats)
            cosz = cos_zenith_angle(time, lon_grid, lat_grid).astype(np.float32)
            n_hist = self.params.n_history + 1
            z = torch.from_numpy(cosz).to(self.device).reshape(1, 1, 1, *cosz.shape[-2:])
            z = z.expand(x.shape[0], n_hist, 1, *cosz.shape[-2:])
        return self.model(x, unpredicted_inp=z, deterministic=True)


def save_model_package(params):
    """Write config.json, the invariants, the stats and metadata.json into
    params.experiment_dir (the checkpoint goes to best_ckpt on its own)."""
    exp_dir = params.experiment_dir
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump({k: v for k, v in params.to_dict().items()
                   if not k.startswith("_")}, f, indent=2, default=str)

    if params.get("add_orography", False):
        shutil.copy(params.orography_path,
                    os.path.join(exp_dir, _invariant_file("orography", params.orography_path)))
    if params.get("add_landmask", False):
        shutil.copy(params.landmask_path,
                    os.path.join(exp_dir, _invariant_file("land_mask", params.landmask_path)))

    if params.get("global_means_path", None):
        shutil.copy(params.global_means_path, os.path.join(exp_dir, MEANS_FILE))
    if params.get("global_stds_path", None):
        shutil.copy(params.global_stds_path, os.path.join(exp_dir, STDS_FILE))
    if params.normalization == "minmax":
        if params.get("min_path", None):
            shutil.copy(params.min_path, os.path.join(exp_dir, MINS_FILE))
        if params.get("max_path", None):
            shutil.copy(params.max_path, os.path.join(exp_dir, MAXS_FILE))

    metadata = {"entrypoint": {"name": f"{THIS_MODULE}:load_time_loop"}}
    with open(os.path.join(exp_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)


def _load_static_data(package, params):
    if params.get("add_orography", False):
        params.orography_path = package.get(_invariant_file("orography", params.orography_path))
    if params.get("add_landmask", False):
        params.landmask_path = package.get(_invariant_file("land_mask", params.landmask_path))

    if params.normalization == "zscore":
        if params.get("global_means_path", None):
            params.global_means_path = package.get(MEANS_FILE)
        if params.get("global_stds_path", None):
            params.global_stds_path = package.get(STDS_FILE)
    elif params.normalization == "minmax":
        if params.get("min_path", None):
            params.min_path = package.get(MINS_FILE)
        if params.get("max_path", None):
            params.max_path = package.get(MAXS_FILE)
    elif params.normalization != "none":
        raise ValueError("Unknown normalization mode.")


def load_model_package(package, pretrained=True, device=None):
    """A ModelWrapper of the package's model on `device` (default "cuda";
    raises without CUDA unless device="cpu"), with the best checkpoint's
    weights when `pretrained`."""
    if isinstance(package, str):
        package = LocalPackage(package)
    device = resolve_device(device)

    params = ParamsBase.from_json(package.get("config.json"))
    _load_static_data(package, params)

    # serial layout
    params.img_local_offset_x = 0
    params.img_local_offset_y = 0
    params.img_local_shape_x = params.img_shape_x
    params.img_local_shape_y = params.img_shape_y

    model = get_model(params, device=device)
    if pretrained:
        weights, _, _ = restore_checkpoint(package.get(MODEL_PACKAGE_CHECKPOINT_PATH),
                                           model.state_dict())
        model.load_state_dict(weights)
    model.eval()
    return ModelWrapper(model, params, device)


class TimeLoop:
    """A time loop over physical fields: ``loop(x, time)`` with
    x (batch, n_history+1, n_channels, nlat, nlon) yields an endless sequence
    of (time, fields), the initial condition first. Normalization and the
    rolling history window run on the host in numpy, the model on the
    wrapper's device."""

    def __init__(self, wrapper, center, scale, channel_names, time_step):
        self.wrapper = wrapper
        self.center = np.asarray(center, np.float32).reshape(1, 1, -1, 1, 1)
        self.scale = np.asarray(scale, np.float32).reshape(1, 1, -1, 1, 1)
        self.in_channel_names = self.out_channel_names = list(channel_names)
        self.time_step = time_step
        p = wrapper.params
        self.n_history = p.n_history
        self.grid_shape = (p.img_shape_x, p.img_shape_y)

    def __call__(self, x, time):
        x = (np.asarray(x, np.float32) - self.center) / self.scale
        b, t, c, h, w = x.shape
        while True:
            yield time, x[:, -1] * self.scale[:, 0] + self.center[:, 0]
            pred = self.wrapper(x.reshape(b, t * c, h, w), time).cpu().numpy()
            # roll the history window forward with the new prediction
            x = np.concatenate([x[:, 1:], pred.reshape(b, 1, c, h, w)], axis=1)
            time = time + self.time_step


def load_time_loop(package, time_step_hours=None, device=None):
    """The package as a TimeLoop (the metadata.json entrypoint)."""
    if isinstance(package, str):
        package = LocalPackage(package)

    params = ParamsBase.from_json(package.get("config.json"))
    if params.in_channels != params.out_channels:
        raise NotImplementedError("TimeLoop requires equal input/output channels")
    names = [params.channel_names[i] for i in params.in_channels]

    if params.normalization == "minmax":
        lo = np.squeeze(np.load(package.get(MINS_FILE)))[params.in_channels]
        hi = np.squeeze(np.load(package.get(MAXS_FILE)))[params.in_channels]
        # the training loaders' [0, 1] map, (x - min) / (max - min), as
        # makani_tpu's TimeLoop takes it
        center, scale = lo, hi - lo
    else:
        center = np.squeeze(np.load(package.get(MEANS_FILE)))[params.in_channels]
        scale = np.squeeze(np.load(package.get(STDS_FILE)))[params.in_channels]

    wrapper = load_model_package(package, pretrained=True, device=device)
    hours = time_step_hours if time_step_hours is not None else params.get("dt", 6)
    return TimeLoop(wrapper, center, scale, names, datetime.timedelta(hours=int(hours)))
