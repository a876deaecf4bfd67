"""Preprocessor: everything between raw loader tensors and the network.

Counterpart of makani_tpu/models/preprocessor.py. The rolling unpredicted
(zenith) feature window is explicit state threaded by the steppers and the
inferencer, as in the JAX package. The static features (the linear or
sinusoidal grid, on the unit square or on the data's explicit lat/lon through
GridConverter; orography z-scored; the land-sea mask one-hot) are built on
the host in numpy, as makani_tpu builds them, cut to the crop window and
moved to the device once. On spatial ranks (parallel/comm) they are cut to
the rank's patch of the crop, and the history-normalization statistics sum
over the spatial group.
"""

import numpy as np
import torch

from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.utils.conditioning_inputs import get_land_mask, get_orography
from makani_tpu_torch.utils.grids import GridConverter


class Preprocessor2D:
    def __init__(self, params, device="cpu"):
        self.device = torch.device(device)
        self.n_history = params.n_history
        self.history_normalization_mode = params.get("history_normalization_mode", "none")
        if self.history_normalization_mode == "exponential":
            decay = params.history_normalization_decay
            # inverse ordering, since first element is oldest
            w = np.exp(-decay * np.arange(self.n_history, -1, -1, dtype=np.float64))
            w = (w / np.sum(w)).reshape(1, -1, 1, 1, 1).astype(np.float32)
        elif self.history_normalization_mode == "mean":
            w = np.full((1, self.n_history + 1, 1, 1, 1), 1.0 / (self.n_history + 1),
                        dtype=np.float32)
        else:
            w = np.ones((1, self.n_history + 1, 1, 1, 1), dtype=np.float32)
        self.history_normalization_weights = torch.from_numpy(w).to(self.device)

        # residual normalization
        self.learn_residual = params.target == "residual"
        self.residual_scale = None
        if self.learn_residual and params.get("normalize_residual", False):
            scale = np.load(params.time_diff_stds_path).astype(np.float32)
            self.residual_scale = torch.from_numpy(scale).to(self.device)

        self.img_shape = (params.img_shape_x, params.img_shape_y)

        start_x = params.get("img_crop_offset_x", 0)
        end_x = min(start_x + params.get("img_crop_shape_x", params.img_shape_x),
                    params.img_shape_x)
        start_y = params.get("img_crop_offset_y", 0)
        end_y = min(start_y + params.get("img_crop_shape_y", params.img_shape_y),
                    params.img_shape_y)

        static_features = None
        if params.get("add_grid", False):
            if params.get("lat", None) is not None and params.get("lon", None) is not None:
                lat = np.deg2rad(np.asarray(params.lat, dtype=np.float64))
                lon = np.deg2rad(np.asarray(params.lon, dtype=np.float64))
                gconv = GridConverter(params.get("data_grid_type", "equiangular"),
                                      params.get("model_grid_type", "equiangular"), lat, lon)
                tx, ty = gconv.get_dst_coords()
            else:
                tx = np.linspace(0, 1, params.img_shape_x + 1, dtype=np.float64)[:-1]
                ty = np.linspace(0, 1, params.img_shape_y + 1, dtype=np.float64)[:-1]
            x_grid, y_grid = np.meshgrid(tx, ty, indexing="ij")
            grid = np.stack([x_grid, y_grid], axis=0)[None].astype(np.float32)
            grid = grid[:, :, start_x:end_x, start_y:end_y]
            if params.get("gridtype", "linear") == "sinusoidal":
                num_freq = int(params.get("grid_num_frequencies", 1))
                static_features = np.concatenate(
                    [np.sin(freq * grid) for freq in range(1, num_freq + 1)], axis=1
                ).astype(np.float32)
            else:
                static_features = grid

        if params.get("add_orography", False):
            oro = np.asarray(get_orography(params.orography_path), dtype=np.float64)
            oro = oro.reshape(1, 1, *oro.shape)
            # ddof=1: z-scored with the unbiased std, as makani_tpu does
            oro = ((oro - oro.mean()) / (oro.std(ddof=1) + 1.0e-6)).astype(np.float32)
            oro = oro[:, :, start_x:end_x, start_y:end_y]
            static_features = (oro if static_features is None
                               else np.concatenate([static_features, oro], axis=1))

        if params.get("add_landmask", False):
            lsm = np.asarray(get_land_mask(params.landmask_path)).astype(np.int64)
            onehot = np.eye(int(lsm.max()) + 1, dtype=np.float32)[lsm]  # (H, W, classes)
            onehot = np.transpose(onehot, (2, 0, 1))[None]
            onehot = onehot[:, :, start_x:end_x, start_y:end_y]
            static_features = (onehot if static_features is None
                               else np.concatenate([static_features, onehot], axis=1))

        if static_features is not None and spmd.spatial_distributed():
            # the rank's patch of the crop
            static_features = spmd.local_patch(static_features, static_features.shape[-2:])
        self.static_features = (None if static_features is None
                                else torch.from_numpy(np.ascontiguousarray(static_features))
                                .to(self.device))
        self.do_add_static_features = static_features is not None
        self.n_static_features = 0 if static_features is None else static_features.shape[1]

    # --- history reshaping ---

    def flatten_history(self, x):
        if x.ndim == 5:
            b, t, c, h, w = x.shape
            x = x.reshape(b, t * c, h, w)
        return x

    def expand_history(self, x, nhist):
        if x.ndim == 4:
            b, ct, h, w = x.shape
            x = x.reshape(b, nhist, ct // nhist, h, w)
        return x

    # --- residual learning ---

    def add_residual(self, x, dx):
        """dx = model output; for residual learning add onto the latest history
        frame of x."""
        if not self.learn_residual:
            return dx
        if self.residual_scale is not None:
            dx = dx * self.residual_scale.to(dx.dtype)
        xe = self.expand_history(x, nhist=self.n_history + 1)
        xe = torch.cat([xe[:, :-1], xe[:, -1:] + dx[:, None]], dim=1)
        return self.flatten_history(xe)

    # --- static features ---

    def add_static_features(self, x):
        if not self.do_add_static_features:
            return x
        static = self.static_features.to(x.dtype).expand(x.shape[0], -1, -1, -1)
        return torch.cat([x, static], dim=1)

    def remove_static_features(self, x):
        if not self.do_add_static_features:
            return x
        return x[:, : x.shape[1] - self.n_static_features]

    # --- unpredicted (e.g. zenith) channels ---

    def append_channels(self, x, xc):
        """Interleave unpredicted channels per history frame."""
        xdim = x.ndim
        x = self.expand_history(x, self.n_history + 1)
        xc = self.expand_history(xc, self.n_history + 1)
        xo = torch.cat([x, xc.to(x.dtype)], dim=2)
        if xdim == 4:
            xo = self.flatten_history(xo)
        return xo

    def remove_unpredicted_features(self, x, n_unpredicted):
        if n_unpredicted == 0:
            return x
        xf = self.expand_history(x, nhist=self.n_history + 1)
        return self.flatten_history(xf[:, :, : xf.shape[2] - n_unpredicted])

    def advance_unpredicted(self, unpredicted_inp, unpredicted_tar, step):
        """advance_unpredicted_dyn for a step inside the target window; a
        step past it leaves the window as it was (makani_tpu's static-step
        form)."""
        if unpredicted_tar is None or unpredicted_inp is None \
                or step >= unpredicted_tar.shape[1]:
            return unpredicted_inp
        return self.advance_unpredicted_dyn(unpredicted_inp, unpredicted_tar, step)

    def advance_unpredicted_dyn(self, unpredicted_inp, unpredicted_tar, step):
        """Roll the unpredicted input window forward by one AR step, pulling
        the slice for `step` from the targets; a step past the target window
        clamps to the last target frame (makani_tpu's traced-index form)."""
        if unpredicted_tar is None or unpredicted_inp is None:
            return unpredicted_inp
        step = min(max(int(step), 0), unpredicted_tar.shape[1] - 1)
        utar = unpredicted_tar[:, step: step + 1]
        if self.n_history == 0:
            return utar
        return torch.cat([unpredicted_inp[:, 1:], utar], dim=1)

    # --- history normalization ---

    def history_compute_stats(self, x):
        """Returns (mean, std) with shapes (B, C, 1, 1)."""
        mode = self.history_normalization_mode
        if mode in ("none", "timediff"):
            return (x.new_zeros((1, 1, 1, 1), dtype=torch.float32),
                    x.new_ones((1, 1, 1, 1), dtype=torch.float32))
        xr = self.expand_history(x, self.n_history + 1).float()
        w = self.history_normalization_weights
        npix = float(self.img_shape[0] * self.img_shape[1])
        # sums over the whole field: a spatial rank's patch sums are summed
        # over the spatial group
        mean = spmd.all_reduce_sum(torch.sum(xr * w, dim=(1, 3, 4), keepdim=True),
                                   "spatial") / npix
        std = torch.sqrt(spmd.all_reduce_sum(
            torch.sum(torch.square(xr - mean) * w, dim=(1, 3, 4), keepdim=True),
            "spatial") / npix)
        return (mean.squeeze(1), std.squeeze(1))

    def history_normalize(self, x, stats, target=False):
        if self.history_normalization_mode in ("none", "timediff"):
            return x
        mean, std = stats
        xshape = x.shape
        x = self.flatten_history(x)
        if target:
            xn = (x - mean[:, : x.shape[1]]) / std[:, : x.shape[1]]
        else:
            xn = (x - mean.repeat(1, self.n_history + 1, 1, 1)) \
                / std.repeat(1, self.n_history + 1, 1, 1)
        return xn.reshape(xshape)

    def history_denormalize(self, xn, stats, target=False):
        if self.history_normalization_mode in ("none", "timediff"):
            return xn
        mean, std = stats
        xnshape = xn.shape
        xn = self.flatten_history(xn)
        if target:
            x = xn * std[:, : xn.shape[1]] + mean[:, : xn.shape[1]]
        else:
            x = xn * std.repeat(1, self.n_history + 1, 1, 1) \
                + mean.repeat(1, self.n_history + 1, 1, 1)
        return x.reshape(xnshape)

    # --- autoregressive history append ---

    def append_history(self, x1, x2):
        """Append prediction x2 to history window x1."""
        if self.n_history > 0:
            x1 = self.expand_history(x1, nhist=self.n_history + 1)
            x2 = self.expand_history(x2, nhist=1)
            return self.flatten_history(torch.cat([x1[:, 1:], x2], dim=1))
        return x2
