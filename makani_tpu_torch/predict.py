"""Standalone prediction CLI (counterpart of makani_tpu/predict.py).

    python3 -m makani_tpu_torch.predict --yaml_config config/sfnonet.yaml \\
        --config NAME [--run_num 00] [--device cuda|cpu]

Reads initial conditions from an HDF5/NetCDF file (config keys `predict_ic_*`),
rolls the model forward `prediction_length` steps (the zenith channel of
each step from its time), denormalizes, and writes one NetCDF file per
initial condition with a time axis in days since 2000-01-01 12:00. IC
selection: "continuous" (start/stop/step) or "incontinuous" (a list). The
reads and writes need h5py.
"""

import argparse
import datetime
import logging
import os

import numpy as np
import torch

from makani_tpu_torch.models.model_registry import get_model
from makani_tpu_torch.utils import logging_utils
from makani_tpu_torch.utils.checkpoint import restore_checkpoint
from makani_tpu_torch.utils.dataset_metadata import parse_dataset_metadata
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.imports import import_optional
from makani_tpu_torch.utils.nctools import write_netcdf
from makani_tpu_torch.utils.timetools import datetime_to_days2000
from makani_tpu_torch.utils.yparams import YParams
from makani_tpu_torch.utils.zenith_angle import cos_zenith_angle_grid

logger = logging.getLogger(__name__)


class Predict:
    """Predictions of the configured model on `device` (default "cuda";
    raises without CUDA unless device="cpu") from the best checkpoint
    (`predict_with_best_ckpt`, default) or the latest."""

    def __init__(self, params, device=None):
        self.params = params
        self.device = resolve_device(device)

        # normalization stats
        self.global_means = np.load(params.global_means_path)[:, params.in_channels]
        self.global_stds = np.load(params.global_stds_path)[:, params.in_channels]

        # serial shapes
        params["img_crop_shape_x"] = params.img_shape_x
        params["img_crop_shape_y"] = params.img_shape_y
        params["img_crop_offset_x"] = 0
        params["img_crop_offset_y"] = 0
        params["img_local_shape_x"] = params.img_shape_x
        params["img_local_shape_y"] = params.img_shape_y
        params["img_local_offset_x"] = 0
        params["img_local_offset_y"] = 0
        params["N_in_channels"] = len(params.in_channels) + int(params.get("add_zenith", False))
        if params.get("add_grid", False):
            n_grid_chan = 2
            if params.get("gridtype") == "sinusoidal":
                n_grid_chan *= params.get("grid_num_frequencies", 1)
            params["N_in_channels"] += n_grid_chan
        if params.get("add_orography", False):
            params["N_in_channels"] += 1
        if params.get("add_landmask", False):
            params["N_in_channels"] += 2
        params["N_out_channels"] = len(params.out_channels)
        params["n_future"] = 0

        self.model = get_model(params, device=self.device)
        ckpt = (params.best_checkpoint_path if params.get("predict_with_best_ckpt", True)
                else params.checkpoint_path)
        weights, _, _ = restore_checkpoint(ckpt, self.model.state_dict())
        self.model.load_state_dict(weights)
        self.model.eval()

        self.lat = np.asarray(params.lat)
        self.lon = np.asarray(params.lon)

    def _ic_indices(self):
        p = self.params
        mode = p.get("predict_ic_mode", "continuous")
        if mode == "continuous":
            start = p.get("predict_ic_start", 0) or 0
            stop = p.get("predict_ic_stop", 1) or 1
            step = p.get("predict_ic_step", 1) or 1
            return list(range(start, stop, step))
        elif mode == "incontinuous":
            return list(p.get("predict_ic_list") or [])
        raise ValueError(f"Unknown predict_ic_mode {mode}")

    def _read_ic(self, index):
        path = self.params.predict_ic_path
        h5py = import_optional("h5py", f"reading initial conditions from {path}")
        with h5py.File(path, "r") as f:
            key = self.params.h5_path if self.params.h5_path in f else list(f.keys())[0]
            fields = f[key][index, self.params.in_channels]
        return np.asarray(fields, dtype=np.float32)

    def _zenith(self, time):
        if not self.params.get("add_zenith", False):
            return None
        cosz = cos_zenith_angle_grid([time], self.lon, self.lat)
        return torch.from_numpy(cosz).to(self.device).reshape(1, 1, 1, *cosz.shape[-2:])

    @torch.inference_mode()
    def run(self):
        p = self.params
        out_dir = p.get("predict_output_dir", "./")
        os.makedirs(out_dir, exist_ok=True)

        ic_year = p.get("predict_ic_year", 2020)
        dhours = p.dhours
        n_steps = p.get("prediction_length", 4)

        for ic in self._ic_indices():
            out_path = os.path.join(out_dir, f"prediction_ic{ic}.nc")
            if os.path.exists(out_path):
                if p.get("predict_output_skipExists", True) and not p.get(
                        "predict_output_overwrite", False):
                    logger.info(f"skipping existing {out_path}")
                    continue
                os.remove(out_path)

            fields = self._read_ic(ic)
            x = (fields - self.global_means[0]) / self.global_stds[0]
            x = torch.from_numpy(x[None]).to(self.device)

            t0 = datetime.datetime(ic_year, 1, 1, tzinfo=datetime.timezone.utc) \
                + datetime.timedelta(hours=ic * dhours)

            preds, times = [], []
            for step in range(n_steps):
                t = t0 + datetime.timedelta(hours=(step + 1) * dhours)
                z = self._zenith(t0 + datetime.timedelta(hours=step * dhours))
                x = self.model(x, unpredicted_inp=z, deterministic=True)
                preds.append(x[0].cpu().numpy())
                times.append(datetime_to_days2000(t))

            preds = np.stack(preds, axis=0)  # (T, C, H, W)
            preds = preds * self.global_stds[0][None] + self.global_means[0][None]

            dims = {
                "time": np.asarray(times, dtype=np.float64),
                "lat": self.lat.astype(np.float64),
                "lon": self.lon.astype(np.float64),
            }
            variables = {
                name: (("time", "lat", "lon"), preds[:, i], {"long_name": name})
                for i, name in enumerate([p.channel_names[c] for c in p.in_channels])
            }
            write_netcdf(out_path, variables, dims,
                         global_attrs={"ic_index": ic,
                                       "time_units": "days since 2000-01-01 12:00"})
            logger.info(f"wrote {out_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--yaml_config", default="./config/sfnonet.yaml", type=str)
    parser.add_argument("--config", default="base_73chq", type=str)
    parser.add_argument("--run_num", default="00", type=str)
    parser.add_argument("--device", default="cuda", type=str, choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    params = YParams(os.path.abspath(args.yaml_config), args.config)
    exp_dir = os.path.join(params.exp_dir, args.config, str(args.run_num))
    params["experiment_dir"] = os.path.abspath(exp_dir)
    params["checkpoint_path"] = os.path.join(exp_dir, "training_checkpoints", "ckpt")
    params["best_checkpoint_path"] = os.path.join(exp_dir, "training_checkpoints", "best_ckpt")

    logging_utils.config_logger()

    if "metadata_json_path" in params and params["metadata_json_path"]:
        params, _ = parse_dataset_metadata(params["metadata_json_path"], params=params)

    Predict(params, device=args.device).run()
    return 0


if __name__ == "__main__":
    main()
