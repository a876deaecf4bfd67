"""Validation metrics: the rollout ACC and RMSE curves, loss and L1 buffers.

Counterpart of makani_tpu/utils/metric.py. The buffers are a dict of tensors
on the handler's device; `update` returns new buffers and leaves the ones it
was given as they were, as makani_tpu's pure update does. As in makani_tpu
(and unlike the reference), the curves accumulate sums over the batch and
`acc_counter` counts samples, not update calls, so the finalized curves are
per-sample means at any batch size.

On several ranks (parallel/comm) each rank scores its patch of its batch:
the quadratures sum their patches over the spatial group (utils/grids), the
climatology is cut to the patch, and `finalize` sums the curves, the sample
counts and the loss and L1 sums over the data group, the loss and L1 divided
by the data size as makani_tpu divides them (makani_tpu/utils/metric.py:46-120).
`split_data_channels` (on ranks split over fin or fout): each rank scores
its chunk of the channels (split_shapes over ("fin", "fout"), uneven where
the channels do not divide), keeps its rows of the `acc_curve` and
`rmse_curve` buffers, and `finalize` gathers the rows over ("fin", "fout")
(makani_tpu/utils/metric.py:46-120); the L1 and the loss stay whole.

`time_stats` is makani_tpu's Trainer._get_time_stats as a function, for the
Inferencer and the Trainer: the output normalization's scale (`mult`) and
the climatology (`clim`, time_means_path cropped and normalized with the
*input* normalization; zeros on synthetic data).
"""

import numpy as np
import torch

from makani_tpu_torch.parallel import comm, spmd

from makani_tpu_torch.utils.metrics.functions import (
    GeometricACC,
    GeometricL1,
    GeometricRMSE,
    Quadrature,
)

DEFAULT_VAR_NAMES = ["u10m", "t2m", "u500", "z500", "r500", "q500"]

# the axes split_data_channels splits the metric's channels over
MATMUL = ("fin", "fout")


def time_stats(params, dataloader):
    """(mult (C,), clim (C, H, W)) as float32 numpy."""
    _, out_scale = dataloader.get_output_normalization()
    mult = np.asarray(out_scale)[0, :, 0, 0]
    if params.get("enable_synthetic_data", False):
        clim = np.zeros((params.N_out_channels, params.img_crop_shape_x,
                         params.img_crop_shape_y), dtype=np.float32)
    else:
        in_bias, in_scale = dataloader.get_input_normalization()
        sx, sy = params.img_crop_offset_x, params.img_crop_offset_y
        ex, ey = sx + params.img_crop_shape_x, sy + params.img_crop_shape_y
        time_means = np.load(params.time_means_path)[0, params.out_channels, sx:ex, sy:ey]
        clim = ((time_means - in_bias[0]) / in_scale[0]).astype(np.float32)
    return mult, clim


class MetricsHandler:
    def __init__(self, params, mult, clim,
                 rmse_var_names=DEFAULT_VAR_NAMES,
                 acc_var_names=DEFAULT_VAR_NAMES,
                 acc_auc_var_names=DEFAULT_VAR_NAMES,
                 device="cpu"):
        self.device = torch.device(device)
        # the predicted channels only: the auxiliary inputs (aux_channel_names)
        # are never named here
        self.channel_names = list(params.channel_names)

        # effective time interval, steps per day
        self.dtxdh = params.dt * params.dhours

        rmse_var_names = [x for x in rmse_var_names if x in self.channel_names]
        acc_var_names = [x for x in acc_var_names if x in self.channel_names]
        acc_auc_var_names = [x for x in acc_auc_var_names if x in self.channel_names]
        self.rmse_vars = {v: self.channel_names.index(v) for v in rmse_var_names}
        self.acc_vars = {v: self.channel_names.index(v) for v in acc_var_names}
        self.acc_auc_vars = {v: self.channel_names.index(v) for v in acc_auc_var_names}

        self.N_out_channels = params.N_out_channels
        self.valid_autoreg_steps = params.valid_autoreg_steps

        self.split_data_channels = (bool(params.get("split_data_channels", False))
                                    and comm.get_size("matmul") > 1)
        # the channels this rank scores
        self.channels = (spmd.patch_slice(self.N_out_channels, MATMUL)
                         if self.split_data_channels else slice(None))
        self.mult = torch.from_numpy(np.asarray(mult, dtype=np.float32).reshape(-1)[
            self.channels].copy()).to(self.device)  # (C,)
        clim = np.asarray(clim, dtype=np.float32)[self.channels]
        clim = np.ascontiguousarray(spmd.local_patch(clim, clim.shape[-2:]))
        self.clim = torch.from_numpy(clim[None]).to(self.device)  # (1, C, H, W)

        self.simpquad = Quadrature(self.valid_autoreg_steps,
                                   1.0 / float(self.valid_autoreg_steps + 1))

        self.img_shape = (params.img_shape_x, params.img_shape_y)
        self.crop_shape = (params.img_crop_shape_x, params.img_crop_shape_y)
        self.crop_offset = (params.img_crop_offset_x, params.img_crop_offset_y)

        quadrature_rule_type = "naive"
        if params.model_grid_type == "legendre_gauss":
            quadrature_rule_type = "legendre-gauss"

        kw = dict(img_shape=self.img_shape, crop_shape=self.crop_shape,
                  crop_offset=self.crop_offset, normalize=True, device=self.device)
        self.l1_handle = GeometricL1(quadrature_rule_type, channel_reduction="mean",
                                     batch_reduction="mean", **kw)
        self.rmse_handle = GeometricRMSE(quadrature_rule_type, channel_reduction="none",
                                         batch_reduction="none", **kw)
        self.acc_handle = GeometricACC(quadrature_rule_type, channel_reduction="none",
                                       batch_reduction="sum", **kw)

    def initialize_buffers(self):
        C, S = self.mult.shape[0], self.valid_autoreg_steps + 1

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)
        return {"valid_loss": zeros(), "valid_l1": zeros(), "valid_steps": zeros(),
                "acc_curve": zeros(C, S), "rmse_curve": zeros(C, S), "acc_counter": zeros(S)}

    def update(self, buffers, prediction, target, loss, idt):
        """The buffers after AR step `idt` (an int) of a batch."""
        clim = self.clim.to(prediction.dtype)
        pred, targ = prediction[:, self.channels], target[:, self.channels]
        acc = self.acc_handle(pred - clim, targ - clim)
        rmse = self.mult * torch.sum(self.rmse_handle(pred, targ), dim=0)

        buffers = dict(buffers)
        for key, value in (("acc_curve", acc), ("rmse_curve", rmse)):
            curve = buffers[key].clone()
            curve[:, idt] += value
            buffers[key] = curve
        counter = buffers["acc_counter"].clone()
        counter[idt] += float(prediction.shape[0])
        buffers["acc_counter"] = counter

        first = float(idt == 0)
        buffers["valid_steps"] = buffers["valid_steps"] + first
        buffers["valid_loss"] = buffers["valid_loss"] + first * loss
        buffers["valid_l1"] = buffers["valid_l1"] + first * self.l1_handle(prediction, target)
        return buffers

    def finalize(self, buffers, final_inference=False):
        """The logs dict (and, for final_inference, the ACC and RMSE curves
        as numpy), on the host."""
        if spmd.data_distributed():
            buffers = {k: v.detach().clone() for k, v in buffers.items()}
            data = float(comm.get_size("data"))
            for key in ("valid_loss", "valid_l1", "acc_curve", "rmse_curve", "acc_counter"):
                spmd.all_reduce_(buffers[key], "data")
            buffers["valid_loss"] /= data
            buffers["valid_l1"] /= data
        if self.split_data_channels:
            buffers = dict(buffers)
            for key in ("acc_curve", "rmse_curve"):
                buffers[key] = spmd.gather(buffers[key].detach().contiguous(), 0, MATMUL,
                                           self.N_out_channels)
        buffers = {k: v.detach().cpu().numpy() for k, v in buffers.items()}
        valid_steps = float(buffers["valid_steps"])
        valid_loss = float(buffers["valid_loss"]) / max(valid_steps, 1.0)
        valid_l1 = float(buffers["valid_l1"]) / max(valid_steps, 1.0)

        counter = np.maximum(buffers["acc_counter"], 1.0)
        acc_curve = buffers["acc_curve"] / counter
        rmse_curve = buffers["rmse_curve"] / counter

        acc_auc = self.simpquad(torch.from_numpy(acc_curve), dim=1).numpy()

        logs = {
            "base": {
                "validation steps": int(valid_steps),
                "validation loss": valid_loss,
                "validation L1": valid_l1,
            },
            "metrics": {},
        }

        for var_name, var_idx in self.rmse_vars.items():
            logs["metrics"]["validation " + var_name] = float(rmse_curve[var_idx, 0])
        for var_name, var_idx in self.acc_auc_vars.items():
            logs["metrics"]["ACC AUC " + var_name] = float(acc_auc[var_idx])

        table_data = []
        for var_name, var_idx in self.acc_vars.items():
            for d in range(self.valid_autoreg_steps + 1):
                table_data.append(["ACC", var_name, (d + 1) * self.dtxdh,
                                   float(acc_curve[var_idx, d])])
        for var_name, var_idx in self.rmse_vars.items():
            for d in range(self.valid_autoreg_steps + 1):
                table_data.append(["RMSE", var_name, (d + 1) * self.dtxdh,
                                   float(rmse_curve[var_idx, d])])
        logs["metrics"]["rollouts"] = table_data

        self.logs = logs

        if final_inference:
            return logs, acc_curve, rmse_curve
        return logs
