"""Inference engine: rollouts, scoring and predictions.

Counterpart of makani_tpu/utils/inferencer.py: an Inferencer built from
params runs a host loop over one AR step, in four kinds of rollout:
  - `metrics_step`: the loss (LossHandler, training=False), the
    MetricsHandler's ACC and RMSE curves, and the fork's squared-error
    accumulators over time (S, C) and space (C, H, W), summed over the batch;
  - `capture_step`: the prediction and the matching target frame;
  - `lite_step`: the prediction without targets, with the
    `sst_persistence_channels` pinned to their initial-condition value.
`inference_single` (metrics and/or captured data of one initial condition),
`inference_lite` (with `ic_perturbation_std`), `predict` (denormalized),
`inference_epoch` (the whole evaluation loader; the ACC and RMSE curves and
the RMSE over time and over space, saved as four npy files in
experiment_dir, and the curves plotted a channel a PNG under
experiment_dir/rollout_plots by utils/visualize, where matplotlib imports,
else a warning) and `score_model` are makani_tpu's.

The weights: `weights` (a state dict of the stepper) where the caller gives
them; else the checkpoint at params.checkpoint_path (utils/checkpoint, the
port's format; a versioned root resolves to its latest step), as makani_tpu
restores it; a config that names no checkpoint gets weights drawn from a
generator seeded with its global_seed.

Under `amp_mode` "bf16" (or "fp16", bf16 here as in makani_tpu) each step
casts its input to bfloat16 before the forward and takes the prediction back
in float32; the rollout state and the host buffers stay float32. As in
makani_tpu, the Inferencer leaves the transform and contraction precision as
they are set.

The evaluation data: as in makani_tpu, the Inferencer builds the evaluation
loader of `inf_data_path` (data.json first, for data from files; synthetic
data under enable_synthetic_data) and takes the image shapes, the crop and
the channel counts from its dataset. `_get_batch(ic)` reads sample
samples_offset + ic. No step writes into its inputs, so a caller's zenith
fields serve any number of rollouts (makani_tpu copies them because its steps
donate their buffers).

The MetricsHandler and the loss are built at their first use: a rollout
without metrics needs neither channel names nor stats files.

Each `lite_step` is a unit of the host-lead counter's "serve" loop
(utils/tracing.mark), whose finished units a rollout's closing synchronize
settles.

On several ranks (parallel/comm, set up by the caller: inference.py under
torchrun) over data, the spatial h and w axes and the channel fin and fout
axes, the rollouts run on each rank's patch of its rows (the model's
outputs are whole in their channels); the weights are the checkpoint's slices; the
scores sum over the spatial and data groups (the validation loss is the
data ranks' mean, invariant to the layout as makani_tpu's,
makani_tpu/utils/inferencer.py:125-135), and only what is exported or scored
on the host is gathered: the captured and lite rollouts of one initial
condition are gathered whole on every rank, and rank 0 writes the files.
"""

import functools
import logging
import os
import time

import numpy as np
import torch

from makani_tpu_torch.data.dataloader import get_dataloader, init_data_params, to_device
from makani_tpu_torch.models.model_registry import as_params, get_model, update_channel_params
from makani_tpu_torch.parallel import comm, spmd
from makani_tpu_torch.utils import tracing
from makani_tpu_torch.utils.checkpoint import restore_checkpoint
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.losses import LossHandler
from makani_tpu_torch.utils.metric import MetricsHandler, time_stats

logger = logging.getLogger(__name__)


class Inferencer:
    """Rollouts of the configured model on `device` (default "cuda"; raises
    without CUDA unless device="cpu")."""

    def __init__(self, params, weights=None, device=None):
        self.device = resolve_device(device)
        params = as_params(params)
        self.log_to_screen = params.get("log_to_screen", False)
        init_data_params(params)
        self.valid_dataloader, self.valid_dataset = get_dataloader(
            params, params.get("inf_data_path", None), train=False, final_eval=True)
        params = update_channel_params(params, dataset=self.valid_dataset)
        self.amp_dtype = (torch.bfloat16 if params.get("amp_mode", "none") in ("bf16", "fp16")
                          else None)
        self.params = params
        self.model = get_model(params, device=self.device)
        if weights is None and params.get("checkpoint_path", None):
            weights, _, _ = restore_checkpoint(params.checkpoint_path, self.model.state_dict(),
                                               shards=self.model.shards)
        if weights is not None:
            self.model.load_state_dict(weights)
        self.model.eval()
        self.preprocessor = self.model.preprocessor
        self._S = params.valid_autoreg_steps + 1
        self.sst_persistence_channels = tuple(params.get("sst_persistence_channels", ()) or ())
        self.ic_perturbation_std = params.get("ic_perturbation_std", None)

    @functools.cached_property
    def metrics(self):
        mult, clim = time_stats(self.params, self.valid_dataloader)
        return MetricsHandler(self.params, mult, clim, device=self.device)

    @functools.cached_property
    def loss_obj(self):
        return LossHandler(self.params, device=self.device)

    # ------------------------------------------------------------------
    # one AR step

    def _fwd(self, inpt, uinp):
        x = inpt if self.amp_dtype is None else inpt.to(self.amp_dtype)
        return self.model(x, unpredicted_inp=uinp, deterministic=True).float()

    def _target(self, tar, idt):
        t = min(idt, tar.shape[1] - 1)
        return self.preprocessor.flatten_history(tar[:, t: t + 1])

    @torch.inference_mode()
    def metrics_step(self, buffers, rmse_t, rmse_s, inpt, uinp, tar, zen_tar, idt):
        """Returns the new buffers and accumulators, the next input and the
        next zenith input."""
        prep = self.preprocessor
        targ = self._target(tar, idt)
        pred = self._fwd(inpt, uinp)
        loss = self.loss_obj(pred, targ, inpt, training=False)
        buffers = self.metrics.update(buffers, pred, targ, loss, idt)
        sqdif = torch.sum((pred - targ) ** 2, dim=0)  # (C, H, W), summed over the batch
        rmse_t = rmse_t.clone()
        if spmd.spatial_distributed():
            h, w = self._global_hw()
            rmse_t[idt] += spmd.all_reduce_(sqdif.sum(dim=(-2, -1)), "spatial") / (h * w)
        else:
            rmse_t[idt] += torch.mean(sqdif, dim=(-2, -1))
        rmse_s = rmse_s + sqdif
        uinp = prep.advance_unpredicted_dyn(uinp, zen_tar, idt)
        return buffers, rmse_t, rmse_s, prep.append_history(inpt, pred), uinp

    @torch.inference_mode()
    def capture_step(self, inpt, uinp, tar, zen_tar, idt):
        prep = self.preprocessor
        targ = self._target(tar, idt)
        pred = self._fwd(inpt, uinp)
        uinp = prep.advance_unpredicted_dyn(uinp, zen_tar, idt)
        return pred, targ, prep.append_history(inpt, pred), uinp

    @torch.inference_mode()
    def lite_step(self, inpt, uinp, zen_tar, idt):
        tracing.mark("serve", self.device)
        prep = self.preprocessor
        pred = self._fwd(inpt, uinp)
        if self.sst_persistence_channels:
            # pinning each step keeps the channel at its IC value inductively
            pred = pred.clone()
            for c in self.sst_persistence_channels:
                pred[:, c] = inpt[:, c]
        uinp = prep.advance_unpredicted_dyn(uinp, zen_tar, idt)
        return pred, prep.append_history(inpt, pred), uinp

    # ------------------------------------------------------------------
    # rollouts

    def _put(self, x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _host_buffer(self, steps, like):
        """(steps, *like.shape) float32 host array the predictions are copied
        into as they come: page-locked when they come from the GPU, so each
        step's copy runs at the link's rate and no stacking copy follows."""
        return torch.empty((steps, *like.shape), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _global_hw(self):
        return (self.params.img_crop_shape_x, self.params.img_crop_shape_y)

    def _finish(self, *buffers):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            tracing.settle("serve")
        if spmd.spatial_distributed():
            # the whole fields, from every spatial rank's patches
            buffers = tuple(spmd.gather_patch(b, self._global_hw()) for b in buffers)
        return tuple(b.numpy() for b in buffers)

    def _zero_accumulators(self):
        p = self.params
        rmse_t = torch.zeros((self._S, p.N_out_channels), dtype=torch.float32, device=self.device)
        hw = [spmd.patch(n, ax)[1] for n, ax in zip(self._global_hw(), ("h", "w"))]
        rmse_s = torch.zeros((p.N_out_channels, *hw), dtype=torch.float32, device=self.device)
        return rmse_t, rmse_s

    def _rollout_metrics(self, buffers, rmse_t, rmse_s, inp, tar, zen_inp=None, zen_tar=None):
        inpt = self.preprocessor.flatten_history(self._put(inp))
        tar, uinp, zen_tar = self._put(tar), self._put(zen_inp), self._put(zen_tar)
        for idt in range(self._S):
            buffers, rmse_t, rmse_s, inpt, uinp = self.metrics_step(
                buffers, rmse_t, rmse_s, inpt, uinp, tar, zen_tar, idt)
        return buffers, rmse_t, rmse_s

    def _rollout_capture(self, inp, tar, zen_inp=None, zen_tar=None):
        """(steps, B, C, H, W) predictions and targets as numpy arrays."""
        inpt = self.preprocessor.flatten_history(self._put(inp))
        tar, uinp, zen_tar = self._put(tar), self._put(zen_inp), self._put(zen_tar)
        preds = targs = None
        for idt in range(self._S):
            pred, targ, inpt, uinp = self.capture_step(inpt, uinp, tar, zen_tar, idt)
            if preds is None:
                preds, targs = self._host_buffer(self._S, pred), self._host_buffer(self._S, targ)
            preds[idt].copy_(pred, non_blocking=True)
            targs[idt].copy_(targ, non_blocking=True)
        return self._finish(preds, targs)

    def _rollout_lite(self, inp, zen_inp=None, zen_tar=None):
        """(steps, B, C, H, W) predictions as a numpy array."""
        inpt = self.preprocessor.flatten_history(self._put(inp))
        uinp, zen_tar = self._put(zen_inp), self._put(zen_tar)
        preds = None
        for idt in range(self._S):
            pred, inpt, uinp = self.lite_step(inpt, uinp, zen_tar, idt)
            if preds is None:
                preds = self._host_buffer(self._S, pred)
            preds[idt].copy_(pred, non_blocking=True)
        return self._finish(preds)[0]

    def _get_batch(self, ic):
        """Initial condition `ic` (after samples_offset) as a device batch of
        one: (inp, tar, zen_inp, zen_tar), the zenith fields None without."""
        idx = int(self.params.get("samples_offset", 0) or 0) + ic
        if idx >= len(self.valid_dataset):
            raise IndexError(f"initial condition {ic} beyond dataset")
        return to_device(tuple(np.asarray(f)[None] for f in self.valid_dataset[idx]),
                         self.device)

    # ------------------------------------------------------------------
    # public API

    def inference_single(self, ic=0, compute_metrics=False, output_data=False,
                         output_channels=(0, 1)):
        inp, tar, zen_inp, zen_tar = self._get_batch(ic)
        result = []
        if compute_metrics:
            buffers, (rt, rs) = self.metrics.initialize_buffers(), self._zero_accumulators()
            buffers, rt, rs = self._rollout_metrics(buffers, rt, rs, inp, tar, zen_inp, zen_tar)
            self.metrics.finalize(buffers)
        if output_data:
            preds, targs = self._rollout_capture(inp, tar, zen_inp, zen_tar)
            oc = list(output_channels)
            result += [targs[:, :, oc], preds[:, :, oc]]
        return tuple(result)

    def inference_lite(self, ic=0, output_data=False, output_channels=(0, 1)):
        inp, tar, zen_inp, zen_tar = self._get_batch(ic)
        if self.ic_perturbation_std:
            # noise drawn on the host in makani_tpu's order: one (H, W) field
            # a perturbed channel, added to every history frame
            rng = np.random.RandomState(42)
            inp_np = np.array(inp.cpu())
            for ch, std in dict(self.ic_perturbation_std).items():
                noise = rng.normal(0.0, std, self._global_hw()).astype(np.float32)
                inp_np[:, :, int(ch)] += spmd.local_patch(noise, self._global_hw())
            inp = torch.from_numpy(inp_np).to(self.device)
        preds = self._rollout_lite(inp, zen_inp, zen_tar)
        if output_data:
            return (preds[:, :, list(output_channels)],)
        return ()

    def predict(self, ic=0):
        """Denormalized predictions (steps, C, H, W) in physical units."""
        global_means = np.load(self.params.global_means_path)
        global_stds = np.load(self.params.global_stds_path)
        channels = list(range(self.params.N_out_channels))
        _, preds = self.inference_single(ic, output_data=True, output_channels=channels)
        out_ch = self.params.out_channels
        return (np.squeeze(preds) * global_stds[:, out_ch, 0, 0].reshape(1, -1, 1, 1)
                + global_means[:, out_ch, 0, 0].reshape(1, -1, 1, 1))

    def inference_epoch(self, output_channels):
        """Scores the evaluation loader; saves acc_curves.npy, rmse_curves.npy,
        RMSE_over_time.npy and RMSE_over_space.npy into experiment_dir and
        plots the curves.
        The squared errors are sums over the batch, so the RMSE exports are
        normalized by the number of samples, not batches."""
        buffers, (rt, rs) = self.metrics.initialize_buffers(), self._zero_accumulators()
        eval_samples = 0
        for data in self.valid_dataloader:
            inp, tar, zen_inp, zen_tar = to_device(data, self.device)
            eval_samples += int(inp.shape[0])
            buffers, rt, rs = self._rollout_metrics(buffers, rt, rs, inp, tar, zen_inp, zen_tar)

        if comm.get_world_size() > 1:
            # sums over the data ranks; the whole field from the patches
            rt, rs = spmd.all_reduce_(rt, "data"), spmd.all_reduce_(rs, "data")
            eval_samples *= comm.get_size("data")
            rs = spmd.gather_patch(rs, self._global_hw())
        eval_samples = max(eval_samples, 1)
        rmse_over_space = np.sqrt(rs.cpu().numpy() / (self._S * eval_samples))
        rmse_over_time = np.sqrt(rt.cpu().numpy() / eval_samples)

        logs, acc_curves, rmse_curves = self.metrics.finalize(buffers, final_inference=True)
        if comm.get_world_rank() != 0:
            return logs

        exp_dir = self.params.experiment_dir
        np.save(os.path.join(exp_dir, "acc_curves.npy"), acc_curves)
        np.save(os.path.join(exp_dir, "rmse_curves.npy"), rmse_curves)
        global_stds = np.load(self.params.global_stds_path)
        oc = output_channels
        np.save(os.path.join(exp_dir, "RMSE_over_time.npy"),
                rmse_over_time * global_stds[:, oc, 0, 0])
        np.save(os.path.join(exp_dir, "RMSE_over_space.npy"),
                rmse_over_space * global_stds[0, oc])

        try:
            from makani_tpu_torch.utils.visualize import plot_rollout_metrics
            plot_rollout_metrics(acc_curves, rmse_curves, self.params,
                                 epoch=0, model_name=self.params.nettype)
        except Exception as e:
            logger.warning(f"rollout plotting failed: {e}")
        return logs

    def log_score(self, scoring_logs, scoring_time):
        if not self.log_to_screen:
            return
        separator = "-" * 50
        prefix = "    "
        logger.info(separator)
        logger.info("Scoring summary:")
        logger.info("Total scoring time is {:.2f} sec".format(scoring_time))
        print_list = list(scoring_logs["metrics"].keys())
        max_len = max(len(x) for x in print_list) if print_list else 0
        logger.info("Metrics:")
        for key in print_list:
            value = scoring_logs["metrics"][key]
            if np.isscalar(value):
                logger.info(f"{prefix}{key}: {' ' * (max_len - len(key))}{value}")
        logger.info(separator)

    def score_model(self, output_channels):
        if self.log_to_screen:
            logger.info("Starting Scoring...")
        scoring_start = time.time()
        scoring_logs = self.inference_epoch(output_channels=output_channels)
        self.log_score(scoring_logs, time.time() - scoring_start)
        return scoring_logs
