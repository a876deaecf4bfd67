"""Training engine.

Counterpart of makani_tpu/utils/trainer.py for a single device: the train
step of `_build_steps` (augmentation, forward, loss, backward, optimizer
update), the evaluation steps (`eval_ar_step`, `eval_step`, `eval_forward`,
`grad_step`), `train` with validation, the per-epoch and best checkpoints,
resume and finetune, the weights-and-grads dump, the experiment log and the
DebugNet pipeline self-test. The forward and backward run eagerly; the
spectral filter's contractions go through the differentiable kernel wrappers
(ops/spectral_mm legdot, dhconv on the "kernel" coefficient engine;
complex_kernels.contract_dhconv_kernel on the "xla" engine under
complex_ops.enable_pallas_kernels).
Under `amp_mode` "bf16" (or "fp16", which is bf16 here as in makani_tpu) the
input is cast to bfloat16 before the forward, the activations stay bf16
where makani_tpu's do, the loss is taken on the float32 prediction, and the
parameters, gradients and optimizer state stay float32 (bf16 moments where
the config asks for them). Validation casts its input and takes its
prediction back to float32 the same way.
The update is the fused Adam kernel (ops/fused_adam, one launch per update
for all the parameter leaves, in place; its twin on the CPU) for every
Adam-family config (Adam, AdamW, LAMB; float32 or bf16 moments; clipped by
the global gradient norm, computed on the device, where the config asks),
whatever `optimizer_fused`
says: without clipping or LAMB it gives the bits of makani_tpu's fused stage,
and for bf16 moments those of its optax chain too. Adafactor and SGD run
utils/optimizers' chain (float32 tensor ops on either device); float16
moments run it on the CPU only. The step's
forward, backward and optimizer update are spans ("train_step.forward",
".backward", ".optimizer"), which tools/profile_forward.py --train and the
benchmark's optimizer_ms read; like every span they come from
utils/tracing.py and are free when no profiler runs (a check, under 1 us a
span on the host). Each `train_step` is a unit of the host-lead counter's "train"
loop (utils/tracing.mark). `profile_steps` > 0 traces the first that many
steps of epoch 1 with torch.profiler into
<experiment_dir>/profile/trace.json.

The data: the training loader reads `train_data_path` and the evaluation
loader `valid_data_path` (data/dataloader.get_dataloader: the native reader
for npy shards, zarr, HDF5, or synthetic data under enable_synthetic_data),
after data.json (`metadata_json_path`) has named the channels, as makani_tpu's
train.py parses it; the image shapes, the crop and the channel counts come
from the evaluation dataset, as in makani_tpu's `_update_parameters`.

Multi-step training (n_future > 0, train.py's --multistep_count) unrolls
the stepper n_future + 1 steps against the flattened target window, with the
loss's uniform multistep weights. Dropout: each train step's forward draws
its masks under the DropoutKey (dropout seed, the step's `iters`, the
unrolled step) of models/common/layers.py, makani_tpu's fold of the step into
its dropout key; the masks are not JAX's, and a block recomputed under
checkpointing draws those of its forward.

Checkpoints (utils/checkpoint, the port's format, written in the
background): each epoch's under `checkpoint_path` (versioned, keep
`checkpoint_max_to_keep`), and the best validation loss's under
`best_checkpoint_path`. Their counters are makani_tpu's (`iters`, `epoch`,
`scheduler_epoch`, `scheduler_state`, `best_valid_loss`) with the
augmentation generator's state under AUG_STATE_KEY and the dropout seed under
DROPOUT_SEED_KEY in place of makani_tpu's `dropout_key`: a resumed run
continues as the uninterrupted one would, bit for bit.

The rollout videos: where `log_video` > 0, every log_video-th epoch's
validation renders, for its first batch, the one-step prediction against
the target of channels :2 (`eval_forward`) and a video of channel 0 over the
rollout whose frames the scoring AR steps hand back (`eval_step(...,
capture_frames=True)`), both by utils/visualize.VisualizationWrapper into
<experiment_dir>/visualizations/ as makani_tpu names them. The metrics do
not depend on it. The host packages it needs (matplotlib, PIL) are checked
when the Trainer is built, where a config would render (makani_tpu fails at
the first render).

Several ranks (parallel/comm, set up by the caller: train.py under
torchrun) over the data axis, the spatial h and w axes and the channel fin
and fout axes: each rank's loader yields its rows and its (lat/h, lon/w)
window of the global batch, the model keeps its shard of the leaves split
over h, w, fin and fout (parallel/partitioning, weights broadcast at init;
the channel collectives are the modules' own), the step's gradients are summed over the spatial
axes that share each leaf and averaged over data in one flattened buffer per
dtype and group, and the loss reported is the data ranks' mean, as
makani_tpu divides its loss and gradients by the data size
(makani_tpu/utils/trainer.py:435-452). The fused Adam kernel runs on each
rank's shards; the clip norm, LAMB's trust ratios and Adafactor's
statistics are those of whole leaves. The augmentation's longitude roll is
drawn for the global batch and applied across the w ranks. Checkpoints hold
the serial file: every split leaf is gathered and rank 0 writes it; each
rank restores its slice. Only rank 0 logs, renders and writes.
`split_data_channels` splits the validation metrics' channels over fin and
fout (utils/metric).
"""

import functools
import logging
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from makani_tpu_torch.data.dataloader import get_dataloader, init_data_params, to_device
from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
from makani_tpu_torch.models.model_registry import as_params, get_model, update_channel_params
from makani_tpu_torch.ops import complex_ops, sht
from makani_tpu_torch.ops.fused_adam import fused_adam_apply
from makani_tpu_torch.parallel import comm, partitioning, spmd
from makani_tpu_torch.utils import checkpoint as ckpt_lib
from makani_tpu_torch.utils import tracing
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.imports import import_optional
from makani_tpu_torch.utils.losses import LossHandler
from makani_tpu_torch.utils.metric import MetricsHandler, time_stats
from makani_tpu_torch.utils.optimizers import (
    AdamState,
    LRScheduler,
    apply_updates,
    build_optimizer,
    kernel_update_settings,
)
from makani_tpu_torch.utils.param_layout import from_port_layout, torch_key_to_jax

logger = logging.getLogger(__name__)

# the checkpoint counter that carries the augmentation generator's state (a
# list of ints, so the counters stay JSON)
AUG_STATE_KEY = "aug_generator_state"
# the counter that carries the dropout masks' seed
DROPOUT_SEED_KEY = "dropout_seed"

_DEFAULTS = (("history_normalization_mode", "none"), ("num_visualization_workers", 1),
             ("log_video", 0), ("log_weights_and_grads", 0), ("skip_validation", False),
             ("load_checkpoint", "legacy"), ("save_checkpoint", "legacy"),
             ("load_optimizer", True), ("load_scheduler", True), ("load_counters", True),
             ("print_timings_frequency", -1))


def augment_batch(inp, tar, zen_inp, zen_tar, generator, do_roll, noise_std, global_hw=None):
    """Train-time augmentation on the batch's device: a random longitude roll
    per sample, applied consistently to inputs, targets and zenith, then
    gaussian input noise. Draws come from `generator` (torch's stream, not
    JAX's: the same seed gives other shifts and noise than makani_tpu). On
    several ranks the draws are the global batch's (whole (H, W) =
    `global_hw`), each rank taking its rows and patch, and a roll moves
    longitudes across the w ranks."""
    data, wsize = comm.get_size("data"), comm.get_size("w")
    b, r = inp.shape[0], comm.get_rank("data")
    if do_roll:
        nlon = inp.shape[-1] if global_hw is None else global_hw[1]
        shifts = torch.randint(0, nlon, (b * data,), generator=generator,
                               device=generator.device).tolist()[r * b:(r + 1) * b]

        def roll(t):
            if t is None:
                return None
            if wsize > 1:
                sizes = spmd.split_shapes(nlon, wsize)
                t = spmd.gather_uneven(t, -1, "w", sizes)
            t = torch.stack([torch.roll(x, s, dims=-1) for x, s in zip(t, shifts)])
            return t[..., spmd.patch_slice(nlon, "w")].contiguous() if wsize > 1 else t

        inp, tar, zen_inp, zen_tar = roll(inp), roll(tar), roll(zen_inp), roll(zen_tar)
    if noise_std > 0.0:
        shape = list(inp.shape)
        shape[0] *= data
        if global_hw is not None:
            shape[-2:] = global_hw
        noise = torch.randn(shape, generator=generator, device=generator.device)[r * b:(r + 1) * b]
        if global_hw is not None:
            noise = spmd.local_patch(noise, global_hw)
        inp = inp + noise_std * noise.to(inp.device, inp.dtype)
    return inp, tar, zen_inp, zen_tar


def _check_supported(params):
    log_video = int(params.get("log_video", 0) or 0)
    if log_video > 0 and not params.get("skip_validation", False):
        for module in ("matplotlib", "PIL"):
            import_optional(module, f"log_video {log_video} (the rollout videos)",
                            hint="set log_video: 0 to train without them")
    sizes = list(params.get("model_parallel_sizes", None) or [1, 1, 1, 1])
    names = list(params.get("model_parallel_names", None) or ["h", "w", "fin", "fout"])
    asked = dict(zip(names, (int(s) for s in sizes)))
    for ax in comm.MODEL_AXES:
        if asked.get(ax, 1) != comm.get_size(ax):
            raise ValueError(f"model_parallel_sizes asks for {ax} = {asked.get(ax, 1)}, the "
                             f"process groups have {comm.get_size(ax)}: start the ranks with "
                             "torchrun and call parallel.comm.init first (as train.py does)")
    world = int(params.get("world_size", 1) or 1)
    if world != comm.get_world_size():
        raise ValueError(f"world_size {world} in the config, {comm.get_world_size()} ranks")


class Trainer:
    """Trains the configured model on `device` (default "cuda"; raises without
    CUDA unless device="cpu"). Weights are drawn from `generator`, by default
    one seeded with the config's global_seed."""

    def __init__(self, params, device=None, generator=None, world_rank=None, job_type="train"):
        self.device = resolve_device(device)
        params = as_params(params)
        _check_supported(params)
        self.world_rank = comm.get_world_rank() if world_rank is None else world_rank
        self.data_parallel_size = comm.get_size("data")
        self.data_parallel_rank = comm.get_rank("data")
        init_data_params(params)
        self.train_dataloader, self.train_dataset = get_dataloader(
            params, params.get("train_data_path", None), train=True)
        self.valid_dataloader, self.valid_dataset = get_dataloader(
            params, params.get("valid_data_path", None), train=False)
        params = update_channel_params(params, dataset=self.valid_dataset)
        for key, default in _DEFAULTS:
            if params.get(key, None) is None:
                params[key] = default
        self.params = params
        # only rank 0 logs, renders and writes
        self.log_to_screen = params.get("log_to_screen", False) and self.world_rank == 0

        # the experiment log: wandb where it imports, else makani_tpu's
        # JSON-lines backend
        self.wandb = None
        if params.get("log_to_wandb", False) and self.world_rank == 0:
            from makani_tpu_torch.utils.wandb_compat import experiment_log
            self.wandb = experiment_log()
            self.wandb.init(
                dir=params.get("wandb_dir", None) or params.get("experiment_dir", "."),
                config=params, name=params.get("wandb_name", None),
                group=params.get("wandb_group", None), project=params.get("wandb_project", None),
                entity=params.get("wandb_entity", None), resume=params.get("resuming", False))

        # a self-contained inference package (its best_ckpt comes with training)
        if self.world_rank == 0 and params.get("experiment_dir", None) and job_type == "train":
            from makani_tpu_torch.models.model_package import save_model_package
            save_model_package(params)

        # AMP: "fp16" is bf16 too, as in makani_tpu (no loss scaling)
        amp_mode = params.get("amp_mode", "none")
        self.amp_dtype = torch.bfloat16 if amp_mode in ("bf16", "fp16") else None

        # spectral precision of the transforms and of the contractions, both
        # set as makani_tpu's Trainer sets them: "default" (1 bf16 pass in
        # the kernels) under AMP, else "high" (3 passes); "highest" runs the
        # complex path in float32; transform_precision overrides either
        tp = params.get("transform_precision", None) or (
            "default" if self.amp_dtype is not None else "high")
        sht.set_transform_precision(tp)
        complex_ops.set_contraction_precision(tp)
        logger.info("transform/contraction precision: %r (amp=%s%s)", tp, amp_mode,
                    "" if params.get("transform_precision", None) else ", default for this mode")
        engine = params.get("coefficient_engine", None)
        if engine is not None:
            # makani_tpu's "pallas" engine is the port's kernel engine; "xla"
            # and "stacked" keep their names
            sht.set_coeff_engine("kernel" if engine == "pallas" else engine)

        # NaN/Inf trapping (makani_tpu: jax_debug_nans)
        if params.get("enable_grad_anomaly_detection", False):
            torch.autograd.set_detect_anomaly(True)

        self.model = get_model(params, device=self.device, generator=generator)
        self.preprocessor = self.model.preprocessor
        self.loss_obj = LossHandler(params, device=self.device)

        # the leaves split over h and w hold the rank's shard (get_model);
        # every rank starts from the same weights
        self.shards = self.model.shards
        self.model_params = dict(self.model.named_parameters())
        if comm.get_world_size() > 1:
            partitioning.sync_params(self.model_params, self.shards)
        self.optimizer = build_optimizer(params, self.shards or None)
        self.scheduler = LRScheduler(params)
        self.opt_state = self.optimizer.init({k: p.detach() for k, p in self.model_params.items()})
        self.fused_kw = kernel_update_settings(params)
        if self.fused_kw is not None:
            logger.info("optimizer: fused Adam kernel (%s)", self.fused_kw)
        self.dropout_seed = int(params.get("global_seed", 333)) + 1

        self.do_roll = bool(params.get("roll", False))
        self.noise_std = (float(params.get("noise_std", 0.0))
                          if params.get("add_noise", False) else 0.0)
        self.aug_generator = torch.Generator(device=self.device)
        self.aug_generator.manual_seed(int(params.get("global_seed", 333)) + 1)

        self.iters = 0
        self.epoch = 0
        self.startEpoch = 0
        self.best_valid_loss = 1.0e6
        # (epoch, path, seconds the save call took: the host copies) of each
        # save, and the seconds each epoch's checkpoint decision waited for
        # the previous writes
        self.checkpoint_log = []
        self.checkpoint_waits = []
        # last_logs of every epoch this Trainer ran
        self.epoch_logs = []
        # the rollout videos' renderer, made at the first validation that
        # renders
        self.visualizer = None

        self._log_memory("after model and optimizer init")

        if params.get("resuming", False):
            self.restore_checkpoint(params.checkpoint_path)
        elif params.get("finetune", False) and params.get("pretrained_checkpoint_path", None):
            self.restore_checkpoint(params.pretrained_checkpoint_path,
                                    load_optimizer=False, load_counters=False)

        self.n_model_params = sum(p.numel() for p in self.model_params.values())
        if self.log_to_screen:
            logger.info(f"number of trainable model parameters: {self.n_model_params}")

    def _get_time_stats(self):
        """(mult, clim) of the evaluation data (utils/metric.time_stats)."""
        return time_stats(self.params, self.valid_dataloader)

    @functools.cached_property
    def metrics(self):
        """The MetricsHandler, built at the first validation (as the
        Inferencer builds its own): training without validation needs
        neither channel names nor the time-means file."""
        mult, clim = self._get_time_stats()
        return MetricsHandler(self.params, mult, clim, device=self.device)

    # ------------------------------------------------------------------
    # steps

    def adam_state(self):
        """The Adam state of the optimizer chain (after its clip stage, where
        the config clips)."""
        return next(s for s in self.opt_state if isinstance(s, AdamState))

    @tracing.span("train_step.optimizer")
    def apply_updates(self, grads, lr):
        """The optimizer update of makani_tpu's train step, in place."""
        if self.fused_kw is not None:
            fused_adam_apply(self.model_params, grads, self.adam_state(), lr,
                             shards=self.shards or None, **self.fused_kw)
            return
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                        self.model_params)
        apply_updates(self.model_params, updates, lr)

    def _amp(self, x):
        return x if self.amp_dtype is None else x.to(self.amp_dtype)

    def dropout_key(self):
        """The dropout key of the current step (makani_tpu folds `iters` into
        its dropout key)."""
        return DropoutKey(self.dropout_seed, self.iters, 0)

    def loss_and_grads(self, inp, tar, zen_inp=None, zen_tar=None, deterministic=False):
        """Loss of the batch and the gradient of every parameter (dict); in
        training the forward draws its dropout masks from `dropout_key()`."""
        prep = self.preprocessor
        for p in self.model_params.values():
            p.grad = None
        # the input's flattening and cast are the forward's work
        with tracing.span("train_step.forward"), \
                use_dropout_key(None if deterministic else self.dropout_key()):
            inp = self._amp(prep.flatten_history(inp))
            tar = prep.flatten_history(tar)
            pred = self.model(inp, unpredicted_inp=zen_inp, unpredicted_tar=zen_tar,
                              deterministic=deterministic)
            loss = self.loss_obj(pred.float(), tar, inp, training=True)
        with tracing.span("train_step.backward"):
            loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.model_params.items()}
        for p in self.model_params.values():
            p.grad = None
        loss = loss.detach()
        if comm.get_world_size() > 1:
            # the whole batch's gradients; the loss the data ranks' mean
            partitioning.reduce_gradients(grads, self.shards)
            if self.data_parallel_size > 1:
                loss = spmd.all_reduce_(loss.clone(), "data") / self.data_parallel_size
        return loss, grads

    def train_step(self, inp, tar, zen_inp, zen_tar, lr):
        """One optimizer step on a device batch; returns the loss (a tensor)."""
        tracing.mark("train", self.device)
        if self.do_roll or self.noise_std > 0.0:
            inp, tar, zen_inp, zen_tar = augment_batch(
                inp, tar, zen_inp, zen_tar, self.aug_generator, self.do_roll, self.noise_std,
                self._global_hw() if spmd.spatial_distributed() else None)
        loss, grads = self.loss_and_grads(inp, tar, zen_inp, zen_tar)
        self.apply_updates(grads, lr)
        return loss

    def grad_step(self, inp, tar, zen_inp=None, zen_tar=None):
        """Loss and raw gradients for the weights-and-grads dump (the model
        in its deterministic mode, no augmentation)."""
        return self.loss_and_grads(inp, tar, zen_inp, zen_tar, deterministic=True)

    def _global_hw(self):
        return (self.params.img_crop_shape_x, self.params.img_crop_shape_y)

    @torch.no_grad()
    def eval_forward(self, inp, zen_inp=None):
        """One deterministic forward of a batch's input window, float32 out."""
        x = self._amp(self.preprocessor.flatten_history(inp))
        return self.model(x, unpredicted_inp=zen_inp, deterministic=True).float()

    @torch.no_grad()
    def eval_ar_step(self, buffers, inpt, uinp, tar, zen_tar, idt, capture_frame=False):
        """One autoregressive validation step: the prediction of `inpt`
        scored against target frame `idt` into the metric buffers; returns
        the buffers, the next input window, the next zenith input and the
        channel-0 frames of the first sample (prediction, target), on the
        device."""
        prep = self.preprocessor
        t = min(idt, tar.shape[1] - 1)
        targ = prep.flatten_history(tar[:, t: t + 1])
        pred = self.model(self._amp(inpt), unpredicted_inp=uinp, deterministic=True).float()
        loss = self.loss_obj(pred, targ, inpt, training=False)
        buffers = self.metrics.update(buffers, pred, targ, loss, idt)
        uinp = prep.advance_unpredicted_dyn(uinp, zen_tar, idt)
        frame = (pred[0, 0], targ[0, 0])
        if capture_frame and spmd.spatial_distributed():
            frame = tuple(spmd.gather_patch(f, self._global_hw()) for f in frame)
        return buffers, prep.append_history(inpt, pred), uinp, frame

    def eval_step(self, buffers, inp, tar, zen_inp, zen_tar, capture_frames=False):
        """A batch's rollout over valid_autoreg_steps + 1 steps; with
        `capture_frames`, (buffers, frames): each step's channel-0 frame pair
        copied to the host after the step, as numpy arrays."""
        inpt = self.preprocessor.flatten_history(inp)
        uinp = zen_inp
        frames = []
        for idt in range(self.params.valid_autoreg_steps + 1):
            buffers, inpt, uinp, frame = self.eval_ar_step(buffers, inpt, uinp, tar, zen_tar, idt,
                                                           capture_frames)
            if capture_frames:
                frames.append(tuple(f.cpu().numpy() for f in frame))
        if capture_frames:
            return buffers, frames
        return buffers

    # ------------------------------------------------------------------
    # training loop

    def _device_batch(self, data):
        return to_device(data, self.device)

    def train(self):
        if self.log_to_screen:
            logger.info("Starting Training Loop...")
        training_start = time.time()
        self._log_memory("training start")
        dump_every = int(self.params.log_weights_and_grads or 0)

        for epoch in range(self.startEpoch, self.params.max_epochs):
            epoch_start = time.time()
            train_time, train_data_gb, train_logs = self.train_one_epoch()
            self._log_memory(f"epoch {self.epoch} train end")

            if dump_every > 0 and self.epoch % dump_every == 0 \
                    and getattr(self, "_dump_batch", None) is not None:
                self.dump_weights_and_grads(self._dump_batch)

            if not self.params.skip_validation:
                valid_time, viz_time, valid_logs = self.validate_one_epoch(epoch)
            else:
                valid_time, viz_time = 0, 0
                valid_logs = {"base": {}, "metrics": {}}

            self.scheduler.epoch_step(valid_logs["base"].get("validation loss"))

            if self.params.save_checkpoint != "none":
                best_path = self.params.best_checkpoint_path
                t0 = time.perf_counter()
                best_saved = self._on_every_rank(  # waits for the writes
                    ckpt_lib.checkpoint_exists(best_path) if self.world_rank == 0 else False)
                self.checkpoint_waits.append(time.perf_counter() - t0)
                vloss = valid_logs["base"].get("validation loss", None)
                is_best = (not self.params.skip_validation) and (
                    (not best_saved) or (vloss is not None and vloss <= self.best_valid_loss))
                # update best BEFORE writing, so the per-epoch checkpoint's
                # counters carry this epoch's value (resume equivalence)
                if is_best and vloss is not None:
                    self.best_valid_loss = vloss
                self.save_checkpoint(self.params.checkpoint_path)
                if is_best:
                    self.save_checkpoint(best_path)

            timing_logs = {
                "epoch time [s]": time.time() - epoch_start,
                "training time [s]": train_time,
                "validation time [s]": valid_time,
                "visualization time [s]": viz_time,
                "training step time [ms]": (train_time / max(train_logs["train_steps"], 1)) * 1e3,
                "minimal IO rate [GB/s]": train_data_gb / max(train_time, 1e-9),
            }
            self.log_epoch(train_logs, valid_logs, timing_logs)

        # drain the writes in flight and stop the renderer's workers before
        # returning
        t0 = time.perf_counter()
        ckpt_lib.wait_for_saves()
        comm.barrier()
        self.checkpoint_waits.append(time.perf_counter() - t0)
        if self.visualizer is not None:
            self.visualizer.close()
            self.visualizer = None
        if self.log_to_screen:
            logger.info("Total training time is {:.2f} sec".format(time.time() - training_start))

    def _start_profile(self):
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        profile_dir = os.path.join(self.params.get("experiment_dir", "."), "profile")
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        if self.log_to_screen:
            logger.info(f"profiler trace written to {path}")
        return path

    def train_one_epoch(self):
        self.epoch += 1
        total_data_bytes = 0
        train_steps = 0
        losses, lrs = [], []
        train_start = time.perf_counter_ns()

        # a profiler trace of the first profile_steps steps of epoch 1
        profile_steps = int(self.params.get("profile_steps", 0) or 0)
        prof = self._start_profile() if profile_steps > 0 and self.epoch == 1 else None
        dump_every = int(self.params.log_weights_and_grads or 0)
        freq = self.params.print_timings_frequency

        # time spent blocked on the loader (its read-ahead exhausted)
        data_wait_ns = 0
        data_iter = iter(self.train_dataloader)
        while True:
            t_wait = time.perf_counter_ns()
            try:
                data = next(data_iter)
            except StopIteration:
                break
            data_wait_ns += time.perf_counter_ns() - t_wait
            train_steps += 1
            self.iters += 1
            inp, tar, zen_inp, zen_tar = self._device_batch(data)
            total_data_bytes += sum(0 if x is None else x.size * 4 for x in data)
            if dump_every > 0:
                self._dump_batch = (inp, tar, zen_inp, zen_tar)
            lrs.append(self.scheduler(self.iters))
            losses.append(self.train_step(inp, tar, zen_inp, zen_tar, lrs[-1]))

            if prof is not None and train_steps >= profile_steps:
                self.profile_path = self._stop_profile(prof)
                prof = None
            if freq > 0 and self.iters % freq == 0 and self.log_to_screen:
                loss = float(losses[-1])
                running = time.perf_counter_ns() - train_start
                logger.info(f"Average step time after step {self.iters}: "
                            f"{running / float(train_steps) * 1e-6:.1f} ms")
                logger.info(f"Average effective io rate after step {self.iters}: "
                            f"{total_data_bytes / (float(running) * 1e-9 * 1024**3):.2f} GB/s")
                logger.info(f"Current loss {loss}")
        if prof is not None:
            self.profile_path = self._stop_profile(prof)

        step_losses = torch.stack(losses).tolist() if losses else []
        train_time = (time.perf_counter_ns() - train_start) * 1e-9
        logs = {"loss": step_losses[-1] if step_losses else float("nan"),
                "step losses": step_losses, "step lrs": lrs, "train_steps": train_steps}
        self._last_train_loss = logs["loss"]

        # more than 15% of an epoch blocked on the loader: the steps are
        # loader-bound (the first epoch also pays the workers' start)
        data_wait = data_wait_ns * 1e-9
        self._last_data_wait_frac = data_wait / max(train_time, 1e-9)
        if self.epoch > 1 and train_steps > 1 and self._last_data_wait_frac > 0.15:
            have = total_data_bytes / max(data_wait, 1e-9) / 1e9
            need = total_data_bytes / max(train_time, 1e-9) / 1e9
            logger.warning(
                "DATA-PLANE BOTTLENECK: %.0f%% of epoch %d spent waiting on the "
                "dataloader (sustains ~%.2f GB/s under load vs ~%.2f GB/s the "
                "step consumes). Raise num_data_workers (currently %s) or move "
                "the dataset to faster storage / the native loader.",
                100 * self._last_data_wait_frac, self.epoch, have, need,
                self.params.get("num_data_workers"))
        return train_time, total_data_bytes / 1024 ** 3, logs

    def validate_one_epoch(self, epoch):
        """Scores the evaluation loader; on an epoch that renders (log_video),
        the first batch's comparison image and rollout video too. Returns
        (seconds, the seconds of them spent waiting for the renders, logs)."""
        buffers = self.metrics.initialize_buffers()
        valid_start = time.time()
        visualize = bool(self.params.log_video) and epoch % max(self.params.log_video, 1) == 0
        eval_steps = 0
        for data in self.valid_dataloader:
            eval_steps += 1
            inp, tar, zen_inp, zen_tar = self._device_batch(data)
            if visualize and eval_steps <= 1:
                render = self.world_rank == 0
                if self.visualizer is None and render:
                    from makani_tpu_torch.utils.visualize import VisualizationWrapper
                    self.visualizer = VisualizationWrapper(
                        self.params, num_workers=self.params.num_visualization_workers)
                pred = self.eval_forward(inp, zen_inp)[0, :2]
                targ = self.preprocessor.flatten_history(tar[:, :1])[0, :2]
                if spmd.spatial_distributed():
                    pred = spmd.gather_patch(pred, self._global_hw())
                    targ = spmd.gather_patch(targ, self._global_hw())
                if render:
                    self.visualizer.add(f"epoch{epoch}_step{eval_steps}",
                                        pred.cpu().numpy(), targ.cpu().numpy())
                buffers, frames = self.eval_step(buffers, inp, tar, zen_inp, zen_tar,
                                                 capture_frames=True)
                if render:
                    self.visualizer.add_video(f"epoch{epoch}_rollout_ch0",
                                              np.stack([f[0] for f in frames]),
                                              np.stack([f[1] for f in frames]))
                continue
            buffers = self.eval_step(buffers, inp, tar, zen_inp, zen_tar)
        logs = self.metrics.finalize(buffers)

        viz_time = time.perf_counter()
        if visualize and self.visualizer is not None:
            self.visualizer.finalize()
        viz_time = time.perf_counter() - viz_time
        return time.time() - valid_start, viz_time, logs

    # ------------------------------------------------------------------
    # observability

    def _log_memory(self, tag):
        """Device memory at phase boundaries (torch.cuda's allocator stats);
        nothing on the CPU."""
        if not self.log_to_screen or self.device.type != "cuda":
            return
        used = torch.cuda.memory_allocated(self.device) / 2 ** 30
        peak = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
        limit = torch.cuda.get_device_properties(self.device).total_memory / 2 ** 30
        logger.info(f"Device memory [{tag}]: {used:.2f} GB in use, {peak:.2f} GB peak, "
                    f"{limit:.2f} GB limit")

    def dump_weights_and_grads(self, batch):
        """npz of every parameter and its gradient on `batch`, under
        makani_tpu's keys (weights/<flax path>, grads/<flax path>) and in its
        layout."""
        _, grads = self.grad_step(*batch)
        out = {}
        for key, p in self.model_params.items():
            path = torch_key_to_jax(key)
            out[f"weights/{path}"] = from_port_layout(key, p.detach().cpu().numpy())
            out[f"grads/{path}"] = from_port_layout(key, grads[key].cpu().numpy())
        dump_dir = os.path.join(self.params.get("experiment_dir", "."), "weights_and_grads")
        os.makedirs(dump_dir, exist_ok=True)
        fname = os.path.join(
            dump_dir, f"weights_and_grads_epoch{self.epoch}_rank{self.world_rank}.npz")
        np.savez(fname, **out)
        if self.log_to_screen:
            logger.info(f"weights and grads dumped to {fname}")
        return fname

    # ------------------------------------------------------------------
    # logging / checkpointing

    def log_epoch(self, train_logs, valid_logs, timing_logs):
        self.last_logs = {"train": train_logs, "valid": valid_logs, "timing": timing_logs,
                          "data_wait_frac": self._last_data_wait_frac}
        self.epoch_logs.append(self.last_logs)
        if self.wandb is not None:
            from makani_tpu_torch.utils.wandb_compat import Table
            self.wandb.log({"training loss": train_logs["loss"],
                            "learning rate": self.scheduler(self.iters),
                            **timing_logs}, step=self.epoch)
            self.wandb.log(valid_logs["base"], step=self.epoch)
            metrics = dict(valid_logs["metrics"])
            rollouts = metrics.pop("rollouts", None)
            if rollouts is not None:
                metrics["rollouts"] = Table(
                    data=rollouts, columns=["metric type", "variable name", "time [h]", "value"])
            self.wandb.log(metrics, step=self.epoch)

        if not self.log_to_screen:
            return
        separator = "-" * 50
        prefix = "    "
        logger.info(separator)
        logger.info(f"Epoch {self.epoch} summary:")
        logger.info("Performance Parameters:")
        logger.info(prefix + "training steps: {}".format(train_logs["train_steps"]))
        logger.info(prefix + "validation steps: {}".format(
            valid_logs["base"].get("validation steps", 0)))
        for key, val in timing_logs.items():
            logger.info(prefix + key + ": {:.2f}".format(val))
        print_list = (["training loss", "validation loss", "validation L1"]
                      + list(valid_logs["metrics"].keys()))
        max_len = max(len(x) for x in print_list)
        logger.info("Metrics:")
        logger.info(prefix + "training loss: {}{}".format(" " * (max_len - 13), train_logs["loss"]))
        if "validation loss" in valid_logs["base"]:
            logger.info(prefix + "validation loss: {}{}".format(
                " " * (max_len - 15), valid_logs["base"]["validation loss"]))
            logger.info(prefix + "validation L1: {}{}".format(
                " " * (max_len - 13), valid_logs["base"]["validation L1"]))
        for key, value in valid_logs["metrics"].items():
            if np.isscalar(value):
                logger.info(f"{prefix}{key}: {' ' * (max_len - len(key))}{value}")
        if self.device.type == "cuda":
            logger.info("peak device memory: %.2f GiB",
                        torch.cuda.max_memory_allocated(self.device) / 2 ** 30)
        if not np.isfinite(train_logs["loss"]):
            logger.warning("training loss is not finite")
        logger.info(separator)

    def counters(self):
        """The counters a checkpoint carries."""
        return {"iters": self.iters, "epoch": self.epoch,
                "scheduler_epoch": self.scheduler.epoch,
                "scheduler_state": self.scheduler.state_dict(),
                "best_valid_loss": float(self.best_valid_loss),
                AUG_STATE_KEY: self.aug_generator.get_state().tolist(),
                DROPOUT_SEED_KEY: self.dropout_seed}

    def _on_every_rank(self, flag):
        """Rank 0's boolean, on every rank."""
        if comm.get_world_size() == 1:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(spmd.broadcast_(t, "world").item() > 0.5)

    def _whole_state(self):
        """The model's state dict and the optimizer state with every split
        leaf gathered whole (a collective of every rank): what a serial run
        would save."""
        state = self.model.state_dict()
        if not self.shards:
            return state, self.opt_state
        state = {k: partitioning.gather_full(k, v, self.shards) for k, v in state.items()}
        opt = []
        for stage in self.opt_state:
            if isinstance(stage, AdamState):
                stage = AdamState(
                    count=stage.count,
                    mu={k: partitioning.gather_full(k, v, self.shards) for k, v in stage.mu.items()},
                    nu={k: partitioning.gather_full(k, v, self.shards) for k, v in stage.nu.items()})
            opt.append(stage)
        return state, tuple(opt)

    def save_checkpoint(self, checkpoint_path):
        """The per-epoch checkpoint (versioned, keep-N) at checkpoint_path,
        any other path as a single-dir checkpoint; returns once the tensors
        are on the host, the files are written in the background. On
        several ranks every rank takes part in gathering the split leaves
        and rank 0 writes the serial file."""
        t0 = time.perf_counter()
        state, opt_state = self._whole_state()
        if self.world_rank != 0:
            return
        if checkpoint_path == self.params.checkpoint_path:
            if getattr(self, "_ckpt_mgr", None) is None:
                self._ckpt_mgr = ckpt_lib.TrainingCheckpointer(
                    checkpoint_path,
                    max_to_keep=int(self.params.get("checkpoint_max_to_keep", 3)))
            self._ckpt_mgr.save(self.epoch, state, opt_state, self.counters())
        else:
            ckpt_lib.save_checkpoint(checkpoint_path, state, opt_state, self.counters())
        self.checkpoint_log.append((self.epoch, checkpoint_path, time.perf_counter() - t0))

    def restore_checkpoint(self, checkpoint_path, load_optimizer=None, load_counters=None):
        load_optimizer = (self.params.get("load_optimizer", True) if load_optimizer is None
                          else load_optimizer)
        load_counters = (self.params.get("load_counters", True) if load_counters is None
                         else load_counters)
        if comm.is_distributed("world"):
            # rank 0's writes are on disk before any rank reads (a serial
            # restore waits for its own saves inside restore_checkpoint)
            ckpt_lib.wait_for_saves()
            comm.barrier()
        try:
            params, opt_state, counters = ckpt_lib.restore_checkpoint(
                checkpoint_path, self.model.state_dict(),
                self.opt_state if load_optimizer else None, shards=self.shards)
        except RuntimeError as e:
            if "does not fit its template" in str(e):
                raise RuntimeError(
                    f"Checkpoint restore from {checkpoint_path!r} failed with a "
                    "structure mismatch. This usually means the model or "
                    "optimizer configuration changed since the checkpoint was "
                    "written (e.g. a different optimizer chain, width, or "
                    "layer count). Start a fresh experiment dir, or set "
                    "load_optimizer: false to restore weights only.") from e
            raise
        self.model.load_state_dict(params)
        if load_optimizer and opt_state is not None:
            self.opt_state = opt_state
        if load_counters and counters:
            self.iters = counters.get("iters", 0)
            self.epoch = counters.get("epoch", 0)
            self.startEpoch = self.epoch
            self.scheduler.epoch = counters.get("scheduler_epoch", 0)
            if self.params.get("load_scheduler", True) and "scheduler_state" in counters:
                self.scheduler.load_state_dict(counters["scheduler_state"])
            if "best_valid_loss" in counters:
                self.best_valid_loss = float(counters["best_valid_loss"])
            if counters.get(AUG_STATE_KEY) is not None:
                self.aug_generator.set_state(
                    torch.tensor(counters[AUG_STATE_KEY], dtype=torch.uint8))
            if counters.get(DROPOUT_SEED_KEY) is not None:
                self.dropout_seed = int(counters[DROPOUT_SEED_KEY])
            # the shuffle is seeded with base_seed + the loader's epoch: a
            # resumed run continues the schedule instead of replaying epoch 0
            for dl in (self.train_dataloader, self.valid_dataloader):
                if hasattr(dl, "epoch"):
                    dl.epoch = self.epoch

    # ------------------------------------------------------------------
    # debug / self-test harness

    @torch.no_grad()
    def test_autoregression_pipeline(self):
        """DebugNet pipeline self-test: runs the eval forward (the
        preprocessor's round trip), appends the *targets* into the history
        window, and checks that the rolled window holds exactly the expected
        target slices. Returns the number of errors."""
        if self.params.nettype != "DebugNet":
            raise ValueError(f"the pipeline self-test runs DebugNet, not {self.params.nettype}")
        prep = self.preprocessor
        n_hist = prep.n_history
        error_count = 0
        total_steps = 0
        for data in self.valid_dataloader:
            inp, tar, zen_inp, zen_tar = self._device_batch(data)
            inpt = prep.flatten_history(inp)
            uinp = zen_inp
            predictions = []
            tarlist = [tar[:, i: i + 1] for i in range(tar.shape[1])]
            for idt, targ in enumerate(tarlist):
                total_steps += 1
                pred = self.model(inpt, unpredicted_inp=uinp, deterministic=True)
                pred = prep.remove_static_features(pred)
                n_unpred = 0 if uinp is None else uinp.shape[2]
                pred = prep.remove_unpredicted_features(pred, n_unpred)
                if n_hist > 0:
                    pred = prep.expand_history(pred, n_hist + 1)[:, -1]
                expected = (targ.shape[0], targ.shape[2], targ.shape[3], targ.shape[4])
                if tuple(pred.shape) != expected:
                    raise RuntimeError(f"prediction shape {tuple(pred.shape)} != {expected}")
                uinp = prep.advance_unpredicted(uinp, zen_tar, idt)
                inpt = prep.append_history(inpt, prep.flatten_history(targ))
                predictions.append(inpt.cpu().numpy())

            # the rolled history windows against the target slices
            for idp, predt in enumerate(predictions):
                predte = predt.reshape(predt.shape[0], n_hist + 1, -1, *predt.shape[-2:])
                predsteps = [predte[:, i] for i in range(n_hist + 1)]
                pred_last = min(n_hist + 1, idp + 1)
                targ_offset = max(0, idp - n_hist)
                targ_comp = tarlist[targ_offset: targ_offset + pred_last]
                for pc, tc in zip(predsteps[-pred_last:], targ_comp):
                    if not np.allclose(pc, tc.cpu().numpy()[:, 0], rtol=1e-5, atol=1e-8):
                        error_count += 1
        if self.log_to_screen:
            logger.info(f"Test done ({total_steps} steps): {error_count} errors found.")
        return error_count
