"""Training engine.

Counterpart of makani_tpu/utils/trainer.py for a single device: the train
step of `_build_steps` (augmentation, forward, loss, backward, optimizer
update), `train_one_epoch`, and `train()` without validation or checkpoints.
The forward and backward run eagerly; the spectral filter's contractions go
through the differentiable kernel wrappers (ops/spectral_mm legdot, dhconv on
the "kernel" coefficient engine; complex_kernels.contract_dhconv_kernel on the
"xla" engine under complex_ops.enable_pallas_kernels).
The update is the fused Adam kernel (ops/fused_adam, one launch per parameter
leaf, in place; its twin on the CPU) wherever the kernel can express the
config's optimizer (Adam or AdamW, float32 or bf16 moments, no clipping),
whatever `optimizer_fused` says: it gives the bits of makani_tpu's fused
stage, and for bf16 moments those of its optax chain too. Other
configs (float16 moments) run utils/optimizers' chain. The step's
forward, backward and optimizer update are profiler ranges
("train_step.forward", ".backward", ".optimizer"), which
tools/profile_forward.py --train reads; they cost a few microseconds a step
when no profiler runs.

Not ported yet; each raises NotImplementedError when the config asks for it
(ROADMAP, Queue 1 item 14 and the items named in the messages): validation
(`skip_validation` must be true), MetricsHandler, checkpoints
(`save_checkpoint` must be "none", no resuming or finetuning), the weights
and grads dump, AMP training, the multi-step training unroll (n_future > 0),
file datasets and parallelism.
"""

import logging
import time

import numpy as np
import torch
from torch.profiler import record_function

from makani_tpu_torch.data.dataloader import get_dataloader
from makani_tpu_torch.models.model_registry import as_params, get_model, update_channel_params
from makani_tpu_torch.ops import complex_ops, sht
from makani_tpu_torch.ops.fused_adam import fused_adam_apply
from makani_tpu_torch.utils.device import resolve_device
from makani_tpu_torch.utils.losses import LossHandler
from makani_tpu_torch.utils.optimizers import (
    LRScheduler,
    adam_kernel_settings,
    apply_updates,
    build_optimizer,
)

logger = logging.getLogger(__name__)

_QUEUE_14 = "is not ported yet (ROADMAP: Queue 1 item 14, the full Trainer)"


def augment_batch(inp, tar, zen_inp, zen_tar, generator, do_roll, noise_std):
    """Train-time augmentation on the batch's device: a random longitude roll
    per sample, applied consistently to inputs, targets and zenith, then
    gaussian input noise. Draws come from `generator` (torch's stream, not
    JAX's: the same seed gives other shifts and noise than makani_tpu)."""
    if do_roll:
        shifts = torch.randint(0, inp.shape[-1], (inp.shape[0],), generator=generator,
                               device=generator.device).tolist()

        def roll(t):
            if t is None:
                return None
            return torch.stack([torch.roll(x, s, dims=-1) for x, s in zip(t, shifts)])

        inp, tar, zen_inp, zen_tar = roll(inp), roll(tar), roll(zen_inp), roll(zen_tar)
    if noise_std > 0.0:
        noise = torch.randn(inp.shape, generator=generator, device=generator.device)
        inp = inp + noise_std * noise.to(inp.device, inp.dtype)
    return inp, tar, zen_inp, zen_tar


def _check_supported(params):
    if not params.get("skip_validation", False):
        raise NotImplementedError(f"validation {_QUEUE_14}; set skip_validation: true")
    if params.get("save_checkpoint", "none") != "none":
        raise NotImplementedError(f"checkpoints {_QUEUE_14}; set save_checkpoint: none")
    if params.get("resuming", False) or (params.get("finetune", False)
                                         and params.get("pretrained_checkpoint_path", None)):
        raise NotImplementedError(f"restoring a checkpoint {_QUEUE_14}")
    if int(params.get("log_weights_and_grads", 0) or 0) > 0:
        raise NotImplementedError(f"the weights and grads dump {_QUEUE_14}")
    if params.get("amp_mode", "none") not in ("none", None):
        raise NotImplementedError("AMP training is not ported yet (ROADMAP: Queue 1, AMP)")
    if params.get("n_future", 0):
        raise NotImplementedError("the multi-step training unroll (n_future > 0) is not "
                                  "ported yet (ROADMAP: Queue 1)")


class Trainer:
    """Trains the configured model on `device` (default "cuda"; raises without
    CUDA unless device="cpu"). Weights are drawn from `generator`, by default
    one seeded with the config's global_seed; `params` must name its channels
    (in_channels/out_channels) and enable the synthetic data."""

    def __init__(self, params, device=None, generator=None):
        self.device = resolve_device(device)
        params = as_params(params)
        _check_supported(params)
        params = update_channel_params(params)
        self.params = params
        self.log_to_screen = params.get("log_to_screen", False)

        self.train_dataloader, self.train_dataset = get_dataloader(params)

        # spectral precision of the transforms and of the contractions, both
        # set as makani_tpu's Trainer sets them: "high" (3 bf16 passes in the
        # kernels) without AMP; "highest" runs the complex path in float32
        tp = params.get("transform_precision", None) or "high"
        sht.set_transform_precision(tp)
        complex_ops.set_contraction_precision(tp)
        engine = params.get("coefficient_engine", None)
        if engine is not None:
            # makani_tpu's "pallas" engine is the port's kernel engine; "xla"
            # and "stacked" keep their names
            sht.set_coeff_engine("kernel" if engine == "pallas" else engine)

        self.model = get_model(params, device=self.device, generator=generator)
        self.preprocessor = self.model.preprocessor
        self.loss_obj = LossHandler(params, device=self.device)

        self.optimizer = build_optimizer(params)
        self.scheduler = LRScheduler(params)
        self.model_params = dict(self.model.named_parameters())
        self.opt_state = self.optimizer.init({k: p.detach() for k, p in self.model_params.items()})
        self.fused_kw = adam_kernel_settings(params)
        if self.fused_kw is not None:
            logger.info("optimizer: fused Adam kernel (%s)", self.fused_kw)

        self.do_roll = bool(params.get("roll", False))
        self.noise_std = (float(params.get("noise_std", 0.0))
                          if params.get("add_noise", False) else 0.0)
        self.aug_generator = torch.Generator(device=self.device)
        self.aug_generator.manual_seed(int(params.get("global_seed", 333)) + 1)

        self.iters = 0
        self.epoch = 0
        self.startEpoch = 0
        self.n_model_params = sum(p.numel() for p in self.model_params.values())
        if self.log_to_screen:
            logger.info(f"number of trainable model parameters: {self.n_model_params}")

    # ------------------------------------------------------------------
    # one step

    @record_function("train_step.optimizer")
    def apply_updates(self, grads, lr):
        """The optimizer update of makani_tpu's train step, in place."""
        if self.fused_kw is not None:
            fused_adam_apply(self.model_params, grads, self.opt_state[0], lr, **self.fused_kw)
            return
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                        self.model_params)
        apply_updates(self.model_params, updates, lr)

    def loss_and_grads(self, inp, tar, zen_inp=None, zen_tar=None):
        """Loss of the batch and the gradient of every parameter (dict)."""
        prep = self.preprocessor
        inp = prep.flatten_history(inp)
        tar = prep.flatten_history(tar)
        for p in self.model_params.values():
            p.grad = None
        with record_function("train_step.forward"):
            pred = self.model(inp, unpredicted_inp=zen_inp, unpredicted_tar=zen_tar,
                              deterministic=False)
            loss = self.loss_obj(pred.float(), tar, inp, training=True)
        with record_function("train_step.backward"):
            loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.model_params.items()}
        for p in self.model_params.values():
            p.grad = None
        return loss.detach(), grads

    def train_step(self, inp, tar, zen_inp, zen_tar, lr):
        """One optimizer step on a device batch; returns the loss (a tensor)."""
        if self.do_roll or self.noise_std > 0.0:
            inp, tar, zen_inp, zen_tar = augment_batch(
                inp, tar, zen_inp, zen_tar, self.aug_generator, self.do_roll, self.noise_std)
        loss, grads = self.loss_and_grads(inp, tar, zen_inp, zen_tar)
        self.apply_updates(grads, lr)
        return loss

    # ------------------------------------------------------------------
    # training loop

    def _device_batch(self, data):
        if len(data) == 4:
            inp, tar, zen_inp, zen_tar = data
        else:
            (inp, tar), zen_inp, zen_tar = data, None, None
        return tuple(None if x is None else torch.as_tensor(x).to(self.device)
                     for x in (inp, tar, zen_inp, zen_tar))

    def train(self):
        if self.log_to_screen:
            logger.info("Starting Training Loop...")
        training_start = time.time()
        for _ in range(self.startEpoch, self.params.max_epochs):
            epoch_start = time.time()
            train_time, train_data_gb, train_logs = self.train_one_epoch()
            self.scheduler.epoch_step()
            timing_logs = {
                "epoch time [s]": time.time() - epoch_start,
                "training time [s]": train_time,
                "training step time [ms]": (train_time / max(train_logs["train_steps"], 1)) * 1e3,
                "minimal IO rate [GB/s]": train_data_gb / max(train_time, 1e-9),
            }
            self.log_epoch(train_logs, timing_logs)
        if self.log_to_screen:
            logger.info("Total training time is {:.2f} sec".format(time.time() - training_start))

    def train_one_epoch(self):
        self.epoch += 1
        total_data_bytes = 0
        train_steps = 0
        losses = []
        train_start = time.perf_counter_ns()
        for data in self.train_dataloader:
            train_steps += 1
            self.iters += 1
            inp, tar, zen_inp, zen_tar = self._device_batch(data)
            total_data_bytes += sum(0 if x is None else x.size * 4 for x in data)
            losses.append(self.train_step(inp, tar, zen_inp, zen_tar, self.scheduler(self.iters)))
        step_losses = torch.stack(losses).tolist() if losses else []
        train_time = (time.perf_counter_ns() - train_start) * 1e-9
        logs = {"loss": step_losses[-1] if step_losses else float("nan"),
                "step losses": step_losses, "train_steps": train_steps}
        self._last_train_loss = logs["loss"]
        return train_time, total_data_bytes / 1024 ** 3, logs

    def log_epoch(self, train_logs, timing_logs):
        self.last_logs = {"train": train_logs, "timing": timing_logs}
        if not self.log_to_screen:
            return
        logger.info(f"Epoch {self.epoch} summary:")
        for k, v in timing_logs.items():
            logger.info(f"{k}: {v:.2f}")
        logger.info(f"training loss: {train_logs['loss']}")
        if self.device.type == "cuda":
            logger.info("peak device memory: %.2f GiB",
                        torch.cuda.max_memory_allocated(self.device) / 2 ** 30)
        if not np.isfinite(train_logs["loss"]):
            logger.warning("training loss is not finite")
