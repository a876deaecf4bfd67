"""Optimizer and LR-schedule construction.

Counterpart of makani_tpu/utils/optimizers.py. The gradient transforms keep
optax's shape: `init(params) -> state` and `update(grads, state) ->
(updates, state)` over dicts of tensors keyed like the model's
`named_parameters()`; `apply_updates` then sets p = p - lr*u in place.
Adam state is a plain `AdamState` (count, and mu/nu dicts keyed like the
parameters).

`scale_by_adam_lowmem` stores its moments in bf16 (or f16) with all update
math in float32, and is bit-identical to makani_tpu's: the same operations
as XLA compiles them for the CPU (ops/fused_adam.py documents them), the same
counter-hash stochastic rounding on each element's flat index in makani_tpu's
layout of its leaf, and the same per-leaf salts in jax.tree.flatten order.
`scale_by_adam` is optax's float32 Adam. The Trainer runs ops/fused_adam.py
instead wherever the fused kernel can express the config
(`adam_kernel_settings`), with the same bits for bf16 moments.

Not ported yet (ROADMAP, Queue 1): LAMB, Adafactor, SGD and gradient
clipping.
"""

import math
from collections import namedtuple
from dataclasses import dataclass

import torch

from makani_tpu_torch.ops.fused_adam import (
    adam_direction,
    adam_moments,
    bias_corrections,
    dither_u16,
    fma,
    jax_flat_index,
    moment_salts,
    stochastic_round_bf16,
)
from makani_tpu_torch.utils.param_layout import jax_leaf_order

GradientTransformation = namedtuple("GradientTransformation", ["init", "update"])

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16}


@dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


def _dither_u16(shape, salt, device="cpu"):
    """Per-element uniform 16-bit dither of makani_tpu's _dither_u16: the hash
    of (flat element index, salt)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return dither_u16(idx, int(salt))


def _stochastic_round(x, target_dtype, salt, idx=None):
    """float32 -> target_dtype; bf16 rounds stochastically with the dither of
    `idx` (default: the flat index of x), other dtypes to nearest."""
    if target_dtype != torch.bfloat16:
        return x.to(target_dtype)
    if idx is None:
        idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device).reshape(x.shape)
    return stochastic_round_bf16(x.float(), idx, int(salt))


def _zeros_like(params, dtype):
    return {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}


def scale_by_adam_lowmem(b1=0.9, b2=0.999, eps=1e-8, moment_dtype=torch.bfloat16,
                         stochastic_rounding=True, seed=1234):
    """Adam with reduced-precision moment buffers: mu/nu are stored in
    `moment_dtype`, all update math runs in float32, and bf16 moments are
    written with stochastic rounding (makani_tpu.utils.optimizers)."""

    def init_fn(params):
        return AdamState(count=0, mu=_zeros_like(params, moment_dtype),
                         nu=_zeros_like(params, moment_dtype))

    def update_fn(updates, state, params=None):
        del params
        count = state.count + 1
        bc1, bc2 = bias_corrections(count, b1, b2)
        order = jax_leaf_order(updates)
        salts = moment_salts(seed, count, len(order))
        new_mu, new_nu, out = {}, {}, {}
        with torch.no_grad():
            for i, key in enumerate(order):
                g = updates[key]
                m, v = adam_moments(g.float(), state.mu[key], state.nu[key], b1, b2)
                if moment_dtype == torch.float32:
                    mq, vq = m, v
                elif stochastic_rounding:
                    idx = jax_flat_index(key, m.shape, m.device)
                    mq = _stochastic_round(m, moment_dtype, salts[2 * i], idx)
                    vq = _stochastic_round(v, moment_dtype, salts[2 * i + 1], idx)
                else:
                    mq, vq = m.to(moment_dtype), v.to(moment_dtype)
                new_mu[key], new_nu[key] = mq, vq
                out[key] = adam_direction(m, v, bc1, bc2, eps).to(g.dtype)
        return out, AdamState(count=count, mu=new_mu, nu=new_nu)

    return GradientTransformation(init_fn, update_fn)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    """optax.scale_by_adam with float32 moments."""

    def init_fn(params):
        return AdamState(count=0, mu=_zeros_like(params, torch.float32),
                         nu=_zeros_like(params, torch.float32))

    def update_fn(updates, state, params=None):
        del params
        count = state.count + 1
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        new_mu, new_nu, out = {}, {}, {}
        with torch.no_grad():
            for key, g in updates.items():
                mu = (1.0 - b1) * g + b1 * state.mu[key]
                nu = (1.0 - b2) * (g * g) + b2 * state.nu[key]
                new_mu[key], new_nu[key] = mu, nu
                out[key] = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        return out, AdamState(count=count, mu=new_mu, nu=new_nu)

    return GradientTransformation(init_fn, update_fn)


def add_decayed_weights(weight_decay):
    """optax.add_decayed_weights: u + wd * p."""

    def update_fn(updates, state, params=None):
        with torch.no_grad():
            return {k: u + weight_decay * params[k] for k, u in updates.items()}, state

    return GradientTransformation(lambda params: None, update_fn)


def chain(*transforms):
    """optax.chain: the state is the tuple of the transforms' states."""

    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def apply_updates(params, updates, lr):
    """p <- p - lr*u in place, rounded once (a fused multiply-add, as XLA
    compiles makani_tpu's Trainer step)."""
    lr_t = torch.tensor(lr, dtype=torch.float32)
    with torch.no_grad():
        for key, p in params.items():
            p.copy_(fma(-updates[key].to(p.dtype), lr_t.to(p.device), p))
    return params


def adam_kernel_settings(params):
    """kwargs for ops/fused_adam.fused_adam_apply when the config's optimizer
    is expressible as the single fused kernel (Adam or AdamW, float32 or bf16
    moments, no gradient clipping), else None."""
    opt_type = params.get("optimizer_type", "Adam")
    if opt_type not in ("Adam", "AdamW"):
        return None
    if params.get("gradient_clip_norm"):
        return None
    md = params.get("optimizer_moment_dtype", "float32")
    if md not in (None, "float32", "fp32", "bfloat16", "bf16"):
        return None
    wd = float(params.get("weight_decay", 0.0) or 0.0) if opt_type == "AdamW" else 0.0
    return dict(
        b1=params.get("optimizer_beta1", 0.9),
        b2=params.get("optimizer_beta2", 0.95),
        eps=1e-8 * (10.0 ** float(params.get("epsilon_factor", 0) or 0)),
        weight_decay=wd,
        stochastic_rounding=bool(params.get("optimizer_stochastic_rounding", True))
        and md in ("bfloat16", "bf16"),
        seed=params.get("global_seed", 333) + 7,
    )


def fused_adam_settings(params):
    """makani_tpu's gate of its fused Adam stage: `adam_kernel_settings` when
    the config sets optimizer_fused, else None."""
    if not params.get("optimizer_fused", False):
        return None
    return adam_kernel_settings(params)


def build_optimizer(params):
    """The lr-free gradient transform of the config (Adam or AdamW)."""
    opt_type = params.get("optimizer_type", "Adam")
    if opt_type in ("FusedLAMB", "LAMB", "Adafactor", "SGD"):
        raise NotImplementedError(f"optimizer {opt_type!r} is not ported yet "
                                  "(ROADMAP: Queue 1, optimizers)")
    if opt_type not in ("Adam", "AdamW"):
        raise ValueError(f"Unknown optimizer type {opt_type}")
    if params.get("gradient_clip_norm", None):
        raise NotImplementedError("gradient clipping is not ported yet "
                                  "(ROADMAP: Queue 1, optimizers)")
    b1 = params.get("optimizer_beta1", 0.9)
    b2 = params.get("optimizer_beta2", 0.95)
    wd = params.get("weight_decay", 0.0)
    eps = 1e-8 * (10.0 ** float(params.get("epsilon_factor", 0) or 0))
    moment_dtype = params.get("optimizer_moment_dtype", "float32")
    if moment_dtype in (None, "float32", "fp32"):
        tx = [scale_by_adam(b1=b1, b2=b2, eps=eps)]
    else:
        tx = [scale_by_adam_lowmem(
            b1=b1, b2=b2, eps=eps, moment_dtype=_DTYPES[moment_dtype],
            stochastic_rounding=bool(params.get("optimizer_stochastic_rounding", True)),
            seed=params.get("global_seed", 333) + 7)]
    if opt_type == "AdamW" and wd > 0:
        tx.append(add_decayed_weights(wd))
    return chain(*tx)


class LRScheduler:
    """Host-side LR computation per optimizer step (makani_tpu's LRScheduler).

    Schedules are stepped per *epoch*; warmup is linear over
    ``lr_warmup_steps`` optimizer steps. ReduceLROnPlateau scales the base
    lr by ``scheduler_factor`` once the validation loss fed to `epoch_step`
    has not improved for more than ``scheduler_patience`` epochs.
    """

    def __init__(self, params):
        self.base_lr = float(params.lr)
        self.scheduler = params.get("scheduler", "none")
        self.warmup_steps = int(params.get("lr_warmup_steps", 0))
        self.start_factor = 0.1 if self.warmup_steps > 0 else 1.0

        self.T_max = int(params.get("scheduler_T_max", 70))
        self.factor = float(params.get("scheduler_factor", 0.1))
        self.patience = int(params.get("scheduler_patience", 10))
        self.step_size = int(params.get("scheduler_step_size", 100))
        self.gamma = float(params.get("scheduler_gamma", 0.5))
        self.pct_start = float(params.get("scheduler_pct_start", 0.3))
        self.div_factor = float(params.get("scheduler_div_factor", 25.0))
        self.final_div_factor = float(params.get("scheduler_final_div_factor", 1e4))

        # plateau state
        self._plateau_scale = 1.0
        self._best = float("inf")
        self._bad_epochs = 0

        self.epoch = 0

    def state_dict(self):
        """The runtime state a checkpoint carries (JSON-able; an infinite
        best loss is stored as None)."""
        return {
            "epoch": self.epoch,
            "plateau_scale": self._plateau_scale,
            "plateau_best": self._best if math.isfinite(self._best) else None,
            "plateau_bad_epochs": self._bad_epochs,
        }

    def load_state_dict(self, state):
        self.epoch = int(state.get("epoch", 0))
        self._plateau_scale = float(state.get("plateau_scale", 1.0))
        best = state.get("plateau_best", float("inf"))
        self._best = float("inf") if best is None else float(best)
        self._bad_epochs = int(state.get("plateau_bad_epochs", 0))

    def epoch_step(self, valid_loss=None):
        """Advance the epoch counter; feed the plateau schedule."""
        self.epoch += 1
        if self.scheduler == "ReduceLROnPlateau" and valid_loss is not None:
            if valid_loss < self._best:
                self._best = valid_loss
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
                if self._bad_epochs > self.patience:
                    self._plateau_scale *= self.factor
                    self._bad_epochs = 0

    def _epoch_lr(self):
        if self.scheduler == "ReduceLROnPlateau":
            return self.base_lr * self._plateau_scale
        elif self.scheduler == "StepLR":
            return self.base_lr * (self.gamma ** (self.epoch // self.step_size))
        elif self.scheduler == "CosineAnnealingLR":
            t = min(self.epoch, self.T_max)
            return 0.5 * self.base_lr * (1 + math.cos(math.pi * t / self.T_max))
        elif self.scheduler == "OneCycleLR":
            total = max(self.T_max, 1)
            initial_lr = self.base_lr / self.div_factor
            min_lr = initial_lr / self.final_div_factor
            up_steps = float(self.pct_start * total) - 1.0
            down_steps = float(total - up_steps - 1.0)

            def anneal_cos(start, end, pct):
                return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

            step_num = min(self.epoch, total - 1)
            if up_steps > 0 and step_num <= up_steps:
                return anneal_cos(initial_lr, self.base_lr, step_num / up_steps)
            return anneal_cos(self.base_lr, min_lr,
                              (step_num - up_steps) / max(down_steps, 1.0))
        elif self.scheduler in ("none", None, "None"):
            return self.base_lr
        raise ValueError(f"Scheduler {self.scheduler} not known")

    def __call__(self, global_step: int) -> float:
        lr = self._epoch_lr()
        if self.warmup_steps > 0 and global_step < self.warmup_steps:
            frac = global_step / float(self.warmup_steps)
            lr = lr * (self.start_factor + (1.0 - self.start_factor) * frac)
        return lr
