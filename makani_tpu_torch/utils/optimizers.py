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
`scale_by_adam` is optax's float32 Adam. Both are plain tensor ops kept off
the card: the lowmem update emulates XLA's CPU arithmetic in float64 and
raises on CUDA tensors. The Trainer runs ops/fused_adam.py instead for every
Adam-family config (`kernel_update_settings`: Adam, AdamW, LAMB, float32,
bf16 or float16 moments, clipped or not), with the same bits for bf16 and
float16 moments where no norm enters.

`build_optimizer` is makani_tpu's in full: clip_by_global_norm
(gradient_clip_norm for any optimizer, optimizer_max_grad_norm for LAMB
only), Adam, AdamW, LAMB (Adam, add_decayed_weights, scale_by_trust_ratio),
Adafactor (scale_by_factored_rms, its statistics taken on makani_tpu's layout
of each leaf) and SGD (trace(momentum) where momentum > 0).
"""

import math
from collections import namedtuple
from dataclasses import dataclass

import torch

import numpy as np

from makani_tpu_torch.ops.fused_adam import (
    _libm,
    adam_direction,
    adam_moments,
    bias_corrections,
    clip_by_norm,
    dither_u16,
    fma,
    global_norm,
    jax_flat_index,
    moment_salts,
    stochastic_round_bf16,
    trust_ratios,
)
from makani_tpu_torch.parallel import partitioning, spmd
from makani_tpu_torch.utils.param_layout import jax_dims, jax_leaf_order, jax_view, port_view

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
        if any(g.device.type == "cuda" for g in updates.values()):
            raise RuntimeError("scale_by_adam_lowmem emulates XLA's CPU arithmetic and stays off "
                               "the card; ops/fused_adam.fused_adam_apply runs the same update "
                               "there")
        count = state.count + 1
        bc1, bc2 = bias_corrections(count, b1, b2)
        order = jax_leaf_order(updates)
        salts = moment_salts(seed, count, len(order))
        new_mu, new_nu, out = {}, {}, {}
        with torch.no_grad():
            for i, key in enumerate(order):
                g = updates[key]
                m, v, m_dir = adam_moments(g.float(), state.mu[key], state.nu[key], b1, b2)
                if moment_dtype == torch.float32:
                    mq, vq = m, v
                elif stochastic_rounding:
                    idx = jax_flat_index(key, m.shape, m.device)
                    mq = _stochastic_round(m, moment_dtype, salts[2 * i], idx)
                    vq = _stochastic_round(v, moment_dtype, salts[2 * i + 1], idx)
                else:
                    mq, vq = m.to(moment_dtype), v.to(moment_dtype)
                new_mu[key], new_nu[key] = mq, vq
                out[key] = adam_direction(m_dir, v, bc1, bc2, eps).to(g.dtype)
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


def clip_by_global_norm(max_norm, shards=None):
    """optax.clip_by_global_norm: every leaf scaled by max_norm / norm when
    the global norm reaches max_norm (computed on the device, no sync; over
    whole leaves where `shards` names leaves split over ranks)."""

    def update_fn(updates, state, params=None):
        with torch.no_grad():
            if shards:
                norm = partitioning.global_norm(list(updates), list(updates.values()), shards)
            else:
                norm = global_norm(updates.values())
            return {k: clip_by_norm(g, norm, max_norm) for k, g in updates.items()}, state

    return GradientTransformation(lambda params: None, update_fn)


def scale_by_trust_ratio(shards=None):
    """optax.scale_by_trust_ratio: u * ||p|| / ||u|| per leaf, u where
    either norm is 0 (whole leaves' norms for leaves split over ranks)."""

    def update_fn(updates, state, params=None):
        keys = list(updates)
        with torch.no_grad():
            ratios = trust_ratios([params[k] for k in keys], [updates[k] for k in keys],
                                  keys, shards)
            return {k: updates[k] * r for k, r in zip(keys, ratios)}, state

    return GradientTransformation(lambda params: None, update_fn)


@dataclass
class TraceState:
    trace: dict


def trace(decay):
    """optax.trace (no Nesterov): t <- g + decay * t, the update is t."""

    def init_fn(params):
        return TraceState(_zeros_like(params, torch.float32))

    def update_fn(updates, state, params=None):
        with torch.no_grad():
            new = {k: g + decay * state.trace[k] for k, g in updates.items()}
        return dict(new), TraceState(new)

    return GradientTransformation(init_fn, update_fn)


@dataclass
class FactoredState:
    count: int
    v_row: dict
    v_col: dict
    v: dict


def _factored_dims(shape, factored, min_dim_size_to_factor):
    """The two largest axes of `shape` to factor over, or None (optax)."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _decay_rate_pow(i, exponent=0.8):
    """float32 1 - (i + 1)**-exponent, the power from the C library's powf."""
    t = float(np.float32(i + 1))
    return np.float32(1.0) - np.float32(_libm.powf(t, float(np.float32(-exponent))))


def _split_jax_dims(key, shard):
    """{dim in makani_tpu's layout: (axis, whole size)} of a shard's split
    dimensions."""
    if shard is None:
        return {}
    # dimension j of makani_tpu's layout is the port's order[j]
    order = jax_dims(key, shard.global_shape)
    return {order.index(s.dim): (s.axis, shard.global_shape[s.dim]) for s in shard.splits}


def _global_jax_shape(key, shape, shard):
    if shard is None:
        return tuple(shape)
    return tuple(jax_view(key, torch.empty(shard.global_shape, device="meta")).shape)


def _mean(x, dim, split, full_dims):
    """x.mean(dim) over the whole leaf: a dimension split over ranks sums
    over its group and divides by its whole size. `full_dims` maps x's
    dimensions to the leaf's (makani_tpu's layout)."""
    d = full_dims[dim]
    if d not in split:
        return x.mean(dim=dim)
    axis, size = split[d]
    return spmd.all_reduce_(x.sum(dim=dim), axis) / size


def scale_by_factored_rms(factored=True, decay_rate=0.8, step_offset=0,
                          min_dim_size_to_factor=128, epsilon=1e-30, shards=None):
    """optax.scale_by_factored_rms (Adafactor's scaling), on makani_tpu's
    layout of every leaf: the factored axes are chosen and the row and column
    statistics kept in that layout, so the port's dhconv weight (2, L, C, O)
    gets the statistics of makani_tpu's (C, O, L, 2). The state's v_row,
    v_col and v are keyed like the parameters, in makani_tpu's shapes. A
    rank's shard of a leaf split over ranks (`shards`) factors the axes of
    the whole leaf, and its statistics average over the whole leaf; it keeps
    the shard of them that its elements need."""
    shards = shards or {}

    def init_fn(params):
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            shape = tuple(jax_view(k, p).shape)
            dims = _factored_dims(_global_jax_shape(k, shape, shards.get(k)), factored,
                                  min_dim_size_to_factor)
            one = torch.zeros((1,), device=p.device)
            if dims is not None:
                d1, d0 = dims
                v_row[k] = torch.zeros(tuple(np.delete(shape, d0)), device=p.device)
                v_col[k] = torch.zeros(tuple(np.delete(shape, d1)), device=p.device)
                v[k] = one
            else:
                v_row[k], v_col[k] = one, one.clone()
                v[k] = torch.zeros(shape, device=p.device)
        return FactoredState(0, v_row, v_col, v)

    def update_fn(updates, state, params=None):
        rate = _decay_rate_pow(state.count - step_offset, decay_rate)
        dev = next(iter(updates.values())).device if updates else "cpu"
        d_t = torch.tensor(rate, device=dev)
        d_c = torch.tensor(np.float32(1.0) - rate, device=dev)
        out, v_row, v_col, v = {}, {}, {}, {}
        with torch.no_grad():
            for k, g_port in updates.items():
                g = jax_view(k, g_port.float())
                shard = shards.get(k)
                dims = _factored_dims(_global_jax_shape(k, g.shape, shard), factored,
                                      min_dim_size_to_factor)
                grad_sqr = g * g + epsilon
                if dims is not None:
                    d1, d0 = dims
                    split = _split_jax_dims(k, shard)
                    every = list(range(g.ndim))
                    vr = d_t * state.v_row[k] + d_c * _mean(grad_sqr, d0, split, every)
                    vc = d_t * state.v_col[k] + d_c * _mean(grad_sqr, d1, split, every)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = _mean(vr, reduced_d1, split,
                                         [d for d in every if d != d0]).unsqueeze(reduced_d1)
                    row_factor = (vr / row_col_mean) ** -0.5
                    col_factor = vc ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                    v_row[k], v_col[k], v[k] = vr, vc, state.v[k]
                else:
                    vv = d_t * state.v[k] + d_c * grad_sqr
                    u = g * vv ** -0.5
                    v_row[k], v_col[k], v[k] = state.v_row[k], state.v_col[k], vv
                out[k] = port_view(k, u, g_port.shape).contiguous()
        return out, FactoredState(state.count + 1, v_row, v_col, v)

    return GradientTransformation(init_fn, update_fn)


ADAM_FAMILY = ("Adam", "AdamW", "FusedLAMB", "LAMB")
_LAMB = ("FusedLAMB", "LAMB")


def clip_norm(params):
    """The global-norm clip of the config, or None: gradient_clip_norm for any
    optimizer, else optimizer_max_grad_norm for the LAMB optimizers alone (as
    in the reference, whose torch Adam takes no such argument)."""
    opt_type = params.get("optimizer_type", "Adam")
    max_norm = params.get("gradient_clip_norm", None)
    if max_norm is None and opt_type in _LAMB:
        max_norm = params.get("optimizer_max_grad_norm", None)
    return float(max_norm) if max_norm is not None and max_norm > 0 else None


def kernel_update_settings(params):
    """kwargs for ops/fused_adam.fused_adam_apply when the config's optimizer
    is one the fused kernel runs (Adam, AdamW, LAMB; float32, bf16 or float16
    moments; with the config's clipping), else None. float16 moments round to
    nearest (stochastic_rounding False), as makani_tpu stores them whatever
    optimizer_stochastic_rounding says."""
    opt_type = params.get("optimizer_type", "Adam")
    if opt_type not in ADAM_FAMILY:
        return None
    md = params.get("optimizer_moment_dtype", "float32")
    if md not in (None, "float32", "fp32", *_DTYPES):
        return None
    wd = float(params.get("weight_decay", 0.0) or 0.0) if opt_type != "Adam" else 0.0
    return dict(
        b1=params.get("optimizer_beta1", 0.9),
        b2=params.get("optimizer_beta2", 0.95),
        eps=1e-8 * (10.0 ** float(params.get("epsilon_factor", 0) or 0)),
        weight_decay=wd,
        stochastic_rounding=bool(params.get("optimizer_stochastic_rounding", True))
        and md in ("bfloat16", "bf16"),
        seed=params.get("global_seed", 333) + 7,
        max_norm=clip_norm(params),
        lamb=opt_type in _LAMB,
    )


def fused_adam_settings(params):
    """makani_tpu's gate of its fused Adam stage: `kernel_update_settings`
    without the clip and LAMB keys where the config sets optimizer_fused and
    the kernel's plain mode expresses it (Adam or AdamW, no clipping, float32
    or bf16 moments: makani_tpu's TPU kernel takes no float16), else None."""
    kw = kernel_update_settings(params)
    if (not params.get("optimizer_fused", False) or kw is None or kw["lamb"]
            or kw["max_norm"] is not None
            or params.get("optimizer_moment_dtype", "float32") in ("float16", "fp16")):
        return None
    return {k: v for k, v in kw.items() if k not in ("lamb", "max_norm")}


def build_optimizer(params, shards=None):
    """The lr-free gradient transform of the config (makani_tpu's
    build_optimizer); `shards` names the leaves split over ranks
    (parallel/partitioning.shard_module), whose norms and statistics are
    taken over the whole leaf."""
    opt_type = params.get("optimizer_type", "Adam")
    tx = []
    max_norm = clip_norm(params)
    if max_norm is not None:
        tx.append(clip_by_global_norm(max_norm, shards))
    b1 = params.get("optimizer_beta1", 0.9)
    b2 = params.get("optimizer_beta2", 0.95)
    wd = params.get("weight_decay", 0.0)
    eps = 1e-8 * (10.0 ** float(params.get("epsilon_factor", 0) or 0))
    moment_dtype = params.get("optimizer_moment_dtype", "float32")

    def adam():
        if moment_dtype in (None, "float32", "fp32"):
            return scale_by_adam(b1=b1, b2=b2, eps=eps)
        return scale_by_adam_lowmem(
            b1=b1, b2=b2, eps=eps, moment_dtype=_DTYPES[moment_dtype],
            stochastic_rounding=bool(params.get("optimizer_stochastic_rounding", True)),
            seed=params.get("global_seed", 333) + 7)

    if opt_type in ("Adam", "AdamW") + _LAMB:
        tx.append(adam())
        if opt_type != "Adam" and wd > 0:
            tx.append(add_decayed_weights(wd))
        if opt_type in _LAMB:
            tx.append(scale_by_trust_ratio(shards))
    elif opt_type == "Adafactor":
        tx.append(scale_by_factored_rms(shards=shards))
    elif opt_type == "SGD":
        momentum = params.get("momentum", 0.0)
        if momentum > 0:
            tx.append(trace(decay=momentum))
    else:
        raise ValueError(f"Unknown optimizer type {opt_type}")
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
