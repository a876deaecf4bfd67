"""Fused Adam(W) update with bf16 moments under stochastic rounding, as a
Hopper kernel.

Counterpart of makani_tpu/ops/pallas_adam.py. `fused_adam_apply` updates
every parameter leaf and its two moments in one pass per leaf
(csrc/fused_adam.cu, one launch per leaf, as on the TPU), in place: the
parameters and the moment tensors of `state` are overwritten and
`state.count` advances. On CPU tensors it runs the plain twin
(`fused_adam_apply_plain`), which repeats the kernel's arithmetic bit for
bit.

Both are bit-identical to makani_tpu's fused_adam_apply and its
scale_by_adam_lowmem + ``p - lr*u`` as XLA compiles them for the CPU:
  mu' = fma(g, 1-b1, b1*mu)
  nu' = fma(g*g, 1-b2, b2*nu)
  u   = mu' / (bc1 * (sqrt(nu'/bc2) + eps))     (mu'/bc1)/(...) folded
  p'  = fma(-u, lr, p*(1 - lr*wd))
with every other operation rounded once in float32, the (1-b)-style constants
rounded from Python floats to float32 (JAX's weak-typed scalars), and the
moments stored through the counter-hash dither keyed by the element's flat
index in makani_tpu's layout of the leaf (utils/param_layout.py) and a salt
per (step, leaf, moment) keyed by the leaf's position in jax.tree.flatten
order. The bias corrections bc = 1 - b**count take b**count from the C
library's float32 powf, as XLA compiles makani_tpu's float32 pow for the CPU;
it is not always the correctly rounded power (0.999**2958 and 0.999**3606 are
one ulp off).
"""

import ctypes
import ctypes.util

import numpy as np
import torch

from makani_tpu_torch.ops import kernels
from makani_tpu_torch.utils.param_layout import jax_index_strides, jax_leaf_order

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# host scalars, shared by the kernel, its twin and utils/optimizers
# --------------------------------------------------------------------------

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.powf.restype = ctypes.c_float
_libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]


def bias_corrections(count, b1, b2):
    """float32 1 - b**count for both betas, b**count from the C library's
    powf (makani_tpu's float32 pow on the CPU, bit for bit)."""
    def bc(b):
        return np.float32(1.0) - np.float32(_libm.powf(float(np.float32(b)), float(count)))
    return bc(b1), bc(b2)


def moment_salts(seed, count, n_leaves):
    """The dither salts of one step: [mu of leaf 0, nu of leaf 0, mu of leaf 1,
    ...] (utils/optimizers.py:85-88, pallas_adam.py:159-173)."""
    base = (((int(seed) & _M32) ^ (int(count) & _M32)) * 0x9E3779B1) & _M32
    return [((base ^ ((j * 0x68E31DA4 + 0xB5297A4D) & _M32)) * 0x1B56C4E9) & _M32
            for j in range(2 * max(n_leaves, 1))]


# --------------------------------------------------------------------------
# exact float32 pieces in PyTorch
# --------------------------------------------------------------------------

def fma(a, b, c):
    """float32 a*b + c rounded once: the product is exact in float64, the sum
    is formed with round-to-odd (TwoSum, then the odd neighbour), and rounding
    that to float32 is the correctly rounded fused multiply-add."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt_rn(x):
    """Correctly rounded float32 square root of a non-negative float32 tensor
    (torch.sqrt on the CPU is not always: it can be one ulp off). Rounds the
    float64 root to float32, then moves one ulp where the square of a midpoint,
    exact in float64, shows the root on the other side."""
    s = torch.sqrt(x.double()).float()
    xd, sd = x.double(), s.double()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.zeros_like(s))
    hi = (sd + up.double()) * 0.5
    lo = (sd + down.double()) * 0.5
    return torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, down, s))


def dither_u16(idx, salt):
    """The counter-hash dither on int64 element indices (< 2^32): unsigned
    32-bit arithmetic emulated in int64, masked after every multiply (the low
    32 bits of a wrapped int64 product are exact)."""
    h = ((idx * 0x9E3779B1) & _M32) ^ salt
    h = ((h ^ (h >> 15)) * 0x85EBCA6B) & _M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _M32
    return (h ^ (h >> 16)) & 0xFFFF


def stochastic_round_bf16(x, idx, salt):
    """float32 -> bf16: add the 16-bit dither below the kept bits, truncate."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    bits = ((bits + dither_u16(idx, salt)) & 0xFFFF0000) >> 16
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(torch.bfloat16)


def jax_flat_index(key, shape, device):
    """int64 flat index of every element of the port's leaf in makani_tpu's
    layout of that leaf."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for d, (size, stride) in enumerate(zip(shape, jax_index_strides(key, shape))):
        view = [1] * len(shape)
        view[d] = size
        idx = idx + torch.arange(size, dtype=torch.int64, device=device).view(view) * stride
    return idx.expand(tuple(shape))


def _f32(v, device):
    return torch.tensor(np.float32(v), device=device)


def adam_moments(g, mu, nu, b1, b2):
    """float32 mu', nu' of one leaf from float32 g and the stored moments."""
    dev = g.device
    m = fma(g, _f32(1.0 - b1, dev), _f32(b1, dev) * mu.float())
    v = fma(g * g, _f32(1.0 - b2, dev), _f32(b2, dev) * nu.float())
    return m, v


def adam_direction(m, v, bc1, bc2, eps):
    dev = m.device
    return m / (_f32(bc1, dev) * (sqrt_rn(v / _f32(bc2, dev)) + _f32(eps, dev)))


def store_moment(dst, value, key, salt, stochastic):
    """Write a float32 moment into `dst` (float32 or bf16), in place."""
    if dst.dtype == torch.bfloat16 and stochastic:
        value = stochastic_round_bf16(value, jax_flat_index(key, value.shape, value.device), salt)
    dst.copy_(value)


# --------------------------------------------------------------------------
# the fused update
# --------------------------------------------------------------------------

def _moment_kind(mu, stochastic):
    if mu.dtype == torch.float32:
        return 0
    if mu.dtype == torch.bfloat16:
        return 2 if stochastic else 1
    raise TypeError(f"fused Adam takes float32 or bf16 moments, got {mu.dtype}")


def _leaf_plain(key, p, g, mu, nu, lr, bc1, bc2, b1, b2, eps, wd, salts, stochastic):
    with torch.no_grad():
        m, v = adam_moments(g.float(), mu, nu, b1, b2)
        u = adam_direction(m, v, bc1, bc2, eps)
        dev = p.device
        decay = np.float32(1.0) - np.float32(lr) * np.float32(wd)
        p.copy_(fma(-u, _f32(lr, dev), p * _f32(decay, dev)))
        store_moment(mu, m, key, salts[0], stochastic)
        store_moment(nu, v, key, salts[1], stochastic)


def _leaf_kernel(key, p, g, mu, nu, lr, bc1, bc2, b1, b2, eps, wd, salts, stochastic):
    kind = _moment_kind(mu, stochastic)
    for t in (p, g, mu, nu):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"{key}: fused Adam takes contiguous tensors on one device")
        if t.shape != p.shape:
            raise ValueError(f"{key}: shapes differ: {tuple(t.shape)} vs {tuple(p.shape)}")
    if p.dtype != torch.float32 or g.dtype != torch.float32 or nu.dtype != mu.dtype:
        raise TypeError(f"{key}: fused Adam takes float32 p and g and moments of one dtype")
    n = p.numel()
    if n >= 2 ** 32 or p.dim() > 4:
        raise ValueError(f"{key}: leaf of shape {tuple(p.shape)} exceeds the kernel's indexing")
    shape = (1,) * (4 - p.dim()) + tuple(p.shape)
    strides = (0,) * (4 - p.dim()) + jax_index_strides(key, p.shape)
    decay = np.float32(1.0) - np.float32(lr) * np.float32(wd)
    launch = kernels.launcher("fused_adam")
    with torch.cuda.device(p.device):
        # float32 scalars, passed as the Python floats that hold them exactly
        scalars = [float(np.float32(v)) for v in
                   (lr, bc1, bc2, b1, b2, 1.0 - b1, 1.0 - b2, eps, decay)]
        rc = launch(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), n,
                    shape[1], shape[2], shape[3], *strides, *scalars,
                    salts[0], salts[1], kind, torch.cuda.current_stream().cuda_stream)
    kernels.raise_on(rc, "fused_adam")
    kernels.launches["fused_adam"] += 1


def _apply(leaf_fn, params, grads, state, lr, b1, b2, eps, weight_decay, stochastic_rounding,
           seed):
    count = state.count + 1
    bc1, bc2 = bias_corrections(count, b1, b2)
    order = jax_leaf_order(grads)
    salts = moment_salts(seed, count, len(order))
    for i, key in enumerate(order):
        leaf_fn(key, params[key], grads[key], state.mu[key], state.nu[key], lr, bc1, bc2, b1, b2,
                eps, weight_decay, salts[2 * i: 2 * i + 2], stochastic_rounding)
    state.count = count
    return params, state


def fused_adam_apply_plain(params, grads, state, lr, *, b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0, stochastic_rounding=True, seed=1234):
    """Plain twin of `fused_adam_apply`, on any device."""
    return _apply(_leaf_plain, params, grads, state, lr, b1, b2, eps, weight_decay,
                  stochastic_rounding, seed)


def fused_adam_apply(params, grads, state, lr, *, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0, stochastic_rounding=True, seed=1234):
    """One fused Adam(W) step over `params` and `grads` (dicts name -> tensor,
    named like the model's parameters) and `state` (count, mu, nu), in place.
    Returns (params, state). Leaves on CUDA launch the kernel; leaves on the
    CPU run the twin."""
    def leaf(key, p, *rest):
        fn = _leaf_kernel if kernels.dispatch(p) else _leaf_plain
        fn(key, p, *rest)

    return _apply(leaf, params, grads, state, lr, b1, b2, eps, weight_decay,
                  stochastic_rounding, seed)
