"""Fused Adam(W) update with bf16 moments under stochastic rounding (or
float32, or float16 moments rounded to nearest), as a Hopper kernel.

Counterpart of makani_tpu/ops/pallas_adam.py. `fused_adam_apply` updates
every parameter leaf and its two moments in one pass (csrc/fused_adam.cu),
in place: the parameters and the moment tensors of `state` are overwritten
and `state.count` advances. Where the TPU kernel launches once per leaf, the
card's kernel launches once per update: the wrapper packs one descriptor a
non-empty leaf (LEAF_DTYPE: its tensors' addresses, its index dims, the
first flat index of a shard, its salts) into a table that one asynchronous
copy from page-locked memory puts on the card. What a parameter set fixes of
the table (LeafLayout: every check, the index dims, the work units) is built
once and reused while the same tensors hold the same memory; an update
checks its gradients and fills in their addresses and its salts. The leaves
of one update lie on one device and carry moments of one dtype, or it
raises. Two modes extend it to makani_tpu's optax chains:
gradient clipping by the global norm (read by the kernel from the device),
and LAMB (the kernel writes the decayed direction, the trust ratio applies
it). On CPU tensors it runs the plain twin
(`fused_adam_apply_plain`), which repeats the kernel's arithmetic bit for
bit.

Both are bit-identical to makani_tpu's fused_adam_apply and its
scale_by_adam_lowmem + ``p - lr*u`` as XLA compiles them for the CPU:
  mu' = fma(g, 1-b1, b1*mu)
  nu' = fma(g*g, 1-b2, b2*nu)
  u   = mu' / (bc1 * (sqrt(nu'/bc2) + eps))     (mu'/bc1)/(...) folded
  p'  = fma(-u, lr, p*(1 - lr*wd))
(float16 moments: stored as fma(mu, b1, (1-b1)*g) and fma(nu, b2,
(1-b2)*(g*g)), u taken from the first form of mu', as XLA's CPU code
contracts that graph), with every other operation rounded once in float32,
the (1-b)-style constants rounded from Python floats to float32 (JAX's
weak-typed scalars), and the
moments stored through the counter-hash dither keyed by the element's flat
index in makani_tpu's layout of the leaf (utils/param_layout.py) and a salt
per (step, leaf, moment) keyed by the leaf's position in jax.tree.flatten
order. The bias corrections bc = 1 - b**count take b**count from the C
library's float32 powf, as XLA compiles makani_tpu's float32 pow for the CPU;
it is not always the correctly rounded power (0.999**2958 and 0.999**3606 are
one ulp off).
"""

import collections
import ctypes
import ctypes.util
import functools
import math
import operator
import weakref

import numpy as np
import torch

from makani_tpu_torch.ops import kernels
from makani_tpu_torch.parallel import partitioning
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


def salt_terms(j):
    """The part of the salt of moment j (2 * leaf + 0 for mu, + 1 for nu)
    that no step changes, as uint32."""
    j = np.asarray(j, dtype=np.uint64)
    terms = (j * np.uint64(0x68E31DA4) + np.uint64(0xB5297A4D)) & np.uint64(_M32)
    return terms.astype(np.uint32)


def step_salts(seed, count, terms):
    """The salts of one step from salt_terms' `terms` (uint32 arithmetic,
    wrapping as the reference's does)."""
    base = np.uint32((((int(seed) & _M32) ^ (int(count) & _M32)) * 0x9E3779B1) & _M32)
    return (terms ^ base) * np.uint32(0x1B56C4E9)


def moment_salts(seed, count, n_leaves):
    """The dither salts of one step: [mu of leaf 0, nu of leaf 0, mu of leaf 1,
    ...] (utils/optimizers.py:85-88, pallas_adam.py:159-173)."""
    return step_salts(seed, count, salt_terms(np.arange(2 * max(n_leaves, 1)))).tolist()


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


def shard_strides(key, shape, shard=None):
    """(index strides, flat index of the first element) of the port's leaf,
    or of a rank's `shard` of it (parallel/partitioning.Shard): a shard's
    elements keep their indices in the whole leaf."""
    if shard is None:
        return jax_index_strides(key, shape), 0
    strides = jax_index_strides(key, shard.global_shape)
    return strides, sum(s.start * int(strides[s.dim]) for s in shard.splits)


def jax_flat_index(key, shape, device, shard=None):
    """int64 flat index of every element of the port's leaf in makani_tpu's
    layout of that leaf (of the whole leaf, for a rank's `shard` of it)."""
    strides, base = shard_strides(key, shape, shard)
    idx = torch.full((), base, dtype=torch.int64, device=device)
    for d, (size, stride) in enumerate(zip(shape, strides)):
        view = [1] * len(shape)
        view[d] = size
        idx = idx + torch.arange(size, dtype=torch.int64, device=device).view(view) * stride
    return idx.expand(tuple(shape))


def kernel_index_dims(key, shape, shard=None):
    """The leaf's sizes and makani_tpu-layout index strides with size-1
    dimensions dropped and neighbours merged where the outer one strides by
    the inner one's extent: the same flat indices in as few dimensions as
    they take (the stacked dhconv weight (..., 2, L, C, O) in 3 or 4, every
    other leaf in 1), within the kernel's four. A rank's `shard` of a leaf
    takes the whole leaf's strides."""
    strides = shard_strides(key, shape, shard)[0]
    dims = [(int(n), int(j)) for n, j in zip(shape, strides) if n != 1]
    merged = []
    for n, j in dims:
        if merged and merged[-1][1] == j * n:
            merged[-1] = (merged[-1][0] * n, j)
        else:
            merged.append((n, j))
    merged = merged or [(1, 1)]
    return tuple(n for n, _ in merged), tuple(j for _, j in merged)


def _f32(v, device):
    return torch.tensor(np.float32(v), device=device)


def adam_moments(g, mu, nu, b1, b2):
    """float32 (mu', nu', mu'') of one leaf from float32 g and the stored
    moments: mu' and nu' to store, mu'' for the direction. They are
    fma(g, 1-b1, b1*mu), fma(g*g, 1-b2, b2*nu) and mu'' = mu', except for
    float16 moments, where XLA's CPU code contracts the other product for
    the stored moments, fma(mu, b1, (1-b1)*g) and fma(nu, b2, (1-b2)*(g*g)),
    and computes the direction's mu'' apart, as fma(g, 1-b1, b1*mu)."""
    dev = g.device
    a1, a2, b1, b2 = (_f32(v, dev) for v in (1.0 - b1, 1.0 - b2, b1, b2))
    m = fma(g, a1, b1 * mu.float())
    if mu.dtype == torch.float16:
        return fma(mu.float(), b1, a1 * g), fma(nu.float(), b2, a2 * (g * g)), m
    return m, fma(g * g, a2, b2 * nu.float()), m


def adam_direction(m, v, bc1, bc2, eps):
    dev = m.device
    return m / (_f32(bc1, dev) * (sqrt_rn(v / _f32(bc2, dev)) + _f32(eps, dev)))


def store_moment(dst, value, key, salt, stochastic, shard=None):
    """Write a float32 moment into `dst` (float32, bf16 or float16), in place:
    stochastically rounded for bf16 under `stochastic`, else rounded to
    nearest (float16 always, subnormals kept, as XLA's CPU conversion and
    makani_tpu's _stochastic_round give it)."""
    if dst.dtype == torch.bfloat16 and stochastic:
        idx = jax_flat_index(key, value.shape, value.device, shard)
        value = stochastic_round_bf16(value, idx, salt)
    dst.copy_(value)


# --------------------------------------------------------------------------
# the fused update
# --------------------------------------------------------------------------

def _moment_kind(mu, stochastic):
    """The kernel's moment kind: 0 float32, 1 bf16 to nearest, 2 bf16
    stochastically, 3 float16 to nearest (whatever `stochastic` says)."""
    if mu.dtype == torch.float32:
        return 0
    if mu.dtype == torch.bfloat16:
        return 2 if stochastic else 1
    if mu.dtype == torch.float16:
        return 3
    raise TypeError(f"fused Adam takes float32, bf16 or float16 moments, got {mu.dtype}")


def global_norm(tensors):
    """sqrt of the sum of squares of every element of `tensors` (optax's
    global_norm), a float32 0-dim tensor on their device, with no host sync:
    one norm a leaf (torch._foreach_norm), then the norm of those."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_norm(g, norm, max_norm):
    """optax.clip_by_global_norm's arithmetic on one leaf: g where norm <
    max_norm, else (g / norm) * max_norm, rounded twice in float32."""
    limit = _f32(max_norm, g.device)
    return torch.where(norm < limit, g, (g / norm) * limit)


def trust_ratios(params, updates, keys=None, shards=None):
    """optax.scale_by_trust_ratio's ratio of each leaf, ||p|| / ||u|| (1
    where either norm is 0), as 0-dim tensors on the device; with `shards`
    (leaves split over ranks, named by `keys`) the norms of whole leaves."""
    if not params:
        return []
    if shards:
        pn = torch.stack(partitioning.leaf_square_norms(keys, params, shards)).sqrt()
        un = torch.stack(partitioning.leaf_square_norms(keys, updates, shards)).sqrt()
        return torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un).unbind()
    pn = torch.stack(torch._foreach_norm(list(params)))
    un = torch.stack(torch._foreach_norm(list(updates)))
    return torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un).unbind()


def trust_ratio_apply(params, dirs, lr, shards=None):
    """LAMB's step from the directions u' (dict, as `params`), in place:
    p <- p - lr * u' * ratio; one pass over p and u' a leaf (addcmul with the
    ratio on the device, no host sync), one call for all leaves."""
    keys = list(dirs)
    with torch.no_grad():
        leaves, dirs = [params[k] for k in keys], [dirs[k] for k in keys]
        torch._foreach_addcmul_(leaves, dirs, list(trust_ratios(leaves, dirs, keys, shards)),
                                value=-float(lr))


def _leaf_plain(key, p, g, mu, nu, lr, bc1, bc2, b1, b2, eps, wd, salts, stochastic,
                norm=None, max_norm=None, direction=None, shard=None):
    with torch.no_grad():
        g = g.float()
        if norm is not None:
            g = clip_by_norm(g, norm, max_norm)
        m, v, m_dir = adam_moments(g, mu, nu, b1, b2)
        u = adam_direction(m_dir, v, bc1, bc2, eps)
        dev = p.device
        if direction is not None:
            direction.copy_(fma(p, _f32(wd, dev), u))
        else:
            decay = np.float32(1.0) - np.float32(lr) * np.float32(wd)
            p.copy_(fma(-u, _f32(lr, dev), p * _f32(decay, dev)))
        store_moment(mu, m, key, salts[0], stochastic, shard)
        store_moment(nu, v, key, salts[1], stochastic, shard)


# --------------------------------------------------------------------------
# the kernel's table of leaves
# --------------------------------------------------------------------------

# csrc/fused_adam.cu: a thread takes VEC consecutive elements, a work unit is
# its block's 256 runs, and the grid BLOCKS_PER_SM blocks an SM
VEC = 8
UNIT = 256 * VEC
BLOCKS_PER_SM = 2

# csrc/fused_adam.cu's LeafDesc, field for field (120 bytes)
LEAF_DTYPE = np.dtype([(f, "<u8") for f in ("p", "g", "mu", "nu", "dir")]
                      + [(f, "<u4") for f in ("n", "unit0", "s1", "m1", "l1", "s2", "m2", "l2",
                                              "s3", "m3", "l3", "j0", "j1", "j2", "j3", "base",
                                              "salt_mu", "salt_nu", "vec", "pad")])


def divider(d):
    """(m, l) of the kernel's division by d, 1 <= d < 2^32: for every 32-bit
    i, i // d = (t + ((i - t) >> min(l, 1))) >> max(l - 1, 0) with t the
    high 32 bits of i * m (Granlund and Montgomery's division by an
    invariant integer)."""
    d = int(d)
    l = (d - 1).bit_length()
    return (((1 << l) - d) << 32) // d + 1, l


def leaf_index_fields(key, shape, shard=None):
    """The index fields of a leaf's descriptor: the last three of its four
    merged sizes (kernel_index_dims, padded in front with 1) with their
    dividers, the four index strides (0 in front) and the flat index of its
    first element (shard_strides)."""
    sizes, strides = kernel_index_dims(key, shape, shard)
    n = math.prod(shape)
    total = n if shard is None else math.prod(shard.global_shape)
    if total >= 2 ** 32 or n > 2 ** 32 - UNIT or len(sizes) > 4:
        raise ValueError(f"{key}: leaf of shape {tuple(shape)} exceeds the kernel's indexing")
    pad = 4 - len(sizes)
    sizes, strides = (1,) * pad + sizes, (0,) * pad + strides
    out = {f"j{d}": j for d, j in enumerate(strides)}
    for d in (1, 2, 3):
        out[f"s{d}"] = sizes[d]
        out[f"m{d}"], out[f"l{d}"] = divider(sizes[d])
    out["base"] = shard_strides(key, shape, shard)[1]
    return out


def _check_leaf(key, p, mu, nu, device, moment_dtype):
    for t in (p, mu, nu):
        if t.device != device:
            raise ValueError(f"{key}: the update's leaves lie on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{key}: fused Adam takes contiguous tensors")
        if t.shape != p.shape:
            raise ValueError(f"{key}: shapes differ: {tuple(t.shape)} vs {tuple(p.shape)}")
    if p.dtype != torch.float32:
        raise TypeError(f"{key}: fused Adam takes float32 parameters, got {p.dtype}")
    if mu.dtype != moment_dtype or nu.dtype != moment_dtype:
        raise TypeError(f"{key}: the update's moments mix {mu.dtype}, {nu.dtype} and "
                        f"{moment_dtype}")


class LeafLayout:
    """What a parameter set fixes of the kernel's table (one row a non-empty
    leaf of `order`: the p, mu and nu addresses, n, the first work unit, the
    index fields, the salts' constant part), checked and built once; every
    update then checks only that it still holds (the same p, mu, nu and
    shards, each p on the same memory) and its gradients."""

    def __init__(self, order, params, mu, nu, shards):
        self.order = list(order)
        self.device = params[order[0]].device
        moment_dtype = mu[order[0]].dtype
        _moment_kind(mu[order[0]], False)   # raises on a dtype the kernel does not take
        rows, live = [], []
        for pos, key in enumerate(order):
            p, m, v, shard = params[key], mu[key], nu[key], shards.get(key)
            _check_leaf(key, p, m, v, self.device, moment_dtype)
            if p.numel():
                live.append(pos)
                rows.append(dict(leaf_index_fields(key, p.shape, shard), p=p.data_ptr(),
                                 mu=m.data_ptr(), nu=v.data_ptr(), n=p.numel()))
        ps = [params[k] for k in order]
        self.refs = [[weakref.ref(t) for t in ps], [weakref.ref(mu[k]) for k in order],
                     [weakref.ref(nu[k]) for k in order]]
        self.p_addresses = [p.data_ptr() for p in ps]
        self.shapes = [p.shape for p in ps]
        self.shards = [shards.get(k) for k in order]
        self.live = np.array(live, dtype=np.int64)
        table = np.zeros(len(rows), LEAF_DTYPE)
        for field in LEAF_DTYPE.names:
            if rows and field in rows[0]:
                table[field] = [r[field] for r in rows]
        units = -(-table["n"].astype(np.int64) // UNIT)
        table["unit0"] = np.cumsum(units) - units
        self.n_units = int(units.sum())
        self.aligned = (table["p"] | table["mu"] | table["nu"]) % 16 == 0
        self.salt_terms = salt_terms(np.stack([2 * self.live, 2 * self.live + 1]))
        self.rows = table.view(np.uint8)

    def gradients(self, params, mu, nu, grads, shards):
        """The address of every leaf's gradient, each checked; None where the
        layout no longer holds."""
        keys = self.order
        ps = list(map(params.__getitem__, keys))
        held = zip((ps, map(mu.__getitem__, keys), map(nu.__getitem__, keys)), self.refs)
        if (not all(all(map(operator.is_, ts, map(_deref, refs))) for ts, refs in held)
                or list(map(torch.Tensor.data_ptr, ps)) != self.p_addresses
                or list(map(shards.get, keys)) != self.shards):
            return None
        gs = list(map(grads.__getitem__, keys))
        dev = self.device.index if self.device.type == "cuda" else -1
        if (list(map(_shape, gs)) != self.shapes or set(map(_dtype, gs)) != {torch.float32}
                or not all(map(torch.Tensor.is_contiguous, gs))
                or set(map(torch.Tensor.get_device, gs)) != {dev}):
            for key, g, shape in zip(keys, gs, self.shapes):
                if (g.shape != shape or g.dtype != torch.float32 or not g.is_contiguous()
                        or g.get_device() != dev):
                    raise ValueError(f"{key}: the gradient must be a contiguous float32 tensor "
                                     f"of shape {tuple(shape)} on {self.device}, got {g.dtype} "
                                     f"{tuple(g.shape)} on {g.device}")
        return list(map(torch.Tensor.data_ptr, gs))

    def table(self, grads, seed, count, dirs=None, out=None):
        """The kernel's table of one update, in `out` (uint8, the table's
        bytes) where given: the layout's rows with each leaf's gradient
        address (`grads`, from `gradients`) and its direction buffer's, the
        step's two salts of each leaf, and `vec` where all its addresses lie
        on 16 bytes."""
        if out is None:
            out = np.empty_like(self.rows)
        out[:] = self.rows
        table = out.view(LEAF_DTYPE)
        live = self.live
        g = np.asarray(grads, dtype=np.uint64)
        if len(live) < len(g):
            g = g[live]
        table["g"] = g
        table["salt_mu"], table["salt_nu"] = step_salts(seed, count, self.salt_terms)
        vec = self.aligned & (g % 16 == 0)
        if dirs:
            d = np.asarray([dirs[self.order[i]].data_ptr() for i in live], dtype=np.uint64)
            table["dir"] = d
            vec &= d % 16 == 0
        table["vec"] = vec
        return table


_deref = weakref.ref.__call__
_shape = operator.attrgetter("shape")
_dtype = operator.attrgetter("dtype")
_LAYOUTS = collections.OrderedDict()
_SMS = {}


def _prepare(order, params, state, grads, shards):
    """The LeafLayout of `order`'s leaves, cached (a few parameter sets
    kept) and rebuilt where it no longer holds, and the update's gradient
    addresses."""
    layout = _LAYOUTS.get(order)
    addresses = None if layout is None else layout.gradients(params, state.mu, state.nu, grads,
                                                              shards)
    if addresses is None:
        layout = _LAYOUTS[order] = LeafLayout(order, params, state.mu, state.nu, shards)
        while len(_LAYOUTS) > 8:
            _LAYOUTS.popitem(last=False)
        addresses = layout.gradients(params, state.mu, state.nu, grads, shards)
    return layout, addresses


def _kernel_update(order, params, grads, state, count, lr, bc1, bc2, b1, b2, eps, wd, seed,
                   stochastic, norm, max_norm, dirs, shards):
    """One launch for every leaf: the table written into page-locked memory
    and copied to the card (the caching host allocator keeps the buffer
    until the copy has run), then the kernel, all on the current stream, no
    sync."""
    layout, addresses = _prepare(order, params, state, grads, shards)
    dev = layout.device
    if norm is not None and (norm.device != dev or norm.dtype != torch.float32
                             or norm.numel() != 1):
        raise ValueError(f"the global norm must be one float32 on {dev}")
    if layout.n_units == 0:
        return
    host = torch.empty(layout.rows.size, dtype=torch.uint8, pin_memory=True)
    table = layout.table(addresses, seed, count, dirs, out=host.numpy())
    kind = _moment_kind(state.mu[order[0]], stochastic)
    mode = (1 if norm is not None else 0) | (2 if dirs else 0)
    decay = np.float32(1.0) - np.float32(lr) * np.float32(wd)
    # float32 scalars, passed as the Python floats that hold them exactly
    scalars = [float(np.float32(v)) for v in
               (lr, bc1, bc2, b1, b2, 1.0 - b1, 1.0 - b2, eps, decay,
                0.0 if max_norm is None else max_norm, wd)]
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(layout.n_units, BLOCKS_PER_SM * _SMS[dev.index])
    # the copy runs on the current stream of dev, the stream the kernel takes
    on_card = torch.empty(layout.rows.size, dtype=torch.uint8, device=dev)
    on_card.copy_(host, non_blocking=True)
    kernels.launch("fused_adam", dev.index, on_card.data_ptr(), len(table), layout.n_units,
                   blocks, None if norm is None else norm.data_ptr(), *scalars, kind, mode)


@functools.lru_cache(maxsize=16)
def _leaf_order(keys):
    return tuple(jax_leaf_order(keys))


def _apply(params, grads, state, lr, b1, b2, eps, weight_decay, stochastic_rounding, seed,
           max_norm, lamb, shards, kernel):
    count = state.count + 1
    bc1, bc2 = bias_corrections(count, b1, b2)
    order = _leaf_order(tuple(grads))
    norm = None
    if max_norm:
        norm = (global_norm(grads[k] for k in order) if shards is None else
                partitioning.global_norm(order, [grads[k] for k in order], shards))
    dirs = {k: torch.empty_like(params[k]) for k in order} if lamb else {}
    if kernel:
        _kernel_update(order, params, grads, state, count, lr, bc1, bc2, b1, b2, eps,
                       weight_decay, seed, stochastic_rounding, norm, max_norm, dirs, shards or {})
    else:
        salts = moment_salts(seed, count, len(order))
        for i, key in enumerate(order):
            _leaf_plain(key, params[key], grads[key], state.mu[key], state.nu[key], lr, bc1,
                        bc2, b1, b2, eps, weight_decay, salts[2 * i: 2 * i + 2],
                        stochastic_rounding, norm, max_norm, dirs.get(key),
                        None if shards is None else shards.get(key))
    if lamb:
        trust_ratio_apply(params, dirs, lr, shards)
    state.count = count
    return params, state


def fused_adam_apply_plain(params, grads, state, lr, *, b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0, stochastic_rounding=True, seed=1234, max_norm=None,
                           lamb=False, shards=None):
    """Plain twin of `fused_adam_apply`, on any device."""
    return _apply(params, grads, state, lr, b1, b2, eps, weight_decay, stochastic_rounding, seed,
                  max_norm, lamb, shards, kernel=False)


def fused_adam_apply(params, grads, state, lr, *, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0, stochastic_rounding=True, seed=1234, max_norm=None,
                     lamb=False, shards=None):
    """One fused Adam(W) step over `params` and `grads` (dicts name -> tensor,
    named like the model's parameters) and `state` (count, mu, nu), in place.
    Returns (params, state). Leaves on a card launch the kernel once for the
    whole update; leaves on the CPU run the twin; leaves on both, or on two
    cards, raise.

    max_norm (> 0) first clips the gradients by their global norm, computed
    on the device (optax.clip_by_global_norm). lamb=True makes the step
    LAMB's (optax's Adam, add_decayed_weights(weight_decay),
    scale_by_trust_ratio): the kernel writes each leaf's u + wd*p and the
    trust ratio scales it before p - lr*u'; AdamW's decay is otherwise folded
    into the update.

    shards ({name: parallel/partitioning.Shard}) names the leaves that are a
    rank's shard of a leaf split over ranks: their elements keep the whole
    leaf's indices in the stochastic rounding, and the global norm and the
    trust ratios take the whole leaves' norms."""
    kernel = bool(grads) and kernels.dispatch(params[next(iter(grads))])
    if not kernel and any(params[k].device.type != "cpu" for k in grads):
        raise ValueError("fused Adam's leaves lie on the CPU and on a card")
    return _apply(params, grads, state, lr, b1, b2, eps, weight_decay, stochastic_rounding, seed,
                  max_norm, lamb, shards, kernel)
