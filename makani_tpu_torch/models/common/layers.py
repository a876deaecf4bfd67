"""Core building-block layers on NCHW tensors.

Counterpart of makani_tpu/models/common/layers.py. Parameter names and shapes
follow the JAX modules so that weights carry across one to one
(tools/convert_jax_params.py). Initialization: W ~ N(0, sqrt(gain/fan_in)),
zero biases, drawn from the caller's torch.Generator. `DenseLayer` and
`LayerNorm` mirror flax.linen's Dense and LayerNorm as the AFNO v1 and ViT
networks use them (`kernel` (in, out), `scale`; flax's dtype promotion and
fast variance); `PatchEmbed` is makani_tpu's reshape-and-contract patch
embedding.

Dropout. makani_tpu draws its masks with flax's make_rng from the step's
dropout key; here every mask comes from `drop_mask`, which seeds a generator
of its own from the DropoutKey in force (a seed, the optimizer step and the
unrolled step of a multi-step forward) and the site's index (`Dropout.site`,
`DropPath.site`, numbered by the network). A forward that drops must run
under `use_dropout_key`. `remat` carries the key in force into the
recomputation, so a block recomputed in backward draws the masks of its
forward, bit for bit; it carries comm.serial_model_axes() in alike.

Channel parallelism (fin, fout). A layer reads how its leaves are stored
from spmd.leaf_axis (partitioning.shard_module tells it) and is told how its
input's channels are split (`x_axis`: None for whole, or the mesh axis);
its output's channels are split as its weight's output dimension is
(`out_axis`). `parallel_linear` is makani_tpu's fin/fout ping-pong written
out (partitioning.py:24-33): an input split over the axis that splits the
weight's input dimension is contracted locally and summed over that axis;
an input the weight wants otherwise is gathered or sliced first; a weight
split over its output dimension gets its input through copy_to. Norms over
channels sum their statistics over the split axis, and a whole affine leaf
is cut to the rank's channels through spmd.scatter. Dropout masks are drawn
at the whole channel count and cut, so every layout drops the same values.
"""

import contextlib
from collections import namedtuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from makani_tpu_torch.ops import instance_norm
from makani_tpu_torch.parallel import comm, spmd
from makani_tpu_torch.utils.tracing import span

# what a training forward's masks are drawn from: the run's seed, the
# optimizer step and the unrolled step (MultiStepWrapper)
DropoutKey = namedtuple("DropoutKey", ["seed", "step", "substep"])

# flax's lecun_normal: truncated_normal with stddev sqrt(1 / fan_in) divided
# by the standard deviation of N(0, 1) truncated to [-2, 2]
LECUN_STD = 1.0 / 0.87962566103423978

_dropout_key = None


@contextlib.contextmanager
def use_dropout_key(key):
    """Draw the dropout masks of the forwards inside from `key` (a DropoutKey,
    or None for no key)."""
    global _dropout_key
    prev, _dropout_key = _dropout_key, key
    try:
        yield
    finally:
        _dropout_key = prev


def current_dropout_key():
    return _dropout_key


def drop_mask(shape, keep, site, device):
    """Boolean keep-mask of `shape` (True with probability `keep`) for dropout
    site `site`, drawn on `device` from a generator seeded by the key in force
    and the site: the same key and site give the same mask."""
    key = _dropout_key
    if key is None:
        raise RuntimeError("dropout at a nonzero rate in training needs a dropout key: run the "
                           "forward under layers.use_dropout_key(DropoutKey(seed, step, 0))")
    entropy = [int(key.seed), int(key.step), int(key.substep), int(site)]
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(tuple(shape), generator=gen, device=device) < keep


def rank_mask(shape, keep, site, device, global_hw=None, channel=None, tokens=None):
    """drop_mask of a rank's part of a field: on several ranks the mask is
    drawn at the whole batch's shape (for a spatially split field at its
    whole (H, W) = `global_hw`, for the tokens of a rank's tile of a token
    grid along one dimension, `tokens` = (dim, (gh, gw)), at every token,
    for channels split over a mesh axis at their whole count: `channel` =
    (dim, axis, size)) and cut to the rank's part, so every rank drops what
    one rank would. Serial: drop_mask."""
    full, index = list(shape), [slice(None)] * len(shape)
    token_dim = None
    if channel is not None and channel[1] is not None and shape[channel[0]] > 1:
        d, axis, size = channel
        full[d], index[d] = size, spmd.patch_slice(size, axis)
    if spmd.data_distributed():
        b, r = shape[0], comm.get_rank("data")
        full[0], index[0] = b * comm.get_size("data"), slice(r * b, (r + 1) * b)
    if spmd.spatial_distributed() and tokens is not None and shape[tokens[0]] > 1:
        token_dim, grid = tokens[0] % len(shape), tokens[1]
        full[token_dim] = int(grid[0]) * int(grid[1])
    elif spmd.spatial_distributed() and len(shape) >= 3 and (shape[-2] > 1 or shape[-1] > 1):
        if global_hw is None:
            raise ValueError("dropout on a spatially split field needs its whole shape")
        full[-2], full[-1] = global_hw
        index[-2] = spmd.patch_slice(global_hw[0], "h")
        index[-1] = spmd.patch_slice(global_hw[1], "w")
    if full == list(shape):
        return drop_mask(shape, keep, site, device)
    mask = drop_mask(full, keep, site, device)[tuple(index)]
    if token_dim is not None:
        mask = mask.index_select(token_dim, spmd.tile_tokens(tokens[1], mask.device))
    return mask


def remat(fn, *args):
    """fn(*args), its activations recomputed in backward instead of saved
    (makani_tpu's nn.remat); a plain call when no gradient is recorded. The
    recomputation runs under the dropout key of the call, and inside
    comm.serial_model_axes() where the call was."""
    if not torch.is_grad_enabled():
        return fn(*args)
    key = _dropout_key
    serial = comm.in_serial_model_axes()

    def run(*a):
        with use_dropout_key(key), \
                (comm.serial_model_axes() if serial else contextlib.nullcontext()):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def leaf_part(module, leaf, dim, axis, size=None):
    """`module`'s parameter `leaf` as the rank's part along `dim` for
    activations split over `axis` (None: whole): the leaf as it is where it
    is stored split alike, else the rank's slice (spmd.scatter) of the whole
    leaf, gathered first (global length `size`; the backward keeps the
    rank's block of the gradient) where it is stored split otherwise."""
    t = getattr(module, leaf)
    stored = spmd.leaf_axis(module, leaf, dim)
    if stored == axis:
        return t
    if stored is not None:
        t = spmd.gather(t, dim, stored, size)
    return spmd.scatter(t, dim, axis) if axis is not None else t


def parallel_linear(x, dim, x_axis, in_axis, out_axis, size, matmul):
    """matmul(x) contracting x's dimension `dim` (global length `size`, split
    over `x_axis`) with a weight whose input dimension is split over
    `in_axis` and output dimension over `out_axis` (None: whole): the input
    is gathered or sliced to the weight's split, copied to a weight split
    over its outputs, and the partial products summed over `in_axis`. The
    result's channels are split over `out_axis`."""
    if x_axis != in_axis:
        if x_axis is not None:
            x = spmd.gather(x, dim, x_axis, size)
        if in_axis is not None:
            x = spmd.scatter(x, dim, in_axis)
    if out_axis is not None:
        x = spmd.copy_to(x, out_axis)
    y = matmul(x)
    return spmd.all_reduce_sum(y, in_axis) if in_axis is not None else y


def apply_norm(norm, x, x_axis):
    """A channel norm of this module (or nn.Identity) on `x`, whose channels
    are split over `x_axis`; the span "model.norm"."""
    if isinstance(norm, nn.Identity):
        return x
    with span("model.norm"):
        return norm(x, x_axis)


def normal_param(shape, std, device, generator):
    return nn.Parameter(std * torch.randn(shape, device=device, generator=generator))


def trunc_normal_param(shape, std, device, generator):
    """flax's truncated_normal(stddev=std): N(0, 1) truncated to [-2, 2],
    times std."""
    w = torch.empty(shape, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return nn.Parameter(std * w)


def promoted(x, param):
    """x in flax's promote_dtype of x and a parameter: float32 for a bf16
    input and a float32 parameter (flax's Dense, Conv and LayerNorm then
    compute and return float32)."""
    return x.to(torch.promote_types(x.dtype, param.dtype))


class DenseLayer(nn.Module):
    """flax.linen.Dense as makani_tpu's AFNO v1 and ViT use it: y = x @
    kernel + bias over the last axis, kernel (in, out) drawn from
    truncated_normal(0.02), in the promoted type of the input and the
    parameters."""

    def __init__(self, in_features, out_features, use_bias=True, device="cpu", generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.kernel = trunc_normal_param((in_features, out_features), 0.02, device, generator)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if use_bias else None

    @property
    def out_axis(self):
        return spmd.leaf_axis(self, "kernel", 1)

    def forward(self, x, x_axis=None):
        x = promoted(x, self.kernel)
        kernel = self.kernel.to(x.dtype)
        y = parallel_linear(x, -1, x_axis, spmd.leaf_axis(self, "kernel", 0), self.out_axis,
                            self.in_features, lambda v: v @ kernel)
        if self.bias is None:
            return y
        return y + leaf_part(self, "bias", 0, self.out_axis, self.out_features).to(x.dtype)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis with `scale` and `bias`:
    float32 statistics by flax's fast variance max(E[x^2] - E[x]^2, 0), then
    (x - mean) * (rsqrt(var + eps) * scale) + bias in the promoted type
    (float32 for a bf16 input)."""

    def __init__(self, num_features, eps=1e-6, device="cpu"):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x, x_axis=None):
        xf = promoted(x, self.scale)
        if x_axis is None:
            mean = xf.mean(-1, keepdim=True)
            msq = (xf * xf).mean(-1, keepdim=True)
        else:
            # E[x] and E[x^2] over the whole C: the rank's sums, summed over
            # the axis that splits the channels
            n = float(self.scale.shape[0])
            sums = spmd.reduce_partial(torch.stack((xf.sum(-1), (xf * xf).sum(-1))), x_axis)
            mean, msq = sums[0].unsqueeze(-1) / n, sums[1].unsqueeze(-1) / n
        var = torch.clamp_min(msq - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * leaf_part(self, "scale", 0, x_axis)
        return (xf - mean) * mul + leaf_part(self, "bias", 0, x_axis)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding: (B, C, H, W) -> (B, E, H/ph * W/pw);
    a reshape, then one contraction over (c, ph, pw) with the weight
    (E, C, ph, pw) and the bias cast to the input's type (bf16 stays bf16
    under AMP). Weight N(0, 1/fan_in), zero bias."""

    def __init__(self, img_size=(224, 224), patch_size=(16, 16), in_chans=3, embed_dim=768,
                 device="cpu", generator=None):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size = tuple(patch_size)
        ph, pw = self.patch_size
        self.weight = normal_param((embed_dim, in_chans, ph, pw),
                                   (1.0 / (in_chans * ph * pw)) ** 0.5, device, generator)
        self.bias = nn.Parameter(torch.zeros(embed_dim, device=device))

    def forward(self, x):
        """x the whole image, or on spatial ranks the rank's window of it,
        which must hold whole patches (spmd.image_tile); the tokens are the
        rank's tile of the grid, row-major."""
        b, c, h, w = x.shape
        size = self.img_size
        if spmd.spatial_distributed():
            size = spmd.image_tile(self.img_size, self.patch_size)
        if (h, w) != size:
            raise ValueError(f"Input image size ({h}*{w}) doesn't match model "
                             f"({size[0]}*{size[1]}).")
        ph, pw = self.patch_size
        gh, gw = h // ph, w // pw
        patches = x.reshape(b, c, gh, ph, gw, pw).permute(0, 2, 4, 1, 3, 5)
        weight = self.weight.to(x.dtype).reshape(self.weight.shape[0], -1)
        # (B, E, gh * gw) = W (E, K) @ patches (B, K, gh * gw); the embedding
        # channels split over the weight's E
        patches = patches.reshape(b, gh * gw, c * ph * pw).transpose(1, 2)
        y = parallel_linear(patches, 1, None, None, self.out_axis, None, lambda v: weight @ v)
        return y + leaf_part(self, "bias", 0, self.out_axis).to(x.dtype)[:, None]

    @property
    def out_axis(self):
        return spmd.leaf_axis(self, "weight", 0)


class Conv1x1(nn.Module):
    """Channel-mixing linear layer on NCHW tensors (a 1x1 convolution), run as
    one matmul over the channel dimension."""

    def __init__(self, in_features, out_features, use_bias=True, gain=1.0, device="cpu",
                 generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        std = (gain / in_features) ** 0.5
        self.weight = normal_param((out_features, in_features), std, device, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)

    @property
    def out_axis(self):
        return spmd.leaf_axis(self, "weight", 0)

    def forward(self, x, x_axis=None):
        b, h, w = x.shape[0], x.shape[2], x.shape[3]
        # bmm against the broadcast weight: matmul of a 2D by a 3D operand
        # would transpose-copy the activation in and the output out
        weight = self.weight.to(x.dtype).expand(b, -1, -1)
        y = parallel_linear(x.reshape(b, x.shape[1], h * w), 1, x_axis,
                            spmd.leaf_axis(self, "weight", 1), self.out_axis, self.in_features,
                            lambda v: torch.bmm(weight, v))
        if self.bias is not None:
            bias = leaf_part(self, "bias", 0, self.out_axis, self.out_features)
            y = y + bias.to(x.dtype)[:, None]
        return y.view(b, -1, h, w)


class Dropout(nn.Module):
    """flax's nn.Dropout: select(mask, x / keep, 0), one draw shared along
    `broadcast_dims`; the identity when deterministic or at rate 0."""

    def __init__(self, rate=0.0, broadcast_dims=()):
        super().__init__()
        self.rate = rate
        self.broadcast_dims = tuple(broadcast_dims)
        self.site = 0
        # the whole (H, W) of the field it drops on, where that is split over
        # ranks, or (dim, (gh, gw)) where dimension dim holds the tokens of a
        # rank's tile of a token grid (set by the network)
        self.global_hw = None
        self.tokens = None

    def forward(self, x, deterministic=True, channel=None):
        """`channel`: (dim, axis, size) where x's channels are split over a
        mesh axis (rank_mask)."""
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        shape = [1 if d in self.broadcast_dims else s for d, s in enumerate(x.shape)]
        tokens = {} if self.tokens is None else {"tokens": self.tokens}
        mask = rank_mask(shape, keep, self.site, x.device, self.global_hw, channel, **tokens)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Stochastic depth per sample: (x / keep) * mask with one draw a sample;
    the identity when deterministic or at rate 0."""

    def __init__(self, drop_prob=0.0):
        super().__init__()
        self.drop_prob = drop_prob
        self.site = 0

    def forward(self, x, deterministic=True):
        if self.drop_prob == 0.0 or deterministic:
            return x
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = rank_mask(shape, keep, self.site, x.device)
        return (x / keep) * mask.to(x.dtype)


def number_dropout_sites(module):
    """Give every Dropout and DropPath under `module` its site index, in
    registration order; returns the number of sites. A module that runs its
    submodules several times over (the scanned blocks) numbers its own sites
    through its `number_sites(base)`, which returns how many it took."""
    count = 0

    def visit(m):
        nonlocal count
        if isinstance(m, (Dropout, DropPath)):
            m.site = count
            count += 1
        elif hasattr(m, "number_sites"):
            count += m.number_sites(count)
        else:
            for child in m.children():
                visit(child)

    visit(module)
    return count


class MLP(nn.Module):
    """Two-layer channel MLP on NCHW tensors, dropout after the activation and
    after the output ("iid", or "features": one draw per (sample, channel)).
    checkpointing >= 2 recomputes its activations in backward instead of
    saving them."""

    def __init__(self, in_features, hidden_features=None, out_features=None, act_layer=None,
                 output_bias=True, drop_rate=0.0, drop_type="iid", gain=1.0, checkpointing=0,
                 device="cpu", generator=None):
        super().__init__()
        self.checkpointing = checkpointing
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        self.sizes = (hidden_features, out_features)
        self.act_layer = act_layer
        self.fc1 = Conv1x1(in_features, hidden_features, use_bias=True, gain=2.0,
                           device=device, generator=generator)
        self.fc2 = Conv1x1(hidden_features, out_features, use_bias=output_bias, gain=gain,
                           device=device, generator=generator)
        if drop_type not in ("iid", "features"):
            raise NotImplementedError(f"Error, drop_type {drop_type} not supported")
        dims = (2, 3) if drop_type == "features" else ()
        self.drop1 = Dropout(drop_rate, dims)
        self.drop2 = Dropout(drop_rate, dims)

    @property
    def out_axis(self):
        return self.fc2.out_axis

    def _body(self, x, deterministic, x_axis):
        hidden, out = self.fc1.out_axis, self.fc2.out_axis
        x = self.drop1(self.act_layer(self.fc1(x, x_axis)), deterministic,
                       (1, hidden, self.sizes[0]))
        return self.drop2(self.fc2(x, hidden), deterministic, (1, out, self.sizes[1]))

    def forward(self, x, deterministic=True, x_axis=None):
        """x's channels split over `x_axis`; the output's over `out_axis`."""
        if self.checkpointing >= 2:
            return remat(self._body, x, deterministic, x_axis)
        return self._body(x, deterministic, x_axis)


class EncoderDecoder(nn.Module):
    """Stack of 1x1-conv + activation layers, then a bias-free 1x1 output conv."""

    def __init__(self, num_layers, input_dim, output_dim, hidden_dim, act_layer, gain=1.0,
                 device="cpu", generator=None):
        super().__init__()
        self.act_layer = act_layer
        self.num_layers = num_layers
        current = input_dim
        for i in range(num_layers):
            self.add_module(f"fwd_{i}", Conv1x1(current, hidden_dim, use_bias=True, gain=2.0,
                                                device=device, generator=generator))
            current = hidden_dim
        self.out = Conv1x1(current, output_dim, use_bias=False, gain=gain, device=device,
                           generator=generator)

    @property
    def out_axis(self):
        return self.out.out_axis

    def forward(self, x, x_axis=None):
        """x's channels split over `x_axis`; the output's over `out_axis`."""
        for i in range(self.num_layers):
            layer = getattr(self, f"fwd_{i}")
            x, x_axis = self.act_layer(layer(x, x_axis)), layer.out_axis
        return self.out(x, x_axis)


# how InstanceNorm2d takes its statistics (makani_tpu's set_norm_stats_mode):
# "f32", the default, casts the input to float32 for two-pass statistics and
# normalizes in float32; "bf16" gives a non-float32 input one-pass statistics
# accumulated in float32, max(E[x^2] - E[x]^2, 0) with x * x rounded in the
# input's type, and normalizes and applies the affine in the input's type. A
# float32 input takes the "f32" path in either mode.
_NORM_STATS = "f32"


def set_norm_stats_mode(mode):
    global _NORM_STATS
    if mode not in ("f32", "bf16"):
        raise ValueError(f"unknown norm statistics mode {mode!r}; one of 'f32', 'bf16'")
    _NORM_STATS = mode


def get_norm_stats_mode():
    return _NORM_STATS


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalization over (H, W), optional affine;
    its statistics as `set_norm_stats_mode` says. At "f32" statistics (or a
    float32 input) off spatial ranks it runs ops/instance_norm.py: the
    kernels on the card, their twin on the CPU. Spatial ranks, whose
    statistics are summed over the spatial group, and the "bf16" statistics
    stay eager, counted on the card in kernels.eager_calls."""

    def __init__(self, num_features, eps=1e-6, affine=True, device="cpu"):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        else:
            self.weight = self.bias = None

    def _affine(self, x_axis):
        if self.weight is None:
            return None, None
        return tuple(leaf_part(self, k, 0, x_axis) for k in ("weight", "bias"))

    def forward(self, x, x_axis=None):
        """x's channels split over `x_axis` (the statistics are per channel;
        the affine is cut to the rank's channels)."""
        if _NORM_STATS == "bf16" and x.dtype != torch.float32:
            instance_norm.count_eager(x)
            return self._one_pass(x, x_axis)
        weight, bias = self._affine(x_axis)
        if not spmd.spatial_distributed():
            return instance_norm.instance_norm(x, weight, bias, self.eps)
        instance_norm.count_eager(x)
        xf = x.float()
        mean, var = self._global_stats(xf)
        return instance_norm.normalized_plain(xf - mean, var, weight, bias, self.eps, x.dtype)[0]

    def _one_pass(self, x, x_axis):
        """The "bf16" mode (makani_tpu/models/common/layers.py:186-200): the
        sums of x and of x * x (rounded in x's type) accumulated in float32,
        on spatial ranks with the patch's point count summed over the
        spatial group in one all-reduce; the mean and the rsqrt scale cast
        to x's type, the normalization and the affine in x's type."""
        b, c = x.shape[:2]
        sums = torch.stack((x.float().sum(dim=(-2, -1)), (x * x).float().sum(dim=(-2, -1))))
        count = float(x.shape[-2] * x.shape[-1])
        if spmd.spatial_distributed():
            n = x.new_full((1,), count, dtype=torch.float32)
            s = spmd.reduce_partial(torch.cat([sums.reshape(-1), n]), "spatial")
            sums, count = s[:-1].view(2, b, c), s[-1].detach()
        mean, sq = (sums / count).view(2, b, c, 1, 1)
        var = torch.clamp_min(sq - mean.square(), 0.0)
        scale = torch.rsqrt(var + self.eps)
        y = (x - mean.to(x.dtype)) * scale.to(x.dtype)
        if self.weight is not None:
            weight, bias = self._affine(x_axis)
            y = y * weight.to(x.dtype)[None, :, None, None] + bias.to(x.dtype)[None, :, None, None]
        return y

    @staticmethod
    def _global_stats(xf):
        """The two passes over the whole (H, W) of a spatially split field:
        the patch sums, with the patch's point count, summed over the spatial
        group for the mean, then the centred squares likewise."""
        b, c = xf.shape[:2]
        count = xf.new_full((1,), float(xf.shape[-2] * xf.shape[-1]))
        s = spmd.reduce_partial(torch.cat([xf.sum(dim=(-2, -1)).reshape(-1), count]),
                                "spatial")
        n = s[-1].detach()
        mean = (s[:-1] / n).view(b, c, 1, 1)
        sq = spmd.reduce_partial((xf - mean).square().sum(dim=(-2, -1)), "spatial")
        return mean, (sq / n).view(b, c, 1, 1)


class LayerNorm2d(nn.Module):
    """Per-sample normalization over the channel axis of NCHW tensors, at
    every grid point, with float32 statistics and the result cast back to the
    input's type; optional affine (makani_tpu's LayerNorm2d)."""

    def __init__(self, num_features, eps=1e-6, affine=True, device="cpu"):
        super().__init__()
        self.eps = eps
        self.num_features = num_features
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x, x_axis=None):
        """x's channels split over `x_axis`: the two passes' channel sums are
        summed over that axis."""
        xf = x.float()
        if x_axis is None:
            mean = xf.mean(dim=1, keepdim=True)
            xc = xf - mean
            var = xc.square().mean(dim=1, keepdim=True)
        else:
            n = float(self.num_features)
            mean = spmd.reduce_partial(xf.sum(dim=1, keepdim=True), x_axis) / n
            xc = xf - mean
            var = spmd.reduce_partial(xc.square().sum(dim=1, keepdim=True), x_axis) / n
        y = xc * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            weight, bias = (leaf_part(self, k, 0, x_axis) for k in ("weight", "bias"))
            y = y * weight[None, :, None, None] + bias[None, :, None, None]
        return y.to(x.dtype)
