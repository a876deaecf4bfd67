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
forward, bit for bit.
"""

import contextlib
from collections import namedtuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from makani_tpu_torch.parallel import comm, spmd

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


def rank_mask(shape, keep, site, device, global_hw=None):
    """drop_mask of a rank's part of a field: on several ranks the mask is
    drawn at the whole batch's shape (and, for a spatially split field, at
    its whole (H, W) = `global_hw`) and cut to the rank's part, so every rank
    drops what one rank would. Serial: drop_mask."""
    full, index = list(shape), [slice(None)] * len(shape)
    if spmd.data_distributed():
        b, r = shape[0], comm.get_rank("data")
        full[0], index[0] = b * comm.get_size("data"), slice(r * b, (r + 1) * b)
    if spmd.spatial_distributed() and len(shape) >= 3 and (shape[-2] > 1 or shape[-1] > 1):
        if global_hw is None:
            raise NotImplementedError("dropout on a spatially split field needs its whole "
                                      "shape " + comm.TENSOR_PARALLEL_TODO)
        full[-2], full[-1] = global_hw
        index[-2] = spmd.patch_slice(global_hw[0], "h")
        index[-1] = spmd.patch_slice(global_hw[1], "w")
    if full == list(shape):
        return drop_mask(shape, keep, site, device)
    return drop_mask(full, keep, site, device)[tuple(index)]


def remat(fn, *args):
    """fn(*args), its activations recomputed in backward instead of saved
    (makani_tpu's nn.remat); a plain call when no gradient is recorded. The
    recomputation runs under the dropout key of the call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    key = _dropout_key

    def run(*a):
        with use_dropout_key(key):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


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
        self.kernel = trunc_normal_param((in_features, out_features), 0.02, device, generator)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if use_bias else None

    def forward(self, x):
        x = promoted(x, self.kernel)
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


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

    def forward(self, x):
        xf = promoted(x, self.scale)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean) * mul + self.bias


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
        b, c, h, w = x.shape
        if (h, w) != self.img_size:
            raise ValueError(f"Input image size ({h}*{w}) doesn't match model "
                             f"({self.img_size[0]}*{self.img_size[1]}).")
        ph, pw = self.patch_size
        gh, gw = h // ph, w // pw
        patches = x.reshape(b, c, gh, ph, gw, pw).permute(0, 2, 4, 1, 3, 5)
        weight = self.weight.to(x.dtype).reshape(self.weight.shape[0], -1)
        # (B, E, gh * gw) = W (E, K) @ patches (B, K, gh * gw)
        y = weight @ patches.reshape(b, gh * gw, c * ph * pw).transpose(1, 2)
        return y + self.bias.to(x.dtype)[:, None]


class Conv1x1(nn.Module):
    """Channel-mixing linear layer on NCHW tensors (a 1x1 convolution), run as
    one matmul over the channel dimension."""

    def __init__(self, in_features, out_features, use_bias=True, gain=1.0, device="cpu",
                 generator=None):
        super().__init__()
        std = (gain / in_features) ** 0.5
        self.weight = normal_param((out_features, in_features), std, device, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)

    def forward(self, x):
        b, c, h, w = x.shape
        # bmm against the broadcast weight: matmul of a 2D by a 3D operand
        # would transpose-copy the activation in and the output out
        weight = self.weight.to(x.dtype).expand(b, -1, -1)
        y = torch.bmm(weight, x.reshape(b, c, h * w))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None]
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
        # ranks (set by the network)
        self.global_hw = None

    def forward(self, x, deterministic=True):
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        shape = [1 if d in self.broadcast_dims else s for d, s in enumerate(x.shape)]
        mask = rank_mask(shape, keep, self.site, x.device, self.global_hw)
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

    def _body(self, x, deterministic):
        x = self.drop1(self.act_layer(self.fc1(x)), deterministic)
        return self.drop2(self.fc2(x), deterministic)

    def forward(self, x, deterministic=True):
        if self.checkpointing >= 2:
            return remat(self._body, x, deterministic)
        return self._body(x, deterministic)


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

    def forward(self, x):
        for i in range(self.num_layers):
            x = self.act_layer(getattr(self, f"fwd_{i}")(x))
        return self.out(x)


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalization over (H, W) with float32 two-pass
    statistics (makani_tpu's "f32" stats mode), optional affine."""

    def __init__(self, num_features, eps=1e-6, affine=True, device="cpu"):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        xf = x.float()
        if spmd.spatial_distributed():
            mean, var = self._global_stats(xf)
            xc = xf - mean
        else:
            mean = xf.mean(dim=(-2, -1), keepdim=True)
            xc = xf - mean
            var = xc.square().mean(dim=(-2, -1), keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)

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
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        xc = xf - mean
        var = xc.square().mean(dim=1, keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)
