"""Core building-block layers on NCHW tensors.

Counterpart of makani_tpu/models/common/layers.py. Parameter names and shapes
follow the JAX modules so that weights carry across one to one
(tools/convert_jax_params.py). Initialization: W ~ N(0, sqrt(gain/fan_in)),
zero biases, drawn from the caller's torch.Generator.
"""

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def remat(fn, *args):
    """fn(*args), its activations recomputed in backward instead of saved
    (makani_tpu's nn.remat); a plain call when no gradient is recorded."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def normal_param(shape, std, device, generator):
    return nn.Parameter(std * torch.randn(shape, device=device, generator=generator))


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


def _eval_only(drop_rate, deterministic, what):
    if drop_rate > 0.0 and not deterministic:
        raise NotImplementedError(f"{what} at a nonzero rate in training is not ported yet "
                                  "(ROADMAP: Queue 1, dropout in training)")


class DropPath(nn.Module):
    """Stochastic depth per sample; the identity in deterministic (serving) use."""

    def __init__(self, drop_prob=0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x, deterministic=True):
        _eval_only(self.drop_prob, deterministic, "DropPath")
        return x


class MLP(nn.Module):
    """Two-layer channel MLP on NCHW tensors (dropout is the identity when
    deterministic). checkpointing >= 2 recomputes its activations in
    backward instead of saving them."""

    def __init__(self, in_features, hidden_features=None, out_features=None, act_layer=None,
                 output_bias=True, drop_rate=0.0, gain=1.0, checkpointing=0, device="cpu",
                 generator=None):
        super().__init__()
        self.checkpointing = checkpointing
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        self.act_layer = act_layer
        self.drop_rate = drop_rate
        self.fc1 = Conv1x1(in_features, hidden_features, use_bias=True, gain=2.0,
                           device=device, generator=generator)
        self.fc2 = Conv1x1(hidden_features, out_features, use_bias=output_bias, gain=gain,
                           device=device, generator=generator)

    def _body(self, x):
        return self.fc2(self.act_layer(self.fc1(x)))

    def forward(self, x, deterministic=True):
        _eval_only(self.drop_rate, deterministic, "MLP dropout")
        return remat(self._body, x) if self.checkpointing >= 2 else self._body(x)


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
        mean = xf.mean(dim=(-2, -1), keepdim=True)
        xc = xf - mean
        var = xc.square().mean(dim=(-2, -1), keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)
