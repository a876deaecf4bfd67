"""Real activation functions by config name, and the complex activations.

Counterpart of makani_tpu/models/common/activations.py: get_activation,
ComplexReLU and ComplexActivation (their bias parameters named and shaped as
there).
"gelu" is the tanh approximation there (jax.nn.gelu's default), so it is
here too; "gelu_exact" is the erf form.

On a bfloat16 input (bf16 AMP) jax.nn.gelu rounds each of its nine steps to
bf16, where PyTorch's fused F.gelu rounds once; the two differ by one bf16
ulp in a large share of the elements, which spreads through every later
layer, so on bf16 "gelu" is ops/gelu.py's `gelu_bf16`, which gives JAX's
bits (one kernel each way on the card). Other dtypes, and the other
activations, take PyTorch's fused forms.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from makani_tpu_torch.ops.gelu import gelu_bf16


def _identity(x):
    return x


def _gelu(x):
    return gelu_bf16(x) if x.dtype == torch.bfloat16 else F.gelu(x, approximate="tanh")


def get_activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return _gelu
    if name == "gelu_exact":
        return F.gelu
    if name == "silu":
        return F.silu
    if name in ("identity", "none"):
        return _identity
    raise ValueError(f"Unknown activation function {name}")


class ComplexReLU(nn.Module):
    """Complex-valued ReLU variants: "cartesian" (leaky ReLU on both parts),
    "modulus" (shrinks |z| by a learned bias), "halfplane" (keeps z whose
    angle less the bias lies in [0, pi/2)), "real" (leaky ReLU on the real
    part). modulus and halfplane hold `bias` (bias_shape, default (1,)),
    initialized to `scale`."""

    def __init__(self, negative_slope=0.0, mode="real", bias_shape=None, scale=1.0,
                 device="cpu"):
        super().__init__()
        if mode not in ("cartesian", "modulus", "halfplane", "real"):
            raise NotImplementedError(f"Unknown complex activation mode {mode}")
        self.negative_slope = negative_slope
        self.mode = mode
        if mode in ("modulus", "halfplane"):
            shape = tuple(bias_shape) if bias_shape is not None else (1,)
            self.bias = nn.Parameter(scale * torch.ones(shape, device=device))

    def _leaky(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)

    def forward(self, z):
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        if self.mode == "cartesian":
            return torch.complex(self._leaky(z.real), self._leaky(z.imag))
        if self.mode == "modulus":
            zabs = torch.sqrt(torch.square(z.real) + torch.square(z.imag))
            cond = (zabs + self.bias) > 0
            safe = torch.where(zabs == 0, torch.ones_like(zabs), zabs)
            return torch.where(cond, ((zabs + self.bias) / safe).to(z.dtype) * z, zero)
        if self.mode == "halfplane":
            angle = torch.angle(z) - self.bias
            cond = (angle >= 0.0) & (angle < math.pi / 2.0)
            return torch.where(cond, z, self.negative_slope * z)
        return torch.complex(self._leaky(z.real), z.imag)


class ComplexActivation(nn.Module):
    """A real activation on complex inputs: on both parts ("cartesian"), or on
    the modulus plus a learned bias (`bias`, zeros) keeping the phase
    ("modulus"); any other mode passes z through."""

    def __init__(self, activation, mode="cartesian", bias_shape=None, device="cpu"):
        super().__init__()
        self.activation = activation
        self.mode = mode
        if mode == "modulus":
            shape = tuple(bias_shape) if bias_shape is not None else (1,)
            self.bias = nn.Parameter(torch.zeros(shape, device=device))

    def forward(self, z):
        if self.mode == "cartesian":
            return torch.complex(self.activation(z.real), self.activation(z.imag))
        if self.mode == "modulus":
            zabs = torch.sqrt(torch.square(z.real) + torch.square(z.imag))
            mag = self.activation(zabs + self.bias)
            return (mag * torch.exp(1j * torch.angle(z))).to(z.dtype)
        return z
