"""Real activation functions by config name.

Counterpart of get_activation in makani_tpu/models/common/activations.py.
"gelu" is the tanh approximation there (jax.nn.gelu's default), so it is
here too; "gelu_exact" is the erf form.

On a bfloat16 input (bf16 AMP) jax.nn.gelu rounds each of its nine steps to
bf16, where PyTorch's fused F.gelu rounds once; the two differ by one bf16
ulp in a large share of the elements, which spreads through every later
layer, so on bf16 "gelu" is ops/gelu.py's `gelu_bf16`, which gives JAX's
bits (one kernel each way on the card). Other dtypes, and the other
activations, take PyTorch's fused forms.
"""

import torch
import torch.nn.functional as F

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
