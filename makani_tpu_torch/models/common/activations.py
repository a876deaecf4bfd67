"""Real activation functions by config name.

Counterpart of get_activation in makani_tpu/models/common/activations.py.
"gelu" is the tanh approximation there (jax.nn.gelu's default), so it is
here too; "gelu_exact" is the erf form.
"""

from functools import partial

import torch.nn.functional as F


def _identity(x):
    return x


def get_activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return partial(F.gelu, approximate="tanh")
    if name == "gelu_exact":
        return F.gelu
    if name == "silu":
        return F.silu
    if name in ("identity", "none"):
        return _identity
    raise ValueError(f"Unknown activation function {name}")

