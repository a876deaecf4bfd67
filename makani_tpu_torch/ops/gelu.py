"""GELU (tanh form) on bf16 activations: the kernels of csrc/gelu.cu, their
plain twins and the autograd Function over them.

jax.nn.gelu on a bf16 input is a chain of nine bf16 operations, each rounded
to bf16, its constants too (bf16 AMP in makani_tpu); PyTorch's fused F.gelu
computes in float32 and rounds once, and the two differ by one bf16 ulp in a
large share of the elements (tests/test_torch_port_amp.py measures it). The
forward kernel gives the chain's bits in one pass; its twin,
`gelu_bf16_plain`, is the chain itself. The gradient kernel gives the bits of
jax.nn.gelu's VJP on bf16, a chain of bf16 operations too, from x alone; its
twin is `gelu_bf16_grad_plain`. The Function saves x alone.
"""

import math

import torch

from makani_tpu_torch.ops.kernels import dispatch, launch, no_work

# jax.nn.gelu's constants as bf16 rounds them (csrc/gelu.cu's kS and kC)
SQRT_2_OVER_PI = float(torch.tensor(math.sqrt(2 / math.pi)).bfloat16())  # 0.796875
C3 = float(torch.tensor(0.044715).bfloat16())                             # 0.044677734375


def gelu_bf16_plain(x):
    """x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))) in jax.nn.gelu's
    order, x^3 as (x x) x, every step a bf16 operation."""
    cdf = 0.5 * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + C3 * (x * x * x))))
    return x * cdf


def gelu_bf16_grad_plain(x, g):
    """g through jax.nn.gelu's VJP at x, the operations of its jaxpr in its
    order, every step a bf16 operation."""
    p = x * x
    t = torch.tanh(SQRT_2_OVER_PI * (x + C3 * (p * x)))
    l = 0.5 * (1.0 + t)
    a = (0.5 * (x * g)) * (1.0 - t)
    r = SQRT_2_OVER_PI * (a + a * t)
    return (g * l + r) + (C3 * r) * (3.0 * p)


def _checked(name, *tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} takes bf16 tensors, got {t.dtype}")
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: shapes {[tuple(a.shape) for a in tensors]} differ")
    if tensors[0].numel() >= 2**31:
        raise ValueError(f"{name}: {tensors[0].numel()} elements exceed the kernel's 32-bit count")
    return [t.contiguous() for t in tensors]


def gelu_bf16_forward(x):
    """The forward kernel on a CUDA tensor (its twin on a CPU tensor)."""
    if not dispatch(x):
        return gelu_bf16_plain(x)
    (x,) = _checked("gelu_bf16", x)
    out = no_work(x.shape, 1, x.device, torch.bfloat16)
    if out is not None:
        return out
    y = torch.empty_like(x)
    launch("gelu_bf16", x.device.index, x.data_ptr(), y.data_ptr(), x.numel())
    return y


def gelu_bf16_backward(x, g):
    """The gradient kernel on CUDA tensors (its twin on CPU tensors)."""
    if not dispatch(x):
        return gelu_bf16_grad_plain(x, g)
    x, g = _checked("gelu_bf16_grad", x, g)
    if g.device != x.device:
        raise ValueError(f"tensors on different devices: {g.device} vs {x.device}")
    out = no_work(x.shape, 1, x.device, torch.bfloat16)
    if out is not None:
        return out
    dx = torch.empty_like(x)
    launch("gelu_bf16_grad", x.device.index, x.data_ptr(), g.data_ptr(), dx.data_ptr(),
           x.numel())
    return dx


class _GeluBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_bf16_forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return gelu_bf16_backward(x, g)


def gelu_bf16(x):
    """GELU on a bf16 tensor: jax.nn.gelu's bits forward, one kernel each way
    on the card, x alone saved for backward."""
    return _GeluBf16.apply(x)
