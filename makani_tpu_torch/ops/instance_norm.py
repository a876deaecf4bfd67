"""InstanceNorm2d at "f32" statistics: the kernels of csrc/instance_norm.cu,
their plain twins and the autograd Function over them.

Per (b, c) plane over (H, W): the float32 mean and the centred variance
mean((x - mean)^2), y = ((x - mean) * rsqrt(var + eps)) * w + b in float32,
rounded once to x's type (bf16 or float32); the affine is the channels'
slice the caller hands in. The forward kernel writes y and each plane's
float32 mean and rstd, which the Function saves with x as it was given (no
float32 copy of the activation). The backward kernel gives, with
x^ = (x - mean) rstd and g^ = g w,

    dx = rstd (g^ - mean(g^) - x^ mean(g^ x^)),

rounded once to x's type, and each plane's sum of g x^ and of g; the
wrapper sums those over the batch in a fixed order (no launch at batch 1)
for the affine's float32 gradients. The statistics travel as one (2, B, C)
float32 tensor, the mean then the rstd. The twins: `instance_norm_plain`, the
eager chain, and `instance_norm_grad_plain`, that closed form in plain
PyTorch. A CUDA tensor launches the kernel or raises; a CPU tensor runs the
twin.

InstanceNorm2d calls on the card that take the eager path instead (spatial
ranks, the "bf16" statistics) are counted in kernels.eager_calls
["instance_norm"] (`count_eager`), beside the launches.
"""

import torch

from makani_tpu_torch.ops import kernels
from makani_tpu_torch.ops.kernels import dispatch, launch, no_work

DTYPES = (torch.bfloat16, torch.float32)


def normalized_plain(xc, var, weight, bias, eps, dtype):
    """The centred float32 input xc times rsqrt(var + eps), then the affine
    (weight and bias over the channels, or None), rounded to `dtype`; and
    the rstd."""
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight[None, :, None, None] + bias[None, :, None, None]
    return y.to(dtype), rstd


def instance_norm_plain(x, weight, bias, eps):
    """The eager chain: y in x's type, and the planes' float32 statistics
    (2, B, C): the mean, then the rstd."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    xc = xf - mean
    var = xc.square().mean(dim=(-2, -1), keepdim=True)
    y, rstd = normalized_plain(xc, var, weight, bias, eps, x.dtype)
    return y, torch.stack((mean.flatten(1), rstd.flatten(1)))


def instance_norm_grad_plain(x, g, weight, stats):
    """The closed-form backward in float32 (float64 for a float64 x) from the
    statistics (2, B, C): dx in x's type, and the affine's gradients sum g x^
    and sum g over (B, H, W) (None without a weight)."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    mean, rstd = stats[..., None, None]
    xhat = (x.to(dtype) - mean) * rstd
    gf = g.to(dtype)
    ghat = gf if weight is None else gf * weight[None, :, None, None]
    dx = rstd * (ghat - ghat.mean(dim=(-2, -1), keepdim=True)
                 - xhat * (ghat * xhat).mean(dim=(-2, -1), keepdim=True))
    if weight is None:
        return dx.to(x.dtype), None, None
    return dx.to(x.dtype), (gf * xhat).sum(dim=(0, 2, 3)), gf.sum(dim=(0, 2, 3))


def _checked(x, *floats):
    """x contiguous (B, C, H, W) in bf16 or float32 within the kernels'
    32-bit counts; `floats` (the affine, the statistics; None for none)
    float32 and contiguous on x's device."""
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"instance_norm takes a 4-d bf16 or float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, c, h, w = x.shape
    if h * w >= 2**31 or b * c * 8 >= 2**31:
        raise ValueError(f"instance_norm: shape {tuple(x.shape)} exceeds the kernel's "
                         "32-bit counts")
    for t in floats:
        if t is not None and (t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"instance_norm: {t.dtype} on {t.device} beside x on {x.device}")
    return x.contiguous(), *(t if t is None else t.contiguous() for t in floats)


def _ptr(t):
    return None if t is None else t.data_ptr()


def instance_norm_forward(x, weight, bias, eps):
    """The forward kernel on a CUDA tensor (its twin on a CPU tensor): y, and
    the planes' float32 statistics (2, B, C), the mean, then the rstd."""
    if not dispatch(x):
        return instance_norm_plain(x, weight, bias, eps)
    x, weight, bias = _checked(x, weight, bias)
    b, c, h, w = x.shape
    if (weight is None) != (bias is None) or (
            weight is not None and (weight.shape != (c,) or bias.shape != (c,))):
        raise ValueError(f"instance_norm: weight and bias of {c} channels, or neither")
    stats = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    y = no_work(x.shape, 1, x.device, x.dtype)
    if y is not None:
        return y, stats.fill_(float("nan"))
    y = torch.empty_like(x)
    mean = stats.data_ptr()
    launch("instance_norm_fwd", x.device.index, x.data_ptr(), _ptr(weight), _ptr(bias),
           y.data_ptr(), mean, mean + 4 * b * c, b * c, c, h * w, float(eps),
           int(x.dtype == torch.bfloat16))
    return y, stats


def instance_norm_backward(x, g, weight, stats):
    """The backward kernel on CUDA tensors (its twin on CPU tensors): dx, and
    the affine's float32 gradients (None without a weight)."""
    if not dispatch(x):
        return instance_norm_grad_plain(x, g, weight, stats)
    x, weight, stats = _checked(x, weight, stats)
    b, c, h, w = x.shape
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"instance_norm: gradient {g.dtype} {tuple(g.shape)} on {g.device} "
                         f"for x {x.dtype} {tuple(x.shape)}")
    if stats.shape != (2, b, c) or (weight is not None and weight.shape != (c,)):
        raise ValueError(f"instance_norm: statistics {tuple(stats.shape)} for {b} x {c} planes")
    g = g.contiguous()
    sums = None if weight is None else torch.empty((2, b, c), device=x.device,
                                                   dtype=torch.float32)
    dx = no_work(x.shape, 1, x.device, x.dtype)
    if dx is not None:
        return dx, *((None, None) if sums is None else sums.zero_().sum(dim=1))
    dx = torch.empty_like(x)
    mean, dw = stats.data_ptr(), _ptr(sums)
    launch("instance_norm_bwd", x.device.index, x.data_ptr(), g.data_ptr(), _ptr(weight), mean,
           mean + 4 * b * c, dx.data_ptr(), dw, None if dw is None else dw + 4 * b * c, b * c, c,
           h * w, int(x.dtype == torch.bfloat16))
    if sums is None:
        return dx, None, None
    # sum g x^ and sum g over the batch's partials in a fixed order; at batch
    # 1 they are the sums
    dw, db = sums[:, 0] if b == 1 else sums.sum(dim=1)
    return dx, dw, db


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, stats = instance_norm_forward(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, stats = ctx.saved_tensors
        dx, dw, db = instance_norm_backward(x, g, weight, stats)
        return dx, dw, db, None


def instance_norm(x, weight, bias, eps):
    """InstanceNorm2d at "f32" statistics on x (B, C, H, W), with the affine
    `weight` and `bias` (C float32 each, or both None): one kernel each way on
    the card, x and the planes' float32 mean and rstd saved for backward.
    Where nothing needs a gradient (a forecast) the forward kernel runs
    without the autograd Function and its host time."""
    if weight is not None and weight.dtype != torch.float32:
        weight, bias = weight.float(), bias.float()
    if torch.is_grad_enabled() and (x.requires_grad or weight is not None and (
            weight.requires_grad or bias.requires_grad)):
        return _InstanceNorm.apply(x, weight, bias, eps)
    return instance_norm_forward(x, weight, bias, eps)[0]


def count_eager(x):
    """Counts a call on the card (a tensor the kernels would take) that took
    the eager path."""
    if dispatch(x):
        kernels.eager_calls["instance_norm"] += 1
