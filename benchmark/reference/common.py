"""Plain PyTorch pieces the references share: float32 arithmetic with TF32
off, the lower-precision control (products in fp8), the layers both model
families use, and the float32 Adam update.

Nothing here imports the program under test: the references are the
yardstick the program is held to, and work out again whatever the program
derives (tables, quadratures, inits).
"""

import math

import torch
import torch.nn.functional as F

# float8 e4m3's largest finite magnitude
_E4M3_MAX = 448.0


def strict_fp32():
    """TF32 off for every float32 product: the reference is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x):
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude onto e4m3's largest), back in x's type; the gradient
    passes straight through. The control's operands of every product."""
    if x.is_complex():
        return torch.complex(round_fp8(x.real), round_fp8(x.imag))
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def quantizer(precision):
    """The rounding applied to both operands of every product: none for
    "float32" (the reference), e4m3 for "fp8" (the control)."""
    if precision == "float32":
        return lambda x: x
    if precision == "fp8":
        return round_fp8
    raise ValueError(f"unknown reference precision {precision!r}")


def gelu(x):
    # makani's "gelu" is the tanh approximation (jax.nn.gelu's default)
    return F.gelu(x, approximate="tanh")


def conv1x1(x, weight, bias=None, q=lambda t: t):
    """(B, I, H, W) -> (B, O, H, W) by the (O, I) weight."""
    b, _, h, w = x.shape
    y = torch.matmul(q(weight), q(x.reshape(b, x.shape[1], h * w)))
    if bias is not None:
        y = y + bias[:, None]
    return y.view(b, -1, h, w)


def instance_norm(x, weight, bias, eps=1e-6):
    """Per sample and channel over (H, W): two-pass statistics, affine."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    xc = x - mean
    var = xc.square().mean(dim=(-2, -1), keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight[None, :, None, None] + bias[None, :, None, None]


def adam(params, grads, state, lr, b1, b2, eps):
    """One float32 Adam step in place (moments in `state`, created at the
    first step)."""
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m = state.setdefault(("m", k), torch.zeros_like(p))
            v = state.setdefault(("v", k), torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


def make_leaves(spec, generator, device, dtype=torch.float32):
    """The parameters of `spec` [(name, shape, init)], init ("normal", std),
    ("zeros",) or ("ones",), from one draw of `generator` on `device`: the
    normal leaves are consecutive slices of one standard normal vector."""
    total = sum(math.prod(shape) for _, shape, init in spec if init[0] == "normal")
    flat = torch.randn(total, generator=generator, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init[0] == "normal":
            out[name] = flat[at: at + n].view(shape).mul_(init[1])
            at += n
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out
