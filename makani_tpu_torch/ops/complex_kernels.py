"""The complex dhconv contraction as a Hopper kernel.

Counterpart of makani_tpu/ops/pallas_kernels.py: `contract_dhconv_pallas`
computes ``einsum('bilm,iol->bolm')`` on complex64 x (B, C, L, M) and
w (C, O, L), giving (B, O, L, M), in the 3M form of `_dhconv_kernel`:

  rr = wr.xr, ii = wi.xi, cross = (wr + wi).(xr + xi)
  re = rr - ii, im = (cross - rr) - ii

each real product split into bf16 parts and summed as (hh + hl) + lh
(passes 3) or hh alone (passes 1), the weight the first operand. The kernel
is csrc/dhconv_complex.cu (CUDA C++ for sm_90a), which reads x and writes the
output in their complex64 layouts and reads the weight in place, through its
strides and its conjugate bit, into a prepared copy in scratch once a call.

  contract_dhconv_plain   the plain PyTorch twin: the same splits, products
                          and sums in the same order, on any device
  contract_dhconv_raw     the raw wrapper: launches the kernel on CUDA
                          tensors (no launch where there is nothing to
                          compute: an empty output, or zeros for C = 0), runs
                          the twin on CPU tensors, carries no gradient and
                          refuses inputs that require one
  contract_dhconv_kernel  the differentiable wrapper (the custom VJP of
                          contract_dhconv_pallas), a torch.autograd.Function

complex_ops.contract_dhconv passes the pass count of its contraction
precision: 3 under every mode but "default", which gives 1.

Gradients follow PyTorch's convention for complex tensors, the conjugate of
JAX's cotangents (which is why makani_tpu's `_dhconv_bwd` transposes without
conjugating): dx = sum_o g . conj(w), the kernel on the lazy view
w.conj().transpose(0, 1), which it reads without a copy; dw = sum_{b,m}
conj(x) . g, a complex64 einsum in float32, as makani_tpu's dw is an einsum
outside the kernel.
"""

import torch
from torch.autograd.function import once_differentiable

from makani_tpu_torch.ops.kernels import dispatch, launch, no_work
from makani_tpu_torch.ops.spectral_mm import dhconv_weight_scratch, no_grad_through, split_bf16

_WRAPPER = "complex_kernels.contract_dhconv_kernel"


def _shapes(x, w):
    if x.dtype != torch.complex64 or w.dtype != torch.complex64:
        raise TypeError(f"contract_dhconv takes complex64, got {x.dtype} and {w.dtype}")
    if x.ndim != 4 or w.ndim != 3:
        raise ValueError(f"expected x (B, C, L, M) and w (C, O, L), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    B, C, L, M = x.shape
    if (w.shape[0], w.shape[2]) != (C, L):
        raise ValueError(f"x {tuple(x.shape)} does not contract with w {tuple(w.shape)}")
    return B, C, w.shape[1], L, M


def _check_passes(passes):
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")


def contract_dhconv_plain(x, w, passes=3):
    """Plain twin of the kernel: x (B, C, L, M), w (C, O, L) complex64 ->
    (B, O, L, M) complex64."""
    no_grad_through("contract_dhconv_plain", _WRAPPER, x, w)
    _shapes(x, w)
    _check_passes(passes)
    xr = x.real.permute(0, 2, 1, 3)          # (B, L, C, M)
    xi = x.imag.permute(0, 2, 1, 3)
    wr = w.real.permute(2, 1, 0)             # (L, O, C): the weight as first operand
    wi = w.imag.permute(2, 1, 0)

    def dot(a, b):
        ah, al = split_bf16(a)
        bh, bl = split_bf16(b)
        if passes == 1:
            return torch.matmul(ah, bh)
        return (torch.matmul(ah, bh) + torch.matmul(ah, bl)) + torch.matmul(al, bh)

    rr = dot(wr, xr)
    ii = dot(wi, xi)
    cross = dot(wr + wi, xr + xi)
    out = torch.complex(rr - ii, (cross - rr) - ii)  # (B, L, O, M)
    return out.permute(0, 2, 1, 3).contiguous()


def contract_dhconv_raw(x, w, passes=3):
    """The kernel on CUDA tensors (its twin on CPU tensors): x (B, C, L, M),
    w (C, O, L) complex64 -> (B, O, L, M) complex64. The kernel reads w in
    place through its strides and its conjugate bit; a conjugated or strided
    x is resolved into a contiguous copy first."""
    no_grad_through("contract_dhconv_raw", _WRAPPER, x, w)
    B, C, O, L, M = _shapes(x, w)
    _check_passes(passes)
    if not dispatch(x):
        return contract_dhconv_plain(x, w, passes)
    if w.device != x.device:
        raise ValueError(f"tensors on different devices: {w.device} vs {x.device}")
    # the kernel reads memory: x's lazy conjugation or strides would be read
    # as the plain values of the underlying storage; w's are passed to it
    out = no_work((B, O, L, M), C, x.device, torch.complex64)
    if out is not None:
        return out
    x = x.resolve_conj().contiguous()
    w = w.resolve_neg()
    if max(abs(s) for s in w.stride()) >= 2**31:
        raise ValueError(f"w's strides {w.stride()} exceed the kernel's 32-bit indices")
    out = torch.empty((B, O, L, M), device=x.device, dtype=torch.complex64)
    scratch = dhconv_weight_scratch(L, C, O, 3, 2 if passes == 3 else 1, x.device)
    launch("dhconv_complex", x.device.index, x.data_ptr(), w.data_ptr(), scratch.data_ptr(),
           out.data_ptr(), B, C, O, L, M, *w.stride(), int(w.is_conj()), passes, passes=passes)
    return out


class _ContractDhconv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, passes):
        ctx.save_for_backward(x, w)
        ctx.passes = passes
        return contract_dhconv_raw(x, w, passes)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[b, i, l, m] = sum_o conj(w[i, o, l]) g[b, o, l, m]
            dx = contract_dhconv_raw(g, w.conj().transpose(0, 1), ctx.passes)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("bilm,bolm->iol", x.conj(), g)
        return dx, dw, None


def contract_dhconv_kernel(x, w, passes):
    """Differentiable complex dhconv contraction (contract_dhconv_pallas):
    x (B, C, L, M), w (C, O, L) complex64 -> (B, O, L, M)."""
    return _ContractDhconv.apply(x, w, passes)
