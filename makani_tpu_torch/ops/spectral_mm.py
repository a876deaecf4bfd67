"""Multi-pass bf16 matmuls of the SFNO's coefficient stage, as Hopper kernels.

Counterpart of makani_tpu/ops/pallas_mm.py. Three kernels carry the spectral
filter forward and backward, and a fourth is the grid-side matmul of the
longitude DFT, each written in CUDA C++ for sm_90a (makani_tpu_torch/csrc/)
and bound through a plain C interface loaded with ctypes:

  legmm      per-m Legendre contraction of every SHT and inverse SHT
             (replaces pallas_mm.legmm / _legmm_kernel)
  dhconv_mm  per-l complex channel mixing of the dhconv filter, and its dx
             (replaces pallas_mm.dhconv_mm / _dhconv_mm_kernel)
  dhconv_dw  the dhconv filter's weight gradient
             (replaces pallas_mm.dhconv_dw / _dhconv_dw_kernel)
  gridmm     (R, K) @ (K, N) with a resident table, bf16 or float32 in and out
             (replaces pallas_mm.gridmm / _gridmm_kernel; no model path of
             makani_tpu calls it, the kernel benchmarks do)

`legdot` and `dhconv` are the differentiable wrappers, the counterparts of
pallas_mm's custom VJPs: torch.autograd.Functions whose forward and backward
both run the kernels. The raw wrappers carry no gradient and raise when asked
to.

`passes` selects the accuracy point of the bf16 operand split
(hi = bf16(a), lo = bf16(a - hi)), products accumulated in float32:
  1 = both operands bf16
  2 = first operand bf16, second operand split
  3 = ah*bh + (ah*bl + al*bh), about 16 bits per operand

Each wrapper runs its kernel on a CUDA tensor or raises; on a CPU tensor it
runs the plain PyTorch twin (`legmm_plain`, `dhconv_mm_plain`,
`dhconv_dw_plain`, `gridmm_plain`), which repeats the kernel's arithmetic.
ops/kernels.py builds the kernels and counts their launches.
"""

import torch
from torch.autograd.function import once_differentiable

from makani_tpu_torch.ops.kernels import dispatch, launcher, launches, raise_on


def _check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")


def no_grad_through(name, wrapper, *tensors):
    """The raw wrappers and twins carry no gradient: a kernel's output has no
    grad_fn, and autograd through a twin would round every gradient to bf16
    in `split_bf16`. Differentiate through `wrapper` instead, where there is
    one (None: the kernel has no VJP, as in makani_tpu)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if wrapper is None:
            raise RuntimeError(f"{name} carries no gradient (no VJP, as in makani_tpu)")
        raise RuntimeError(f"{name} carries no gradient; call {wrapper}, "
                           "whose backward runs the kernels")


# --------------------------------------------------------------------------
# plain twins: the kernels' arithmetic in PyTorch
# --------------------------------------------------------------------------

def split_bf16(a):
    """hi = bf16(a), lo = bf16(a - hi), both returned as float32."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def _mp_matmul(a, b, passes):
    """Multi-pass matmul of float32 a and b: bf16 parts, float32 products
    (exact for bf16 x bf16) and float32 sums, in the order of the kernels."""
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    if passes == 1:
        return torch.matmul(ah, bh)
    if passes == 2:
        return torch.matmul(ah, bh) + torch.matmul(ah, bl)
    return torch.matmul(ah, bh) + (torch.matmul(ah, bl) + torch.matmul(al, bh))


def _legmm_shapes(z, p, contract):
    if contract not in ("k", "l"):
        raise ValueError(f"contract must be 'k' or 'l', got {contract!r}")
    if z.ndim != 3 or p.ndim != 3 or z.shape[0] < 1:
        raise ValueError(f"expected z (M2, C, D) and p (mmax, L, K), got {tuple(z.shape)} and "
                         f"{tuple(p.shape)}")
    M2, C, D = z.shape
    mmax, L, K = p.shape
    if D != (K if contract == "k" else L):
        raise ValueError(f"z {tuple(z.shape)} does not contract with p {tuple(p.shape)}")
    return M2, mmax, C, L, K


def legmm_plain(z, p, passes=3, contract="k"):
    """Plain twin of `legmm`: row g of z against table g % mmax."""
    no_grad_through("legmm_plain", "spectral_mm.legdot", z, p)
    M2, mmax, C, L, K = _legmm_shapes(z, p, contract)
    table = p[torch.arange(M2, device=p.device) % mmax]
    if contract == "k":
        table = table.transpose(-1, -2)
    return _mp_matmul(z, table, passes)


def legmm(z, p, passes=3, contract="k"):
    """Per-m Legendre contraction; row g of z meets table g % mmax, as in
    pallas_mm.legmm. The stacked layout (M2 = 2*mmax: re rows, then im rows)
    shares one (mmax, L, K) table between the re and im rows; the paired
    layout (M2 = mmax, re and im side by side in C) is a plain batched
    product. Any M2 >= 1 is taken.

    contract="k": analysis  (M2, C, K) x (mmax, L, K) -> (M2, C, L)
    contract="l": synthesis (M2, C, L) x (mmax, L, K) -> (M2, C, K)
    """
    no_grad_through("legmm", "spectral_mm.legdot", z, p)
    M2, mmax, C, L, K = _legmm_shapes(z, p, contract)
    if not dispatch(z):
        return legmm_plain(z, p, passes, contract)
    _check_cuda(z, p)
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if M2 > 65535:
        raise ValueError(f"M2 = {M2} exceeds the kernel's grid limit")
    out = torch.empty((M2, C, L if contract == "k" else K), device=z.device,
                      dtype=torch.float32)
    launch = launcher("legmm")
    with torch.cuda.device(z.device):
        rc = launch(z.data_ptr(), p.data_ptr(), out.data_ptr(), M2, mmax, C, L, K,
                    int(contract == "k"), passes, torch.cuda.current_stream().cuda_stream)
    raise_on(rc, "legmm")
    launches["legmm"] += 1
    return out


def _dhconv_shapes(x, w, wdim):
    if wdim not in (0, 1):
        raise ValueError(f"wdim must be 0 or 1, got {wdim}")
    if x.ndim != 5 or w.ndim != 4 or x.shape[0] != 2 or w.shape[0] != 2:
        raise ValueError(f"expected x (2,B,L,Ci,M) and w (2,L,C,O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    _, B, L, Ci, M = x.shape
    _, Lw, C, O = w.shape
    if Lw != L or Ci != (C if wdim == 0 else O):
        raise ValueError(f"x {tuple(x.shape)} does not contract with w {tuple(w.shape)}")
    return B, L, C, O, M


def dhconv_mm_plain(x, w, passes=3, m3=True, wdim=0, conj_w=False):
    """Plain twin of `dhconv_mm`."""
    no_grad_through("dhconv_mm_plain", "spectral_mm.dhconv", x, w)
    _dhconv_shapes(x, w, wdim)
    wr, wi = w[0], (-w[1] if conj_w else w[1])
    xr, xi = x[0], x[1]

    def mp(a, b):
        # (L, C, O) weight as the first operand: contract C (wdim 0) or O (wdim 1)
        a = a.transpose(-1, -2) if wdim == 0 else a
        return _mp_matmul(a, b, passes)

    rr = mp(wr, xr)
    ii = mp(wi, xi)
    if m3:
        cross = mp(wr + wi, xr + xi)
        return torch.stack([rr - ii, cross - rr - ii])
    return torch.stack([rr - ii, mp(wr, xi) + mp(wi, xr)])


def dhconv_mm(x, w, passes=3, m3=True, wdim=0, conj_w=False):
    """x (2, B, L, Cin, M) [stacked re/im], w (2, L, C, O) -> (2, B, L, Cout, M).

    wdim=0 contracts w's C dim (forward: Cin=C, Cout=O);
    wdim=1 contracts w's O dim (backward dx: Cin=O, Cout=C).
    conj_w negates w's imaginary plane in the kernel (cotangent rules).
    m3 selects the 3-multiplication complex product, else 4.
    """
    no_grad_through("dhconv_mm", "spectral_mm.dhconv", x, w)
    B, L, C, O, M = _dhconv_shapes(x, w, wdim)
    if not dispatch(x):
        return dhconv_mm_plain(x, w, passes, m3, wdim, conj_w)
    _check_cuda(x, w)
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if B * L > 65535:
        raise ValueError(f"B*L = {B * L} exceeds the kernel's grid limit")
    co = O if wdim == 0 else C
    out = torch.empty((2, B, L, co, M), device=x.device, dtype=torch.float32)
    launch = launcher("dhconv_mm")
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, L, C, O, M, wdim,
                    int(conj_w), int(m3), passes, torch.cuda.current_stream().cuda_stream)
    raise_on(rc, "dhconv_mm")
    launches["dhconv_mm"] += 1
    return out


def _dhconv_dw_shapes(x, g):
    if x.ndim != 5 or g.ndim != 5 or x.shape[0] != 2 or g.shape[0] != 2:
        raise ValueError(f"expected x (2,B,L,C,M) and g (2,B,L,O,M), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    _, B, L, C, M = x.shape
    if (g.shape[1], g.shape[2], g.shape[4]) != (B, L, M):
        raise ValueError(f"x {tuple(x.shape)} does not contract with g {tuple(g.shape)}")
    return B, L, C, g.shape[3], M


def dhconv_dw_plain(x, g, passes=3, m3=True):
    """Plain twin of `dhconv_dw`: the per-b products of _dhconv_dw_kernel,
    summed over b in order."""
    no_grad_through("dhconv_dw_plain", "spectral_mm.dhconv", x, g)
    B = _dhconv_dw_shapes(x, g)[0]

    def mp(a, b):
        # x (L, C, M) as the first operand, contracted with g (L, O, M) over M
        return _mp_matmul(a, b.transpose(-1, -2), passes)

    out = None
    for b in range(B):
        xr, xi, gr, gi = x[0, b], x[1, b], g[0, b], g[1, b]
        rr = mp(xr, gr)
        ii = mp(xi, gi)
        if m3:
            part = torch.stack([rr + ii, mp(xr - xi, gr + gi) - rr + ii])
        else:
            part = torch.stack([rr + ii, mp(xr, gi) - mp(xi, gr)])
        out = part if out is None else out + part
    return out


def dhconv_dw(x, g, passes=3, m3=True):
    """Weight gradient of the dhconv filter: x (2, B, L, C, M), g (2, B, L, O, M)
    -> dw (2, L, C, O), dw[l] = sum over b, m of conj(x[b, l]) . g[b, l]^T."""
    no_grad_through("dhconv_dw", "spectral_mm.dhconv", x, g)
    B, L, C, O, M = _dhconv_dw_shapes(x, g)
    if not dispatch(x):
        return dhconv_dw_plain(x, g, passes, m3)
    _check_cuda(x, g)
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if L > 65535:
        raise ValueError(f"L = {L} exceeds the kernel's grid limit")
    out = torch.empty((2, L, C, O), device=x.device, dtype=torch.float32)
    launch = launcher("dhconv_dw")
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), g.data_ptr(), out.data_ptr(), B, L, C, O, M, int(m3), passes,
                    torch.cuda.current_stream().cuda_stream)
    raise_on(rc, "dhconv_dw")
    launches["dhconv_dw"] += 1
    return out


_GRID_DTYPES = (torch.float32, torch.bfloat16)


def _gridmm_checks(x, t, passes, out_dtype):
    if x.ndim != 2 or t.ndim != 2 or x.shape[1] != t.shape[0]:
        raise ValueError(f"expected x (R, K) and t (K, N), got {tuple(x.shape)} and "
                         f"{tuple(t.shape)}")
    if x.dtype not in _GRID_DTYPES or t.dtype != torch.float32 or out_dtype not in _GRID_DTYPES:
        raise TypeError(f"gridmm takes x float32 or bfloat16, t float32 and out_dtype float32 or "
                        f"bfloat16, got {x.dtype}, {t.dtype} and {out_dtype}")
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")


def gridmm_plain(x, t, passes=3, out_dtype=torch.float32):
    """Plain twin of `gridmm`: _mp_matmul's sum hh + (hl + lh) in float32 (a
    bf16 x splits with lo = 0), rounded once to `out_dtype`."""
    no_grad_through("gridmm_plain", None, x, t)
    _gridmm_checks(x, t, passes, out_dtype)
    return _mp_matmul(x.float(), t, passes).to(out_dtype)


def gridmm(x, t, passes=3, out_dtype=torch.float32):
    """(R, K) @ (K, N) -> (R, N) in multi-pass bf16 with float32 accumulation,
    the table resident (pallas_mm.gridmm): x float32 or bfloat16, t float32,
    the output float32 or bfloat16, rounded once from the float32 sum.

    pallas_mm.gridmm's row tile `tr` has no counterpart: the kernel tiles the
    rows itself (64 a block) and masks the ragged edges of R, K and N, so
    nothing is padded or copied. No VJP, as in makani_tpu: the wrapper
    refuses inputs that require grad.
    """
    no_grad_through("gridmm", None, x, t)
    _gridmm_checks(x, t, passes, out_dtype)
    if not dispatch(x):
        return gridmm_plain(x, t, passes, out_dtype)
    if t.device != x.device:
        raise ValueError(f"tensors on different devices: {t.device} vs {x.device}")
    if not (x.is_contiguous() and t.is_contiguous()):
        raise ValueError("kernel takes contiguous tensors")
    (R, K), N = x.shape, t.shape[1]
    out = torch.empty((R, N), device=x.device, dtype=out_dtype)
    launch = launcher("gridmm")
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), t.data_ptr(), out.data_ptr(), R, K, N,
                    int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), passes,
                    torch.cuda.current_stream().cuda_stream)
    raise_on(rc, "gridmm")
    launches["gridmm"] += 1
    return out


# --------------------------------------------------------------------------
# differentiable wrappers: torch.autograd.Functions over the raw wrappers
# (pallas_mm.legdot / pallas_mm.dhconv custom VJPs). Forward and backward both
# run the kernels on CUDA tensors and the twins on CPU tensors; autograd never
# enters a twin. Cotangents can arrive as non-contiguous views and are made
# contiguous here: the kernels take contiguous tensors only.
# --------------------------------------------------------------------------

class _LegDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, p, contract, passes, plain):
        ctx.save_for_backward(p)
        ctx.contract, ctx.passes, ctx.plain = contract, passes, plain
        return (legmm_plain if plain else legmm)(z, p, passes, contract)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # the contraction is linear in z; its transpose is the opposite-direction
        # contraction against the same table. The table is a constant of the
        # transform and gets no gradient.
        (p,) = ctx.saved_tensors
        dz = None
        if ctx.needs_input_grad[0]:
            other = "l" if ctx.contract == "k" else "k"
            dz = (legmm_plain if ctx.plain else legmm)(g.contiguous(), p, ctx.passes, other)
        return dz, None, None, None, None


def legdot(z, p, contract="k", passes=3, plain=False):
    """Differentiable `legmm` (pallas_mm.legdot). plain=True runs the twin on
    any device (the "stacked" coefficient engine)."""
    return _LegDot.apply(z, p, contract, passes, plain)


class _DhConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, passes, m3, plain):
        ctx.save_for_backward(x, w)
        ctx.passes, ctx.m3, ctx.plain = passes, m3, plain
        return (dhconv_mm_plain if plain else dhconv_mm)(x, w, passes, m3)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # complex-linear cotangents: dx = g . conj(w) (contract O),
        # dw = conj(x) . g (contract B and M)
        x, w = ctx.saved_tensors
        g = g.contiguous()
        mm, dw_fn = (dhconv_mm_plain, dhconv_dw_plain) if ctx.plain else (dhconv_mm, dhconv_dw)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm(g, w, ctx.passes, ctx.m3, wdim=1, conj_w=True)
        if ctx.needs_input_grad[1]:
            dw = dw_fn(x, g, ctx.passes, ctx.m3)
        return dx, dw, None, None, None


def dhconv(x, w, passes=3, m3=True, plain=False):
    """Differentiable `dhconv_mm` (pallas_mm.dhconv): x (2, B, L, C, M),
    w (2, L, C, O) -> (2, B, L, O, M). plain=True runs the twins on any
    device (the "stacked" coefficient engine)."""
    return _DhConv.apply(x, w, passes, m3, plain)
