"""Complex helpers and the spectral contractions.

Counterpart of makani_tpu/ops/complex_ops.py. The complex contraction
family (`compl_mul1d` ... `contract_rank`, `get_contract_fun`) runs
SpectralConv's complex branch, the "xla" coefficient engine of ops/sht.py:
einsums over complex64 activations and weights, split into real planes.
Weights are stored as real planes and viewed as complex at use time.
`contract_dhconv_stacked` is the dhconv channel mixing of the stacked-real
pipeline (the "kernel" and "stacked" engines, ops/spectral_mm).

Arithmetic by contraction precision (`set_contraction_precision`), the same
on every device:
  "default"     operands rounded to bf16, products and sums in float32 (one
                bf16 pass, as the TPU's DEFAULT dot);
  every other   float32 with TF32 off (PyTorch's default for matmuls). This is
                tighter than the TPU's 3-pass HIGH, which keeps about 16 bits
                of each operand.
The complex dhconv kernel (`enable_pallas_kernels`) keeps the TPU's pass
counts: 3 bf16 passes under every mode but "default", which gives 1.
"""

import torch

from makani_tpu_torch.ops import spectral_mm
from makani_tpu_torch.ops.complex_kernels import contract_dhconv_kernel

# contraction precision of makani_tpu's names (complex_ops.py:20-33): the
# transform-stage modes split2/tf32/mixed/mixed2 are "high" here, as the
# contractions act on genuine float32 coefficients
_PRECISIONS = {"default": "default", "split2": "high", "tf32": "high", "mixed": "high",
               "mixed2": "high", "high": "high", "highest": "highest"}
_PRECISION = "high"


def set_contraction_precision(name: str):
    global _PRECISION
    if name not in _PRECISIONS:
        raise ValueError(f"unknown contraction precision {name!r}; one of {sorted(_PRECISIONS)}")
    _PRECISION = _PRECISIONS[name]


def get_contraction_precision():
    return _PRECISION


def contraction_passes():
    """bf16 passes of the complex dhconv kernel: 1 under "default", else 3
    (pallas_kernels.py:57-68)."""
    return 1 if _PRECISION == "default" else 3


# 3-multiplication (Karatsuba) complex products: 25% fewer real products than
# the 4-multiplication form at the cost of ~1 extra ulp of rounding. Toggle
# for A/B testing.
_USE_3M = True


def set_3m_contraction(flag: bool):
    global _USE_3M
    _USE_3M = bool(flag)


def view_as_complex(x):
    """(..., 2) real -> (...) complex."""
    return torch.complex(x[..., 0], x[..., 1])


def view_as_real(z):
    """(...) complex -> (..., 2) real."""
    return torch.stack([z.real, z.imag], dim=-1)


def _round(a):
    """An einsum operand at the contraction precision."""
    return a.to(torch.bfloat16).float() if _PRECISION == "default" else a


def _einsum(eq, a, b):
    return torch.einsum(eq, _round(a), _round(b))


def _cplx_einsum(eq, x, w):
    """Complex einsum through real contractions, 3M or 4M."""
    xr, xi = x.real, x.imag
    wr, wi = w.real, w.imag
    rr = _einsum(eq, xr, wr)
    ii = _einsum(eq, xi, wi)
    if _USE_3M:
        # (xr+xi)(wr+wi) - rr - ii = xr*wi + xi*wr
        cross = _einsum(eq, xr + xi, wr + wi)
        return torch.complex(rr - ii, cross - rr - ii)
    ri = _einsum(eq, xr, wi)
    ir = _einsum(eq, xi, wr)
    return torch.complex(rr - ii, ri + ir)


# --- contraction zoo (complex activations x complex weights) ---

def compl_mul1d(x, w):
    return _cplx_einsum("bix,io->box", x, w)


def compl_mul2d(x, w):
    return _cplx_einsum("bixy,io->boxy", x, w)


def compl_muladd2d(x, w, b):
    return compl_mul2d(x, w) + b


def compl_exp_mul2d(x, w):
    """l-dependent channel mixing (per-l dense)."""
    return _cplx_einsum("bixy,xio->boxy", x, w)


def compl_exp_muladd2d(x, w, b):
    return compl_exp_mul2d(x, w) + b


def contract_diagonal(x, w):
    return _cplx_einsum("bixy,ioxy->boxy", x, w)


# Kernel toggle for the dhconv contraction, off by default as in makani_tpu
_USE_PALLAS_DHCONV = False


def enable_pallas_kernels(flag: bool = True):
    """Select the Hopper kernel (csrc/dhconv_complex.cu, the port of
    contract_dhconv_pallas) for `contract_dhconv`: it runs on CUDA tensors,
    and its plain twin on CPU tensors. Off, `contract_dhconv` is the complex
    einsum."""
    global _USE_PALLAS_DHCONV
    _USE_PALLAS_DHCONV = bool(flag)


def contract_dhconv(x, w):
    if _USE_PALLAS_DHCONV:
        return contract_dhconv_kernel(x, w, contraction_passes())
    return _cplx_einsum("bixy,iox->boxy", x, w)


def contract_dhconv_stacked(x, w):
    """dhconv on stacked-real l-major layouts: x (2, B, L, C, M) x
    w (2, L, C, O) -> (2, B, L, O, M); plane 0 = real, plane 1 = imag.

    Differentiable (spectral_mm.dhconv): the "kernel" coefficient engine runs
    the dhconv_mm and dhconv_dw kernels (their plain twins for CPU tensors);
    the "stacked" engine runs the plain twins on any device.
    """
    from makani_tpu_torch.ops import sht
    return spectral_mm.dhconv(x, w, sht._coeff_passes(), _USE_3M,
                              plain=sht.get_coeff_engine() == "stacked")


def contract_sep_diagonal(x, w):
    return _cplx_einsum("bixy,ixy->bixy", x, w)


def contract_sep_dhconv(x, w):
    return _cplx_einsum("bixy,ix->bixy", x, w)


def contract_rank(x, w, a, b):
    xr = _cplx_einsum("bixy,ior->borxy", x, w)
    # contract the rank dimension with the two positional factors
    ar = torch.einsum("borxy,xr->borxy", xr, a.to(xr.dtype))
    return torch.einsum("borxy,yr->boxy", ar, b.to(xr.dtype))


CONTRACT_HANDLES = {
    ("diagonal", False): contract_diagonal,
    ("dhconv", False): contract_dhconv,
    ("diagonal", True): contract_sep_diagonal,
    ("dhconv", True): contract_sep_dhconv,
}


def get_contract_fun(operator_type, separable=False):
    """The contraction of an operator type (makani_tpu's dispatch)."""
    key = (operator_type, separable)
    if key not in CONTRACT_HANDLES:
        raise ValueError(f"Unsupported operator type {operator_type} (separable={separable})")
    return CONTRACT_HANDLES[key]
