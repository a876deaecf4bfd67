"""Complex helpers and the stacked-real dhconv contraction.

Counterpart of makani_tpu/ops/complex_ops.py for the SFNO's path: complex
weights are stored as real planes and the dhconv channel mixing runs on the
stacked-real l-major layout through ops/spectral_mm.dhconv_mm.
"""

import torch

from makani_tpu_torch.ops import spectral_mm

# 3-multiplication (Karatsuba) complex products: 25% fewer tensor-core
# operations than the 4-multiplication form at the cost of ~1 extra ulp of
# rounding. Toggle for A/B testing.
_USE_3M = True


def set_3m_contraction(flag: bool):
    global _USE_3M
    _USE_3M = bool(flag)


def view_as_complex(x):
    """(..., 2) real -> (...) complex."""
    return torch.complex(x[..., 0], x[..., 1])


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
