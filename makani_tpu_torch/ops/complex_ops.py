"""Complex helpers and the stacked-real dhconv contraction.

Counterpart of makani_tpu/ops/complex_ops.py for the serving path: complex
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

    The "kernel" coefficient engine runs the dhconv_mm kernel (its plain twin
    for CPU tensors); the "stacked" engine runs the plain twin on any device.
    """
    from makani_tpu_torch.ops import sht
    passes = sht._coeff_passes()
    if sht.get_coeff_engine() == "kernel":
        return spectral_mm.dhconv_mm(x, w, passes=passes, m3=_USE_3M)
    return spectral_mm.dhconv_mm_plain(x, w, passes=passes, m3=_USE_3M)
