"""Truncated real DFT as a matmul (host float64 precompute, f32 storage).

Copy of the rDFT/irDFT tables of makani_tpu/ops/dft.py. Only mmax of nlon
frequencies survive the SFNO's hard mode truncation, so the longitude
transform is one (nlon x mmax) matmul.

  forward rDFT:  X_m = s_f * sum_j x_j e^{-2 pi i j m / N},  m < mmax
  inverse rDFT:  x_j = s_i * Re sum_m fac_m X_m e^{+2 pi i j m / N}
with fac_m = 2 except fac_0 = 1 (and the Nyquist mode when present).
"""

from functools import lru_cache

import numpy as np

_TWO_PI = 2.0 * np.pi


def _fscale(n, scale):
    # forward scale: "integral" = 2*pi*rfft(norm="forward"); "ortho" = rfft(norm="ortho")
    return {"integral": _TWO_PI / n, "ortho": 1.0 / np.sqrt(n), "none": 1.0}[scale]


def _iscale(n, scale):
    # inverse scale: "synthesis" = irfft(norm="forward"); "ortho" = irfft(norm="ortho")
    return {"synthesis": 1.0, "ortho": 1.0 / np.sqrt(n), "none": 1.0}[scale]


@lru_cache(maxsize=None)
def rdft_matrices(nlon, mmax, scale="integral"):
    """Forward real-DFT matrices (nlon, mmax): coeff = x @ C - i * (x @ S)."""
    j = np.arange(nlon)[:, None]
    m = np.arange(mmax)[None, :]
    ang = _TWO_PI * j * m / nlon
    s = _fscale(nlon, scale)
    C = (s * np.cos(ang)).astype(np.float32)
    S = (s * np.sin(ang)).astype(np.float32)
    return C, S


@lru_cache(maxsize=None)
def irdft_matrices(nlon, mmax, scale="synthesis"):
    """Inverse real-DFT matrices (mmax, nlon): x = Xr @ Cs - Xi @ Ss."""
    j = np.arange(nlon)[None, :]
    m = np.arange(mmax)[:, None]
    ang = _TWO_PI * j * m / nlon
    fac = np.full((mmax, 1), 2.0)
    fac[0, 0] = 1.0
    if (nlon % 2 == 0) and (mmax == nlon // 2 + 1):
        fac[-1, 0] = 1.0
    s = _iscale(nlon, scale)
    Cs = (s * fac * np.cos(ang)).astype(np.float32)
    Ss = (s * fac * np.sin(ang)).astype(np.float32)
    return Cs, Ss
