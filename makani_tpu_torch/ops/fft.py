"""Truncated 2D real FFTs with the SHT pair's interface, for the planar FNO.

Counterpart of makani_tpu/ops/fft.py (:18-112). `RealFFT2` keeps, of the
orthonormal rfft2, the `lmax_high = ceil(lmax/2)` lowest latitude
frequencies and the `lmax_low = floor(lmax/2)` highest (negative) ones, and
the first `mmax` longitude frequencies; `InverseRealFFT2` zero-pads the
middle rows back to `nlat` and synthesises on (nlat, nlon). Both compute in
float32 and complex64 whatever the input's type (bf16 under AMP is cast
first, as makani_tpu casts it). makani_tpu runs these as jnp.fft, not in a
Pallas kernel, so the port calls torch.fft (cuFFT on the card). On channels
split over fin each rank transforms its own. makani_tpu's spatially
distributed DFT-matmul branch is not ported yet: the FNO under a spatial
decomposition raises (ROADMAP Queue 1 item 7c).
"""

import math

import torch


class _Truncation:
    def __init__(self, nlat, nlon, lmax=None, mmax=None):
        self.nlat = nlat
        self.nlon = nlon
        self.lmax = min(lmax or nlat, nlat)
        self.mmax = min(mmax or nlon // 2 + 1, nlon // 2 + 1)
        self.truncate = not (self.lmax == nlat and self.mmax == nlon // 2 + 1)
        self.lmax_high = math.ceil(self.lmax / 2)
        self.lmax_low = math.floor(self.lmax / 2)


class RealFFT2(_Truncation):
    """Analysis: real (..., nlat, nlon) -> complex (..., lmax, mmax)."""

    def __call__(self, x):
        y = torch.fft.rfft2(x.float(), s=(self.nlat, self.nlon), dim=(-2, -1), norm="ortho")
        if self.truncate:
            y = torch.cat((y[..., : self.lmax_high, : self.mmax],
                           y[..., -self.lmax_low:, : self.mmax]), dim=-2)
        return y


class InverseRealFFT2(_Truncation):
    """Synthesis: complex (..., lmax, mmax) -> real (..., nlat, nlon)."""

    def __call__(self, x):
        xt = x.to(torch.complex64)[..., : self.mmax]
        if self.truncate:
            pad = xt.new_zeros((*xt.shape[:-2], self.nlat - self.lmax, xt.shape[-1]))
            xt = torch.cat((xt[..., : self.lmax_high, :], pad,
                            xt[..., -self.lmax_low:, :]), dim=-2)
        return torch.fft.irfft2(xt, s=(self.nlat, self.nlon), dim=(-2, -1), norm="ortho")
