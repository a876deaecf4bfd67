"""Truncated 3D real FFTs over (depth, lat, lon).

Counterpart of makani_tpu/ops/fft3d.py (:15-69). `RealFFT3` keeps, of the
orthonormal rfftn over the last three axes, the `ceil(max/2)` lowest and
`floor(max/2)` highest (negative) frequencies in depth and in latitude, and
the first `lwmax` longitude frequencies; `InverseRealFFT3` zero-pads the
middle back to (nd, nh) and the longitudes to nw // 2 + 1, then synthesises
on (nd, nh, nw). Both compute in float32 and complex64 whatever the input's
type. makani_tpu runs them as jnp.fft, not in a Pallas kernel, so the port
calls torch.fft (cuFFT on the card). makani_tpu's slicing is kept as it is,
`[-0:]` included: at a `max` of 1 the forward's second slice is the whole
axis, as jnp's is.
"""

import math

import torch


class _Truncation3:
    def __init__(self, nd, nh, nw, ldmax=None, lhmax=None, lwmax=None):
        self.nd, self.nh, self.nw = nd, nh, nw
        self.ldmax = min(ldmax or nd, nd)
        self.lhmax = min(lhmax or nh, nh)
        self.lwmax = min(lwmax or nw // 2 + 1, nw // 2 + 1)
        self.ldmax_high = math.ceil(self.ldmax / 2)
        self.ldmax_low = math.floor(self.ldmax / 2)
        self.lhmax_high = math.ceil(self.lhmax / 2)
        self.lhmax_low = math.floor(self.lhmax / 2)


class RealFFT3(_Truncation3):
    """Analysis: real (..., nd, nh, nw) -> complex (..., ldmax, lhmax, lwmax)."""

    def __call__(self, x):
        y = torch.fft.rfftn(x.float(), s=(self.nd, self.nh, self.nw), dim=(-3, -2, -1),
                            norm="ortho")
        y = torch.cat((y[..., : self.ldmax_high, :, :], y[..., -self.ldmax_low:, :, :]), dim=-3)
        y = torch.cat((y[..., : self.lhmax_high, :], y[..., -self.lhmax_low:, :]), dim=-2)
        return y[..., : self.lwmax]


def _pad_mid(v, dim, high, low, n):
    """The first `high` and the last `low` entries of `v` along `dim`, zeros
    between them up to length n."""
    size = v.shape[dim]
    hi = v.narrow(dim, 0, high)
    lo = v.narrow(dim, size - low, low)
    shape = list(v.shape)
    shape[dim] = n - high - low
    return torch.cat((hi, v.new_zeros(shape), lo), dim=dim)


class InverseRealFFT3(_Truncation3):
    """Synthesis: complex (..., ldmax, lhmax, lwmax) -> real (..., nd, nh, nw)."""

    def __call__(self, x):
        x = x.to(torch.complex64)
        x = _pad_mid(x, x.dim() - 3, self.ldmax_high, self.ldmax_low, self.nd)
        x = _pad_mid(x, x.dim() - 2, self.lhmax_high, self.lhmax_low, self.nh)
        x = torch.nn.functional.pad(x, (0, self.nw // 2 + 1 - x.shape[-1]))
        return torch.fft.irfftn(x, s=(self.nd, self.nh, self.nw), dim=(-3, -2, -1),
                                norm="ortho")
