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

Under a spatial decomposition (parallel/comm's h and w groups, more than
one rank) a 5-D input is the rank's (B, C, depth, lat/h, lon/w) patch.
makani_tpu has no branch of its own: the depth FFT stays local and XLA's
partitioner reshards h and w (makani_tpu/ops/fft3d.py:1-7). The port writes
those moves out as ops/fft.py does: the longitude rFFT with the channels
split over w and the longitude whole, then the depth and latitude FFT with
the channels split over h and the latitude whole, each 1-D transform
orthonormal (their product is rfftn's "ortho"), each move an all-to-all
(parallel/spmd.distributed_transpose); the coefficients are the rank's (B,
C, ldmax, lh/h, lw/w) block, the synthesis its mirror. A spatially split
input of any other rank raises.
"""

import math

import torch

from makani_tpu_torch.parallel import comm, spmd


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

    def _distributed(self, x):
        if not spmd.spatial_distributed():
            return False
        if x.dim() != 5:
            raise ValueError(f"a spatially split 3D FFT takes a 5-D (B, C, depth, lat/h, lon/w) "
                             f"patch, got shape {tuple(x.shape)}")
        return True

    def _splits(self, channels):
        nh, nw = comm.get_size("h"), comm.get_size("w")
        return dict(lat=spmd.split_shapes(self.nh, nh), lon=spmd.split_shapes(self.nw, nw),
                    l=spmd.split_shapes(self.lhmax, nh), m=spmd.split_shapes(self.lwmax, nw),
                    c_h=spmd.split_shapes(channels, nh), c_w=spmd.split_shapes(channels, nw))


def _truncate(y, high, low, dim):
    """makani_tpu's two-sided cut along `dim`, `[-0:]` included."""
    return torch.cat((y.narrow(dim, 0, high), y[(slice(None),) * (dim % y.dim()) + (
        slice(-low, None),)]), dim=dim)


class RealFFT3(_Truncation3):
    """Analysis: real (..., nd, nh, nw) -> complex (..., ldmax, lhmax, lwmax);
    on spatial ranks the rank's (B, C, nd, nh/h, nw/w) patch -> its (B, C,
    ldmax, lhmax/h, lwmax/w) block."""

    def __call__(self, x):
        if self._distributed(x):
            return self._distributed_call(x.float())
        y = torch.fft.rfftn(x.float(), s=(self.nd, self.nh, self.nw), dim=(-3, -2, -1),
                            norm="ortho")
        y = torch.cat((y[..., : self.ldmax_high, :, :], y[..., -self.ldmax_low:, :, :]), dim=-3)
        y = torch.cat((y[..., : self.lhmax_high, :], y[..., -self.lhmax_low:, :]), dim=-2)
        return y[..., : self.lwmax]

    def _distributed_call(self, x):
        sp = self._splits(x.shape[1])
        x = spmd.distributed_transpose(x, 1, 4, "w", sp["c_w"], sp["lon"])   # (B, C/w, D, H/h, W)
        y = torch.fft.rfft(x, n=self.nw, dim=-1, norm="ortho")[..., : self.lwmax]
        y = torch.stack((y.real, y.imag))                                   # (2, B, C/w, D, H/h, lw)
        y = spmd.distributed_transpose(y, 5, 2, "w", sp["m"], sp["c_w"])     # (2, B, C, D, H/h, lw/w)
        y = spmd.distributed_transpose(y, 2, 4, "h", sp["c_h"], sp["lat"])   # (2, B, C/h, D, H, lw/w)
        y = torch.fft.fftn(torch.complex(y[0], y[1]), s=(self.nd, self.nh), dim=(2, 3),
                           norm="ortho")
        y = _truncate(y, self.ldmax_high, self.ldmax_low, 2)
        y = _truncate(y, self.lhmax_high, self.lhmax_low, 3)                # (B, C/h, ld, lh, lw/w)
        y = torch.stack((y.real, y.imag))
        y = spmd.distributed_transpose(y, 4, 2, "h", sp["l"], sp["c_h"])     # (2, B, C, ld, lh/h, lw/w)
        return torch.complex(y[0], y[1])


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
    """Synthesis: complex (..., ldmax, lhmax, lwmax) -> real (..., nd, nh, nw);
    on spatial ranks the rank's block -> its patch (RealFFT3)."""

    def __call__(self, x):
        x = x.to(torch.complex64)
        if self._distributed(x):
            return self._distributed_call(x)
        x = _pad_mid(x, x.dim() - 3, self.ldmax_high, self.ldmax_low, self.nd)
        x = _pad_mid(x, x.dim() - 2, self.lhmax_high, self.lhmax_low, self.nh)
        x = torch.nn.functional.pad(x, (0, self.nw // 2 + 1 - x.shape[-1]))
        return torch.fft.irfftn(x, s=(self.nd, self.nh, self.nw), dim=(-3, -2, -1),
                                norm="ortho")

    def _distributed_call(self, x):
        sp = self._splits(x.shape[1])
        if x.shape[2:] != (self.ldmax, spmd.patch(self.lhmax, "h")[1],
                           spmd.patch(self.lwmax, "w")[1]):
            raise ValueError(f"the coefficients {tuple(x.shape)} are not the rank's block of "
                             f"({self.ldmax}, {self.lhmax}, {self.lwmax})")
        z = torch.stack((x.real, x.imag))                                   # (2, B, C, ld, lh/h, lw/w)
        z = spmd.distributed_transpose(z, 2, 4, "h", sp["c_h"], sp["l"])     # (2, B, C/h, ld, lh, lw/w)
        z = _pad_mid(torch.complex(z[0], z[1]), 2, self.ldmax_high, self.ldmax_low, self.nd)
        z = _pad_mid(z, 3, self.lhmax_high, self.lhmax_low, self.nh)
        z = torch.fft.ifftn(z, s=(self.nd, self.nh), dim=(2, 3), norm="ortho")
        z = torch.stack((z.real, z.imag))                                   # (2, B, C/h, D, H, lw/w)
        z = spmd.distributed_transpose(z, 4, 2, "h", sp["lat"], sp["c_h"])   # (2, B, C, D, H/h, lw/w)
        z = spmd.distributed_transpose(z, 2, 5, "w", sp["c_w"], sp["m"])     # (2, B, C/w, D, H/h, lw)
        z = torch.nn.functional.pad(torch.complex(z[0], z[1]),
                                    (0, self.nw // 2 + 1 - self.lwmax))
        out = torch.fft.irfft(z, n=self.nw, dim=-1, norm="ortho")           # (B, C/w, D, H/h, W)
        return spmd.distributed_transpose(out, 4, 1, "w", sp["lon"], sp["c_w"])
