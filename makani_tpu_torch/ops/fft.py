"""Truncated 2D real FFTs with the SHT pair's interface, for the planar FNO
and the AFNO filters.

Counterpart of makani_tpu/ops/fft.py (:18-112). `RealFFT2` keeps, of the
orthonormal rfft2, the `lmax_high = ceil(lmax/2)` lowest latitude
frequencies and the `lmax_low = floor(lmax/2)` highest (negative) ones, and
the first `mmax` longitude frequencies; `InverseRealFFT2` zero-pads the
middle rows back to `nlat` and synthesises on (nlat, nlon). Both compute in
float32 and complex64 whatever the input's type (bf16 under AMP is cast
first, as makani_tpu casts it). Serially makani_tpu runs jnp.fft, not a
Pallas kernel, so the port calls torch.fft (cuFFT on the card). On channels
split over fin each rank transforms its own.

Under a spatial decomposition (parallel/comm's h and w groups, more than
one rank) a 4-D input is the rank's (B, C, lat/h, lon/w) patch, and the pair
takes makani_tpu's distributed branch (makani_tpu/ops/fft.py:33-54, 80-104):
two DFT matmuls with channel <-> space moves between them. Analysis: the
longitude real DFT onto the first mmax modes with the channels split over w
and the longitude whole, then the latitude complex DFT straight onto the
kept two-sided rows with the channels split over h and the latitude whole;
the coefficients are the rank's (B, C, l/h, m/w) block, l in the serial
order of the kept rows (ops/sht.py's layout). Synthesis mirrors both steps.
Each move is an explicit all-to-all (parallel/spmd.distributed_transpose,
uneven chunks by spmd.split_shapes). The DFTs are float32 torch.matmul, as
makani_tpu's are einsums outside any Pallas kernel; on the GPU they keep
full float32 while TF32 matmuls are off (PyTorch's default). A spatially
split input of any other rank raises: its patch alone cannot be transformed.
"""

import math
from functools import lru_cache

import torch

from makani_tpu_torch.ops.dft import dft_matrices, irdft_matrices, rdft_matrices
from makani_tpu_torch.parallel import comm, spmd


class _Truncation:
    def __init__(self, nlat, nlon, lmax=None, mmax=None):
        self.nlat = nlat
        self.nlon = nlon
        self.lmax = min(lmax or nlat, nlat)
        self.mmax = min(mmax or nlon // 2 + 1, nlon // 2 + 1)
        self.truncate = not (self.lmax == nlat and self.mmax == nlon // 2 + 1)
        self.lmax_high = math.ceil(self.lmax / 2)
        self.lmax_low = math.floor(self.lmax / 2)

    def rows(self):
        """The latitude frequencies kept, in the coefficients' order."""
        return tuple(range(self.lmax_high)) + tuple(range(self.nlat - self.lmax_low, self.nlat))

    def _distributed(self, x):
        if not spmd.spatial_distributed():
            return False
        if x.dim() != 4:
            raise ValueError(f"a spatially split FFT takes a 4-D (B, C, lat/h, lon/w) patch, "
                             f"got shape {tuple(x.shape)}")
        return True

    def _splits(self, channels):
        nh, nw = comm.get_size("h"), comm.get_size("w")
        return dict(lat=spmd.split_shapes(self.nlat, nh), lon=spmd.split_shapes(self.nlon, nw),
                    l=spmd.split_shapes(self.lmax, nh), m=spmd.split_shapes(self.mmax, nw),
                    c_h=spmd.split_shapes(channels, nh), c_w=spmd.split_shapes(channels, nw))


@lru_cache(maxsize=None)
def _tables(nlat, nlon, mmax, rows, sign, device):
    """float32 (longitude, latitude) DFT tables on `device`: the real DFT's
    (nlon, mmax) cos and sin for the analysis, its (mmax, nlon) synthesis
    tables for sign +1; the complex (nlat, rows) latitude pair. Made as
    normal tensors even under inference_mode, so that a later training
    forward may save them for backward."""
    if sign < 0:
        lon = rdft_matrices(nlon, mmax, scale="ortho")
    else:
        lon = irdft_matrices(nlon, mmax, scale="ortho")
    lat = dft_matrices(nlat, rows=rows, sign=sign, scale="ortho")
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device) for t in (*lon, *lat))


class RealFFT2(_Truncation):
    """Analysis: real (..., nlat, nlon) -> complex (..., lmax, mmax); on
    spatial ranks the rank's (B, C, lat/h, lon/w) patch -> its (B, C, l/h,
    m/w) block."""

    def __call__(self, x):
        if self._distributed(x):
            return self._distributed_call(x.float())
        y = torch.fft.rfft2(x.float(), s=(self.nlat, self.nlon), dim=(-2, -1), norm="ortho")
        if self.truncate:
            y = torch.cat((y[..., : self.lmax_high, : self.mmax],
                           y[..., -self.lmax_low:, : self.mmax]), dim=-2)
        return y

    def _distributed_call(self, x):
        sp = self._splits(x.shape[1])
        C, S, Ck, Sk = _tables(self.nlat, self.nlon, self.mmax, self.rows(), -1, x.device)
        # channels over w, longitude whole: the real DFT onto mmax modes
        x = spmd.distributed_transpose(x, 1, 3, "w", sp["c_w"], sp["lon"])   # (B, C/w, lat/h, nlon)
        y = torch.stack((x @ C, -(x @ S)))                                  # (2, B, C/w, lat/h, mmax)
        # modes over w, channels whole; then channels over h, latitude whole
        y = spmd.distributed_transpose(y, 4, 2, "w", sp["m"], sp["c_w"])     # (2, B, C, lat/h, m/w)
        y = spmd.distributed_transpose(y, 2, 3, "h", sp["c_h"], sp["lat"])   # (2, B, C/h, nlat, m/w)
        # the latitude DFT onto the kept rows: (k, m) -> (l, m)
        yt = y.transpose(-1, -2)                                            # (2, B, C/h, m/w, nlat)
        ore = yt[0] @ Ck - yt[1] @ Sk
        oim = yt[1] @ Ck + yt[0] @ Sk
        o = torch.stack((ore, oim)).transpose(-1, -2)                       # (2, B, C/h, lmax, m/w)
        # degrees over h, channels whole
        o = spmd.distributed_transpose(o.contiguous(), 3, 2, "h", sp["l"], sp["c_h"])
        return torch.complex(o[0], o[1])                                    # (B, C, l/h, m/w)


class InverseRealFFT2(_Truncation):
    """Synthesis: complex (..., lmax, mmax) -> real (..., nlat, nlon); on
    spatial ranks the rank's (B, C, l/h, m/w) block -> its (B, C, lat/h,
    lon/w) patch."""

    def __call__(self, x):
        x = x.to(torch.complex64)
        if self._distributed(x):
            return self._distributed_call(x)
        xt = x[..., : self.mmax]
        if self.truncate:
            pad = xt.new_zeros((*xt.shape[:-2], self.nlat - self.lmax, xt.shape[-1]))
            xt = torch.cat((xt[..., : self.lmax_high, :], pad,
                            xt[..., -self.lmax_low:, :]), dim=-2)
        return torch.fft.irfft2(xt, s=(self.nlat, self.nlon), dim=(-2, -1), norm="ortho")

    def _distributed_call(self, x):
        sp = self._splits(x.shape[1])
        if (x.shape[-2], x.shape[-1]) != (spmd.patch(self.lmax, "h")[1],
                                          spmd.patch(self.mmax, "w")[1]):
            raise ValueError(f"the coefficients {tuple(x.shape)} are not the rank's block of "
                             f"({self.lmax}, {self.mmax})")
        Cs, Ss, Ck, Sk = _tables(self.nlat, self.nlon, self.mmax, self.rows(), 1, x.device)
        z = torch.stack((x.real, x.imag))                                   # (2, B, C, l/h, m/w)
        # channels over h, degrees whole: synthesis from the kept rows
        z = spmd.distributed_transpose(z, 2, 3, "h", sp["c_h"], sp["l"])     # (2, B, C/h, lmax, m/w)
        zt = z.transpose(-1, -2)                                            # (.., m/w, lmax)
        zre = zt[0] @ Ck.T - zt[1] @ Sk.T
        zim = zt[1] @ Ck.T + zt[0] @ Sk.T
        z = torch.stack((zre, zim)).transpose(-1, -2).contiguous()          # (2, B, C/h, nlat, m/w)
        # latitude over h, channels whole; then channels over w, modes whole
        z = spmd.distributed_transpose(z, 3, 2, "h", sp["lat"], sp["c_h"])   # (2, B, C, lat/h, m/w)
        z = spmd.distributed_transpose(z, 2, 4, "w", sp["c_w"], sp["m"])     # (2, B, C/w, lat/h, mmax)
        out = z[0] @ Cs - z[1] @ Ss                                         # (B, C/w, lat/h, nlon)
        # longitude over w, channels whole
        return spmd.distributed_transpose(out, 3, 1, "w", sp["lon"], sp["c_w"])
