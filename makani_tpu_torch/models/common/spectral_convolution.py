"""Spectral convolution on the sphere (dhconv filter, stacked-real pipeline).

Counterpart of SpectralConv in makani_tpu/models/common/spectral_convolution.py
on the path its "pallas" coefficient engine takes (:98-126): analysis SHT ->
per-l complex channel mixing -> synthesis SHT, all in real planes, with the
Legendre contractions and the channel mixing on the Hopper kernels.
"""

import math

import torch
from torch import nn

from makani_tpu_torch.ops.complex_ops import contract_dhconv_stacked


class SpectralConv(nn.Module):
    """Linear spectral convolution, dhconv operator, non-separable.

    The complex weight is stored as real planes in the layout the dhconv_mm
    kernel reads, ``weight (2, L, C, O)`` (plane 0 = re); makani_tpu stores the
    same values as ``(C, O, L, 2)`` (tools/convert_jax_params.py permutes).
    forward returns ``(out, residual)``; when the two transforms differ in
    grid or shape, the residual is the synthesis of the analysed input on the
    output grid (scale_residual), else the input itself.
    """

    def __init__(self, forward_transform, inverse_transform, in_channels, out_channels,
                 operator_type="dhconv", separable=False, bias=False, gain=1.0, device="cpu",
                 generator=None):
        super().__init__()
        if operator_type != "dhconv" or separable:
            raise NotImplementedError(
                f"only the non-separable dhconv operator is ported (got {operator_type!r}, "
                f"separable={separable}); ROADMAP: Queue 1, other model families")
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        self.in_channels = in_channels
        self.out_channels = out_channels
        fwd_t, inv_t = forward_transform, inverse_transform
        self.scale_residual = ((fwd_t.nlat, fwd_t.nlon, fwd_t.grid)
                               != (inv_t.nlat, inv_t.nlon, inv_t.grid))

        modes_lat = inv_t.lmax
        # N(0,1) * sqrt(gain / C), with the l = 0 row scaled by sqrt(2)
        scale = torch.full((modes_lat,), math.sqrt(gain / in_channels), device=device)
        scale[0] *= math.sqrt(2.0)
        w = torch.randn((2, modes_lat, in_channels, out_channels), device=device,
                        generator=generator)
        self.weight = nn.Parameter(w * scale[None, :, None, None])

        self.bias_mode = bias
        if bias == "constant":
            self.bias_const = nn.Parameter(torch.zeros(1, out_channels, 1, 1, device=device))
        elif bias == "position":
            self.bias_pos = nn.Parameter(
                torch.zeros(1, out_channels, inv_t.nlat, inv_t.nlon, device=device))
        elif bias:
            raise ValueError(f"unknown bias mode {bias!r}")

    def forward(self, x):
        fwd_t, inv_t = self.forward_transform, self.inverse_transform
        dtype = x.dtype
        residual = x

        z = fwd_t.analysis_stacked(x)                         # (2*mmax, B, C, L)
        if self.scale_residual:
            residual = inv_t.synthesis_stacked(z).to(dtype)
        mmax = z.shape[0] // 2
        B, L = z.shape[1], z.shape[-1]
        zs = z.view(2, mmax, B, self.in_channels, L).permute(0, 2, 4, 3, 1).contiguous()
        o = contract_dhconv_stacked(zs, self.weight)          # (2, B, L, O, mmax)
        o = o.permute(0, 4, 1, 3, 2).reshape(2 * mmax, B, self.out_channels, L)
        x = inv_t.synthesis_stacked(o)

        if self.bias_mode == "constant":
            x = x + self.bias_const
        elif self.bias_mode == "position":
            x = x + self.bias_pos
        return x.to(dtype), residual
