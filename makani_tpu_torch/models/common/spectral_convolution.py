"""Spectral convolution on the sphere: the linear spectral filter.

Counterpart of SpectralConv in makani_tpu/models/common/spectral_convolution.py
(:35-172). Two paths, chosen per call as makani_tpu chooses them:
  - the stacked-real pipeline (:98-126), for the non-separable dhconv operator
    on the "kernel" or "stacked" coefficient engine at a precision the
    kernels express: analysis SHT -> per-l complex channel mixing -> synthesis
    SHT, all in real planes, on the legmm / dhconv_mm kernels;
  - the complex branch (:127-172), for every other case (the "xla" engine,
    the "highest" precision, the diagonal and separable operators): complex
    coefficients from the SHT's `__call__`, complex_ops' contraction of the
    operator, the inverse SHT.
"""

import math

import torch
from torch import nn

from makani_tpu_torch.ops import sht
from makani_tpu_torch.ops.complex_ops import (
    contract_dhconv_stacked,
    get_contract_fun,
    view_as_complex,
)


class SpectralConv(nn.Module):
    """Linear spectral convolution, operator "dhconv" or "diagonal",
    separable or not.

    The non-separable dhconv weight is stored as real planes in the layout
    the dhconv_mm kernel reads, ``weight (2, L, C, O)`` (plane 0 = re), where
    makani_tpu stores ``(C, O, L, 2)`` (tools/convert_jax_params.py
    permutes); the complex branch views it as complex ``(C, O, L)``. The other
    operators' weights, which no kernel reads, keep makani_tpu's layout
    ``(C, [O,] L[, M], 2)``. forward returns ``(out, residual)``; when the two
    transforms differ in grid or shape, the residual is the synthesis of the
    analysed input on the output grid (scale_residual), else the input itself.
    """

    def __init__(self, forward_transform, inverse_transform, in_channels, out_channels,
                 operator_type="dhconv", separable=False, bias=False, gain=1.0, device="cpu",
                 generator=None):
        super().__init__()
        get_contract_fun(operator_type, separable)  # raises on an unknown operator
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.operator_type = operator_type
        self.separable = separable
        self.stacked_weight = operator_type == "dhconv" and not separable
        fwd_t, inv_t = forward_transform, inverse_transform
        self.scale_residual = ((fwd_t.nlat, fwd_t.nlon, fwd_t.grid)
                               != (inv_t.nlat, inv_t.nlon, inv_t.grid))

        modes_lat, modes_lon = inv_t.lmax, inv_t.mmax
        # N(0,1) * sqrt(gain / C), with the l = 0 row scaled by sqrt(2)
        scale = torch.full((modes_lat,), math.sqrt(gain / in_channels), device=device)
        scale[0] *= math.sqrt(2.0)
        if self.stacked_weight:
            w = torch.randn((2, modes_lat, in_channels, out_channels), device=device,
                            generator=generator)
            w = w * scale[None, :, None, None]
        else:
            if operator_type == "diagonal" and separable and in_channels == 2:
                # utils/param_layout tells this (2, L, M, 2) weight from the
                # stacked dhconv weight (2, L, C, O) by its first dimension
                raise ValueError("a separable diagonal filter needs in_channels != 2")
            shape = [in_channels] + ([] if separable else [out_channels])
            shape += [modes_lat, modes_lon] if operator_type == "diagonal" else [modes_lat]
            l_axis = len(shape) - (2 if operator_type == "diagonal" else 1)
            w = torch.randn((*shape, 2), device=device, generator=generator)
            bshape = [1] * (len(shape) + 1)
            bshape[l_axis] = modes_lat
            w = w * scale.view(bshape)
        self.weight = nn.Parameter(w)

        self.bias_mode = bias
        if bias == "constant":
            self.bias_const = nn.Parameter(torch.zeros(1, out_channels, 1, 1, device=device))
        elif bias == "position":
            self.bias_pos = nn.Parameter(
                torch.zeros(1, out_channels, inv_t.nlat, inv_t.nlon, device=device))
        elif bias:
            raise ValueError(f"unknown bias mode {bias!r}")

    def complex_weight(self):
        """The weight as a complex tensor in makani_tpu's logical shape,
        differentiable back to the stored parameter."""
        if self.stacked_weight:
            return torch.complex(self.weight[0], self.weight[1]).permute(1, 2, 0)  # (C, O, L)
        return view_as_complex(self.weight)

    def forward(self, x):
        fwd_t, inv_t = self.forward_transform, self.inverse_transform
        dtype = x.dtype
        residual = x

        if self.stacked_weight and sht._stacked_engine_active():
            z = fwd_t.analysis_stacked(x)                     # (2*mmax, B, C, L)
            if self.scale_residual:
                residual = inv_t.synthesis_stacked(z).to(dtype)
            mmax = z.shape[0] // 2
            B, L = z.shape[1], z.shape[-1]
            zs = z.view(2, mmax, B, self.in_channels, L).permute(0, 2, 4, 3, 1).contiguous()
            o = contract_dhconv_stacked(zs, self.weight)      # (2, B, L, O, mmax)
            o = o.permute(0, 4, 1, 3, 2).reshape(2 * mmax, B, self.out_channels, L)
            x = inv_t.synthesis_stacked(o)
        else:
            x = fwd_t(x)                                      # (B, C, L, mmax) complex
            if self.scale_residual:
                residual = inv_t(x).to(dtype)
            contract = get_contract_fun(self.operator_type, self.separable)
            x = inv_t(contract(x, self.complex_weight()))

        if self.bias_mode == "constant":
            x = x + self.bias_const
        elif self.bias_mode == "position":
            x = x + self.bias_pos
        return x.to(dtype), residual
