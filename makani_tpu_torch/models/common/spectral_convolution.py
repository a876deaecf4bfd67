"""Spectral convolution on the sphere: the linear spectral filter and the
non-linear one.

Counterpart of SpectralConv and SpectralAttention in
makani_tpu/models/common/spectral_convolution.py (:35-246). SpectralConv
takes one of two paths, chosen per call as makani_tpu chooses them:
  - the stacked-real pipeline (:98-126), for the non-separable dhconv operator
    on SHT transforms, on the "kernel" or "stacked" coefficient engine at a
    precision the kernels express: analysis SHT -> per-l complex channel
    mixing -> synthesis SHT, all in real planes, on the legmm / dhconv_mm
    kernels;
  - the complex branch (:127-172), for every other case (the "xla" engine,
    the "highest" precision, the diagonal and separable operators, the FFT
    transforms of the planar FNO): complex coefficients from the transform's
    `__call__`, complex_ops' contraction of the operator, the inverse
    transform.

Channels split over fin (makani_tpu's filter rule: the weight's input
channels over fin, :129-165): the transforms run on the rank's channels,
the contraction over them is a partial sum, and reduce_scatter sums it over
fin and leaves each rank its fin chunk of the output channels, which the
inverse transform then synthesises (an all-reduce where fin does not divide
the output channels). The separable operators mix no channels and need no
sum.
"""

import math

import torch
from torch import nn

from makani_tpu_torch.models.common.activations import ComplexReLU
from makani_tpu_torch.models.common.layers import Dropout, leaf_part
from makani_tpu_torch.ops import sht
from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.ops.complex_ops import (
    contract_dhconv_stacked,
    get_contract_fun,
    view_as_complex,
)


def scale_residual(fwd_t, inv_t):
    """True when the filter's residual must be resynthesised on the output
    grid: the transforms differ in shape, or in grid where the forward one
    has a grid (an SHT; FFT transforms have none), as makani_tpu decides."""
    if (fwd_t.nlat, fwd_t.nlon) != (inv_t.nlat, inv_t.nlon):
        return True
    return hasattr(fwd_t, "grid") and fwd_t.grid != getattr(inv_t, "grid", None)


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
        self.scale_residual = scale_residual(fwd_t, inv_t)
        # the stacked-real pipeline runs on SHT transforms; FFT coefficients
        # (the planar FNO) always take the complex branch
        self.sht = hasattr(fwd_t, "analysis_stacked") and hasattr(inv_t, "synthesis_stacked")

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

    @property
    def in_axis(self):
        """The axis the weight's input channels are split over (None: whole)."""
        return spmd.leaf_axis(self, "weight", 2 if self.stacked_weight else 0)

    @property
    def out_axis(self):
        """The axis the output's channels are split over."""
        if self.separable:
            return self.in_axis
        return self.in_axis and spmd.channel_axis(self.out_channels, self.in_axis)

    def _reduce(self, o, dim):
        """The contraction's partial sum over the rank's input channels,
        summed over their axis: the rank's chunk of the output channels
        along `dim`, or all of them."""
        axis = self.in_axis
        if axis is None or self.separable:
            return o
        if self.out_axis is None:
            return spmd.all_reduce_sum(o, axis)
        return spmd.reduce_scatter(o, dim, axis)

    def forward(self, x, x_axis=None):
        """x's channels split over `x_axis`, which must be the weight's
        `in_axis`; returns (out, residual), out's channels split over
        `out_axis`, the residual's as x's."""
        if x_axis != self.in_axis:
            raise ValueError(f"the filter's input channels are split over {self.in_axis}, "
                             f"its input's over {x_axis}")
        fwd_t, inv_t = self.forward_transform, self.inverse_transform
        dtype = x.dtype
        residual = x

        if self.stacked_weight and self.sht and sht._stacked_engine_active():
            z = fwd_t.analysis_stacked(x)                     # (2*mmax, B, C, L)
            if self.scale_residual:
                residual = inv_t.synthesis_stacked(z).to(dtype)
            mmax = z.shape[0] // 2
            B, C, L = z.shape[1], z.shape[2], z.shape[-1]
            zs = z.view(2, mmax, B, C, L).permute(0, 2, 4, 3, 1).contiguous()
            o = self._reduce(contract_dhconv_stacked(zs, self.weight), 3)   # (2, B, L, O, mmax)
            o = o.permute(0, 4, 1, 3, 2).reshape(2 * mmax, B, o.shape[3], L)
            x = inv_t.synthesis_stacked(o)
        else:
            x = fwd_t(x)                                      # (B, C, L, mmax) complex
            if self.scale_residual:
                residual = inv_t(x).to(dtype)
            contract = get_contract_fun(self.operator_type, self.separable)
            x = inv_t(self._reduce(contract(x, self.complex_weight()), 1))

        if self.bias_mode == "constant":
            x = x + leaf_part(self, "bias_const", 1, self.out_axis)
        elif self.bias_mode == "position":
            bias = leaf_part(self, "bias_pos", 1, self.out_axis)
            x = x + spmd.local_patch(bias, bias.shape[-2:])
        return x.to(dtype), residual


class SpectralAttention(nn.Module):
    """Non-linear spectral filter: `spectral_layers` complex layers (weight,
    optional bias, ComplexReLU, dropout) of width hidden_size_factor *
    in_channels, then the output weight, on the coefficients.

    operator_type "diagonal" mixes channels with one weight ``w_l (I, H)``
    for every mode, "l-dependant" with one per degree ``w_l (L, I, H)``.
    Complex weights are stored as real pairs ``(..., 2)`` under makani_tpu's
    names (w_0.., b_0.., act_0../bias, wout). forward returns ``(out,
    residual)`` as SpectralConv does.
    """

    def __init__(self, forward_transform, inverse_transform, in_channels, out_channels,
                 operator_type="diagonal", hidden_size_factor=2, complex_activation="real",
                 bias=False, spectral_layers=1, drop_rate=0.0, gain=1.0, device="cpu",
                 generator=None):
        super().__init__()
        if operator_type not in ("diagonal", "l-dependant"):
            raise ValueError("Unknown operator type")
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        self.operator_type = operator_type
        self.spectral_layers = spectral_layers
        self.bias = bias
        fwd_t, inv_t = forward_transform, inverse_transform
        self.scale_residual = scale_residual(fwd_t, inv_t)
        modes_lat = fwd_t.lmax
        hidden = int(hidden_size_factor * in_channels)
        scale_out = math.sqrt(gain / in_channels)

        def cplx_param(shape, std):
            return nn.Parameter(std * torch.randn((*shape, 2), device=device,
                                                  generator=generator))

        lead = (modes_lat,) if operator_type == "l-dependant" else ()
        for l in range(spectral_layers):
            in_dim = in_channels if l == 0 else hidden
            setattr(self, f"w_{l}", cplx_param((*lead, in_dim, hidden),
                                               math.sqrt(2.0 / float(in_dim))))
            if bias:
                setattr(self, f"b_{l}", cplx_param((hidden, 1, 1), scale_out))
            setattr(self, f"act_{l}", ComplexReLU(mode=complex_activation,
                                                  bias_shape=(hidden, 1, 1), scale=scale_out,
                                                  device=device))
            setattr(self, f"drop_{l}", Dropout(drop_rate))
            getattr(self, f"drop_{l}").global_hw = (modes_lat, fwd_t.mmax)
        self.wout = cplx_param((*lead, hidden, out_channels), scale_out)

    def _mix(self, x, w):
        if self.operator_type == "diagonal":
            return torch.einsum("bixy,io->boxy", x, view_as_complex(w))
        w = view_as_complex(w)
        if spmd.spatial_distributed():
            w = w[spmd.patch_slice(w.shape[0], "h")]               # the rank's degrees
        return torch.einsum("bixy,xio->boxy", x, w)

    def forward(self, x, deterministic=True):
        fwd_t, inv_t = self.forward_transform, self.inverse_transform
        dtype = x.dtype
        residual = x
        x = fwd_t(x.float())                                  # (B, C, L, mmax) complex
        if self.scale_residual:
            residual = inv_t(x).to(dtype)
        for l in range(self.spectral_layers):
            x = self._mix(x, getattr(self, f"w_{l}"))
            if self.bias:
                x = x + view_as_complex(getattr(self, f"b_{l}"))
            x = getattr(self, f"act_{l}")(x)
            x = getattr(self, f"drop_{l}")(x, deterministic)
        x = inv_t(self._mix(x, self.wout))
        return x.to(dtype), residual
