"""Spherical Fourier Neural Operator network.

Counterpart of makani_tpu/models/networks/sfnonet.py: encoder -> blocks
(spectral filter, instance norm, GELU, MLP, linear outer skip) -> decoder,
plus the big-skip residual transform. The blocks run as a plain loop.
Activation checkpointing follows makani_tpu's levels: checkpointing >= 1
recomputes the encoder and decoder in backward, >= 2 the block MLPs, >= 3
whole blocks (torch.utils.checkpoint, non-reentrant). The linear filter
takes the dhconv and diagonal operators, separable or not; the non-linear
filter (SpectralAttention) the diagonal and l-dependant ones. Dropout in
training: after the encoder (pos_drop_rate), in the blocks' MLPs
(mlp_drop_rate, one draw per feature map), in the non-linear filter and as
stochastic depth (path_drop_rate, linspace(0, rate, num_layers) over the
blocks); the sites are numbered in registration order (layers.drop_mask).
Not ported yet (ROADMAP, Queue 1 item 6): scan_layers, position embeddings,
factorized filters and the FFT (planar FNO) transforms.
"""

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from makani_tpu_torch.models.common import (
    MLP,
    Conv1x1,
    DropPath,
    Dropout,
    EncoderDecoder,
    InstanceNorm2d,
    SpectralAttention,
    SpectralConv,
    get_activation,
)
from makani_tpu_torch.models.common.layers import normal_param, number_dropout_sites, remat
from makani_tpu_torch.ops import InverseRealSHT, RealSHT


@lru_cache(maxsize=None)
def get_transform_pair(kind, nlat, nlon, lmax, mmax, grid, device="cpu"):
    """Cached (forward, inverse) spectral transforms per shape, modes, grid and
    device; transforms of one grid share one device table."""
    if kind == "sht":
        return (
            RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid, device=device),
            InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid, device=device),
        )
    raise NotImplementedError(f"spectral transform {kind!r} is not ported yet")


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: Queue 1 item 6)")


class SpectralFilterLayer(nn.Module):
    """The spectral filter under the name `filter`: SpectralAttention for
    filter_type "non-linear", SpectralConv for "linear"."""

    def __init__(self, forward_transform, inverse_transform, embed_dim, filter_type="linear",
                 operator_type="diagonal", hidden_size_factor=1.0, factorization=None,
                 separable=False, complex_activation="real", spectral_layers=1, bias=False,
                 drop_rate=0.0, gain=1.0, device="cpu", generator=None):
        super().__init__()
        self.non_linear = filter_type == "non-linear"
        if self.non_linear:
            self.filter = SpectralAttention(
                forward_transform, inverse_transform, embed_dim, embed_dim,
                operator_type=operator_type, hidden_size_factor=int(hidden_size_factor),
                complex_activation=complex_activation, spectral_layers=spectral_layers,
                drop_rate=drop_rate, bias=bias, gain=gain, device=device, generator=generator)
            return
        if filter_type != "linear":
            raise NotImplementedError(f"filter_type {filter_type}")
        if factorization is not None:
            raise _not_ported(f"factorized filters ({factorization!r})")
        self.filter = SpectralConv(forward_transform, inverse_transform, embed_dim, embed_dim,
                                   operator_type=operator_type, separable=separable, bias=bias,
                                   gain=gain, device=device, generator=generator)

    def forward(self, x, deterministic=True):
        if self.non_linear:
            return self.filter(x, deterministic=deterministic)
        return self.filter(x)


class FourierNeuralOperatorBlock(nn.Module):
    """filter -> norm0 -> act -> MLP -> norm1 -> drop_path -> linear outer skip,
    the block makani_tpu's SFNO builds (inner skip "none", outer skip
    "linear", no final activation)."""

    def __init__(self, forward_transform, inverse_transform, embed_dim, filter_type="linear",
                 operator_type="diagonal", mlp_ratio=2.0, mlp_drop_rate=0.0,
                 path_drop_rate=0.0, act_name="gelu", norm_layer="instance_norm",
                 factorization=None, separable=False, use_mlp=False, complex_activation="real",
                 spectral_layers=1, bias=False, checkpointing=0, device="cpu", generator=None):
        super().__init__()
        self.act = get_activation(act_name)
        # gain bookkeeping of the reference init scheme: the filter feeds an
        # activation, the MLP and the outer skip share one sum
        self.filter_layer = SpectralFilterLayer(
            forward_transform, inverse_transform, embed_dim, filter_type=filter_type,
            operator_type=operator_type, hidden_size_factor=mlp_ratio,
            factorization=factorization, separable=separable,
            complex_activation=complex_activation, spectral_layers=spectral_layers, bias=bias,
            drop_rate=path_drop_rate, gain=1.0 if act_name == "identity" else 2.0,
            device=device, generator=generator)
        self.norm0 = self._norm(norm_layer, embed_dim, device)
        self.mlp = (MLP(embed_dim, int(embed_dim * mlp_ratio), act_layer=self.act,
                        drop_rate=mlp_drop_rate, drop_type="features", gain=0.5,
                        checkpointing=checkpointing, device=device, generator=generator)
                    if use_mlp else None)
        self.norm1 = self._norm(norm_layer, embed_dim, device)
        self.drop_path = DropPath(path_drop_rate)
        self.outer_skip = Conv1x1(embed_dim, embed_dim, use_bias=False, gain=0.5,
                                  device=device, generator=generator)

    @staticmethod
    def _norm(norm_layer, embed_dim, device):
        if norm_layer == "instance_norm":
            return InstanceNorm2d(embed_dim, eps=1e-6, affine=True, device=device)
        if norm_layer == "none":
            return nn.Identity()
        raise _not_ported(f"normalization {norm_layer!r}")

    def forward(self, x, deterministic=True):
        x, residual = self.filter_layer(x, deterministic)
        x = self.act(self.norm0(x))
        if self.mlp is not None:
            x = self.mlp(x, deterministic=deterministic)
        x = self.drop_path(self.norm1(x), deterministic=deterministic)
        return x + self.outer_skip(residual)


class SphericalFourierNeuralOperatorNet(nn.Module):
    """SFNO as in Bonev et al.; the arguments are makani_tpu's, plus `device`
    and the `generator` the weights are drawn from."""

    def __init__(self, spectral_transform="sht", model_grid_type="equiangular",
                 sht_grid_type="legendre-gauss", filter_type="linear", operator_type="dhconv",
                 inp_shape: Tuple[int, int] = (721, 1440),
                 out_shape: Tuple[int, int] = (721, 1440), scale_factor=8, inp_chans=2,
                 out_chans=2, embed_dim=32, num_layers=4, repeat_layers=1, use_mlp=True,
                 mlp_ratio=2.0, encoder_ratio=1, decoder_ratio=1, activation_function="gelu",
                 encoder_layers=1, pos_embed="none", pos_drop_rate=0.0, path_drop_rate=0.0,
                 mlp_drop_rate=0.0, normalization_layer="instance_norm",
                 max_modes: Optional[Tuple[int, int]] = None, hard_thresholding_fraction=1.0,
                 big_skip=True, factorization=None, rank=1.0, separable=False,
                 complex_activation="real", spectral_layers=3, bias=False, checkpointing=0,
                 scan_layers=False, device="cpu", generator=None):
        super().__init__()
        if pos_embed not in ("none", "None", None):
            raise _not_ported(f"pos_embed {pos_embed!r}")
        if scan_layers and num_layers > 2 and repeat_layers == 1:
            raise _not_ported("scan_layers")
        self.checkpointing = checkpointing
        self.inp_shape = tuple(inp_shape)
        self.out_shape = tuple(out_shape)
        self.big_skip = big_skip
        self.repeat_layers = repeat_layers
        self.act = get_activation(activation_function)

        h = int(self.inp_shape[0] // scale_factor)
        w = int(self.inp_shape[1] // scale_factor)
        if max_modes is not None:
            modes_lat, modes_lon = max_modes
        else:
            modes_lat = int(h * hard_thresholding_fraction)
            modes_lon = int((w // 2 + 1) * hard_thresholding_fraction)
        kind = spectral_transform
        self.trans_down, _ = get_transform_pair(kind, *self.inp_shape, modes_lat, modes_lon,
                                                model_grid_type, device)
        _, self.itrans_up = get_transform_pair(kind, *self.out_shape, modes_lat, modes_lon,
                                               model_grid_type, device)
        trans, itrans = get_transform_pair(kind, h, w, modes_lat, modes_lon, sht_grid_type,
                                           device)

        self.encoder = EncoderDecoder(encoder_layers, inp_chans, embed_dim,
                                      int(encoder_ratio * embed_dim), self.act, device=device,
                                      generator=generator)
        self.pos_drop = Dropout(pos_drop_rate)
        dpr = np.linspace(0, path_drop_rate, num_layers)
        self.blocks = nn.ModuleList([
            FourierNeuralOperatorBlock(
                self.trans_down if i == 0 else trans,
                self.itrans_up if i == num_layers - 1 else itrans,
                embed_dim, filter_type=filter_type, operator_type=operator_type,
                mlp_ratio=mlp_ratio, mlp_drop_rate=mlp_drop_rate,
                path_drop_rate=float(dpr[i]), act_name=activation_function,
                norm_layer=normalization_layer, factorization=factorization,
                separable=separable, use_mlp=use_mlp, complex_activation=complex_activation,
                spectral_layers=spectral_layers, bias=bias, checkpointing=checkpointing,
                device=device, generator=generator)
            for i in range(num_layers)])
        self.decoder = EncoderDecoder(encoder_layers, embed_dim, out_chans,
                                      int(decoder_ratio * embed_dim), self.act,
                                      gain=0.5 if big_skip else 1.0, device=device,
                                      generator=generator)
        if big_skip:
            self.residual_transform = normal_param(
                (out_chans, inp_chans), math.sqrt(0.5 / inp_chans), device, generator)
        self.n_dropout_sites = number_dropout_sites(self)

    def forward(self, x, deterministic=True):
        if self.big_skip:
            if self.out_shape != self.inp_shape:
                residual = self.itrans_up(self.trans_down(x.float())).to(x.dtype)
            else:
                residual = x
        x = remat(self.encoder, x) if self.checkpointing >= 1 else self.encoder(x)
        x = self.pos_drop(x, deterministic)
        for _ in range(self.repeat_layers):
            for blk in self.blocks:
                if self.checkpointing >= 3:
                    x = remat(blk, x, deterministic)
                else:
                    x = blk(x, deterministic=deterministic)
        x = remat(self.decoder, x) if self.checkpointing >= 1 else self.decoder(x)
        if self.big_skip:
            b, c, h, w = residual.shape
            rw = self.residual_transform.to(residual.dtype).expand(b, -1, -1)
            x = x + torch.bmm(rw, residual.reshape(b, c, h * w)).view(b, -1, h, w)
        return x
