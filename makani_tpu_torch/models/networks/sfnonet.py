"""Spherical and planar Fourier Neural Operator networks.

Counterpart of makani_tpu/models/networks/sfnonet.py: encoder -> position
embedding -> blocks (spectral filter, norm, GELU, MLP, linear outer skip) ->
decoder, plus the big-skip residual transform. `FourierNeuralOperatorNet` is
the same network on the truncated 2D FFT pair (ops/fft.py) instead of the
SHT pair. Activation checkpointing follows makani_tpu's levels:
checkpointing >= 1 recomputes the encoder and decoder in backward, >= 2 the
block MLPs, >= 3 whole blocks (torch.utils.checkpoint, non-reentrant). The
linear filter takes the dhconv and diagonal operators, separable or not, and
the factorized weights of models/common/factorizations.py; the non-linear
filter (SpectralAttention) the diagonal and l-dependant ones. Norms:
instance norm, layer norm (over channels) or none. Position embeddings:
"direct" (a learned (1, C, H, W) field) or "frequency" (learned real and
imaginary coefficients under makani_tpu's triangular masks, synthesised by
the output transform).

scan_layers (num_layers > 2, repeat_layers 1): the middle blocks 1 ... n-2
are makani_tpu's flax scan. Each of their weights is one parameter with a
leading layer axis (``scan_blocks.block.<name>``, makani_tpu's
``scan_blocks/block/<name>``), so the optimizer sees one leaf per stacked
weight as makani_tpu's does (the salts and flat indices of the stochastic
rounding, LAMB's trust ratio and Adafactor's factored statistics are taken
over the stacked leaf). A loop runs the layers, each through one template
block with the layer's slices of the stacked weights
(torch.func.functional_call), always recomputed in backward (the scan body
is nn.remat), at path_drop_rate mean(dpr[1:-1]); each layer draws its own
dropout masks (its own sites in layers.drop_mask's numbering). The first and
last blocks run outside the scan, without block-level recomputation, as in
makani_tpu.

Channels split over fin and fout (makani_tpu's partitioning rules, each
layer's leaves cut by parallel/partitioning.shard_module): the encoder's
hidden layer is split over fout and its output over fin, the activations
between blocks stay split over fin (the "direct" embedding, split over h
and w only, is cut to the rank's channels), each block's filter contracts
its fin chunk and reduce-scatters over fin, the MLP's hidden layer is split
over fout, the outer skip gathers its input over fin, and the decoder's
output, split over fin where fin divides the output channels, is gathered
whole before the big skip. The non-linear and factorized filters, whose
leaves makani_tpu keeps whole, run on the gathered channels and hand back
the rank's chunk.

Dropout in training: after the encoder (pos_drop_rate), in the blocks' MLPs
(mlp_drop_rate, one draw per feature map), in the non-linear filter and as
stochastic depth (path_drop_rate, linspace(0, rate, num_layers) over the
blocks); the sites are numbered in registration order (layers.drop_mask).
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
    LayerNorm2d,
    SpectralAttention,
    SpectralConv,
    get_activation,
)
from makani_tpu_torch.models.common.factorizations import FactorizedSpectralConv
from makani_tpu_torch.models.common.layers import (
    apply_norm,
    leaf_part,
    normal_param,
    number_dropout_sites,
    remat,
    trunc_normal_param,
)
from makani_tpu_torch.ops import InverseRealFFT2, InverseRealSHT, RealFFT2, RealSHT
from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.utils.tracing import span


@lru_cache(maxsize=None)
def get_transform_pair(kind, nlat, nlon, lmax, mmax, grid, device="cpu"):
    """Cached (forward, inverse) spectral transforms per shape, modes, grid and
    device; transforms of one grid share one device table. "fft" takes no
    grid and no table."""
    if kind == "sht":
        return (
            RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid, device=device),
            InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid, device=device),
        )
    if kind == "fft":
        return (RealFFT2(nlat, nlon, lmax=lmax, mmax=mmax),
                InverseRealFFT2(nlat, nlon, lmax=lmax, mmax=mmax))
    raise ValueError("Unknown spectral transform")


class SpectralFilterLayer(nn.Module):
    """The spectral filter under the name `filter`: SpectralAttention for
    filter_type "non-linear", FactorizedSpectralConv for "linear" with a
    factorization, SpectralConv for "linear"."""

    def __init__(self, forward_transform, inverse_transform, embed_dim, filter_type="linear",
                 operator_type="diagonal", hidden_size_factor=1.0, factorization=None, rank=1.0,
                 separable=False, complex_activation="real", spectral_layers=1, bias=False,
                 drop_rate=0.0, gain=1.0, device="cpu", generator=None):
        super().__init__()
        self.embed_dim = embed_dim
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
            self.filter = FactorizedSpectralConv(
                forward_transform, inverse_transform, embed_dim, embed_dim,
                operator_type=operator_type, rank=rank, factorization=factorization,
                separable=separable, bias=bias, gain=gain, device=device, generator=generator)
            return
        self.filter = SpectralConv(forward_transform, inverse_transform, embed_dim, embed_dim,
                                   operator_type=operator_type, separable=separable, bias=bias,
                                   gain=gain, device=device, generator=generator)

    @span("model.filter")
    def forward(self, x, deterministic=True, x_axis=None):
        """x's channels split over `x_axis`; (out, residual), both split as x
        is (the SpectralConv's layout, or x's gathered and cut again); the
        span "model.filter"."""
        if isinstance(self.filter, SpectralConv):
            return self.filter(x, x_axis)
        if x_axis is not None:
            x = spmd.gather(x, 1, x_axis, self.embed_dim)
        if self.non_linear:
            out, residual = self.filter(x, deterministic=deterministic)
        else:
            out, residual = self.filter(x)
        if x_axis is not None:
            out, residual = spmd.scatter(out, 1, x_axis), spmd.scatter(residual, 1, x_axis)
        return out, residual


class FourierNeuralOperatorBlock(nn.Module):
    """filter -> norm0 -> act -> MLP -> norm1 -> drop_path -> linear outer skip,
    the block makani_tpu's SFNO builds (inner skip "none", outer skip
    "linear", no final activation)."""

    def __init__(self, forward_transform, inverse_transform, embed_dim, filter_type="linear",
                 operator_type="diagonal", mlp_ratio=2.0, mlp_drop_rate=0.0,
                 path_drop_rate=0.0, act_name="gelu", norm_layer="instance_norm",
                 factorization=None, rank=1.0, separable=False, use_mlp=False,
                 complex_activation="real", spectral_layers=1, bias=False, checkpointing=0,
                 device="cpu", generator=None):
        super().__init__()
        self.act = get_activation(act_name)
        # gain bookkeeping of the reference init scheme: the filter feeds an
        # activation, the MLP and the outer skip share one sum
        self.filter_layer = SpectralFilterLayer(
            forward_transform, inverse_transform, embed_dim, filter_type=filter_type,
            operator_type=operator_type, hidden_size_factor=mlp_ratio,
            factorization=factorization, rank=rank, separable=separable,
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
        if norm_layer == "layer_norm":
            return LayerNorm2d(embed_dim, eps=1e-6, affine=True, device=device)
        if norm_layer == "none":
            return nn.Identity()
        raise NotImplementedError(f"normalization {norm_layer} not implemented")

    def forward(self, x, deterministic=True, x_axis=None):
        """x's channels split over `x_axis`; the output's as x's."""
        x, residual = self.filter_layer(x, deterministic, x_axis)
        x = self.act(apply_norm(self.norm0, x, x_axis))
        if self.mlp is not None:
            with span("model.mlp"):
                x = self.mlp(x, deterministic=deterministic, x_axis=x_axis)
        x = self.drop_path(apply_norm(self.norm1, x, x_axis), deterministic=deterministic)
        return x + self.outer_skip(residual, x_axis)


class ScannedBlocks(nn.Module):
    """makani_tpu's nn.scan over `length` identical blocks: `block` is the
    template, and each of its parameters holds every layer's weight along a
    leading layer axis. Layer i runs the template on the i-th slices, always
    recomputed in backward; its dropout sites are the template's, offset by
    i times their count (`number_sites`)."""

    def __init__(self, length, make_block):
        super().__init__()
        self.length = length
        layers = [make_block() for _ in range(length)]
        self.block = layers[0]
        for name, _ in list(self.block.named_parameters()):
            owner, leaf = self._owner(name)
            stacked = torch.stack([dict(b.named_parameters())[name].detach() for b in layers])
            setattr(owner, leaf, nn.Parameter(stacked))
        self.sites = [m for m in self.block.modules() if isinstance(m, (Dropout, DropPath))]
        self.site_base = 0

    def _owner(self, name):
        *path, leaf = name.split(".")
        return self.block.get_submodule(".".join(path)), leaf

    def number_sites(self, base):
        """Take sites base, base + 1, ...: the template's count for each
        layer; returns the number taken."""
        self.site_base = base
        return len(self.sites) * self.length

    def _layer(self, x, i, deterministic, x_axis):
        for j, m in enumerate(self.sites):
            m.site = self.site_base + i * len(self.sites) + j
        weights = {name: p[i] for name, p in self.block.named_parameters()}
        return torch.func.functional_call(self.block, weights, (x,),
                                          {"deterministic": deterministic, "x_axis": x_axis})

    def forward(self, x, deterministic=True, x_axis=None):
        for i in range(self.length):
            x = remat(self._layer, x, i, deterministic, x_axis)
        return x


class SphericalFourierNeuralOperatorNet(nn.Module):
    """SFNO as in Bonev et al.; the arguments are makani_tpu's, plus `device`
    and the `generator` the weights are drawn from. On spatial ranks it takes
    and returns the rank's (B, C, lat/h, lon/w) patch; the spectral
    transforms (the SHT pair, or the FFT pair of the planar FNO), the
    filters, the norms and the position embedding see the decomposition,
    every other layer is local."""

    # runs on a spatial decomposition (spmd.spatially_parallel reads it)
    spatially_parallel = True

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
        self.checkpointing = checkpointing
        self.inp_shape = tuple(inp_shape)
        self.out_shape = tuple(out_shape)
        self.big_skip = big_skip
        self.repeat_layers = repeat_layers
        self.embed_dim = embed_dim
        self.out_chans = out_chans
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
        self.pos_embed_kind = pos_embed if pos_embed not in ("none", "None", None) else None
        if self.pos_embed_kind == "direct":
            self.pos_embed = self._trunc_normal((1, embed_dim, *self.inp_shape), device,
                                                generator)
        elif self.pos_embed_kind == "frequency":
            lmax, mmax = self.itrans_up.lmax, self.itrans_up.mmax
            self.pos_embed_r = self._trunc_normal((1, embed_dim, lmax, mmax), device, generator,
                                                  diagonal=0)
            self.pos_embed_c = self._trunc_normal((1, embed_dim, lmax, mmax - 1), device,
                                                  generator, diagonal=-1)
        elif self.pos_embed_kind is not None:
            raise ValueError("Unknown position embedding type")
        self.pos_drop = Dropout(pos_drop_rate)
        self.pos_drop.global_hw = self.inp_shape

        dpr = np.linspace(0, path_drop_rate, num_layers)

        def block(fwd_t, inv_t, rate):
            return FourierNeuralOperatorBlock(
                fwd_t, inv_t, embed_dim, filter_type=filter_type, operator_type=operator_type,
                mlp_ratio=mlp_ratio, mlp_drop_rate=mlp_drop_rate, path_drop_rate=rate,
                act_name=activation_function, norm_layer=normalization_layer,
                factorization=factorization, rank=rank, separable=separable, use_mlp=use_mlp,
                complex_activation=complex_activation, spectral_layers=spectral_layers,
                bias=bias, checkpointing=checkpointing, device=device, generator=generator)

        first = block(self.trans_down, itrans if num_layers > 1 else self.itrans_up,
                      float(dpr[0]))
        self.scan = scan_layers and num_layers > 2 and repeat_layers == 1
        if self.scan:
            mid_rate = float(np.mean(dpr[1:-1]))
            self.blocks = nn.ModuleDict({"0": first})
            self.scan_blocks = ScannedBlocks(num_layers - 2,
                                             lambda: block(trans, itrans, mid_rate))
            self.blocks[str(num_layers - 1)] = block(trans, self.itrans_up, float(dpr[-1]))
        else:
            self.blocks = nn.ModuleList([first] + [
                block(trans, self.itrans_up if i == num_layers - 1 else itrans, float(dpr[i]))
                for i in range(1, num_layers)])
        self.decoder = EncoderDecoder(encoder_layers, embed_dim, out_chans,
                                      int(decoder_ratio * embed_dim), self.act,
                                      gain=0.5 if big_skip else 1.0, device=device,
                                      generator=generator)
        if big_skip:
            self.residual_transform = normal_param(
                (out_chans, inp_chans), math.sqrt(0.5 / inp_chans), device, generator)
        self.n_dropout_sites = number_dropout_sites(self)

    @staticmethod
    def _trunc_normal(shape, device, generator, diagonal=None):
        """flax's truncated_normal(stddev=0.02): N(0, 1) truncated to [-2, 2],
        times 0.02; zero above the `diagonal` of the last two axes when
        given (makani_tpu's tril_init)."""
        w = trunc_normal_param(shape, 0.02, device, generator)
        if diagonal is not None:
            w.data *= torch.ones(shape[-2:], dtype=torch.bool, device=device).tril(diagonal)
        return w

    def _position_embedding(self, axis):
        """The embedding on the rank's patch and channels (split over `axis`)."""
        if self.pos_embed_kind == "direct":
            return leaf_part(self, "pos_embed", 1, axis)
        # the imaginary part of the m = 0 column is zero
        cpad = nn.functional.pad(self.pos_embed_c, (1, 0))
        coeffs = torch.complex(self.pos_embed_r, cpad)
        if axis is not None:
            coeffs = spmd.scatter(coeffs, 1, axis)
        if spmd.spatial_distributed():
            coeffs = spmd.coefficient_block(coeffs, diagonal=True)   # (l/h, m/w)
        return self.itrans_up(coeffs)

    def _run_blocks(self, x, deterministic, axis):
        if self.scan:
            x = self.blocks["0"](x, deterministic=deterministic, x_axis=axis)
            x = self.scan_blocks(x, deterministic, axis)
            return self.blocks[str(self.scan_blocks.length + 1)](x, deterministic=deterministic,
                                                                 x_axis=axis)
        for _ in range(self.repeat_layers):
            for blk in self.blocks:
                if self.checkpointing >= 3:
                    x = remat(blk, x, deterministic, axis)
                else:
                    x = blk(x, deterministic=deterministic, x_axis=axis)
        return x

    def forward(self, x, deterministic=True):
        if self.big_skip:
            if self.out_shape != self.inp_shape:
                residual = self.itrans_up(self.trans_down(x.float())).to(x.dtype)
            else:
                residual = x
        x = remat(self.encoder, x) if self.checkpointing >= 1 else self.encoder(x)
        axis = self.encoder.out_axis     # the embedding's channels: fin (or whole)
        if self.pos_embed_kind is not None:
            x = x + self._position_embedding(axis).to(x.dtype)
        x = self.pos_drop(x, deterministic, (1, axis, self.embed_dim))
        x = self._run_blocks(x, deterministic, axis)
        if self.checkpointing >= 1:
            x = remat(self.decoder, x, axis)
        else:
            x = self.decoder(x, axis)
        if self.decoder.out_axis is not None:
            x = spmd.gather(x, 1, self.decoder.out_axis, self.out_chans)
        if self.big_skip:
            b, c, h, w = residual.shape
            rw = self.residual_transform.to(residual.dtype).expand(b, -1, -1)
            x = x + torch.bmm(rw, residual.reshape(b, c, h * w)).view(b, -1, h, w)
        return x


class FourierNeuralOperatorNet(SphericalFourierNeuralOperatorNet):
    """The planar FNO: the SFNO on the truncated 2D FFT pair (makani_tpu's
    FourierNeuralOperatorNet); the same arguments."""

    def __init__(self, spectral_transform="fft", **kwargs):
        super().__init__(spectral_transform=spectral_transform, **kwargs)
