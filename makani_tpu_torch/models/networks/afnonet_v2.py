"""Adaptive FNO v2 (NCHW tokens, blockwise complex spectral MLP).

Counterpart of makani_tpu/models/networks/afnonet_v2.py (:32-244): patch
embedding -> position embedding -> blocks (norm1, AFNO filter, skip, norm2,
MLP, stochastic depth, residual) -> a 1x1 head and the pixel shuffle in the
reference's channel order (p0, p1, c). The filter computes in float32 and
complex64 whatever its input's type: rfft2 (torch.fft, cuFFT on the card),
the blockwise complex MLP with a cartesian ReLU, makani_tpu's static
two-sided mode mask, softshrink on both parts, irfft2, then the output cast
back with the bias and the input added in the input's type. The other
modules keep makani_tpu's dtype rules: the patch embedding, the skip, the
MLP and the head cast their weights to the input's type, so under bf16 AMP
the network stays bf16 from the patch embedding to the head (its GELU is
ops/gelu.py's kernel). Parameter names are makani_tpu's (``blocks.<i>`` for
``blocks_<i>``), and every weight keeps its layout. Dropout sites are
numbered in registration order (models/common/layers.py).

Channels split over fin (makani_tpu's rules; its DistributedAFNO2Dv2, makani
mpu/layers.py:544-643): the embedding's channels are split over fin from the
patch embedding on, and the filter's blocks with them (w1, w2 over their
blocks, b1 over C), so each rank's filter runs on its own blocks; where fin
divides C but not the number of blocks the filter runs on the gathered
channels. The position embedding (1, C, N) is stored split over its tokens,
as makani_tpu's 3-D rule has it, and gathered, then cut to the rank's
channels; the skip gathers its input over fin; the MLP is fin -> fout ->
fin; the head contracts fin.

Spatial ranks (h, w; makani_tpu runs the family through its partitioner on
inputs sharded over (h, w)): each rank takes its window of the image, whose
patches are its tile of the (h, w) token grid (spmd.image_tile), and gives
back its window of the output. The patch embedding, the skip, the MLP and
the head are local; the position embedding, whole, is indexed at the tile's
tokens. The filter's rfft2 is the distributed FFT pair untruncated
(ops/fft.py, lmax = h, mmax = w // 2 + 1): its complex MLP is per mode, so
it runs on the rank's (l/h, m/w) block, and the static mode mask takes the
modes' global indices. LayerNormHW takes its statistics over the whole
(H, W) through the spatial group and cuts its (H, W) affine to the rank's
patch.
"""

from typing import Tuple

import numpy as np
import torch
from torch import nn

from makani_tpu_torch.models.common import MLP, DropPath, Dropout, InstanceNorm2d, get_activation
from makani_tpu_torch.models.common.layers import (
    PatchEmbed,
    apply_norm,
    leaf_part,
    normal_param,
    number_dropout_sites,
    parallel_linear,
    trunc_normal_param,
)
from makani_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.utils.tracing import span


def softshrink(x, lambd):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - lambd, 0.0)


def _as_complex(w):
    return torch.complex(w[..., 0], w[..., 1])


class AFNO2Dv2(nn.Module):
    """Blockwise complex spectral MLP with a hard mode threshold and
    softshrink; w1 (blocks, bs, bs * f, 2), b1 (1, C, 1, 1), w2 (blocks, bs * f,
    bs, 2), the last axis (re, im)."""

    def __init__(self, hidden_size, num_blocks=8, sparsity_threshold=0.0,
                 hard_thresholding_fraction=1.0, hidden_size_factor=1, device="cpu",
                 generator=None):
        super().__init__()
        if hidden_size % num_blocks != 0:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_blocks "
                             f"{num_blocks}")
        self.num_blocks = num_blocks
        self.hidden_size = hidden_size
        self.sparsity_threshold = sparsity_threshold
        self.hard_thresholding_fraction = hard_thresholding_fraction
        bs = hidden_size // num_blocks
        self.w1 = normal_param((num_blocks, bs, bs * hidden_size_factor, 2), 0.02, device,
                               generator)
        self.b1 = normal_param((1, num_blocks * bs, 1, 1), 0.02, device, generator)
        self.w2 = normal_param((num_blocks, bs * hidden_size_factor, bs, 2), 0.02, device,
                               generator)

    def mode_mask(self, h, w, device):
        """makani_tpu's static (h, w // 2 + 1) mask: latitude rows kept at
        both ends (every row when the kept count reaches h // 2 + 1), the
        first longitudes; on spatial ranks the rank's (l/h, m/w) block of
        it."""
        total_h, total_w = h // 2 + 1, w // 2 + 1
        kept_h = int(total_h * self.hard_thresholding_fraction)
        kept_w = int(total_w * self.hard_thresholding_fraction)
        kh = torch.arange(h, device=device)
        keep_h = (kh < kept_h) | (kh >= h - kept_h) if kept_h < total_h else kh >= 0
        keep_m = torch.arange(total_w, device=device) < kept_w
        mask = (keep_h[:, None] & keep_m[None, :]).float()
        if spmd.spatial_distributed():
            mask = mask[spmd.patch_slice(h, "h"), spmd.patch_slice(total_w, "w")]
        return mask

    def forward(self, x, x_axis=None, grid=None):
        """x's channels split over `x_axis`, on spatial ranks its tile of the
        token `grid` (h, w); the output's alike."""
        grid = tuple(grid or x.shape[-2:])
        blocks_axis = spmd.leaf_axis(self, "w1", 0)
        if x_axis != blocks_axis:
            # the blocks do not follow the channels' split: the whole filter
            # on the gathered channels, then the rank's chunk
            if x_axis is not None:
                x = spmd.gather(x, 1, x_axis, self.hidden_size)
            w1, w2 = (leaf_part(self, k, 0, None, self.num_blocks) for k in ("w1", "w2"))
            y = self._filter(x, w1, w2, leaf_part(self, "b1", 1, None, self.hidden_size), grid)
            return spmd.scatter(y, 1, x_axis) if x_axis is not None else y
        return self._filter(x, self.w1, self.w2, self.b1, grid)

    def _filter(self, x, w1, w2, b1, grid):
        bias, dtype = x, x.dtype
        b, c = x.shape[:2]
        h, w = grid
        nb = w1.shape[0]
        fwd, inv = RealFFT2(h, w), InverseRealFFT2(h, w)
        xf = fwd(x)                                  # (b, c, l, m): the rank's block
        xf = xf.reshape(b, nb, c // nb, *xf.shape[-2:])
        o1 = torch.einsum("bkihw,kio->bkohw", xf, _as_complex(w1))
        o1 = torch.complex(torch.relu(o1.real), torch.relu(o1.imag))
        o2 = torch.einsum("bkohw,koi->bkihw", o1, _as_complex(w2))
        o2 = o2 * self.mode_mask(h, w, x.device)
        o2 = torch.complex(softshrink(o2.real, self.sparsity_threshold),
                           softshrink(o2.imag, self.sparsity_threshold))
        o2 = o2.reshape(b, c, *o2.shape[-2:])
        xout = inv(o2).to(dtype)
        return xout + b1.to(dtype) + bias


class LayerNormHW(nn.Module):
    """Normalization over the trailing (H, W) axes with an elementwise (H, W)
    affine `weight`, `bias` (torch nn.LayerNorm(normalized_shape=(h, w))
    semantics): jnp's mean and two-pass variance, computed in float32 and
    returned in the input's type, then the normalization in the input's
    type. On spatial ranks each pass's sums are summed over the spatial
    group, and the affine, whole (makani_tpu's rules leave it replicated),
    is cut to the rank's patch; its gradient sums over the group as every
    shared leaf's does (partitioning.reduce_gradients)."""

    def __init__(self, shape, eps=1e-6, device="cpu"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(tuple(shape), device=device))
        self.bias = nn.Parameter(torch.zeros(tuple(shape), device=device))

    def forward(self, x, x_axis=None):
        """Per channel, x's channels split over `x_axis`; the affine, shared
        by every channel, sums its gradient over that axis (copy_to)."""
        xf = x.float()
        if spmd.spatial_distributed():
            n = float(self.weight.numel())
            mean = spmd.reduce_partial(xf.sum(dim=(-2, -1), keepdim=True), "spatial") / n
            var = spmd.reduce_partial((xf - mean).square().sum(dim=(-2, -1), keepdim=True),
                                      "spatial") / n
        else:
            mean = xf.mean(dim=(-2, -1), keepdim=True)
            var = (xf - mean).square().mean(dim=(-2, -1), keepdim=True)
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + self.eps)
        weight, bias = self.weight, self.bias
        if x_axis is not None:
            weight, bias = spmd.copy_to(weight, x_axis), spmd.copy_to(bias, x_axis)
        weight, bias = (spmd.local_patch(t, t.shape) for t in (weight, bias))
        return y * weight.to(x.dtype) + bias.to(x.dtype)


class BlockV2(nn.Module):
    """norm1 -> AFNO filter -> skip -> norm2 -> MLP -> drop_path -> residual.
    `grid` is the (h, w) token grid, which LayerNormHW's affine takes."""

    def __init__(self, dim, grid, mlp_ratio=4.0, drop_rate=0.0, path_drop_rate=0.0,
                 norm_layer="instance_norm", num_blocks=8, sparsity_threshold=0.01,
                 hard_thresholding_fraction=1.0, skip_fno="linear", nested_skip_fno=True,
                 checkpointing=0, activation_function="gelu", device="cpu", generator=None):
        super().__init__()
        self.grid = tuple(grid)
        self.skip_fno = skip_fno
        self.nested_skip_fno = nested_skip_fno
        self.norm1 = self._norm(norm_layer, dim, grid, device)
        self.filter = AFNO2Dv2(dim, num_blocks, sparsity_threshold, hard_thresholding_fraction,
                               device=device, generator=generator)
        if skip_fno == "linear":
            self.skip_weight = trunc_normal_param((dim, dim), 0.02, device, generator)
            self.skip_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.norm2 = self._norm(norm_layer, dim, grid, device)
        self.mlp = MLP(dim, int(dim * mlp_ratio), act_layer=get_activation(activation_function),
                       drop_rate=drop_rate, checkpointing=checkpointing, device=device,
                       generator=generator)
        for drop in (self.mlp.drop1, self.mlp.drop2):
            drop.global_hw = self.grid
        self.drop_path = DropPath(path_drop_rate)

    @staticmethod
    def _norm(norm_layer, dim, grid, device):
        if norm_layer == "instance_norm":
            return InstanceNorm2d(dim, eps=1e-6, affine=True, device=device)
        if norm_layer == "layer_norm":
            return LayerNormHW(grid, eps=1e-6, device=device)
        raise NotImplementedError(f"Error, normalization {norm_layer} not implemented.")

    def forward(self, x, deterministic=True, x_axis=None):
        """x's channels split over `x_axis`, the output's alike."""
        residual = x
        x = apply_norm(self.norm1, x, x_axis)
        with span("model.filter"):
            x = self.filter(x, x_axis, self.grid)
        if self.skip_fno == "linear":
            b, c, h, w = residual.shape
            weight = self.skip_weight.to(x.dtype).expand(b, -1, -1)
            out_axis = spmd.leaf_axis(self, "skip_weight", 0)
            skip = parallel_linear(residual.reshape(b, c, h * w), 1, x_axis,
                                   spmd.leaf_axis(self, "skip_weight", 1), out_axis,
                                   self.skip_weight.shape[1], lambda v: torch.bmm(weight, v))
            bias = leaf_part(self, "skip_bias", 0, out_axis)
            x = x + skip.view(b, -1, h, w) + bias.to(x.dtype)[None, :, None, None]
        elif self.skip_fno == "identity":
            x = x + residual
        if self.skip_fno in ("linear", "identity") and not self.nested_skip_fno:
            residual = x
        x = apply_norm(self.norm2, x, x_axis)
        with span("model.mlp"):
            x = self.mlp(x, deterministic=deterministic, x_axis=x_axis)
        return self.drop_path(x, deterministic=deterministic) + residual


class AdaptiveFourierNeuralOperatorNet(nn.Module):
    """AFNO v2: patch embed -> AFNO blocks -> pixel-shuffle head; the
    arguments are makani_tpu's, plus `device` and the `generator` the weights
    are drawn from. On spatial ranks it takes and returns the rank's window
    (module docstring)."""

    # runs on a spatial decomposition (spmd.spatially_parallel reads it)
    spatially_parallel = True

    def __init__(self, inp_shape: Tuple[int, int] = (720, 1440),
                 patch_size: Tuple[int, int] = (16, 16), inp_chans=2, out_chans=2, embed_dim=768,
                 num_layers=12, mlp_ratio=4.0, drop_rate=0.0, drop_path_rate=0.0, num_blocks=16,
                 sparsity_threshold=0.01, normalization_layer="instance_norm", skip_fno="linear",
                 nested_skip_fno=True, hard_thresholding_fraction=1.0, checkpointing=0,
                 activation_function="gelu", device="cpu", generator=None):
        super().__init__()
        self.inp_shape = tuple(inp_shape)
        self.patch_size = tuple(patch_size)
        self.out_chans = out_chans
        self.embed_dim = embed_dim
        self.checkpointing = checkpointing
        if self.inp_shape[0] % self.patch_size[0] or self.inp_shape[1] % self.patch_size[1]:
            raise ValueError(f"Error, the patch size {self.patch_size} does not divide the image "
                             f"dimensions {self.inp_shape} evenly.")
        self.grid = (self.inp_shape[0] // self.patch_size[0],
                     self.inp_shape[1] // self.patch_size[1])
        self.patch_embed = PatchEmbed(self.inp_shape, self.patch_size, inp_chans, embed_dim,
                                      device=device, generator=generator)
        self.pos_embed = trunc_normal_param((1, embed_dim, self.grid[0] * self.grid[1]), 0.02,
                                            device, generator)
        self.pos_drop = Dropout(drop_rate)
        self.pos_drop.global_hw = self.grid
        dpr = np.linspace(0, drop_path_rate, num_layers)
        self.blocks = nn.ModuleList([
            BlockV2(embed_dim, self.grid, mlp_ratio=mlp_ratio, drop_rate=drop_rate,
                    path_drop_rate=float(dpr[i]), norm_layer=normalization_layer,
                    num_blocks=num_blocks, sparsity_threshold=sparsity_threshold,
                    hard_thresholding_fraction=hard_thresholding_fraction, skip_fno=skip_fno,
                    nested_skip_fno=nested_skip_fno, checkpointing=checkpointing,
                    activation_function=activation_function, device=device,
                    generator=generator)
            for i in range(num_layers)])
        self.head_weight = trunc_normal_param(
            (out_chans * self.patch_size[0] * self.patch_size[1], embed_dim), 0.02, device,
            generator)
        self.n_dropout_sites = number_dropout_sites(self)

    def forward(self, x, deterministic=True):
        b = x.shape[0]
        h, w = (spmd.patch(n, ax)[1] for n, ax in zip(self.grid, ("h", "w")))
        axis = self.patch_embed.out_axis        # the embedding's channels: fin (or whole)
        pos = leaf_part(self, "pos_embed", 2, None, self.grid[0] * self.grid[1])
        if axis is not None:
            pos = spmd.scatter(pos, 1, axis)
        if spmd.spatial_distributed():
            pos = pos.index_select(2, spmd.tile_tokens(self.grid, pos.device))
        x = (self.patch_embed(x) + pos.to(x.dtype)).reshape(b, -1, h, w)
        # the mask drawn on (B, C, h, w) holds the serial (B, C, h * w) draw
        x = self.pos_drop(x, deterministic, (1, axis, self.embed_dim))
        for blk in self.blocks:
            x = blk(x, deterministic=deterministic, x_axis=axis)
        # the 1x1 head, then the pixel shuffle with the reference's channel
        # order (p0, p1, c)
        weight = self.head_weight.to(x.dtype).expand(b, -1, -1)
        x = parallel_linear(x.reshape(b, x.shape[1], h * w), 1, axis,
                            spmd.leaf_axis(self, "head_weight", 1), None, self.embed_dim,
                            lambda v: torch.bmm(weight, v))
        p0, p1 = self.patch_size
        x = x.reshape(b, p0, p1, self.out_chans, h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, self.out_chans, h * p0, w * p1)
