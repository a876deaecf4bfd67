"""AFNO v1, the original FourCastNet backbone (NHWC tokens), and PrecipNet.

Counterpart of makani_tpu/models/networks/afnonet.py (:27-232): patch
embedding -> position embedding -> blocks (LayerNorm, AFNO filter with
separate real and imaginary weights, double skip, LayerNorm, token MLP,
stochastic depth, residual) -> a dense head and the pixel shuffle in the
reference's order (0, 5, 1, 3, 2, 4). The filter keeps makani_tpu's
*centred* row window [total - kept, total + kept) with total = h // 2 + 1
and the first `kept` longitudes (kept counted from h), applied after each
layer of the spectral MLP. The norms, the MLP and the head are flax's
Dense and LayerNorm (models/common/layers.py): they promote a bf16 input to
float32, so under bf16 AMP the network is bf16 only in the patch embedding,
the position embedding and block 0's first residual, and float32 from block
0's first norm on. `PrecipNet` puts a periodic pad (circular in longitude,
zeros in latitude), a VALID 3x3 convolution (kernel HWIO, as flax's) and a
ReLU after a backbone, whose weights it holds under ``backbone``.

Channels split over fin. makani_tpu's rules split the patch embedding's
channels, the position embedding's C and the head's input over fin, and
also hit the filter's leaves: "fin" on the leading (re, im) axis of w1 and
w2 and on the blocks of b1 and b2 (makani_tpu/models/networks/afnonet.py:
67-70). The leaves are stored as the rules split them. The filter's
computation cannot follow a split of its real and imaginary parts, so the
network gathers the tokens' channels after the position embedding, runs
the blocks on the whole channels with the filter's leaves gathered, and
the head contracts the rank's fin chunk again.
Spatial ranks (h, w; makani_tpu runs the family through its partitioner on
inputs sharded over (h, w)): each rank takes its window of the image, whose
patches are its tile of the token grid (spmd.image_tile), and gives back its
window of the output. The patch embedding, the norms, the MLP and the head
are per token and local; the whole position embedding is indexed at the
tile's tokens. The filter's rfft2 is the distributed FFT pair untruncated
(ops/fft.py, on the channels-first view): its block MLP is per mode and
runs on the rank's (l/h, m/w) block under the window mask of the modes'
global indices. PrecipNet's periodic pad is a one-wide halo exchange
(spmd.halo): periodic in longitude across the w ranks, zeros at the global
latitude edges, a neighbour's row or column everywhere else.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from makani_tpu_torch.models.common import DropPath, Dropout, get_activation
from makani_tpu_torch.models.common.layers import (
    LECUN_STD,
    DenseLayer,
    LayerNorm,
    PatchEmbed,
    leaf_part,
    normal_param,
    number_dropout_sites,
    promoted,
    trunc_normal_param,
)
from makani_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.models.networks.afnonet_v2 import softshrink


class MlpV1(nn.Module):
    """Token MLP over the last axis: fc1 -> activation -> dropout -> fc2 ->
    dropout."""

    def __init__(self, in_features, hidden_features, drop_rate=0.0, activation_function="gelu",
                 device="cpu", generator=None):
        super().__init__()
        self.act = get_activation(activation_function)
        self.fc1 = DenseLayer(in_features, hidden_features, device=device, generator=generator)
        self.drop1 = Dropout(drop_rate)
        self.fc2 = DenseLayer(hidden_features, in_features, device=device, generator=generator)
        self.drop2 = Dropout(drop_rate)

    def forward(self, x, deterministic=True):
        x = self.drop1(self.act(self.fc1(x)), deterministic)
        return self.drop2(self.fc2(x), deterministic)


class AFNO2Dv1(nn.Module):
    """Blockwise spectral MLP on NHWC tokens; w1 (2, blocks, bs, hidden), b1
    (2, blocks, hidden), w2 (2, blocks, hidden, bs), b2 (2, blocks, bs), the
    leading axis (re, im)."""

    def __init__(self, hidden_size, num_blocks=8, sparsity_threshold=0.01,
                 hard_thresholding_fraction=1.0, hidden_size_factor=1, device="cpu",
                 generator=None):
        super().__init__()
        if hidden_size % num_blocks != 0:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_blocks "
                             f"{num_blocks}")
        self.num_blocks = num_blocks
        self.sparsity_threshold = sparsity_threshold
        self.hard_thresholding_fraction = hard_thresholding_fraction
        bs = hidden_size // num_blocks
        hidden = bs * hidden_size_factor
        self.w1 = normal_param((2, num_blocks, bs, hidden), 0.02, device, generator)
        self.b1 = normal_param((2, num_blocks, hidden), 0.02, device, generator)
        self.w2 = normal_param((2, num_blocks, hidden, bs), 0.02, device, generator)
        self.b2 = normal_param((2, num_blocks, bs), 0.02, device, generator)

    def mode_mask(self, h, w, device):
        """makani_tpu's centred window as a (1, h, w // 2 + 1, 1, 1) mask; on
        spatial ranks the rank's (l/h, m/w) block of it."""
        total = h // 2 + 1
        kept = int(total * self.hard_thresholding_fraction)
        kh = torch.arange(h, device=device)
        keep_h = (kh >= total - kept) & (kh < total + kept)
        keep_m = torch.arange(w // 2 + 1, device=device) < kept
        mask = (keep_h[:, None] & keep_m[None, :]).float()
        if spmd.spatial_distributed():
            mask = mask[spmd.patch_slice(h, "h"), spmd.patch_slice(w // 2 + 1, "w")]
        return mask[None, :, :, None, None]

    def forward(self, x, grid=None):
        """x (B, h, w, C) tokens, on spatial ranks its tile of the token
        `grid`."""
        bias, dtype = x, x.dtype
        b, c = x.shape[0], x.shape[-1]
        h, w = grid or x.shape[1:3]
        # the pair on the channels-first view: (b, c, l, m), the rank's block
        xf = RealFFT2(h, w)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        xf = xf.reshape(b, *xf.shape[1:3], self.num_blocks, c // self.num_blocks)
        mask = self.mode_mask(h, w, x.device)
        # the leaves whole where the rules split them (module docstring)
        w1, w2 = (leaf_part(self, k, 0, None, 2) for k in ("w1", "w2"))
        b1, b2 = (leaf_part(self, k, 1, None, self.num_blocks) for k in ("b1", "b2"))

        def mix(a, weight):
            return torch.einsum("bhwki,kio->bhwko", a, weight)

        xr, xi = xf.real, xf.imag
        o1r = torch.relu(mix(xr, w1[0]) - mix(xi, w1[1]) + b1[0]) * mask
        o1i = torch.relu(mix(xi, w1[0]) + mix(xr, w1[1]) + b1[1]) * mask
        o2r = (mix(o1r, w2[0]) - mix(o1i, w2[1]) + b2[0]) * mask
        o2i = (mix(o1i, w2[0]) + mix(o1r, w2[1]) + b2[1]) * mask
        xf = torch.complex(softshrink(o2r, self.sparsity_threshold),
                           softshrink(o2i, self.sparsity_threshold))
        xf = xf.reshape(b, *xf.shape[1:3], c).permute(0, 3, 1, 2)
        return InverseRealFFT2(h, w)(xf).permute(0, 2, 3, 1).to(dtype) + bias


class BlockV1(nn.Module):
    """norm1 -> filter -> (double skip) -> norm2 -> MLP -> drop_path ->
    residual, on NHWC tokens."""

    def __init__(self, dim, mlp_ratio=4.0, drop_rate=0.0, path_drop_rate=0.0, double_skip=True,
                 num_blocks=8, sparsity_threshold=0.01, hard_thresholding_fraction=1.0,
                 activation_function="gelu", device="cpu", generator=None):
        super().__init__()
        self.double_skip = double_skip
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.filter = AFNO2Dv1(dim, num_blocks, sparsity_threshold, hard_thresholding_fraction,
                               device=device, generator=generator)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = MlpV1(dim, int(dim * mlp_ratio), drop_rate,
                         activation_function=activation_function, device=device,
                         generator=generator)
        self.drop_path = DropPath(path_drop_rate)

    def forward(self, x, deterministic=True, grid=None):
        residual = x
        x = self.filter(self.norm1(x), grid)
        if self.double_skip:
            x = x + residual
            residual = x
        # the token MLP on (B, h * w, C): its dropout masks are drawn on the
        # tokens (the serial (B, h, w, C) draw, flattened)
        x = self.mlp(self.norm2(x).flatten(1, 2), deterministic=deterministic)
        x = x.unflatten(1, residual.shape[1:3])
        return self.drop_path(x, deterministic=deterministic) + residual


class AdaptiveFourierNeuralOperatorNetV1(nn.Module):
    """AFNO v1; the arguments are makani_tpu's, plus `device` and the
    `generator` the weights are drawn from. On spatial ranks it takes and
    returns the rank's window (module docstring)."""

    # runs on a spatial decomposition (spmd.spatially_parallel reads it)
    spatially_parallel = True

    def __init__(self, inp_shape: Tuple[int, int] = (720, 1440),
                 patch_size: Tuple[int, int] = (16, 16), inp_chans=2, out_chans=2, embed_dim=768,
                 num_layers=12, mlp_ratio=4.0, drop_rate=0.0, drop_path_rate=0.0, num_blocks=16,
                 sparsity_threshold=0.01, hard_thresholding_fraction=1.0,
                 activation_function="gelu", device="cpu", generator=None):
        super().__init__()
        self.inp_shape = tuple(inp_shape)
        self.patch_size = tuple(patch_size)
        self.out_chans = out_chans
        self.embed_dim = embed_dim
        self.grid = (self.inp_shape[0] // self.patch_size[0],
                     self.inp_shape[1] // self.patch_size[1])
        self.patch_embed = PatchEmbed(self.inp_shape, self.patch_size, inp_chans, embed_dim,
                                      device=device, generator=generator)
        self.pos_embed = trunc_normal_param((1, self.grid[0] * self.grid[1], embed_dim), 0.02,
                                            device, generator)
        self.pos_drop = Dropout(drop_rate)
        self.pos_drop.tokens = (1, self.grid)
        dpr = np.linspace(0, drop_path_rate, num_layers)
        self.blocks = nn.ModuleList([
            BlockV1(embed_dim, mlp_ratio=mlp_ratio, drop_rate=drop_rate,
                    path_drop_rate=float(dpr[i]), num_blocks=num_blocks,
                    sparsity_threshold=sparsity_threshold,
                    hard_thresholding_fraction=hard_thresholding_fraction,
                    activation_function=activation_function, device=device, generator=generator)
            for i in range(num_layers)])
        for blk in self.blocks:
            for drop in (blk.mlp.drop1, blk.mlp.drop2):
                drop.tokens = (1, self.grid)
        self.head = DenseLayer(embed_dim, out_chans * self.patch_size[0] * self.patch_size[1],
                               use_bias=False, device=device, generator=generator)
        self.n_dropout_sites = number_dropout_sites(self)

    def forward(self, x, deterministic=True):
        b = x.shape[0]
        h, w = (spmd.patch(n, ax)[1] for n, ax in zip(self.grid, ("h", "w")))
        axis = self.patch_embed.out_axis        # the embedding's channels: fin (or whole)
        pos = leaf_part(self, "pos_embed", 2, axis)
        if spmd.spatial_distributed():
            pos = pos.index_select(1, spmd.tile_tokens(self.grid, pos.device))
        x = self.patch_embed(x).transpose(1, 2) + pos.to(x.dtype)
        x = self.pos_drop(x, deterministic, (2, axis, self.embed_dim))
        if axis is not None:
            x = spmd.gather(x, 2, axis, self.embed_dim)
        x = x.reshape(b, h, w, self.embed_dim)
        for blk in self.blocks:
            x = blk(x, deterministic=deterministic, grid=self.grid)
        x = self.head(x)
        # the pixel shuffle with the reference's order (c last)
        p0, p1 = self.patch_size
        x = x.reshape(b, h, w, p0, p1, self.out_chans).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, self.out_chans, h * p0, w * p1)


class PeriodicPad2d(nn.Module):
    """Circular pad in longitude, zero pad in latitude, `pad_width` each
    side, as a halo (spmd.halo): the longitude neighbours' columns over w,
    the ring wrapping at the ends, then the latitude neighbours' rows (of
    the padded width, so the corners are the diagonal neighbours') over h,
    zeros beyond the poles; serially the field's own far columns."""

    def __init__(self, pad_width=1):
        super().__init__()
        self.pad_width = pad_width

    def forward(self, x):
        p = self.pad_width
        west, east = spmd.halo(x, -1, "w", p, periodic=True)
        x = torch.cat((west, x, east), dim=-1)
        north, south = spmd.halo(x, -2, "h", p, periodic=False)
        return torch.cat((north, x, south), dim=-2)


class PrecipNet(nn.Module):
    """`backbone` -> periodic pad -> VALID 3x3 convolution `conv` (kernel
    (3, 3, in, out), bias) -> ReLU. The convolution's input channels are the
    backbone's `out_chans`; its weight is drawn as flax's Conv draws
    (lecun_normal over fan_in 9 * in). On spatial ranks the rank's window in
    and out: the pad is a halo exchange, the convolution local."""

    # runs on a spatial decomposition where its backbone does
    spatially_parallel = True

    def __init__(self, backbone, out_chans=2, device="cpu", generator=None):
        super().__init__()
        self.backbone = backbone
        self.ppad = PeriodicPad2d(1)
        self.conv = nn.Module()
        cin = backbone.out_chans
        self.conv.kernel = trunc_normal_param((3, 3, cin, out_chans),
                                              LECUN_STD / (9 * cin) ** 0.5, device, generator)
        self.conv.bias = nn.Parameter(torch.zeros(out_chans, device=device))

    def forward(self, x, deterministic=True):
        x = self.ppad(self.backbone(x, deterministic=deterministic))
        x = promoted(x, self.conv.kernel)
        kernel = self.conv.kernel.to(x.dtype).permute(3, 2, 0, 1)
        return torch.relu(F.conv2d(x, kernel, self.conv.bias.to(x.dtype)))
