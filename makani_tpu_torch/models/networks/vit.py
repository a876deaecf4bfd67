"""Vision Transformer over spatial patches with a linear reconstruction head.

Counterpart of makani_tpu/models/networks/vit.py (:24-155): patch embedding
-> position embedding (and dropout at path_drop_rate, as makani_tpu has it)
-> blocks (norm1, multi-head self-attention, residual, norm2, MLP, residual)
-> LayerNorm -> dense head -> the depatchify einsum nhwpqc->nchpwq. A block
applies norm2 to x before both the residual and the MLP (vit.py:90), a quirk
of the reference that is kept. The attention is
models/common/attention.py's (materialised up to 2048 tokens, blockwise
beyond); with attn_drop_rate > 0 in training it materialises the softmax to
drop on it, as makani_tpu does. The norms and dense layers are flax's
(models/common/layers.py): they promote a bf16 input to float32, so under
bf16 AMP the network is bf16 only in the patch embedding, the position
embedding and block 0's first residual. Each block has one DropPath for the
attention's branch and one for the MLP's, so the two draw their own masks
as flax's two calls do.

Channels split over fin and fout (makani_tpu's rules; its head-parallel
attention, makani mpu/layers.py:454-524): the tokens' embedding channels are
split over fin from the patch embedding on; the attention's heads over fout
where fout divides their number. The qkv kernel (C, 3C) is stored as
makani_tpu splits it, its 3C outputs in contiguous blocks over fout, which
do not line up with heads (4 heads of 8 on fout 2: rank 0 holds all of q and
half of k); the attention gathers the kernel's fout blocks (and the bias's)
and takes the columns of the rank's heads, and the backward sums their
gradients over fout before each rank keeps its block. The proj kernel's
inputs are split over fout in head order, so it contracts the rank's heads
and sums over fout; the MLP is fin -> fout -> fin; the head contracts fin.

Spatial ranks (h, w; makani_tpu runs the ViT through its partitioner on
inputs sharded over (h, w)): each rank takes its window of the image, whose
patches are its tile of the (gh, gw) token grid (spmd.image_tile) and not a
contiguous range of the serial token order, and gives back its window of
the output. The norms, the MLP and the head are per token and local; the
(1, N, C) position embedding stays whole over h and w (makani_tpu's rule
(None, None, "fin")) and is indexed at the tile's tokens, its gradient
summed over the spatial group as every shared leaf's. In the attention q
stays local and k and v are gathered over the spatial group into the serial
token order (spmd.gather_tokens), so the blockwise recurrence's key blocks
and its padded last block fall where the serial run puts them; the backward
sums the k and v cotangents back to their owners. The dropout masks are
drawn at the whole token count and cut to the tile's tokens.
"""

from typing import Tuple

import numpy as np
import torch
from torch import nn

from makani_tpu_torch.models.common import DropPath, Dropout, get_activation
from makani_tpu_torch.models.common.attention import scaled_dot_product_attention
from makani_tpu_torch.models.common.layers import (
    DenseLayer,
    LayerNorm,
    PatchEmbed,
    leaf_part,
    number_dropout_sites,
    parallel_linear,
    trunc_normal_param,
)
from makani_tpu_torch.parallel import spmd


class Attention(nn.Module):
    """Multi-head self-attention: qkv (kernel (C, 3C), bias where qkv_bias),
    attention, proj (kernel (C, C), bias)."""

    def __init__(self, dim, num_heads=8, qkv_bias=False, attn_drop_rate=0.0, proj_drop_rate=0.0,
                 device="cpu", generator=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim should be divisible by num_heads")
        self.dim = dim
        self.num_heads = num_heads
        self.attn_drop_rate = attn_drop_rate
        self.qkv = DenseLayer(dim, 3 * dim, use_bias=qkv_bias, device=device, generator=generator)
        self.attn_drop = Dropout(attn_drop_rate)
        self.proj = DenseLayer(dim, dim, device=device, generator=generator)
        self.proj_drop = Dropout(proj_drop_rate)

    def _head_columns(self, t, dim, heads, head_axis):
        """The q, k and v columns of the heads [heads.start, heads.stop) of a
        qkv leaf `t` whose 3C outputs lie along `dim` (gathered whole from
        their fout blocks where stored so); the gradient of the columns
        sums over the ranks that take them before the gather's backward
        keeps the rank's block."""
        stored = spmd.leaf_axis(self.qkv, "kernel" if dim == 1 else "bias", dim)
        if stored is not None:
            t = spmd.gather(t, dim, stored, 3 * self.dim)
        if heads.stop - heads.start == self.num_heads:
            return t
        t = spmd.copy_to(t, head_axis)
        hd = self.dim // self.num_heads
        cols = torch.cat([torch.arange(s * self.dim + heads.start * hd,
                                       s * self.dim + heads.stop * hd) for s in range(3)])
        return t.index_select(dim, cols.to(t.device))

    def forward(self, x, deterministic=True, x_axis=None, grid=None):
        """x (B, N, C) with its channels split over `x_axis`, on spatial
        ranks the tokens of its tile of the token `grid`; the output's split
        over the proj kernel's outputs."""
        b, n = x.shape[:2]
        head_dim = self.dim // self.num_heads
        scale = head_dim ** -0.5
        head_axis = spmd.channel_axis(self.num_heads, "fout")
        heads = (spmd.patch_slice(self.num_heads, head_axis) if head_axis
                 else slice(0, self.num_heads))
        nh = heads.stop - heads.start
        xp = x.to(torch.promote_types(x.dtype, self.qkv.kernel.dtype))
        kernel = self._head_columns(self.qkv.kernel, 1, heads, head_axis).to(xp.dtype)
        qkv = parallel_linear(xp, -1, x_axis, spmd.leaf_axis(self.qkv, "kernel", 0), head_axis,
                              self.dim, lambda v: v @ kernel)
        if self.qkv.bias is not None:
            qkv = qkv + self._head_columns(self.qkv.bias, 0, heads, head_axis).to(xp.dtype)
        qkv = qkv.reshape(b, n, 3, nh, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # (B, N, H, D)
        if spmd.spatial_distributed():
            # every token's keys and values, in the serial order
            k, v = (spmd.gather_tokens(t, 1, grid) for t in (k, v))
        if self.attn_drop_rate > 0.0 and not deterministic:
            attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
            # the heads' mask cut to the rank's heads where they are split
            split = ((1, head_axis, self.num_heads),) if head_axis else ()
            attn = self.attn_drop(attn, deterministic, *split)
            y = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, nh * head_dim)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            y = scaled_dot_product_attention(q, k, v, scale=scale)
            y = y.transpose(1, 2).reshape(b, n, nh * head_dim)
        return self.proj_drop(self.proj(y, head_axis), deterministic,
                              (2, self.proj.out_axis, self.dim))


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False, mlp_drop_rate=0.0,
                 attn_drop_rate=0.0, path_drop_rate=0.0, activation_function="gelu",
                 device="cpu", generator=None):
        super().__init__()
        self.act = get_activation(activation_function)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = Attention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                              attn_drop_rate=attn_drop_rate, proj_drop_rate=mlp_drop_rate,
                              device=device, generator=generator)
        self.drop_path_attn = DropPath(path_drop_rate)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.sizes = (int(dim * mlp_ratio), dim)
        self.mlp_fc1 = DenseLayer(dim, int(dim * mlp_ratio), device=device, generator=generator)
        self.mlp_drop1 = Dropout(mlp_drop_rate)
        self.mlp_fc2 = DenseLayer(int(dim * mlp_ratio), dim, device=device, generator=generator)
        self.mlp_drop2 = Dropout(mlp_drop_rate)
        self.drop_path_mlp = DropPath(path_drop_rate)
        # the token grid of the network (set by VisionTransformer)
        self.grid = None

    def forward(self, x, deterministic=True, x_axis=None):
        """x's channels split over `x_axis`, the output's alike."""
        y = self.attn(self.norm1(x, x_axis), deterministic=deterministic, x_axis=x_axis,
                      grid=self.grid)
        x = self.norm2(x + self.drop_path_attn(y, deterministic=deterministic), x_axis)
        hidden, out = self.mlp_fc1.out_axis, self.mlp_fc2.out_axis
        h = self.mlp_drop1(self.act(self.mlp_fc1(x, x_axis)), deterministic,
                           (2, hidden, self.sizes[0]))
        h = self.mlp_drop2(self.mlp_fc2(h, hidden), deterministic, (2, out, self.sizes[1]))
        return x + self.drop_path_mlp(h, deterministic=deterministic)


class VisionTransformer(nn.Module):
    """The ViT; the arguments are makani_tpu's, plus `device` and the
    `generator` the weights are drawn from. On spatial ranks it takes and
    returns the rank's window (module docstring)."""

    # runs on a spatial decomposition (spmd.spatially_parallel reads it)
    spatially_parallel = True

    def __init__(self, inp_shape: Tuple[int, int] = (224, 224),
                 patch_size: Tuple[int, int] = (16, 16), inp_chans=3, out_chans=3, embed_dim=768,
                 depth=12, num_heads=12, mlp_ratio=4.0, qkv_bias=True, mlp_drop_rate=0.0,
                 attn_drop_rate=0.0, path_drop_rate=0.0, activation_function="gelu",
                 device="cpu", generator=None):
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
        self.pos_drop = Dropout(path_drop_rate)
        dpr = np.linspace(0, path_drop_rate, depth)
        self.blocks = nn.ModuleList([
            ViTBlock(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                     mlp_drop_rate=mlp_drop_rate, attn_drop_rate=attn_drop_rate,
                     path_drop_rate=float(dpr[i]), activation_function=activation_function,
                     device=device, generator=generator)
            for i in range(depth)])
        for blk in self.blocks:
            blk.grid = self.grid
            blk.attn.attn_drop.tokens = (2, self.grid)      # (B, H, N, M): the query rows
            for drop in (blk.attn.proj_drop, blk.mlp_drop1, blk.mlp_drop2):
                drop.tokens = (1, self.grid)
        self.pos_drop.tokens = (1, self.grid)
        self.norm = LayerNorm(embed_dim, eps=1e-5, device=device)
        self.head = DenseLayer(embed_dim, out_chans * self.patch_size[0] * self.patch_size[1],
                               use_bias=False, device=device, generator=generator)
        self.n_dropout_sites = number_dropout_sites(self)

    def forward(self, x, deterministic=True):
        b = x.shape[0]
        gh, gw = (spmd.patch(n, ax)[1] for n, ax in zip(self.grid, ("h", "w")))
        axis = self.patch_embed.out_axis        # the embedding's channels: fin (or whole)
        pos = leaf_part(self, "pos_embed", 2, axis)
        if spmd.spatial_distributed():
            pos = pos.index_select(1, spmd.tile_tokens(self.grid, pos.device))
        x = self.patch_embed(x).transpose(1, 2) + pos.to(x.dtype)
        x = self.pos_drop(x, deterministic, (2, axis, self.embed_dim))
        for blk in self.blocks:
            x = blk(x, deterministic=deterministic, x_axis=axis)
        x = self.norm(x, axis)
        x = self.head(x.reshape(b, gh, gw, x.shape[-1]), axis)
        p, q = self.patch_size
        x = x.reshape(b, gh, gw, p, q, self.out_chans).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, self.out_chans, gh * p, gw * q)
