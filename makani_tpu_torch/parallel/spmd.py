"""Explicit collectives for the data, spatial and channel decomposition.

Counterpart of makani_tpu/parallel/spmd.py. makani_tpu pins the sharding of
intermediates and lets XLA's partitioner insert the collectives; here they
are written out, each a torch.autograd.Function whose backward is the dual
collective (the reference's distributed transposes and mappings,
makani mpu/layers.py:38-169, mpu/mappings.py:30-174):

  distributed_transpose   all-to-all: split one dimension over a group,
                          gather another; backward the reverse transpose
  all_reduce_sum          sum of partial values, the result replicated;
                          backward passes the (replicated) cotangent through
  copy_to                 identity; backward sums the partial cotangents
  gather_uneven           all-gather of uneven chunks; backward the own slice
  scatter                 the rank's chunk of a replicated tensor; backward
                          the all-gather of the chunks' cotangents
  reduce_scatter          the rank's chunk of a sum of partial values;
                          backward the all-gather
  gather_tokens           every token of a grid split over h and w, in the
                          serial order; backward sums the ranks' cotangents
                          and keeps the rank's tile's
  halo                    a patch's neighbours' edge rows over one axis
                          (periodic or zero beyond the ends); backward sums
                          the edges' cotangents back to their owners
  whole_field             a network without a spatially parallel path on
                          the whole field: the patches gathered, the network
                          run with the model axes serial, the output cut
                          back to the rank's patch

The channel axes follow one rule throughout: a tensor that is replicated over
an axis holds, on every rank, the whole cotangent in backward. So a tensor
that ranks slice (scatter) gathers its cotangent, a tensor that feeds a
computation whose outputs differ by rank (a weight split over its output
channels) goes through copy_to, and a sum of partial products
(all_reduce_sum, reduce_scatter) passes its cotangent on as it is.

Uneven splits follow `split_shapes`, the ceil-division convention of
jax.sharding (makani_tpu/data/dataset.py `sharding_split_shapes`), so a
rank's patch is the block of the JAX device shard at the same coordinates:
721 over 2 is 361 + 360, 73 over 2 is 37 + 36.

Under gloo (ranks sharing a card, or the CPU) a collective on a CUDA tensor
is staged through host memory; under NCCL it runs on the card. With one rank
in the group every function returns its input and no collective runs.
"""

import collections
import math

import torch
import torch.distributed as dist

from makani_tpu_torch.parallel import comm

# bytes each kind of collective has sent from this rank to the others (a
# rank's own chunk of an all-to-all stays out); callers reset and read it
moved = collections.Counter()


def split_shapes(size, num_chunks):
    """Chunk i covers [i*ceil, min((i+1)*ceil, size)) (jax.sharding's uneven
    shards)."""
    chunk = -(-int(size) // int(num_chunks))
    return [max(0, min(chunk, int(size) - i * chunk)) for i in range(int(num_chunks))]


def patch(size, axis):
    """(start, length) of the rank's chunk of `size` along mesh axis `axis`."""
    sizes = split_shapes(size, comm.get_size(axis))
    r = comm.get_rank(axis)
    return sum(sizes[:r]), sizes[r]


def patch_slice(size, axis):
    start, n = patch(size, axis)
    return slice(start, start + n)


def spatial_distributed():
    return comm.get_size("spatial") > 1


def matmul_distributed():
    return comm.get_size("matmul") > 1


def model_distributed():
    return comm.get_size("model") > 1


def leaf_axis(module, leaf, dim):
    """The axis that dimension `dim` of `module`'s parameter `leaf` is split
    over (partitioning.shard_module tells the module), or None."""
    return getattr(module, "leaf_splits", {}).get(leaf, {}).get(dim)


def channel_axis(size, axis="fin"):
    """`axis` where its group has more than one rank and divides `size`,
    else None: makani_tpu splits a parameter's dimension only where the axis
    divides it (partitioning._fit_spec), and the activations that meet that
    parameter are split alike."""
    n = comm.get_size(axis)
    return axis if n > 1 and int(size) % n == 0 else None


def data_distributed():
    return comm.get_size("data") > 1


def _staged(x):
    """(tensor for the collective, device to return to): gloo takes host
    tensors, NCCL the rank's card."""
    nccl = comm.get_backend() == "nccl"
    if x.device.type == "cuda" and not nccl:
        return x.detach().cpu(), x.device
    if nccl and x.device.type != "cuda":
        return x.detach().to(comm.get_device()), x.device
    return x.detach(), None


def _back(x, device):
    return x if device is None else x.to(device, non_blocking=False)


def all_reduce_(x, group_name, op=dist.ReduceOp.SUM):
    """In-place all-reduce of `x` over the group (no autograd); returns x."""
    group = comm.get_group(group_name)
    if group is None:
        return x
    buf, dev = _staged(x)
    moved["all_reduce"] += buf.numel() * buf.element_size()
    dist.all_reduce(buf, op=op, group=group)
    if dev is not None:
        x.copy_(buf)
    return x


def broadcast_(x, group_name, src_group_rank=0):
    """In-place broadcast from the group's rank `src_group_rank`."""
    group = comm.get_group(group_name)
    if group is None:
        return x
    buf, dev = _staged(x)
    dist.broadcast(buf, src=comm.get_group_ranks(group_name)[src_group_rank], group=group)
    if dev is not None:
        x.copy_(buf)
    return x


def _all_to_all(chunks_out_sizes, x_flat, in_sizes, group):
    """1-D all_to_all_single with element split sizes."""
    buf, dev = _staged(x_flat)
    moved["all_to_all"] += (sum(in_sizes) - in_sizes[dist.get_rank(group)]) * buf.element_size()
    out = torch.empty(sum(chunks_out_sizes), dtype=buf.dtype, device=buf.device)
    dist.all_to_all_single(out, buf, output_split_sizes=list(chunks_out_sizes),
                           input_split_sizes=list(in_sizes), group=group)
    return _back(out, dev)


def _transpose(x, split_dim, gather_dim, group_name, split_sizes, gather_sizes):
    group = comm.get_group(group_name)
    me = comm.get_rank(group_name)
    split_dim %= x.ndim
    gather_dim %= x.ndim
    if x.shape[split_dim] != sum(split_sizes) or x.shape[gather_dim] != gather_sizes[me]:
        raise ValueError(f"transpose over {group_name}: shape {tuple(x.shape)} does not hold "
                         f"{sum(split_sizes)} along {split_dim} and {gather_sizes[me]} along "
                         f"{gather_dim}")
    # the split dimension leading: chunk j is a contiguous run of rows
    xs = x.movedim(split_dim, 0).contiguous()
    rest = list(xs.shape[1:])
    g_axis = gather_dim - (1 if gather_dim > split_dim else 0)   # in `rest`
    shapes = [rest[:g_axis] + [g] + rest[g_axis + 1:] for g in gather_sizes]
    row = math.prod(rest)
    in_sizes = [s * row for s in split_sizes]
    out_sizes = [split_sizes[me] * math.prod(shape) for shape in shapes]
    out = _all_to_all(out_sizes, xs.reshape(-1), in_sizes, group)
    parts = [flat.view([split_sizes[me]] + shape)
             for flat, shape in zip(out.split(out_sizes), shapes)]
    y = torch.cat(parts, dim=1 + g_axis)
    return y.movedim(0, split_dim)


class _DistributedTranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, gather_dim, group_name, split_sizes, gather_sizes):
        ctx.args = (gather_dim, split_dim, group_name, gather_sizes, split_sizes)
        return _transpose(x, split_dim, gather_dim, group_name, split_sizes, gather_sizes)

    @staticmethod
    def backward(ctx, g):
        return (_DistributedTranspose.apply(g.contiguous(), *ctx.args),
                None, None, None, None, None)


def distributed_transpose(x, split_dim, gather_dim, group_name, split_sizes, gather_sizes):
    """All-to-all over the group: `x` holds all of `split_dim`
    (sum(split_sizes)) and the rank's chunk of `gather_dim`
    (gather_sizes[rank]); the result holds the rank's chunk
    split_sizes[rank] of `split_dim` and all of `gather_dim`. Runs on
    all_to_all_single with the split dimension moved to the front and the
    chunks flattened, so uneven chunks exchange whatever the backend.
    Identity over a group of one rank."""
    if comm.get_size(group_name) == 1:
        return x
    return _DistributedTranspose.apply(x, split_dim, gather_dim, group_name,
                                       tuple(split_sizes), tuple(gather_sizes))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_name):
        return all_reduce_(x.clone(), group_name)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_name):
        ctx.group_name = group_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group_name), None


def all_reduce_sum(x, group_name):
    """Sum over the group of each rank's partial `x`, replicated on every
    rank; the cotangent, the same on every rank, passes through (the
    reference's reduce_from_parallel_region)."""
    if comm.get_size(group_name) == 1:
        return x
    return _AllReduceSum.apply(x, group_name)


def copy_to(x, group_name):
    """Identity; the cotangents of the ranks' partial uses of a replicated
    `x` are summed in backward (the reference's copy_to_parallel_region)."""
    if comm.get_size(group_name) == 1:
        return x
    return _CopyTo.apply(x, group_name)


def reduce_partial(x, group_name):
    """A sum of partial values that each rank then uses on its own patch:
    all-reduce forward and backward (copy_to of all_reduce_sum)."""
    return copy_to(all_reduce_sum(x, group_name), group_name)


def _gather(x, dim, group_name, sizes):
    group = comm.get_group(group_name)
    n = comm.get_size(group_name)
    dim %= x.ndim
    big = max(sizes)
    pad = list(x.shape)
    pad[dim] = big
    buf = x.new_zeros(pad)
    buf.narrow(dim, 0, x.shape[dim]).copy_(x)
    staged, dev = _staged(buf)
    moved["all_gather"] += staged.numel() * staged.element_size()
    outs = [torch.empty_like(staged) for _ in range(n)]
    dist.all_gather(outs, staged.contiguous(), group=group)
    y = torch.cat([o.narrow(dim, 0, s) for o, s in zip(outs, sizes)], dim=dim)
    return _back(y, dev)


class _GatherUneven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_name, sizes):
        ctx.args = (dim, group_name, sizes)
        return _gather(x, dim, group_name, sizes)

    @staticmethod
    def backward(ctx, g):
        dim, group_name, sizes = ctx.args
        r = comm.get_rank(group_name)
        return g.narrow(dim, sum(sizes[:r]), sizes[r]), None, None, None


def gather_uneven(x, dim, group_name, sizes):
    """The chunks of every rank of the group along `dim`, concatenated in
    group order; `sizes` the chunks' lengths. The backward takes the rank's
    own slice of a replicated cotangent."""
    if comm.get_size(group_name) == 1:
        return x
    return _GatherUneven.apply(x, dim, group_name, tuple(sizes))


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_name):
        ctx.args = (dim, group_name, tuple(split_shapes(x.shape[dim], comm.get_size(group_name))))
        return x.narrow(dim, *patch(x.shape[dim], group_name)).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group_name, sizes = ctx.args
        return _gather(g.contiguous(), dim, group_name, sizes), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group_name):
        ctx.args = (dim, group_name, tuple(split_shapes(x.shape[dim], comm.get_size(group_name))))
        y = all_reduce_(x.contiguous().clone(), group_name)
        return y.narrow(dim, *patch(x.shape[dim], group_name)).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group_name, sizes = ctx.args
        return _gather(g.contiguous(), dim, group_name, sizes), None, None


def scatter(x, dim, group_name):
    """The rank's chunk (split_shapes) of `x` along `dim`, `x` being the same
    on every rank of the group; the backward gathers the chunks'
    cotangents, so `x` gets its whole cotangent on every rank."""
    if comm.get_size(group_name) == 1:
        return x
    return _Scatter.apply(x, dim % x.ndim, group_name)


def reduce_scatter(x, dim, group_name):
    """The rank's chunk along `dim` of the sum over the group of each rank's
    partial `x` (an all-reduce, then the chunk); the backward gathers the
    chunks' cotangents."""
    if comm.get_size(group_name) == 1:
        return x
    return _ReduceScatter.apply(x, dim % x.ndim, group_name)


def gather(x, dim, group_name, size):
    """The whole of a dimension of global length `size` from the ranks'
    chunks (split_shapes); the backward takes the rank's own slice of the
    cotangent, which the rule above keeps whole on every rank."""
    return gather_uneven(x, dim, group_name, split_shapes(size, comm.get_size(group_name)))


def gather_patch(x, global_hw):
    """The full (..., H, W) field from every spatial rank's patch (no
    autograd needed by the callers: exports and host scores)."""
    H, W = global_hw
    x = gather_uneven(x, -1, "w", split_shapes(W, comm.get_size("w")))
    return gather_uneven(x, -2, "h", split_shapes(H, comm.get_size("h")))


def coefficient_block(w, diagonal):
    """The rank's block of a complex spectral weight that is held whole:
    (..., L) -> (..., l/h), or for the diagonal operator (..., L, M) ->
    (..., l/h, m/w)."""
    if not diagonal:
        return w[..., patch_slice(w.shape[-1], "h")]
    return w[..., patch_slice(w.shape[-2], "h"), patch_slice(w.shape[-1], "w")]


def local_patch(x, global_hw):
    """The rank's (h, w) patch of a full (..., H, W) field."""
    if not spatial_distributed():
        return x
    H, W = global_hw
    return x[..., patch_slice(H, "h"), patch_slice(W, "w")]


def image_tile(img_size, patch_size):
    """The rank's (rows, columns) of a (H, W) image whose (H / ph, W / pw)
    token grid is split over h and w: its token tile times the patch. It
    must be the rank's window of the image itself (the loader's split), else
    a patch would straddle two ranks: that raises."""
    tile = []
    for size, p, axis in zip(img_size, patch_size, ("h", "w")):
        start, n = patch(size // p, axis)
        if (start * p, n * p) != patch(size, axis):
            raise ValueError(f"the patch size {tuple(patch_size)} does not divide the "
                             f"{axis} ranks' windows of the image {tuple(img_size)} evenly: "
                             f"window {patch(size, axis)}, tokens {(start, n)}")
        tile.append(n * p)
    return tuple(tile)


def tile_tokens(grid, device):
    """int64 indices, in the serial (row-major) token order of the (gh, gw)
    grid, of the rank's tile's tokens, row-major within the tile."""
    (h0, hn), (w0, wn) = patch(grid[0], "h"), patch(grid[1], "w")
    rows = torch.arange(h0, h0 + hn, device=device)[:, None] * int(grid[1])
    return (rows + torch.arange(w0, w0 + wn, device=device)[None, :]).reshape(-1)


def gather_tokens(x, dim, grid):
    """All tokens of the (gh, gw) grid in the serial order, from each spatial
    rank's tile (its tokens row-major along `dim`); every rank uses the
    whole, so the backward sums the ranks' cotangents (copy_to) before each
    keeps its tile's."""
    if not spatial_distributed():
        return x
    dim %= x.dim()
    (_, hn), (_, wn) = patch(grid[0], "h"), patch(grid[1], "w")
    t = x.unflatten(dim, (hn, wn))
    t = gather(t, dim + 1, "w", grid[1])
    t = gather(t, dim, "h", grid[0])
    return copy_to(t.flatten(dim, dim + 1), "spatial")


def halo(x, dim, axis, width, periodic):
    """The `width` entries before and after the rank's patch along `dim`,
    from its neighbours over `axis` (periodic: the ring wraps; else zeros
    beyond the global ends), as (before, after). One all-gather of every
    rank's edges; the backward sums each edge's cotangents back to its
    owner (copy_to). On one rank: the patch's own far edges, or zeros."""
    n, r = comm.get_size(axis), comm.get_rank(axis)
    dim %= x.dim()
    size = x.shape[dim]
    edges = torch.cat((x.narrow(dim, 0, width), x.narrow(dim, size - width, width)), dim=dim)
    if n > 1:
        edges = copy_to(gather_uneven(edges.contiguous(), dim, axis, [2 * width] * n), axis)

    def edge(rank, side):
        if not periodic and not 0 <= rank < n:
            return torch.zeros_like(x.narrow(dim, 0, width))
        return edges.narrow(dim, (rank % n) * 2 * width + side * width, width)
    return edge(r - 1, 1), edge(r + 1, 0)


def spatially_parallel(net):
    """Whether `net` runs on a rank's (h, w) patch and splits its own work
    over the model axes: its class sets `spatially_parallel`, as every
    network of the port's registry does. Any other network (a class
    registered from a file) runs in whole_field, its leaves whole
    (partitioning.shard_module)."""
    return bool(getattr(net, "spatially_parallel", False))


def whole_field(net, x, global_hw, **kwargs):
    """net(x, **kwargs) for a network that is not spatially_parallel, on any
    layout, as serial makani_tpu computes it. Under h * w > 1 the rank's
    patch `x` of the (H, W) = `global_hw` field is gathered, w then h, and
    the network's output is cut to the rank's patch of its own (H, W);
    every rank runs the network on the whole field, inside
    comm.serial_model_axes(), so port modules inside it take their serial
    branches (under fin and fout alone every rank computes the same output).
    The whole field goes through copy_to: each rank's cotangent of it holds
    only its own patch's share of the output's, and the sum over the ranks
    comes before the gathers' backward keeps the rank's patch."""
    if spatial_distributed():
        if global_hw is None:
            raise ValueError("a network without a spatially parallel path needs its input's "
                             "global (H, W) on spatial ranks")
        H, W = global_hw
        x = gather(x, -1, "w", W)
        x = copy_to(gather(x, -2, "h", H), "spatial")
    with comm.serial_model_axes():
        y = net(x, **kwargs)
    return local_patch(y, y.shape[-2:])
