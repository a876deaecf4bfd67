"""Which parameters are split over ranks, and how their gradients reduce.

Counterpart of makani_tpu/parallel/partitioning.py. makani_tpu maps every
parameter path to a PartitionSpec and lets GSPMD place the leaves and insert
the gradient collectives; here each rank holds its shard of a split leaf as
a plain tensor, and the gradient reductions are explicit, with the
reference's semantics (makani mpu/mappings.py:30-174): the MEAN over the
`data` axis, and the SUM over every spatial axis that shares the leaf (a
rank's gradient of a shared leaf holds only its patch's contribution).

The spatial rules (makani_tpu's `_RULES` entries for "h" and "w",
partitioning.py:35-45), on the port's layout of each leaf:
  - the linear spectral filter's weight: l over h (the dhconv operator), l
    over h and m over w (the diagonal one); its gradient sums over the
    other spatial axis (w for dhconv) and averages over data;
  - the "direct" position embedding (1, C, H, W): H over h, W over w.
A dimension that its axis does not divide, which makani_tpu's _fit_spec
keeps whole, is cut unevenly (spmd.split_shapes) to match the rank's block
of the coefficients it multiplies; the values are the same. Every other
leaf is replicated; a replicated leaf that the forward reads a patch of
(the "frequency" position embedding's coefficients, a position bias, a
factorized filter's or an l-dependant non-linear filter's weight, AFNO v2's
LayerNormHW (H, W) affine, the AFNO and ViT (1, N, C) position embeddings
indexed at a rank's tokens) is sliced there, and its gradient sums over the
spatial group like any other.

The channel rules (fin, fout) are makani_tpu's `_RULES` entries for those
axes (partitioning.py:24-68), carried as data (`TENSOR_PARALLEL_RULES`, path
pattern and spec in makani_tpu's layout of the leaf) and mapped onto the
port's layout (the stacked dhconv weight (2, L, C, O) takes the filter
rule's "fin" on its C). As makani_tpu's `_fit_spec` does, an axis that does
not divide its dimension leaves it whole (the 73 data channels under fin 2),
and a scanned leaf keeps its leading layer axis whole (`spec_for_path`). A
leaf split over fin or fout holds the whole gradient of its shard after the
backward; a whole leaf that a module uses on a channel slice of its
activations takes the slice through spmd.scatter, whose backward gathers
the slices' gradients, so no channel axis is summed here: the modules make
that choice where they use the leaf (the rule of parallel/spmd).

A network that is not spatially parallel (spmd.spatially_parallel: a class
registered from a file) runs on the whole field on every rank
(spmd.whole_field), so none of its leaves is split, on any axis, whatever
the rules above would find in it; its gradients follow the rule of the
replicated leaves: the sum over h and w (the loss of a rank sees its patch
of the output) and the mean over data.

`shard_module` cuts a model built at its global shapes to the rank's shards
and returns each split leaf's `Shard` (its global shape and, per split
dimension, the axis, start and length); it also tells each owning module
which of its leaves' dimensions are split (`leaf_splits`, read through
spmd.leaf_axis), so the forward follows the stored shards. `sync_params`
broadcasts every leaf from the first rank of the ranks that hold the same
shard; `reduce_gradients`
reduces the gradients in one flattened buffer per dtype and group;
`gather_full` and `local_slice` take a leaf between its shard and its whole.
"""

import re
from collections import namedtuple

import torch

from makani_tpu_torch.parallel import comm, spmd
from makani_tpu_torch.utils.param_layout import (
    is_stacked_filter,
    jax_dims,
    layer_axes,
    torch_key_to_jax,
)

# one split dimension of a leaf: its index in the port's layout, the mesh
# axis, the rank's start and length along it
Split = namedtuple("Split", ["dim", "axis", "start", "length"])
# a split leaf: its global (unsplit) shape and its split dimensions
Shard = namedtuple("Shard", ["global_shape", "splits"])

SPATIAL = ("h", "w")

# makani_tpu's channel-parallel rules (parallel/partitioning.py:26-68), flax
# path pattern -> spec in makani_tpu's layout of the leaf (a callable takes
# the leaf's shape there); the spatial entries are `spatial_rules`'
TENSOR_PARALLEL_RULES = [
    (r".*(mlp|encoder|decoder)/(fc1|fwd_\d+)/weight$", ("fout", "fin")),
    (r".*(mlp|encoder|decoder)/(fc1|fwd_\d+)/bias$", ("fout",)),
    (r".*(mlp|encoder|decoder)/(fc2|out)/weight$", ("fin", "fout")),
    (r".*(mlp|encoder|decoder)/(fc2|out)/bias$", ("fin",)),
    (r".*filter/weight$", ("fin",)),
    (r".*(inner_skip|outer_skip)/weight$", ("fin", None)),
    # the SFNO's (1, C, H, W) embedding is split over h and w only
    (r".*pos_embed$", lambda shape: None if len(shape) == 4 else (None, None, "fin")),
    (r".*attn/qkv/kernel$", ("fin", "fout")),
    (r".*attn/qkv/bias$", ("fout",)),
    (r".*attn/proj/kernel$", ("fout", "fin")),
    (r".*attn/proj/bias$", ("fin",)),
    (r".*mlp_fc1/kernel$", ("fin", "fout")),
    (r".*mlp_fc1/bias$", ("fout",)),
    (r".*mlp_fc2/kernel$", ("fout", "fin")),
    (r".*mlp_fc2/bias$", ("fin",)),
    (r".*head/kernel$", ("fin", None)),
    (r".*patch_embed/weight$", ("fin",)),
    (r".*patch_embed/bias$", ("fin",)),
    (r".*filter/w[12]$", ("fin",)),
    (r".*filter/b[12]$", (None, "fin")),
    (r".*skip_weight$", ("fin", None)),
    (r".*head_weight$", (None, "fin")),
]


def tensor_parallel_spec(path, shape=()):
    """makani_tpu's channel-parallel spec of a flax path, for a leaf of
    `shape` in makani_tpu's layout (without a scanned layer axis); None:
    replicated."""
    for pattern, spec in TENSOR_PARALLEL_RULES:
        if re.match(pattern, path):
            return spec(tuple(shape)) if callable(spec) else spec
    return None


def fit_spec(spec, shape):
    """makani_tpu's _fit_spec: an entry beyond the leaf's rank is dropped, and
    so is one whose axis does not divide its dimension (or has one rank)."""
    out = []
    for size, axis in zip(shape, spec):
        n = comm.get_size(axis) if axis else 1
        out.append(axis if n > 1 and int(size) % n == 0 else None)
    return tuple(out)


def tensor_splits(key, shape):
    """[(dim, axis)] of the port's leaf `key` of (global) `shape` split over
    fin or fout, a scanned leaf's layer axis kept whole."""
    lead = layer_axes(key)
    order = jax_dims(key, shape)
    jshape = [int(shape[d]) for d in order]
    spec = tensor_parallel_spec(torch_key_to_jax(key), jshape[lead:])
    if not spec:
        return []
    fitted = fit_spec(spec, jshape[lead:])
    return [(order[lead + j], axis) for j, axis in enumerate(fitted) if axis]


def _spectral_splits(key, conv, shape):
    """(dim, axis) of the spatially split dimensions of a SpectralConv's
    weight in the port's layout."""
    lead = layer_axes(key)
    if is_stacked_filter(key, shape):
        return [(lead + 1, "h")]                                  # (2, L, C, O)
    if conv.operator_type == "diagonal":
        return [(len(shape) - 3, "h"), (len(shape) - 2, "w")]     # (.., L, M, 2)
    return [(len(shape) - 2, "h")]                                # (.., L, 2)


def spatial_rules(model):
    """{parameter name: [(dim, axis), ...]} of the leaves split over h and w,
    read from the modules that own them."""
    from makani_tpu_torch.models.common.spectral_convolution import SpectralConv
    rules = {}
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, SpectralConv):
            key = prefix + "weight"
            rules[key] = _spectral_splits(key, module, tuple(module.weight.shape))
        if getattr(module, "pos_embed_kind", None) == "direct":
            rules[prefix + "pos_embed"] = [(2, "h"), (3, "w")]
    return rules


def _network(model):
    """The network of a stepper (its `model`), or `model` itself."""
    from makani_tpu_torch.models.stepper import SingleStepWrapper
    return model.model if isinstance(model, SingleStepWrapper) else model


def shard_module(model):
    """Cuts every split leaf of `model` (a stepper or a network, built at
    its global shapes) to the rank's shard, in place, and tells each owning
    module its leaves' split dimensions (`leaf_splits`, behind a scanned
    layer axis); returns {name: Shard}. Serial: nothing. A network that is
    not spatially parallel runs whole on every rank: nothing is split, and
    reduce_gradients sums every leaf's gradient over h and w."""
    if not spmd.model_distributed() or not spmd.spatially_parallel(_network(model)):
        return {}
    params = dict(model.named_parameters())
    rules = spatial_rules(model)
    if spmd.matmul_distributed():
        for key, p in params.items():
            rules[key] = rules.get(key, []) + tensor_splits(key, tuple(p.shape))
    shards = {}
    for key, dims in rules.items():
        p = params[key]
        splits = []
        index = [slice(None)] * p.ndim
        for dim, axis in dims:
            if comm.get_size(axis) == 1:
                continue
            start, n = spmd.patch(p.shape[dim], axis)
            splits.append(Split(dim, axis, start, n))
            index[dim] = slice(start, start + n)
        if not splits:
            continue
        shards[key] = Shard(tuple(p.shape), tuple(splits))
        p.data = p.data[tuple(index)].contiguous()
        *owner, leaf = key.split(".")
        module = model.get_submodule(".".join(owner))
        lead = layer_axes(key)
        module.leaf_splits = {**getattr(module, "leaf_splits", {}),
                              leaf: {s.dim - lead: s.axis for s in splits}}
    return shards


def shared_axes(key, shards, axes=SPATIAL):
    """The axes among `axes` over which leaf `key` is shared (not split)."""
    split = {s.axis for s in shards[key].splits} if key in shards else set()
    return tuple(ax for ax in axes if ax not in split and comm.get_size(ax) > 1)


def sync_params(params, shards):
    """Broadcasts every leaf from the first rank of the ranks that hold the
    same shard of it (the data axis and every model axis it is not split
    over), so every rank starts from the same weights."""
    with torch.no_grad():
        for key, p in params.items():
            spmd.broadcast_(p.data, ("data",) + shared_axes(key, shards, comm.MODEL_AXES))


def reduce_gradients(grads, shards):
    """The gradients of the whole batch from each rank's: summed over the
    spatial axes that share each leaf and averaged over `data`, in place; one
    flattened buffer per dtype and group."""
    data = comm.get_size("data")
    buckets = {}
    for key, g in grads.items():
        axes = ("data",) + shared_axes(key, shards)
        if comm.get_size(axes) == 1:
            continue
        buckets.setdefault((g.dtype, axes), []).append(key)
    with torch.no_grad():
        for (_, axes), keys in buckets.items():
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            spmd.all_reduce_(flat, axes)
            if data > 1:
                flat.div_(data)
            offset = 0
            for k in keys:
                n = grads[k].numel()
                grads[k].copy_(flat[offset: offset + n].view_as(grads[k]))
                offset += n
    return grads


def leaf_square_norms(keys, tensors, shards):
    """Each leaf's sum of squares over the whole leaf (0-dim float32
    tensors): a split leaf's shards summed over its split axes, a
    replicated leaf counted once."""
    sq = [n.square() for n in torch._foreach_norm([t.float() for t in tensors])]
    split = [k for k in keys if k in shards]
    if split:
        by_axes = {}
        for i, k in enumerate(keys):
            if k in shards:
                by_axes.setdefault(tuple(s.axis for s in shards[k].splits), []).append(i)
        for axes, idx in by_axes.items():
            buf = torch.stack([sq[i] for i in idx])
            spmd.all_reduce_(buf, axes)
            for j, i in enumerate(idx):
                sq[i] = buf[j]
    return sq


def global_norm(keys, tensors, shards):
    """optax's global norm of leaves split over ranks."""
    tensors = list(tensors)
    return torch.sqrt(torch.stack(leaf_square_norms(keys, tensors, shards)).sum())


def gather_full(key, t, shards):
    """The whole leaf from every rank's shard (every rank gets it)."""
    if key not in shards:
        return t
    for s in shards[key].splits:
        sizes = spmd.split_shapes(shards[key].global_shape[s.dim], comm.get_size(s.axis))
        t = spmd.gather_uneven(t.contiguous(), s.dim, s.axis, sizes)
    return t


def local_slice(key, t, shards):
    """The rank's shard of a whole leaf `t`."""
    if key not in shards:
        return t
    index = [slice(None)] * t.ndim
    for s in shards[key].splits:
        index[s.dim] = slice(s.start, s.start + s.length)
    return t[tuple(index)].contiguous()
