"""The fused Adam kernel's table of leaves and its walk, on the CPU.

ops/fused_adam.py packs one descriptor a non-empty leaf (LEAF_DTYPE, the
kernel's LeafDesc) and csrc/fused_adam.cu launches once an update over all
of them. The kernel cannot run here, so these tests hold what surrounds it
against the per-leaf arguments it replaces, with numpy and torch alone:

- the packed table, field by field, against kernel_index_dims, shard_strides
  and moment_salts, and the tensors' addresses;
- a numpy walk of the work units as the kernel's grid takes them (blocks
  striding over units, a cursor moving forward over the leaves' `unit0`)
  covers every element of every leaf exactly once;
- the kernel's index arithmetic, the multiply-shift division and the run of
  8 elements that adds the innermost index stride (the exact formula for
  each element where a run crosses that dimension), reproduces
  jax_flat_index for the dhconv layout, an identity leaf and a shard.

The leaves are the flagship SFNO's (flagship_synth_drive_bare, 87 leaves) at
embed 10 on a 36 x 72 grid, so the dhconv weight's innermost merged
dimension (C x O = 100, index stride 2L) is not a multiple of a run; plus a
1-element leaf, an empty leaf and a rank's shard of a dhconv weight whose
first flat index is not 0.
"""

import math

import numpy as np
import pytest
import torch

from makani_tpu_torch.ops import fused_adam
from makani_tpu_torch.parallel.partitioning import Shard, Split
from makani_tpu_torch.utils.optimizers import AdamState
from makani_tpu_torch.utils.param_layout import jax_leaf_order

M32 = 0xFFFFFFFF
SEED, COUNT = 340, 7
SHARD_KEY = "model.blocks.1.filter_layer.filter.weight"
# the second h rank's degrees of block 1's (2, 18, 10, 10) dhconv weight
SHARD = Shard((2, 18, 10, 10), [Split(1, "h", 9, 9)])


@pytest.fixture(scope="module")
def flagship_shapes():
    from makani_tpu_torch.models import model_registry
    from makani_tpu_torch.utils.yparams import YParams
    p = YParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    p.update_params(dict(img_shape_x=36, img_shape_y=72, embed_dim=10, scale_factor=2,
                         enable_synthetic_data=True))
    model_registry.update_channel_params(p, n_channels=7)
    model = model_registry.get_model(p, device="cpu")
    return {k: tuple(v.shape) for k, v in model.named_parameters()}


def _update_set(shapes, moments=torch.bfloat16, seed=0):
    """Parameters, gradients and Adam state of `shapes` with the extra
    leaves: a 1-element one, an empty one, and SHARD_KEY as its shard."""
    shapes = dict(shapes, **{"z.one": (1,), "z.empty": (0, 3)})
    shapes[SHARD_KEY] = (2, 9, 10, 10)
    gen = torch.Generator().manual_seed(seed)
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    state = AdamState(0, {k: torch.zeros(s, dtype=moments) for k, s in shapes.items()},
                      {k: torch.zeros(s, dtype=moments) for k, s in shapes.items()})
    return params, grads, state, {SHARD_KEY: SHARD}


def _table(params, grads, state, shards, dirs=None):
    order = fused_adam._leaf_order(tuple(grads))
    layout = fused_adam.LeafLayout(order, params, state.mu, state.nu, shards)
    addresses = layout.gradients(params, state.mu, state.nu, grads, shards)
    return order, layout, layout.table(addresses, SEED, COUNT, dirs)


def test_table_matches_the_per_leaf_arguments(flagship_shapes):
    """Every non-empty leaf in jax.tree.flatten's order has its row: the
    addresses of its tensors, n, its first work unit after the units of the
    leaves before it, kernel_index_dims' sizes and strides padded to four
    dimensions, shard_strides' base, and moment_salts' pair at its position
    among all the leaves (the empty one included)."""
    params, grads, state, shards = _update_set(flagship_shapes)
    dirs = {k: torch.empty_like(v) for k, v in params.items()}
    order, layout, table = _table(params, grads, state, shards, dirs)
    assert list(order) == jax_leaf_order(grads) and len(order) == 87 + 2
    salts = fused_adam.moment_salts(SEED, COUNT, len(order))
    live = [(i, k) for i, k in enumerate(order) if params[k].numel()]
    assert len(table) == len(live) == 87 + 1 and "z.empty" not in [k for _, k in live]
    unit = 0
    for row, (i, key) in zip(table, live):
        p = params[key]
        shard = shards.get(key)
        sizes, strides = fused_adam.kernel_index_dims(key, p.shape, shard)
        sizes = (1,) * (4 - len(sizes)) + sizes
        strides = (0,) * (4 - len(strides)) + strides
        addresses = (p, grads[key], state.mu[key], state.nu[key], dirs[key])
        assert [int(row[f]) for f in ("p", "g", "mu", "nu", "dir")] == [
            t.data_ptr() for t in addresses], key
        assert int(row["n"]) == p.numel() and int(row["unit0"]) == unit, key
        assert tuple(int(row[f"s{d}"]) for d in (1, 2, 3)) == sizes[1:], key
        assert tuple(int(row[f"j{d}"]) for d in range(4)) == strides, key
        for d in (1, 2, 3):
            assert (int(row[f"m{d}"]), int(row[f"l{d}"])) == fused_adam.divider(sizes[d]), key
        assert int(row["base"]) == fused_adam.shard_strides(key, p.shape, shard)[1], key
        assert (int(row["salt_mu"]), int(row["salt_nu"])) == tuple(salts[2 * i: 2 * i + 2]), key
        assert bool(row["vec"]) == all(t.data_ptr() % 16 == 0 for t in addresses), key
        unit += -(-p.numel() // fused_adam.UNIT)
    assert layout.n_units == unit
    shard_row = table[[k for _, k in live].index(SHARD_KEY)]
    assert int(shard_row["base"]) == 9 * 2 > 0
    assert int(shard_row["j3"]) == 2 * 18 and int(shard_row["s3"]) == 10 * 10


def test_table_without_directions_and_misaligned_leaves(flagship_shapes):
    """Outside the direction mode `dir` is 0; a leaf whose gradient lies off
    16 bytes (a contiguous view 1 element into its storage) loses `vec` and
    goes element by element, the others keep it."""
    params, grads, state, shards = _update_set(flagship_shapes)
    key = "model.blocks.0.mlp.fc1.weight"
    grads[key] = torch.randn(grads[key].numel() + 1)[1:].view(grads[key].shape)
    order, _, table = _table(params, grads, state, shards)
    assert not table["dir"].any()
    keys = [k for k in order if params[k].numel()]
    assert [k for k, v in zip(keys, table["vec"]) if not v] == [key]


def _walk(table, n_units, blocks):
    """The kernel's grid over the table, in numpy: each block strides over
    the work units from its index, moving its leaf cursor forward while the
    next leaf's unit0 is reached; each of its 256 threads takes the run of
    VEC elements at (u - unit0) * UNIT + thread * VEC where it starts inside
    the leaf. Returns each leaf's count of visits per element and the runs
    taken whole by 16-byte vectors."""
    cover = [np.zeros(int(n), np.int64) for n in table["n"]]
    vector_runs = 0
    starts = np.arange(256, dtype=np.int64) * fused_adam.VEC
    for b in range(blocks):
        leaf = 0
        for u in range(b, n_units, blocks):
            while leaf + 1 < len(table) and table["unit0"][leaf + 1] <= u:
                leaf += 1
            n = int(table["n"][leaf])
            i0 = (u - int(table["unit0"][leaf])) * fused_adam.UNIT + starts
            i0 = i0[i0 < n]
            run = i0[:, None] + np.arange(fused_adam.VEC)
            np.add.at(cover[leaf], run[run < n], 1)
            if table["vec"][leaf]:
                vector_runs += int((n - i0 >= fused_adam.VEC).sum())
    return cover, vector_runs


@pytest.mark.parametrize("blocks", [1, 3, 4 * 132])
def test_work_units_cover_every_element_once(flagship_shapes, blocks):
    """The walk visits every element of every leaf exactly once, whatever
    the grid: one block, a few (each crossing many leaves), or the card's."""
    params, grads, state, shards = _update_set(flagship_shapes)
    _, layout, table = _table(params, grads, state, shards)
    cover, vector_runs = _walk(table, layout.n_units, min(blocks, layout.n_units))
    assert all((c == 1).all() for c in cover)
    assert vector_runs == sum(int(n) // fused_adam.VEC for n in table["n"])


@pytest.mark.parametrize("sizes", [(1, 7, 8, 2047, 2048, 2049, 5000, 4096),
                                   (2048 * 5 + 3,), (9, 1, 1, 16)])
def test_work_units_cover_ragged_leaves(sizes):
    """Leaves at and around a run's and a unit's length."""
    params = {f"l{i}": torch.zeros(n) for i, n in enumerate(sizes)}
    state = AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                      {k: torch.zeros_like(v) for k, v in params.items()})
    order = fused_adam._leaf_order(tuple(params))
    layout = fused_adam.LeafLayout(order, params, state.mu, state.nu, {})
    table = layout.table(layout.gradients(params, state.mu, state.nu, params, {}), 0, 1)
    for blocks in (1, 2, 7):
        cover, _ = _walk(table, layout.n_units, min(blocks, layout.n_units))
        assert [c.size for c in cover] == [params[k].numel() for k in order]
        assert all((c == 1).all() for c in cover)


def _divide(i, m, l):
    """csrc/fused_adam.cu's divide() on uint64 arrays holding 32-bit values."""
    t = (i * np.uint64(m)) >> np.uint64(32)
    return (t + ((i - t) >> np.uint64(min(l, 1)))) >> np.uint64(max(l - 1, 0))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 12, 36, 240, 384, 2 * 721, 2 ** 16 + 1, 2 ** 31 - 1,
                               2 ** 31, 2 ** 31 + 1, 3 * 2 ** 30, 2 ** 32 - 1])
def test_divider_divides_every_32_bit_index(d):
    rng = np.random.default_rng(d)
    i = np.concatenate([rng.integers(0, 2 ** 32, 20000, dtype=np.uint64),
                        np.array([0, 1, d - 1, d, d + 1, 2 * d - 1, 2 ** 32 - 1, 2 ** 32 - d],
                                 dtype=np.uint64) % np.uint64(2 ** 32)])
    m, l = fused_adam.divider(d)
    assert 0 < m < 2 ** 32
    assert (_divide(i, m, l) == i // np.uint64(d)).all()


def _kernel_indices(fields, n):
    """Every element's dither index as the kernel computes it: one
    ref_index per run of VEC elements, the others adding j3 while the run
    stays inside the innermost dimension, else ref_index for each; a leaf's
    tail ref_index for each element (uint32 arithmetic)."""
    f = {k: np.uint64(v) for k, v in fields.items()}

    def ref_index(i):
        q3 = _divide(i, f["m3"], int(f["l3"]))
        q2 = _divide(q3, f["m2"], int(f["l2"]))
        q1 = _divide(q2, f["m1"], int(f["l1"]))
        c3 = i - q3 * f["s3"]
        c2, c1 = q3 - q2 * f["s2"], q2 - q1 * f["s1"]
        idx = f["base"] + q1 * f["j0"] + c1 * f["j1"] + c2 * f["j2"] + c3 * f["j3"]
        return idx & np.uint64(M32), c3

    vec = fused_adam.VEC
    starts = np.arange(0, n - n % vec, vec, dtype=np.uint64)
    first, c3 = ref_index(starts)
    e = np.arange(vec, dtype=np.uint64)
    inside = (c3 + np.uint64(vec) <= f["s3"])[:, None]
    along = (first[:, None] + e * f["j3"]) & np.uint64(M32)
    exact, _ = ref_index(starts[:, None] + e)
    runs = np.where(inside, along, exact).reshape(-1)
    tail, _ = ref_index(np.arange(n - n % vec, n, dtype=np.uint64))
    return np.concatenate([runs, tail]), int((~inside).sum())


@pytest.mark.parametrize("key,shape,shard,crosses", [
    # the dhconv weight (2, L, C, O): C and O merge into one dimension of
    # C x O = 100 (index stride 2L), so every other run crosses into the next l
    ("model.blocks.0.filter_layer.filter.weight", (2, 18, 10, 10), None, True),
    # C x O = 42: runs cross l and the planes, and a tail of 2 elements
    ("model.blocks.0.filter_layer.filter.weight", (2, 5, 6, 7), None, True),
    # O = 384, as the flagship's: no run crosses
    ("model.blocks.0.filter_layer.filter.weight", (2, 5, 3, 384), None, False),
    # the scanned blocks' stacked weight, five dimensions in four
    ("model.scan_blocks.block.filter_layer.filter.weight", (3, 2, 5, 6, 7), None, True),
    # identity leaves, one dimension: only a tail
    ("model.blocks.0.mlp.fc1.weight", (24, 10), None, False),
    ("model.encoder.fwd_0.bias", (13,), None, False),
    # a rank's shard, whose first index is not 0
    (SHARD_KEY, (2, 9, 10, 10), SHARD, True),
    ("model.blocks.1.filter_layer.filter.weight", (3, 4, 4, 3, 2),
     Shard((3, 4, 9, 7, 2), [Split(2, "h", 5, 4), Split(3, "w", 4, 3)]), True),
])
def test_run_index_reproduces_jax_flat_index(key, shape, shard, crosses):
    fields = fused_adam.leaf_index_fields(key, shape, shard)
    n = math.prod(shape)
    got, crossing = _kernel_indices(fields, n)
    want = fused_adam.jax_flat_index(key, shape, "cpu", shard).reshape(-1).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want)
    assert (crossing > 0) == crosses


def test_leaf_index_fields_refuse_what_the_kernel_cannot_index():
    with pytest.raises(ValueError, match="indexing"):
        fused_adam.leaf_index_fields("x", (2 ** 16, 2 ** 16))
    with pytest.raises(ValueError, match="indexing"):
        fused_adam.leaf_index_fields(SHARD_KEY, (2, 9, 10, 10),
                                     Shard((2, 2 ** 20, 2 ** 10, 2 ** 10), [Split(1, "h", 9, 9)]))


def test_layout_is_reused_while_its_tensors_hold(flagship_shapes):
    """The per-set part is built once: the same tensors on the same memory
    and equal shards reuse it; a new moment tensor, a parameter moved to new
    memory (`p.data = ...`) or another shard rebuild it."""
    params, grads, state, shards = _update_set(flagship_shapes)
    order = fused_adam._leaf_order(tuple(grads))

    def layout(shards=shards):
        return fused_adam._prepare(order, params, state, grads, shards)[0]

    first = layout()
    assert layout() is first
    state.mu["z.one"] = torch.zeros(1, dtype=torch.bfloat16)
    second = layout()
    assert second is not first
    key = "model.blocks.0.mlp.fc1.weight"
    params[key].data = params[key].data.clone()
    third = layout()
    assert third is not second and layout() is third
    assert layout({SHARD_KEY: Shard(*SHARD)}) is third
    fourth = layout({SHARD_KEY: Shard(SHARD.global_shape, [Split(1, "h", 0, 9)])})
    assert fourth is not third


def test_an_update_refuses_mixed_moments_and_devices(flagship_shapes):
    """Moments of two dtypes, or leaves on two devices, raise: the update is
    never split across launches or between the kernel and its twin."""
    params, grads, state, shards = _update_set(flagship_shapes)
    order = fused_adam._leaf_order(tuple(grads))
    state.nu["z.one"] = torch.zeros(1, dtype=torch.float32)
    with pytest.raises(TypeError, match="mix"):
        fused_adam.LeafLayout(order, params, state.mu, state.nu, shards)
    params, grads, state, shards = _update_set(flagship_shapes)
    params["z.one"] = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="CPU and on a card"):
        fused_adam.fused_adam_apply(params, grads, state, 1e-3, shards=shards)
    params, grads, state, shards = _update_set(flagship_shapes)
    grads["z.one"] = torch.zeros(2)
    layout = fused_adam.LeafLayout(order, params, state.mu, state.nu, shards)
    with pytest.raises(ValueError, match="gradient"):
        layout.gradients(params, state.mu, state.nu, grads, shards)


def test_empty_update_has_no_work_units():
    params = {"a": torch.zeros(0), "b": torch.zeros(3, 0)}
    state = AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                      {k: torch.zeros_like(v) for k, v in params.items()})
    order = fused_adam._leaf_order(tuple(params))
    layout = fused_adam.LeafLayout(order, params, state.mu, state.nu, {})
    assert layout.n_units == 0 and layout.rows.size == 0
