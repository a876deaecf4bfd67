"""makani_tpu_torch on channel-parallel ranks (fin, fout) against serial
makani_tpu.

makani_tpu splits its parameters over fin and fout by path rules and lets
GSPMD insert the collectives, so its sharded runs give its serial numbers
(tests/test_distributed.py:161-470); the port writes the collectives out,
and each rank's output and gradients, gathered, are held against serial
makani_tpu here. makani_tpu runs in this process on the CPU (serial); its
initial weights are carried into the port as load_jax_params carries them
(tools/convert_jax_params._map_flat). The port runs as spawned ranks on the
CPU (tests/torch_port_parallel_ranks.py, gloo, no JAX imported), one spawn a
mesh, each spawn running every check of its mesh:

  - fin 2 x fout 2: the SFNO's forward and every leaf's gradient (the "xla"
    engine at "highest", where the port's contractions are float32 as
    JAX's are on the CPU), its forward on the "kernel" engine (the stacked
    pipeline, its contraction reduce-scattered over fin), scan_layers (the
    layer axis whole), the ViT with 4 heads of 8 (its qkv kernel's 3C
    outputs split over fout in blocks that do not line up with the heads),
    the dropout masks against the serial port's, bit for bit, a checkpoint
    across layouts, and the optimizers on (fout, fin) blocks;
  - h 2 x fin 2: the SFNO's forward and every leaf's gradient, and its
    forward on the "kernel" engine: the distributed SHT on fin-split
    channels;
  - fin 2 (2 ranks): AFNO v2's forward and gradients (blocks over fin),
    AFNO v1's forward (its filter's leaves split over their real and
    imaginary axis, gathered for the compute), the planar FNO's forward
    and the SFNO's forward on the "xla" engine.

Every dimension has a size of its own, and the data channels (3 in, 5 out)
and the MLP's hidden channels of the scanned model are counts that the
axes do not divide (makani_tpu's _fit_spec keeps such a dimension whole).

Tolerances: the forwards at makani_tpu's own gate, rtol and atol 2e-4
(tests/test_distributed.py:188); the gradients at PR 19's, rtol 1e-4 and
atol 1e-5, each rank's shard of a split leaf against the same block of the
serial gradient, a leaf whose exact gradient is zero (the MLP's output bias
before an instance norm) against the largest gradient; the masks and a
checkpoint's files bit for bit; the optimizers as
tests/test_torch_port_parallel.py holds them (bit for bit without a norm,
1e-6 of the leaf's largest with one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu_torch.tools.convert_jax_params import _map_flat
from makani_tpu_torch.utils import checkpoint as tckpt
from makani_tpu_torch.utils.optimizers import AdamState

from torch_port_parallel_ranks import run_cases, run_ranks

FIN_FOUT = [1, 1, 2, 2]
H_FIN = [2, 1, 2, 1]
FIN = [1, 1, 2, 1]
SFNO_MOD = "makani_tpu_torch.models.networks.sfnonet"
SFNO = dict(inp_shape=(17, 36), out_shape=(17, 36), scale_factor=2, inp_chans=3, out_chans=5,
            embed_dim=12, num_layers=2, operator_type="dhconv",
            normalization_layer="instance_norm", use_mlp=True, mlp_ratio=1.5)
SCAN = dict(SFNO, num_layers=4, scan_layers=True, mlp_ratio=1.25)
VIT = dict(inp_shape=(16, 32), patch_size=(4, 4), inp_chans=3, out_chans=3, embed_dim=32,
           depth=2, num_heads=4)
AFNO2 = dict(inp_shape=(16, 32), patch_size=(4, 4), inp_chans=3, out_chans=3, embed_dim=32,
             num_layers=2, num_blocks=8)
AFNO1 = dict(AFNO2, embed_dim=16, num_blocks=4)
DROPOUT = dict(SFNO, pos_drop_rate=0.2, path_drop_rate=0.2, mlp_drop_rate=0.2)
ZERO_GRAD = "mlp.fc2.bias"
OPT_MODES = ("adam", "adam_clip", "lamb", "adafactor_clip")
# a (fout, fin) block of an MLP weight (both of Adafactor's factored axes
# split), a fin shard of the stacked dhconv weight (2, L, C, O)
OPT_SPLITS = {"model.blocks.0.mlp.fc1.weight": [(0, "fout"), (1, "fin")],
              "model.blocks.0.filter_layer.filter.weight": [(2, "fin")]}
OPT_SHAPES = {"model.blocks.0.mlp.fc1.weight": (256, 130),
              "model.blocks.0.filter_layer.filter.weight": (2, 131, 6, 129),
              "model.encoder.fwd_0.weight": (6, 5)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _input(kwargs, seed):
    return np.random.RandomState(seed).randn(
        2, kwargs["inp_chans"], *kwargs["inp_shape"]).astype(np.float32)


def _reference(jax_cls, port_cls, kwargs, seed, grads=True, **apply_kw):
    """Serial makani_tpu: (the port's whole state from makani_tpu's initial
    weights, the input, the output, the gradients of mean(y**2) in the
    port's names and layout or None)."""
    model = jax_cls(**kwargs)
    x = _input(kwargs, seed)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))

    def fwd(v, a):
        return model.apply(v, a, **apply_kw)

    y = np.asarray(jax.jit(fwd)(variables, jnp.asarray(x)))
    template = port_cls(**kwargs).state_dict()
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    state = _map_flat(template, flat, "parameters")
    g = None
    if grads:
        jg = jax.jit(jax.grad(lambda v, a: jnp.mean(fwd(v, a) ** 2)))(variables, jnp.asarray(x))
        g = _map_flat(template, {k: np.asarray(v) for k, v in
                                 flatten_dict(jg["params"], sep="/").items()}, "gradients")
    return state, x, y, g


def _block(a, lat, lon):
    return a[..., lat[0]:lat[0] + lat[1], lon[0]:lon[0] + lon[1]]


def _shard(ref, key, shards):
    if key not in shards:
        return ref
    index = [slice(None)] * ref.ndim
    for s in shards[key].splits:
        index[s.dim] = slice(s.start, s.start + s.length)
    return ref[tuple(index)]


def _check_forward(ranks, y):
    for rank in ranks:
        block = _block(y, rank["lat"], rank["lon"])
        assert rank["y"].shape == block.shape
        np.testing.assert_allclose(rank["y"], block, rtol=2e-4, atol=2e-4)


def _check_grads(ranks, want):
    """Every rank's gradient of every leaf (its shard of a split one)
    against serial makani_tpu's; returns {split leaf: its splits}."""
    largest = max(np.abs(w).max() for w in want.values())
    split = {}
    for rank in ranks:
        assert set(rank["grads"]) == set(want)
        for key, got in rank["grads"].items():
            ref = _shard(want[key], key, rank["shards"])
            assert got.shape == ref.shape, key
            if key in rank["shards"]:
                split[key] = tuple((s.dim, s.axis) for s in rank["shards"][key].splits)
            if key.endswith(ZERO_GRAD):
                assert np.abs(got - ref).max() < 1e-5 * largest, key
                continue
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=key)
    return split


def _sfno_classes():
    from makani_tpu.models.networks import SphericalFourierNeuralOperatorNet as J
    from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet as T
    return J, T


@pytest.fixture(scope="module")
def refs():
    """Serial makani_tpu's runs of every model of the file."""
    from makani_tpu.models.networks import FourierNeuralOperatorNet as JFNO
    from makani_tpu.models.networks.afnonet import AdaptiveFourierNeuralOperatorNetV1 as JA1
    from makani_tpu.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNet as JA2
    from makani_tpu.models.networks.vit import VisionTransformer as JViT
    from makani_tpu_torch.models.networks.afnonet import (
        AdaptiveFourierNeuralOperatorNetV1 as TA1)
    from makani_tpu_torch.models.networks.afnonet_v2 import (
        AdaptiveFourierNeuralOperatorNet as TA2)
    from makani_tpu_torch.models.networks.sfnonet import FourierNeuralOperatorNet as TFNO
    from makani_tpu_torch.models.networks.vit import VisionTransformer as TViT
    from makani_tpu.parallel import comm as jcomm
    jcomm.reset()
    J, T = _sfno_classes()
    return dict(
        sfno=_reference(J, T, SFNO, 1), scan=_reference(J, T, SCAN, 2),
        vit=_reference(JViT, TViT, VIT, 5, deterministic=True),
        afno2=_reference(JA2, TA2, AFNO2, 6, deterministic=True),
        afno1=_reference(JA1, TA1, AFNO1, 7, grads=False, deterministic=True),
        fno=_reference(JFNO, TFNO, dict(SFNO, spectral_transform="fft"), 8, grads=False))


def _net(name, kwargs, ref, engine="xla", precision="highest", module=SFNO_MOD):
    state, x = ref[0], ref[1]
    return ("network_forward_and_grads", (module, name, dict(kwargs), state, x, engine,
                                          precision))


SFNO_NAME = "SphericalFourierNeuralOperatorNet"


@pytest.fixture(scope="module")
def dropout_case():
    """The SFNO with dropout at every site, its weights drawn by the port."""
    _, T = _sfno_classes()
    net = T(**DROPOUT, generator=torch.Generator().manual_seed(9))
    state = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    return net, state, _input(DROPOUT, 3)


@pytest.fixture(scope="module")
def opt_leaves():
    rng = np.random.RandomState(11)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    grads = {k: (rng.randn(*s) * 1e-2).astype(np.float32) for k, s in OPT_SHAPES.items()}
    return params, grads


@pytest.fixture(scope="module")
def serial_checkpoint(refs, tmp_path_factory):
    """A serial checkpoint of the SFNO's weights and an Adam state, in the
    order of the model's state dict, as the Trainer saves it."""
    _, T = _sfno_classes()
    state = refs["sfno"][0]
    whole = {k: torch.from_numpy(state[k].copy()) for k in T(**SFNO).state_dict()}
    mu = {k: v * 0.5 for k, v in whole.items()}
    nu = {k: (v * v).to(torch.bfloat16) for k, v in whole.items()}
    root = tmp_path_factory.mktemp("tp_ckpt")
    tckpt.save_checkpoint(str(root / "serial"), whole, (AdamState(3, mu, nu),), {"iters": 3})
    tckpt.wait_for_saves()
    return root, mu


@pytest.fixture(scope="module")
def fin_fout(refs, dropout_case, opt_leaves, serial_checkpoint):
    _, state, x = dropout_case
    root, _ = serial_checkpoint
    cases = [_net(SFNO_NAME, SFNO, refs["sfno"]),
             _net(SFNO_NAME, SFNO, refs["sfno"], "kernel", "high"),
             _net(SFNO_NAME, SCAN, refs["scan"]),
             _net("VisionTransformer", VIT, refs["vit"],
                  module="makani_tpu_torch.models.networks.vit"),
             ("dropout_masks", (SFNO_MOD, SFNO_NAME, dict(DROPOUT), state, x, 21)),
             ("checkpoint_round_trip", (dict(SFNO), refs["sfno"][0], str(root / "serial"),
                                        str(root / "ranks"))),
             ("optimizer_modes", (*opt_leaves, OPT_SPLITS, OPT_MODES))]
    ranks = run_ranks(run_cases, FIN_FOUT, 4, cases)
    names = ("sfno", "sfno_kernel", "scan", "vit", "masks", "checkpoint", "optimizers")
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


@pytest.fixture(scope="module")
def h_fin(refs):
    cases = [_net(SFNO_NAME, SFNO, refs["sfno"]),
             _net(SFNO_NAME, SFNO, refs["sfno"], "kernel", "high")]
    ranks = run_ranks(run_cases, H_FIN, 4, cases)
    return {name: [r[i] for r in ranks] for i, name in enumerate(("sfno", "sfno_kernel"))}


@pytest.fixture(scope="module")
def fin_only(refs):
    cases = [_net("AdaptiveFourierNeuralOperatorNet", AFNO2, refs["afno2"],
                  module="makani_tpu_torch.models.networks.afnonet_v2"),
             _net("AdaptiveFourierNeuralOperatorNetV1", AFNO1, refs["afno1"],
                  module="makani_tpu_torch.models.networks.afnonet"),
             _net("FourierNeuralOperatorNet", dict(SFNO, spectral_transform="fft"), refs["fno"]),
             _net(SFNO_NAME, SFNO, refs["sfno"], "xla", "high")]
    ranks = run_ranks(run_cases, FIN, 2, cases)
    names = ("afno2", "afno1", "fno", "sfno_xla")
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


# the leaves makani_tpu's rules split on the SFNO: the encoder's and
# decoder's data channels (3, 5) stay whole (_fit_spec)
SFNO_SPLITS = {
    "encoder.fwd_0.weight": ((0, "fout"),), "encoder.fwd_0.bias": ((0, "fout"),),
    "encoder.out.weight": ((0, "fin"), (1, "fout")),
    "decoder.fwd_0.weight": ((0, "fout"), (1, "fin")), "decoder.fwd_0.bias": ((0, "fout"),),
    "decoder.out.weight": ((1, "fout"),),
    **{f"blocks.{i}.{k}": v for i in range(2) for k, v in {
        "filter_layer.filter.weight": ((2, "fin"),),
        "mlp.fc1.weight": ((0, "fout"), (1, "fin")), "mlp.fc1.bias": ((0, "fout"),),
        "mlp.fc2.weight": ((0, "fin"), (1, "fout")), "mlp.fc2.bias": ((0, "fin"),),
        "outer_skip.weight": ((0, "fin"),)}.items()}}


@pytest.mark.parametrize("mesh", ["fin_fout", "h_fin"])
def test_sfno_forward_and_gradients_match_serial_jax(refs, request, mesh):
    ranks = request.getfixturevalue(mesh)["sfno"]
    _, _, y, grads = refs["sfno"]
    _check_forward(ranks, y)
    split = _check_grads(ranks, grads)
    if mesh == "fin_fout":
        assert split == SFNO_SPLITS
    else:
        # the dhconv weight (2, L, C, O): l over h and C over fin; no fout
        assert split["blocks.0.filter_layer.filter.weight"] == ((1, "h"), (2, "fin"))
        assert not any(ax == "fout" for dims in split.values() for _, ax in dims)


@pytest.mark.parametrize("mesh", ["fin_fout", "h_fin"])
def test_sfno_kernel_engine_forward_matches_serial_jax(refs, request, mesh):
    """The stacked pipeline (analysis, dhconv contraction of the rank's fin
    chunk, reduce-scatter over fin, synthesis) on the kernels' plain twins."""
    _check_forward(request.getfixturevalue(mesh)["sfno_kernel"], refs["sfno"][2])


def test_scan_layers_keep_the_layer_axis_whole(refs, fin_fout):
    _, _, y, grads = refs["scan"]
    ranks = fin_fout["scan"]
    _check_forward(ranks, y)
    split = _check_grads(ranks, grads)
    # the stacked dhconv weight (n, 2, L, C, O): C over fin, n whole; the
    # hidden width 15 is not split over fout
    assert split["scan_blocks.block.filter_layer.filter.weight"] == ((3, "fin"),)
    assert split["scan_blocks.block.mlp.fc1.weight"] == ((2, "fin"),)
    assert "scan_blocks.block.mlp.fc1.bias" not in split


def test_vit_heads_split_across_the_qkv_blocks_match_serial_jax(refs, fin_fout):
    _, _, y, grads = refs["vit"]
    ranks = fin_fout["vit"]
    _check_forward(ranks, y)
    split = _check_grads(ranks, grads)
    assert split["blocks.0.attn.qkv.kernel"] == ((0, "fin"), (1, "fout"))
    assert split["blocks.0.attn.proj.kernel"] == ((0, "fout"), (1, "fin"))
    assert split["pos_embed"] == ((2, "fin"),)


def test_afno_v2_blocks_over_fin_match_serial_jax(refs, fin_only):
    _, _, y, grads = refs["afno2"]
    ranks = fin_only["afno2"]
    _check_forward(ranks, y)
    split = _check_grads(ranks, grads)
    assert split["blocks.0.filter.w1"] == ((0, "fin"),)
    assert split["blocks.0.filter.b1"] == ((1, "fin"),)
    # the (1, C, N) embedding: makani_tpu's 3-D rule splits its tokens
    assert split["pos_embed"] == ((2, "fin"),)


@pytest.mark.parametrize("name", ["afno1", "fno", "sfno_xla"])
def test_forwards_on_fin_ranks_match_serial_jax(refs, fin_only, name):
    ranks = fin_only[name]
    _check_forward(ranks, refs[name.replace("_xla", "")][2])
    if name == "afno1":
        # w1 (2, blocks, bs, hidden) is split over its (re, im) axis
        assert ranks[0]["shards"]["blocks.0.filter.w1"].splits[0].dim == 0


def test_dropout_masks_match_the_serial_port(dropout_case, fin_fout):
    """Every mask a rank draws is its cut of the serial port's mask at the
    same site, bit for bit, and the outputs agree."""
    from makani_tpu_torch.models.common import layers
    from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
    from makani_tpu_torch.ops import complex_ops, sht
    net, _, x = dropout_case
    serial, real = {}, layers.rank_mask

    def recording(shape, keep, site, device, global_hw=None, channel=None):
        mask = real(shape, keep, site, device, global_hw, channel)
        serial[site] = mask.numpy().copy()
        return mask

    settings = (sht.get_coeff_engine(), sht.get_transform_precision(),
                complex_ops.get_contraction_precision())
    sht.set_coeff_engine("xla")
    sht.set_transform_precision("highest")
    complex_ops.set_contraction_precision("highest")
    layers.rank_mask = recording
    try:
        with use_dropout_key(DropoutKey(21, 1, 0)):
            y = net(torch.from_numpy(x), deterministic=False).detach().numpy()
    finally:
        layers.rank_mask = real
        sht.set_coeff_engine(settings[0])
        sht.set_transform_precision(settings[1])
        complex_ops.set_contraction_precision(settings[2])
    cut_kinds = set()
    for rank in fin_fout["masks"]:
        assert [m[0] for m in rank["masks"]] == sorted(serial)
        for site, cut, mask in rank["masks"]:
            want = serial[site]
            if cut is not None:
                d, start, stop = cut
                want = np.take(want, np.arange(start, stop), axis=d)
                cut_kinds.add((d, stop - start))
            np.testing.assert_array_equal(mask, want, err_msg=str(site))
        np.testing.assert_allclose(rank["y"], y, rtol=1e-5, atol=1e-5)
    # the embedding's channels over fin and the MLP's hidden over fout
    assert cut_kinds == {(1, 6), (1, 9)}


def test_checkpoints_cross_between_serial_and_fin_fout(refs, fin_fout, serial_checkpoint):
    """A serial checkpoint restores onto the fin x fout shards as their
    blocks, and the ranks save the file a serial save writes, bit for bit."""
    root, mu = serial_checkpoint
    state = refs["sfno"][0]
    for rank in fin_fout["checkpoint"]:
        assert set(rank["shards"]) == set(SFNO_SPLITS)
        for key, got in rank["local"].items():
            np.testing.assert_array_equal(got, _shard(state[key], key, rank["shards"]))
            np.testing.assert_array_equal(rank["mu"][key],
                                          _shard(mu[key].numpy(), key, rank["shards"]))
    for name in (tckpt.MODEL_FILE, tckpt.OPT_FILE, "counters.json"):
        with open(root / "serial" / name, "rb") as a, open(root / "ranks" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("mode", OPT_MODES)
def test_optimizers_on_fout_fin_blocks_match_whole_leaves(opt_leaves, fin_fout, mode):
    """Two updates on each rank's (fout, fin) block and fin shard against
    the serial update of the whole leaves: the fused Adam twin bit for bit
    (the blocks keep the whole leaf's dither indices), the clip norm, LAMB's
    trust ratios and Adafactor's factored statistics (both factored axes
    split) within 1e-6 of each leaf's largest."""
    from makani_tpu_torch.ops.fused_adam import fused_adam_apply_plain
    from makani_tpu_torch.utils.optimizers import apply_updates, build_optimizer
    from makani_tpu_torch.utils.yparams import ParamsBase
    whole, grads = ({k: torch.from_numpy(v.copy()) for k, v in d.items()} for d in opt_leaves)
    mu = {}
    if mode.startswith("adafactor"):
        cfg = ParamsBase()
        cfg.update_params({"optimizer_type": "Adafactor", "gradient_clip_norm": 0.5})
        tx = build_optimizer(cfg)
        state = tx.init(whole)
        for _ in range(2):
            updates, state = tx.update(grads, state, whole)
            apply_updates(whole, updates, 1e-2)
    else:
        state = AdamState(0, {k: torch.zeros_like(v, dtype=torch.bfloat16)
                              for k, v in whole.items()},
                          {k: torch.zeros_like(v, dtype=torch.bfloat16)
                           for k, v in whole.items()})
        kw = dict(max_norm=0.5 if "clip" in mode else None, lamb=mode == "lamb",
                  weight_decay=0.1)
        for _ in range(2):
            fused_adam_apply_plain(whole, grads, state, 1e-3, **kw)
        mu = state.mu
    for rank in fin_fout["optimizers"]:
        params, moments = rank["out"][mode]
        assert set(rank["shards"]) == set(OPT_SPLITS)
        for key, got in params.items():
            want = _shard(whole[key].numpy(), key, rank["shards"])
            if mode == "adam":
                np.testing.assert_array_equal(got, want, err_msg=key)
                np.testing.assert_array_equal(
                    moments[key], _shard(mu[key].float().numpy(), key, rank["shards"]))
            else:
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), key
