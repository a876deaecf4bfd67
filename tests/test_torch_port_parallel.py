"""makani_tpu_torch on several ranks against makani_tpu on the same mesh.

makani_tpu runs in this process on the conftest's virtual CPU devices, its
mesh (data 1, h 2, w 2) made by `comm.init(model_parallel_sizes=[2, 2, 1, 1],
devices=jax.devices()[:4])` as tests/test_distributed.py makes it; GSPMD
gives it the serial result. The port runs as 4 spawned ranks on the CPU
(tests/torch_port_parallel_ranks.py, gloo, no JAX imported), each holding
its (lat/h, lon/w) patch and its shard of the split leaves, and each rank's
block is held against the same block of makani_tpu's result. Every dimension
has a size of its own and the splits are uneven (33 latitudes 17 + 16, 11
channels 6 + 5 and 2 + 1, 17 modes 9 + 8).

Tolerances (makani_tpu's own, tests/test_distributed.py):
  - the SHT pair, 1e-5: on the "xla" engine elementwise (rtol and atol
    1e-5), its float32 einsums against JAX's exact float32 dots; on the
    "kernel" engine 1e-5 of the largest magnitude, since its legmm twin
    splits each operand into 3 bf16 passes (~6e-6 of the largest against
    exact float32, tests/test_torch_port_ops.py). The distributed transforms
    are also held to the port's serial ones within 1e-6 of the largest: the
    Legendre contraction on a rank is the serial one on a slice;
  - the SFNO forward, 2e-4 (rtol and atol), and its gradients, rtol 1e-4
    and atol 1e-5, each rank's slice of a split leaf against the same slice
    of makani_tpu's gradient; the network runs on the "xla" engine at
    "highest", where the port's contractions are float32 as JAX's are on
    the CPU; the MLP's output bias, whose exact gradient is zero (an
    instance norm follows it), against the largest gradient;
  - checkpoints: bit for bit, both ways.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from makani_tpu.parallel import comm as jcomm

from makani_tpu_torch.ops import sht
from makani_tpu_torch.tools.convert_jax_params import _map_flat
from makani_tpu_torch.utils import checkpoint as tckpt
from makani_tpu_torch.utils.optimizers import AdamState

from torch_port_parallel_ranks import (
    checkpoint_round_trip,
    run_cases,
    run_ranks,
    sfno_forward_and_grads,
)

SPATIAL = [2, 2, 1, 1]
WORLD = 4
SHT_CASES = [(engine, nlat, 64, "legendre-gauss" if nlat % 2 == 0 else "equiangular", 0)
             for engine in ("kernel", "xla") for nlat in (32, 33)]
# the grid stage's passes on spatial ranks: the "stacked" engine at "default"
GRID_CASES = [("stacked", 33, 64, "equiangular", 2)]
GRID_TOL = 1e-6
SFNO = dict(inp_shape=(33, 70), out_shape=(33, 70), scale_factor=2, inp_chans=3, out_chans=3,
            embed_dim=11, num_layers=2, operator_type="dhconv",
            normalization_layer="instance_norm", use_mlp=True, mlp_ratio=2.0)
ZERO_GRAD = "mlp.fc2.bias"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def mesh():
    jcomm.reset()
    jcomm.init(model_parallel_sizes=SPATIAL, devices=jax.devices()[:WORLD])
    yield jcomm.get_mesh()
    jcomm.reset()


def _block(a, *windows):
    """The block of `a` at the trailing (start, length) windows."""
    index = [slice(None)] * (a.ndim - len(windows)) + [slice(s, s + n) for s, n in windows]
    return a[tuple(index)]


def _dev(got, want, whole):
    """Largest deviation of a block over the largest magnitude of the whole
    array it is cut from (a rank's block of coefficients above the diagonal
    l >= m is zero)."""
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return np.abs(got - want).max() / np.abs(whole).max()


@pytest.fixture(scope="module")
def sht_spawn():
    return run_ranks(run_cases, SPATIAL, WORLD, [("sht_pairs", (SHT_CASES,)),
                                                 ("sht_pairs_at", ("default", GRID_CASES))])


@pytest.fixture(scope="module")
def sht_ranks(sht_spawn):
    return [r[0] for r in sht_spawn]


def test_distributed_grid_stage_at_default_matches_serial(sht_spawn):
    """The "stacked" engine at "default" (the grid stage's twin at 1 pass)
    on h 2 x w 2 against the port's serial run: coefficients, round trip and
    the gradient of its sum of squares, within GRID_TOL of the largest
    magnitude (the rows' sums in other orders)."""
    (engine, nlat, nlon, grid, seed), = GRID_CASES
    x = torch.from_numpy(np.random.RandomState(seed).randn(2, 3, nlat, nlon).astype(np.float32))
    prev = sht.get_transform_precision()
    sht.set_coeff_engine(engine)
    sht.set_transform_precision("default")
    try:
        fwd, inv = sht.RealSHT(nlat, nlon, grid=grid), sht.InverseRealSHT(nlat, nlon, grid=grid)
        x.requires_grad_(True)
        coeffs = fwd(x)
        back = inv(coeffs)
        back.square().sum().backward()
        serial = dict(coeffs=coeffs.detach().numpy(), back=back.detach().numpy(),
                      grad=x.grad.numpy())
        f32 = sht.InverseRealSHT(nlat, nlon, grid=grid)
        sht.set_transform_precision("highest")
        control = f32(sht.RealSHT(nlat, nlon, grid=grid)(x.detach())).numpy()
    finally:
        sht.set_coeff_engine("kernel")
        sht.set_transform_precision(prev)
    # the mode is applied: 1 pass is far from float32
    assert _dev(serial["back"], control, control) > 1e-4
    for rank in sht_spawn:
        got = rank[1][(engine, nlat)]
        for name, windows in (("coeffs", (got["l"], got["m"])), ("back", (got["lat"], got["lon"])),
                              ("grad", (got["lat"], got["lon"]))):
            block = _block(serial[name], *windows)
            assert got[name].shape == block.shape, name
            assert _dev(got[name], block, serial[name]) < GRID_TOL, name


@pytest.mark.parametrize("engine,nlat,nlon,grid,seed", SHT_CASES)
def test_distributed_sht_matches_jax(mesh, sht_ranks, engine, nlat, nlon, grid, seed):
    from makani_tpu.ops import InverseRealSHT, RealSHT
    x = np.random.RandomState(seed).randn(2, 3, nlat, nlon).astype(np.float32)
    fwd, inv = RealSHT(nlat, nlon, grid=grid), InverseRealSHT(nlat, nlon, grid=grid)
    xd = jax.device_put(x, NamedSharding(mesh, P("data")))
    coeffs = np.asarray(jax.jit(lambda v: fwd(v))(xd))
    back = np.asarray(jax.jit(lambda v: inv(fwd(v)))(xd))
    # the port's serial transforms
    sht.set_coeff_engine(engine)
    try:
        tfwd, tinv = sht.RealSHT(nlat, nlon, grid=grid), sht.InverseRealSHT(nlat, nlon, grid=grid)
        tcoeffs = tfwd(torch.from_numpy(x))
        tback = tinv(tcoeffs).numpy()
        tcoeffs = tcoeffs.numpy()
    finally:
        sht.set_coeff_engine("kernel")
    for rank in sht_ranks:
        got = rank[(engine, nlat)]
        for name, want, serial, windows in (("coeffs", coeffs, tcoeffs, (got["l"], got["m"])),
                                            ("back", back, tback, (got["lat"], got["lon"]))):
            block, port_block = _block(want, *windows), _block(serial, *windows)
            assert got[name].shape == block.shape, name
            assert _dev(got[name], port_block, serial) < 1e-6, name
            if engine == "xla":
                np.testing.assert_allclose(got[name], block, rtol=1e-5, atol=1e-5, err_msg=name)
            else:
                assert _dev(got[name], block, want) < 1e-5, name


def _jax_sfno():
    from makani_tpu.models.networks import SphericalFourierNeuralOperatorNet
    return SphericalFourierNeuralOperatorNet(**SFNO)


@pytest.fixture(scope="module")
def sfno_state():
    """makani_tpu's initial weights of the SFNO (made serially), as the
    port's whole state, and the input."""
    jcomm.reset()
    model = _jax_sfno()
    x = np.random.RandomState(2).randn(2, 3, *SFNO["inp_shape"]).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
    port = SphericalFourierNeuralOperatorNet(**SFNO)
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    return variables, _map_flat(port.state_dict(), flat, "parameters"), x


@pytest.fixture(scope="module")
def sfno_ranks(sfno_state):
    _, state, x = sfno_state
    # "highest" on the "xla" engine (module docstring)
    return run_ranks(sfno_forward_and_grads, SPATIAL, WORLD, dict(SFNO), state, x, "xla",
                     "highest")


def test_distributed_sfno_forward_matches_jax(mesh, sfno_state, sfno_ranks):
    variables, _, x = sfno_state
    model = _jax_sfno()
    xd = jax.device_put(x, NamedSharding(mesh, P("data")))
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a))(variables, xd))
    for rank in sfno_ranks:
        block = _block(want, rank["lat"], rank["lon"])
        assert rank["y"].shape == block.shape
        np.testing.assert_allclose(rank["y"], block, rtol=2e-4, atol=2e-4)


def test_distributed_sfno_gradients_match_jax(mesh, sfno_state, sfno_ranks):
    variables, _, x = sfno_state
    model = _jax_sfno()
    xd = jax.device_put(x, NamedSharding(mesh, P("data")))
    grads = jax.jit(jax.grad(lambda v, a: jnp.mean(model.apply(v, a) ** 2)))(variables, xd)
    from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
    flat = {k: np.asarray(v) for k, v in flatten_dict(grads["params"], sep="/").items()}
    want = _map_flat(SphericalFourierNeuralOperatorNet(**SFNO).state_dict(), flat, "gradients")
    largest = max(np.abs(w).max() for w in want.values())
    split = set()
    for rank in sfno_ranks:
        assert set(rank["grads"]) == set(want)
        for key, got in rank["grads"].items():
            ref = want[key]
            if key in rank["shards"]:
                split.add(key)
                index = [slice(None)] * ref.ndim
                for s in rank["shards"][key].splits:
                    index[s.dim] = slice(s.start, s.start + s.length)
                ref = ref[tuple(index)]
            assert got.shape == ref.shape, key
            if key.endswith(ZERO_GRAD):
                assert np.abs(got - ref).max() < 1e-5 * largest, key
                continue
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=key)
    # each block's dhconv weight is split over h (its l axis)
    assert split == {f"blocks.{i}.filter_layer.filter.weight" for i in range(2)}


def test_checkpoints_cross_between_serial_and_distributed(sfno_state, tmp_path):
    """A serial checkpoint restores onto the ranks' shards as their slices,
    and the ranks save the same file a serial save of the same weights
    writes, bit for bit."""
    _, state, _ = sfno_state
    from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
    # in the order of the model's state dict, as the Trainer saves it
    order = SphericalFourierNeuralOperatorNet(**SFNO).state_dict()
    whole = {k: torch.from_numpy(state[k].copy()) for k in order}
    mu = {k: v * 0.5 for k, v in whole.items()}
    nu = {k: (v * v).to(torch.bfloat16) for k, v in whole.items()}
    serial = tmp_path / "serial"
    tckpt.save_checkpoint(str(serial), whole, (AdamState(3, mu, nu),), {"iters": 3})
    tckpt.wait_for_saves()
    ranks = run_ranks(checkpoint_round_trip, SPATIAL, WORLD, dict(SFNO), state, str(serial),
                      str(tmp_path / "ranks"))
    for rank in ranks:
        for key, got in rank["local"].items():
            ref, ref_mu = state[key], mu[key].numpy()
            if key in rank["shards"]:
                index = [slice(None)] * ref.ndim
                for s in rank["shards"][key].splits:
                    index[s.dim] = slice(s.start, s.start + s.length)
                ref, ref_mu = ref[tuple(index)], ref_mu[tuple(index)]
            np.testing.assert_array_equal(got, ref, err_msg=key)
            np.testing.assert_array_equal(rank["mu"][key], ref_mu, err_msg=key)
    for name in (tckpt.MODEL_FILE, tckpt.OPT_FILE, "counters.json"):
        with open(serial / name, "rb") as a, open(tmp_path / "ranks" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_tensor_parallelism_raises_item_7b():
    """The fin and fout layouts are ported (item 7b,
    tests/test_torch_port_tensor_parallel.py): in a serial process they ask
    for the ranks, as h and w do."""
    from makani_tpu_torch.parallel import comm, partitioning
    for sizes in ([1, 1, 2, 1], [1, 1, 1, 2], [2, 1, 2, 1]):
        with pytest.raises(ValueError, match="ranks"):
            comm.init(sizes, device_type="cpu")
    assert not comm.is_initialized()
    # the channel-parallel rules are carried as makani_tpu's data
    assert partitioning.tensor_parallel_spec(
        "model/blocks_0/mlp/fc1/weight") == ("fout", "fin")
    assert partitioning.tensor_parallel_spec("model/residual_transform") is None
    assert partitioning.tensor_parallel_spec("model/pos_embed", (1, 4, 8, 16)) is None
    assert partitioning.tensor_parallel_spec("model/pos_embed", (1, 8, 16)) == (None, None, "fin")
    # serial: the spatial sizes ask for the ranks of a launcher
    with pytest.raises(ValueError, match="ranks"):
        comm.init([2, 1, 1, 1], device_type="cpu")
    assert os.environ.get("WORLD_SIZE") is None


def _fake_layout(monkeypatch, sizes, coords=None):
    """parallel.comm's state for the layout `sizes` ({axis: size}) with this
    process at `coords` (0 on every axis not given), without process groups:
    whatever reads the layout sees it, and no collective can run (a group is
    a name)."""
    import itertools
    from makani_tpu_torch.parallel import comm
    sizes = {ax: int(sizes.get(ax, 1)) for ax in comm.AXES}
    coords = {ax: int((coords or {}).get(ax, 0)) for ax in comm.AXES}
    live = [ax for ax in comm.AXES if sizes[ax] > 1]
    groups = {frozenset(sub): ("+".join(sub), [])
              for k in range(1, len(live) + 1) for sub in itertools.combinations(live, k)}
    monkeypatch.setattr(comm, "_STATE", dict(
        sizes=sizes, coords=coords, rank=0, world=int(np.prod(list(sizes.values()))),
        local_rank=0, backend="gloo", device=torch.device("cpu"), groups=groups))


PLANAR_FILE = """
import torch
from torch import nn

from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet


class Planar(nn.Module):
    # a port SFNO inside (its filter weight a SpectralConv, which the spatial
    # rules cut) and a leaf that a channel rule matches (mlp.fc1.weight)
    def __init__(self, inp_shape, out_shape, inp_chans, out_chans, device="cpu",
                 generator=None):
        super().__init__()
        self.inner = SphericalFourierNeuralOperatorNet(
            inp_shape=inp_shape, out_shape=out_shape, scale_factor=1, inp_chans=inp_chans,
            out_chans=out_chans, embed_dim=4, num_layers=1, device=device, generator=generator)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(out_chans, 6, bias=False, device=device)})

    def forward(self, x, deterministic=True):
        return self.inner(x, deterministic=deterministic)
"""


def test_every_family_takes_spatial_ranks(monkeypatch, tmp_path):
    """Under a spatial decomposition every registered family runs on its
    patches (tests/test_torch_port_spatial_families.py runs them) and the
    FNO builds on its FFT pair. A class without a spatially parallel path,
    registered from a file, builds on every layout too: get_model wraps it
    in no module of its own (the state dict's keys are the serial ones) and
    shard_module leaves every leaf of it whole, on h and w and on fin, where
    the rules would cut the SpectralConv and the `mlp.fc1` leaf inside it."""
    from makani_tpu_torch.models import model_registry
    from makani_tpu_torch.models.networks.sfnonet import FourierNeuralOperatorNet
    from makani_tpu_torch.parallel import partitioning, spmd
    from makani_tpu_torch.utils.yparams import ParamsBase
    assert set(model_registry.list_models()) == {"SFNO", "FNO", "AFNO", "AFNOv1", "ViT",
                                                 "DebugNet"}
    for nettype in model_registry.list_models():
        assert spmd.spatially_parallel(model_registry._model_registry[nettype]), nettype
    net = FourierNeuralOperatorNet(inp_shape=(8, 16), out_shape=(8, 16), scale_factor=1,
                                   embed_dim=4, num_layers=1)
    assert type(net.trans_down).__name__ == "RealFFT2"

    monkeypatch.setattr(model_registry, "_model_registry", dict(model_registry._model_registry))
    path = tmp_path / "planar.py"
    path.write_text(PLANAR_FILE)
    params = ParamsBase.from_dict(dict(
        nettype=f"{path}:Planar", img_shape_x=8, img_shape_y=16, img_crop_shape_x=8,
        img_crop_shape_y=16, N_in_channels=3, N_out_channels=4, n_history=0, n_future=0,
        target="default", global_seed=3))
    serial = model_registry.get_model(params, device="cpu")
    assert not spmd.spatially_parallel(serial.model) and serial.shards == {}
    shapes = {k: tuple(p.shape) for k, p in serial.state_dict().items()}
    filt = "model.inner.blocks.0.filter_layer.filter.weight"
    assert "model.mlp.fc1.weight" in shapes and filt in shapes
    for sizes in ({"h": 2, "w": 2}, {"h": 2, "fin": 2}):
        with monkeypatch.context() as m:
            _fake_layout(m, sizes, {"h": 1})
            assert spmd.spatial_distributed()
            model = model_registry.get_model(params, device="cpu")
            assert model.shards == {} and model.global_hw == (8, 16)
            assert {k: tuple(p.shape) for k, p in model.state_dict().items()} == shapes
            # the rules find leaves to cut where the class's flag would allow it
            assert partitioning.spatial_rules(model)
            if "fin" in sizes:
                assert partitioning.tensor_splits("model.mlp.fc1.weight", shapes[
                    "model.mlp.fc1.weight"]) == [(1, "fin")]
            inner = model.model.inner
            assert partitioning.shard_module(inner) and \
                inner.blocks[0].filter_layer.filter.weight.shape != shapes[filt]


def test_serial_model_axes_read_the_model_axes_as_one_rank(monkeypatch):
    """comm.serial_model_axes(): h, w, fin and fout read as one rank inside,
    the data axis as it is; it nests, and the layout comes back on exit and
    after an exception. layers.remat recomputes inside it in backward, where
    autograd runs outside it."""
    from makani_tpu_torch.models.common.layers import remat
    from makani_tpu_torch.parallel import comm, spmd
    _fake_layout(monkeypatch, {"data": 2, "h": 2, "w": 2, "fin": 2},
                 {"data": 1, "h": 1, "w": 1, "fin": 1})

    def layout():
        return (spmd.spatial_distributed(), spmd.matmul_distributed(),
                spmd.model_distributed(), comm.get_size("world"), comm.get_rank("world"))

    outside = (True, True, True, 16, 15)
    assert layout() == outside and not comm.in_serial_model_axes()
    assert comm.get_group("spatial") == "h+w" and spmd.patch(13, "h") == (7, 6)
    with comm.serial_model_axes():
        inside = (False, False, False, 2, 1)
        assert layout() == inside and comm.in_serial_model_axes()
        assert (comm.get_size("data"), comm.get_rank("data")) == (2, 1)
        assert comm.get_group("spatial") is None and comm.get_group("world") == "data"
        assert comm.get_group_ranks("h") == [0] and spmd.patch(13, "h") == (0, 13)
        assert spmd.channel_axis(8, "fin") is None
        with comm.serial_model_axes():
            assert layout() == inside
        assert layout() == inside
    assert layout() == outside and not comm.in_serial_model_axes()
    with pytest.raises(RuntimeError, match="inside"):
        with comm.serial_model_axes():
            raise RuntimeError("inside")
    assert layout() == outside and not comm.in_serial_model_axes()

    seen = []

    def body(x):
        seen.append(comm.get_size("h"))
        return x * x

    for scoped, want in ((True, [1, 1]), (False, [2, 2])):
        seen.clear()
        x = torch.arange(3.0, requires_grad=True)
        if scoped:
            with comm.serial_model_axes():
                y = remat(body, x)
        else:
            y = remat(body, x)
        y.sum().backward()
        assert seen == want and torch.equal(x.grad, 2 * x.detach())


# --------------------------------------------------------------------------
# the optimizer on shards: the fused Adam kernel's twin with bf16 moments
# under stochastic rounding (the shard's elements keep the whole leaf's
# indices), its clipped and LAMB modes (norms of whole leaves), Adafactor
# (statistics over whole leaves, a factored axis split over h)
# --------------------------------------------------------------------------

OPT_MODES = ("adam", "adam_clip", "lamb", "adafactor_clip")
# the port's stacked dhconv weight (2, L, C, O), a diagonal filter weight
# (C, O, L, M, 2) and a replicated leaf; L and O are Adafactor's factored
# axes of the first (makani_tpu's (C, O, L, 2), both at least 128)
OPT_SPLITS = {"model.blocks.0.filter_layer.filter.weight": [(1, "h")],
              "model.blocks.1.filter_layer.filter.weight": [(2, "h"), (3, "w")]}
OPT_SHAPES = {"model.blocks.0.filter_layer.filter.weight": (2, 131, 3, 129),
              "model.blocks.1.filter_layer.filter.weight": (3, 4, 9, 7, 2),
              "model.encoder.fwd_0.weight": (6, 5)}


@pytest.fixture(scope="module")
def opt_leaves():
    rng = np.random.RandomState(11)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    grads = {k: (rng.randn(*s) * 1e-2).astype(np.float32) for k, s in OPT_SHAPES.items()}
    return params, grads


@pytest.fixture(scope="module")
def opt_ranks(opt_leaves):
    from torch_port_parallel_ranks import optimizer_modes
    return run_ranks(optimizer_modes, SPATIAL, WORLD, *opt_leaves, OPT_SPLITS, OPT_MODES)


@pytest.mark.parametrize("mode", OPT_MODES)
def test_optimizer_on_shards_matches_whole_leaves(opt_leaves, opt_ranks, mode):
    """Each rank's shards after two updates against the serial update of
    the whole leaves: bit for bit without a norm; the clip, LAMB's trust
    ratios and Adafactor's statistics sum in another order on ranks, within
    1e-6 of each leaf's largest."""
    from makani_tpu_torch.ops.fused_adam import fused_adam_apply_plain
    from makani_tpu_torch.utils.optimizers import (
        AdamState, apply_updates, build_optimizer)
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
    exact = mode == "adam"
    for rank in opt_ranks:
        params, moments = rank["out"][mode]
        for key, got in params.items():
            want, want_mu = whole[key].numpy(), mu[key].float().numpy() if mu else None
            if key in rank["shards"]:
                index = [slice(None)] * want.ndim
                for s in rank["shards"][key].splits:
                    index[s.dim] = slice(s.start, s.start + s.length)
                want = want[tuple(index)]
                want_mu = None if want_mu is None else want_mu[tuple(index)]
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=key)
                np.testing.assert_array_equal(moments[key], want_mu, err_msg=key)
            else:
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), key
    assert {k for k in opt_ranks[0]["shards"]} == set(OPT_SPLITS)


# --------------------------------------------------------------------------
# the options on spatial ranks, against the port's serial network: the
# diagonal filter (l over h and m over w), the "frequency" position
# embedding (its coefficients cut to the rank's block), the position bias,
# and dropout at every site (masks drawn at the whole batch and field and
# cut to the rank's patch), in training; the "xla" engine at "highest"
# (float32 contractions); within 1e-5 of the largest magnitude (the norms'
# sums in another order)
# --------------------------------------------------------------------------

OPTIONS = dict(SFNO, operator_type="diagonal", pos_embed="frequency", bias="position",
               pos_drop_rate=0.2, path_drop_rate=0.2, mlp_drop_rate=0.2)


def test_spatial_options_and_dropout_match_serial():
    from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
    from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
    from makani_tpu_torch.ops import complex_ops
    from torch_port_parallel_ranks import sfno_in_training
    net = SphericalFourierNeuralOperatorNet(**OPTIONS, generator=torch.Generator().manual_seed(9))
    state = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    x = np.random.RandomState(5).randn(2, 3, *OPTIONS["inp_shape"]).astype(np.float32)
    ranks = run_ranks(sfno_in_training, SPATIAL, WORLD, dict(OPTIONS), state, x, 21)
    settings = (sht.get_coeff_engine(), sht.get_transform_precision(),
                complex_ops.get_contraction_precision())
    sht.set_coeff_engine("xla")
    sht.set_transform_precision("highest")
    complex_ops.set_contraction_precision("highest")
    try:
        with use_dropout_key(DropoutKey(21, 1, 0)):
            y = net(torch.from_numpy(x), deterministic=False)
        y.square().mean().backward()
    finally:
        sht.set_coeff_engine(settings[0])
        sht.set_transform_precision(settings[1])
        complex_ops.set_contraction_precision(settings[2])
    want_y = y.detach().numpy()
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    largest = max(np.abs(g).max() for g in grads.values())
    split = set()
    for rank in ranks:
        block = _block(want_y, rank["lat"], rank["lon"])
        assert _dev(rank["y"], block, want_y) < 1e-5
        for key, got in rank["grads"].items():
            ref = grads[key]
            if key in rank["shards"]:
                split.add(key)
                index = [slice(None)] * ref.ndim
                for s in rank["shards"][key].splits:
                    index[s.dim] = slice(s.start, s.start + s.length)
                ref = ref[tuple(index)]
            scale = largest if key.endswith(ZERO_GRAD) else np.abs(grads[key]).max()
            assert np.abs(got - ref).max() <= 1e-5 * scale, key
    # the diagonal weights are split over h and w
    assert split == {f"blocks.{i}.filter_layer.filter.weight" for i in range(2)}


def test_augmentation_and_h1_loss_on_spatial_ranks_match_serial():
    """The longitude roll (across the w ranks) and the input noise, drawn
    for the whole batch, give each rank its patch of the serial
    augmentation, bit for bit; the spherical H1 loss through the distributed
    SHT is the serial one within 1e-5 (sums in another order)."""
    from makani_tpu_torch.utils.losses import GeometricH1Loss
    from makani_tpu_torch.utils.trainer import augment_batch
    from torch_port_parallel_ranks import augment_and_h1
    rng = np.random.RandomState(8)
    inp, tar = (rng.randn(3, 2, 33, 70).astype(np.float32) for _ in range(2))
    ranks = run_ranks(augment_and_h1, SPATIAL, WORLD, inp, tar, 4)
    gen = torch.Generator().manual_seed(4)
    xa, ya, _, _ = augment_batch(torch.from_numpy(inp), torch.from_numpy(tar), None, None, gen,
                                 True, 0.3)
    h1 = GeometricH1Loss((33, 70))(torch.from_numpy(inp), torch.from_numpy(tar)).numpy()
    for rank in ranks:
        np.testing.assert_array_equal(rank["inp"], _block(xa.numpy(), rank["lat"], rank["lon"]))
        np.testing.assert_array_equal(rank["tar"], _block(ya.numpy(), rank["lat"], rank["lon"]))
        np.testing.assert_allclose(rank["h1"], h1, rtol=1e-5)
