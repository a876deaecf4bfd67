"""makani_tpu_torch's SFNO model options against makani_tpu on the CPU:
LayerNorm2d, the "direct" and "frequency" position embeddings on the SHT and
FFT transforms, the factorized filters (dense, CP, Tucker and TT of the
diagonal and dhconv operators), scan_layers, and the SHT pair without the
Condon-Shortley phase.

Models: config/icml_models.yaml's sfno_dhealy_73ch and fno_linear_73ch cut
small, as tests/test_torch_port_fno.py cuts them (17x32 to 8x16, 4 x 4 modes,
embed 12, 3 blocks, 5 channels, batch 2); scan_layers with 5 blocks, so the
scan runs 3. Weights are made in JAX and carried by load_jax_params.

Tolerances:
  - the forward and the gradients of every option:
    test_sfno_gradients_match_jax's (TOL 2e-4 of the largest output,
    GRAD_TOL 2e-4 of each leaf's largest gradient). JAX's CPU dots are exact
    float32 while the port's SHT keeps the 3-pass bf16 splits of its
    kernels' twins (~1e-5 a contraction);
  - LayerNorm2d alone: LN_TOL (1e-6 of the largest output): the float32
    means over 6 channels are summed in another order (a few ulps), and a
    bf16 output rounds the same float32 value;
  - the SHT pair without the phase: its tables bit for bit, the transforms
    P3_TOL (5e-5, tests/test_torch_port_ops.py's);
  - the loss sum(y * r), whose terms cancel: TOL of the sum of their
    magnitudes;
  - the scanned model's optimizers, 3 updates on its stacked leaves: Adam
    with bf16 moments under stochastic rounding bit for bit (moments) and
    the parameters too; LAMB (a norm a leaf) and Adafactor (optax's float32
    arithmetic against the port's) OPT_TOL (2e-5) of each leaf's largest, as
    tests/test_torch_port_multistep.py holds them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from makani_tpu.models.common import layers as jlayers
from makani_tpu.ops import sht as jsht
from makani_tpu.utils import optimizers as jopt

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.models.common import layers as tlayers
from makani_tpu_torch.ops import complex_ops, fused_adam
from makani_tpu_torch.ops import sht as tsht
from makani_tpu_torch.tools.convert_jax_params import load_jax_opt_state
from makani_tpu_torch.utils import checkpoint as tckpt
from makani_tpu_torch.utils import optimizers as topt
from makani_tpu_torch.utils.param_layout import (
    from_port_layout,
    jax_key_to_torch,
    to_port_layout,
    torch_key_to_jax,
)

from test_torch_port_fno import (
    CHANS,
    EMBED,
    NLAT,
    NLON,
    TOL,
    _configs,
    assert_grads_close,
    assert_loss_close,
    inputs,
    jax_output_and_grads,
    matched_models,
    port_output_and_grads,
)

LN_TOL = 1e-6
P3_TOL = 5e-5
OPT_TOL = 2e-5
SCAN_LAYERS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


_MATCHED = {}


def _matched(name, **overrides):
    """matched_models, built once a configuration for the whole module."""
    key = (name, tuple(sorted(overrides.items())))
    if key not in _MATCHED:
        _MATCHED[key] = matched_models(name, **overrides)
    return _MATCHED[key]


# --------------------------------------------------------------------------
# LayerNorm2d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_2d_matches_jax(dtype):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 6, 5, 7) * 3 + 1).astype(np.float32)
    w, b = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    jmod = jlayers.LayerNorm2d(num_features=6)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jmod.apply({"params": {"weight": w, "bias": b}}, jx).astype(jnp.float32))
    tmod = tlayers.LayerNorm2d(6)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(w))
        tmod.bias.copy_(torch.from_numpy(b))
        got = tmod(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.float().numpy(), want) < LN_TOL


# --------------------------------------------------------------------------
# each option's forward and gradients
# --------------------------------------------------------------------------

OPTIONS = {
    "layer_norm": ("sfno_dhealy_73ch", dict(normalization_layer="layer_norm")),
    "pos_direct-sht": ("sfno_dhealy_73ch", dict(pos_embed="direct")),
    "pos_frequency-sht": ("sfno_dhealy_73ch", dict(pos_embed="frequency")),
    "pos_direct-fft": ("fno_linear_73ch", dict(pos_embed="direct")),
    "pos_frequency-fft": ("fno_linear_73ch", dict(pos_embed="frequency")),
    # the fraction-of-parameters rank (float) and an integer rank
    **{f"{fz}-{op}": ("sfno_dhealy_73ch", dict(factorization=fz, operator_type=op, rank=0.5))
       for fz in ("dense", "cp", "tucker") for op in ("diagonal", "dhconv")},
    "tt-diagonal": ("sfno_dhealy_73ch", dict(factorization="tt", operator_type="diagonal",
                                             rank=3)),
    "tt-dhconv": ("sfno_dhealy_73ch", dict(factorization="tt", operator_type="dhconv", rank=0.5)),
    # the factorized dhconv filter on the complex dhconv kernel's twin
    "cp-dhconv-kernel": ("sfno_dhealy_73ch", dict(factorization="cp", operator_type="dhconv",
                                                  rank=0.5)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_forward_and_gradients_match_jax(option):
    name, overrides = OPTIONS[option]
    jmodel, jparams, tmodel, flat = _matched(name, **overrides)
    names = {k.split("/")[-1] for k in flat}
    if "factorization" in overrides:
        fz = overrides["factorization"]
        want = {"dense": {"factors_dense"}, "cp": {"lambda", "factor_0", "factor_2"},
                "tucker": {"core", "factor_0", "factor_2"}, "tt": {"core_0", "core_2"}}[fz]
        assert want <= names
        filt = tmodel.model.blocks[1].filter_layer.filter
        assert type(filt).__name__ == "FactorizedSpectralConv"
    if "pos_embed" in overrides:
        assert ({"pos_embed"} if overrides["pos_embed"] == "direct"
                else {"pos_embed_r", "pos_embed_c"}) <= names
    if option == "layer_norm":
        assert type(tmodel.model.blocks[0].norm0).__name__ == "LayerNorm2d"
    x, r = inputs(5), inputs(6)
    want, jloss, jgrads = jax_output_and_grads(jmodel, jparams, x, r, deterministic=True)
    kernel = option.endswith("-kernel")
    complex_ops.enable_pallas_kernels(kernel)
    try:
        got, loss = port_output_and_grads(tmodel, x, r)
    finally:
        complex_ops.enable_pallas_kernels(False)
    assert got.shape == want.shape == (2, CHANS, NLAT, NLON)
    assert _rel(got, want) < TOL
    assert_loss_close(loss, jloss, want, r)
    assert_grads_close(tmodel, jgrads)


def test_frequency_embedding_masks():
    """pos_embed_r is zero above the diagonal, pos_embed_c (one column
    fewer) on and above it, in makani_tpu's init and the port's own."""
    _, tp = _configs("sfno_dhealy_73ch", pos_embed="frequency")
    net = tregistry.get_model(tp, device="cpu").model
    _, _, _, flat = _matched("sfno_dhealy_73ch", pos_embed="frequency")
    for r, c in ((net.pos_embed_r.detach().numpy(), net.pos_embed_c.detach().numpy()),
                 (flat["model/pos_embed_r"], flat["model/pos_embed_c"])):
        assert r.shape == (1, EMBED, 4, 4) and c.shape == (1, EMBED, 4, 3)
        assert (np.triu(r[0, 0], 1) == 0).all() and (np.triu(c[0, 0], 0) == 0).all()
        assert (r[0, 0][np.tril_indices(4)] != 0).all()
        assert (c[0, 0][np.tril_indices(4, -1, 3)] != 0).all()
        assert np.abs(r).max() <= 0.04


# --------------------------------------------------------------------------
# the SHT pair without the Condon-Shortley phase
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["kernel", "xla"])
def test_sht_without_csphase(engine):
    """csphase=False builds the tables without the phase (-1)^m, as
    makani_tpu's _get_pct does, and the transforms use them. makani_tpu's
    RealSHT and InverseRealSHT take csphase but build their tables with the
    phase whatever it says (makani_tpu/ops/sht.py:307, 414): the port's
    transforms without the phase are theirs with the odd orders negated
    (ROADMAP Queue 3, found in the reference)."""
    nlat, nlon, lmax, mmax, grid = 17, 32, 9, 7, "equiangular"
    pct = tsht._get_pct(grid, nlat, lmax, mmax, False)
    np.testing.assert_array_equal(pct, np.asarray(jsht._get_pct(grid, nlat, lmax, mmax, False)))
    sign = (-1.0) ** np.arange(mmax)
    np.testing.assert_array_equal(pct, tsht._get_pct(grid, nlat, lmax, mmax, True)
                                  * sign[:, None, None])
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, nlat, nlon).astype(np.float32)
    c = (rng.randn(2, 3, lmax, mmax) + 1j * rng.randn(2, 3, lmax, mmax)).astype(np.complex64)
    jfwd = {cs: jsht.RealSHT(nlat, nlon, lmax, mmax, grid=grid, csphase=cs) for cs in (True, False)}
    jinv = {cs: jsht.InverseRealSHT(nlat, nlon, lmax, mmax, grid=grid, csphase=cs)
            for cs in (True, False)}
    want = np.asarray(jfwd[True](jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jfwd[False](jnp.asarray(x))), want)
    want = want * sign
    want_x = np.asarray(jinv[True](jnp.asarray(c * sign.astype(np.float32))))
    prev = tsht.get_coeff_engine()
    tsht.set_coeff_engine(engine)
    try:
        fwd = tsht.RealSHT(nlat, nlon, lmax, mmax, grid=grid, csphase=False)
        inv = tsht.InverseRealSHT(nlat, nlon, lmax, mmax, grid=grid, csphase=False)
        got = fwd(torch.from_numpy(x)).numpy()
        got_x = inv(torch.from_numpy(c)).numpy()
    finally:
        tsht.set_coeff_engine(prev)
    assert not fwd.csphase and not inv.csphase
    assert _rel(got.real, want.real) < P3_TOL and _rel(got.imag, want.imag) < P3_TOL
    assert _rel(got_x, want_x) < P3_TOL


# --------------------------------------------------------------------------
# scan_layers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scanned():
    return _matched("sfno_dhealy_73ch", scan_layers=True, num_layers=SCAN_LAYERS)


def test_scan_stacks_the_middle_blocks(scanned):
    _, _, tmodel, flat = scanned
    net = tmodel.model
    named = dict(tmodel.named_parameters())
    key = "model.scan_blocks.block.filter_layer.filter.weight"
    jkey = "model/scan_blocks/block/SpectralFilterLayer_0/filter/weight"
    assert flat[jkey].shape == (SCAN_LAYERS - 2, EMBED, EMBED, 4, 2)
    # one stacked leaf, the dhconv planes (2, L, C, O) behind the layer axis
    assert tuple(named[key].shape) == (SCAN_LAYERS - 2, 2, 4, EMBED, EMBED)
    np.testing.assert_array_equal(named[key].detach().numpy(),
                                  flat[jkey].transpose(0, 4, 3, 1, 2))
    np.testing.assert_array_equal(from_port_layout(key, named[key].detach().numpy()), flat[jkey])
    assert tuple(named["model.scan_blocks.block.mlp.fc1.weight"].shape) == (
        SCAN_LAYERS - 2, 2 * EMBED, EMBED)
    assert sorted(net.blocks) == ["0", str(SCAN_LAYERS - 1)]
    assert len(named) == len(flat)
    assert {torch_key_to_jax(k) for k in named} == set(flat)


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_scan_forward_and_gradients_match_jax(scanned, engine):
    """The scan's forward on both coefficient engines; its gradients on the
    "xla" engine, float32 on both sides (~1e-5 found), where the point is
    the scan itself: the stacked weights, their slices and the
    recomputation. On the "kernel" engine the 3-pass bf16 splits of 5 blocks
    compound to ~2e-4 in block 0's norm gradients, GRAD_TOL's edge; the
    splits' gradients are held by the 3-block tests."""
    jmodel, jparams, tmodel, _ = scanned
    x, r = inputs(12), inputs(13)
    want, jloss, jgrads = jax_output_and_grads(jmodel, jparams, x, r, deterministic=True)
    prev = tsht.get_coeff_engine()
    tsht.set_coeff_engine(engine)
    try:
        got, loss = port_output_and_grads(tmodel, x, r)
    finally:
        tsht.set_coeff_engine(prev)
    assert _rel(got, want) < TOL
    assert_loss_close(loss, jloss, want, r)
    if engine == "xla":
        assert_grads_close(tmodel, jgrads)


def test_scan_layers_draw_their_own_dropout_masks():
    """Each scanned layer draws at sites of its own (the template's sites
    offset by the layer), at path_drop_rate mean(dpr[1:-1]); its recomputation
    in backward draws the same masks: the gradients equal those of a second
    run."""
    rates = dict(pos_drop_rate=0.2, path_drop_rate=0.3, mlp_drop_rate=0.25)
    _, tp = _configs("sfno_dhealy_73ch", scan_layers=True, num_layers=SCAN_LAYERS, **rates)
    model = tregistry.get_model(tp, device="cpu")
    net = model.model
    assert net.scan_blocks.block.drop_path.drop_prob == pytest.approx(
        float(np.mean(np.linspace(0, 0.3, SCAN_LAYERS)[1:-1])))
    # the encoder's, 3 in each of the first and last blocks, 3 in each scanned layer
    assert net.n_dropout_sites == 1 + 3 * 2 + 3 * (SCAN_LAYERS - 2)
    drawn = []
    draw = tlayers.drop_mask

    def recording(shape, keep, site, device):
        drawn.append(site)
        return draw(shape, keep, site, device)
    x = torch.from_numpy(inputs(14))
    grads = []
    for _ in range(2):
        drawn.clear()
        model.zero_grad(set_to_none=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tlayers, "drop_mask", recording)
            with tlayers.use_dropout_key(tlayers.DropoutKey(5, 3, 0)):
                model(x, deterministic=False).square().sum().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        # every site once in the forward but block 0's DropPath (site 3, rate
        # 0); the scanned layers' again when recomputed
        scan_sites = set(range(7, net.n_dropout_sites))
        assert set(drawn) == set(range(net.n_dropout_sites)) - {3}
        assert sorted(s for s in drawn if s in scan_sites) == sorted(2 * list(scan_sites))
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


def _trainer_config(optimizer, **overrides):
    common = dict(
        img_shape_x=NLAT, img_shape_y=NLON, embed_dim=EMBED, num_layers=SCAN_LAYERS,
        scan_layers=True, enable_synthetic_data=True, n_train_samples_per_epoch=3,
        n_eval_samples=2, batch_size=1, in_channels=list(range(CHANS)),
        out_channels=list(range(CHANS)), channel_names=[f"c{i}" for i in range(CHANS)],
        dhours=6, num_data_workers=1, log_to_screen=False, skip_validation=True,
        save_checkpoint="none", max_epochs=1, global_seed=333, optimizer_beta2=0.95,
        log_video=0, lr=2e-3, scheduler="none", **optimizer, **overrides)
    _, tp = _configs("sfno_dhealy_73ch", **common)
    tregistry.update_channel_params(tp)
    return tp


def _jax_tree_of(port):
    """The port's flat dict as makani_tpu's parameter tree."""
    return jax.tree.map(jnp.asarray, unflatten_dict({
        tuple(torch_key_to_jax(k).split("/")): from_port_layout(k, v.detach().float().numpy())
        for k, v in port.items()}))


def _as_port(tree):
    """A makani_tpu tree as float32 numpy in the port's names and layouts."""
    out = {}
    for key, v in flatten_dict(tree, sep="/").items():
        k = jax_key_to_torch(key)
        out[k] = to_port_layout(k, np.asarray(v, np.float32))
    return out


SCAN_OPTIMIZERS = {
    "Adam-bf16-SR": dict(optimizer_type="Adam", optimizer_moment_dtype="bfloat16",
                         optimizer_stochastic_rounding=True),
    "LAMB": dict(optimizer_type="LAMB", weight_decay=0.01, optimizer_max_grad_norm=32.0),
    "Adafactor": dict(optimizer_type="Adafactor"),
}


@pytest.mark.parametrize("case", sorted(SCAN_OPTIMIZERS))
def test_scan_trainer_steps_match_jax_optimizer(case):
    """3 Trainer steps of the scanned model (one epoch on synthetic data):
    the gradients and learning rates the Trainer fed its optimizer, replayed
    through makani_tpu's build_optimizer on the same stacked leaves, give
    the Trainer's parameters and optimizer state."""
    from makani_tpu_torch.utils.trainer import Trainer
    cfg = SCAN_OPTIMIZERS[case]
    trainer = Trainer(_trainer_config(cfg), device="cpu",
                      generator=torch.Generator().manual_seed(2))
    assert "model.scan_blocks.block.filter_layer.filter.weight" in trainer.model_params
    start = {k: p.detach().clone() for k, p in trainer.model_params.items()}
    fed = []
    apply = trainer.apply_updates

    def recording(grads, lr):
        fed.append(({k: g.clone() for k, g in grads.items()}, lr))
        return apply(grads, lr)
    trainer.apply_updates = recording
    trainer.train()
    assert len(fed) == 3 and np.isfinite(trainer.last_logs["train"]["step losses"]).all()
    assert (trainer.fused_kw is not None) == (case != "Adafactor")

    jtx = jopt.build_optimizer(dict(cfg, optimizer_beta1=0.9, optimizer_beta2=0.95,
                                    global_seed=333))
    jp = _jax_tree_of(start)
    js = jax.jit(jtx.init)(jp)

    @jax.jit
    def step(p, s, g, lr):
        u, s = jtx.update(g, s, p)
        return jax.tree.map(lambda q, v: q - lr * v, p, u), s
    for grads, lr in fed:
        jp, js = step(jp, js, _jax_tree_of(grads), lr)
    want = _as_port(jp)
    got = {k: p.detach().numpy() for k, p in trainer.model_params.items()}
    assert set(got) == set(want)
    for k in got:
        if case == "Adam-bf16-SR":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert _rel(got[k], want[k]) < OPT_TOL, k
    if case == "Adam-bf16-SR":
        jadam = next(s for s in js if hasattr(s, "mu"))
        state = trainer.adam_state()
        assert state.count == int(jadam.count) == 3
        for name in ("mu", "nu"):
            moments = _as_port(getattr(jadam, name))
            for k, v in getattr(state, name).items():
                assert v.dtype == torch.bfloat16
                np.testing.assert_array_equal(v.float().numpy(), moments[k], err_msg=(name, k))


def test_scan_load_jax_opt_state(scanned):
    """makani_tpu's Adam state (bf16 moments) of the scanned model after one
    update carries into the port's; one more update on both from there gives
    the same moments, bit for bit."""
    _, jparams, tmodel, _ = scanned
    cfg = dict(optimizer_type="Adam", optimizer_moment_dtype="bfloat16", optimizer_beta1=0.9,
               optimizer_beta2=0.95, global_seed=333)
    rng = np.random.RandomState(21)
    grads = [jax.tree.map(lambda p: jnp.asarray(0.1 * rng.randn(*p.shape).astype(np.float32)),
                          jparams) for _ in range(2)]
    jtx = jopt.build_optimizer(cfg)
    js = jtx.init(jparams)
    _, js = jax.jit(jtx.update)(grads[0], js, jparams)
    jadam = js[0]
    flat_state = {"count": int(jadam.count),
                  "mu": {k: np.asarray(v, np.float32)
                         for k, v in flatten_dict(jadam.mu, sep="/").items()},
                  "nu": {k: np.asarray(v, np.float32)
                         for k, v in flatten_dict(jadam.nu, sep="/").items()}}
    params = {k: p.detach().clone() for k, p in tmodel.named_parameters()}
    opt = topt.build_optimizer(cfg)
    state = opt.init(params)
    load_jax_opt_state(state[0], tmodel, flat_state)
    key = "model.scan_blocks.block.filter_layer.filter.weight"
    assert tuple(state[0].mu[key].shape) == (SCAN_LAYERS - 2, 2, 4, EMBED, EMBED)
    _, js = jax.jit(jtx.update)(grads[1], js, jparams)
    port_grads = {k: torch.from_numpy(np.array(v))
                  for k, v in _as_port(grads[1]).items()}
    _, state = opt.update(port_grads, state, params)
    for name in ("mu", "nu"):
        want = _as_port(getattr(js[0], name))
        for k, v in getattr(state[0], name).items():
            np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=(name, k))


# --------------------------------------------------------------------------
# the weight and checkpoint round trip
# --------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    dict(scan_layers=True, num_layers=SCAN_LAYERS),
    dict(factorization="tucker", operator_type="dhconv", rank=0.5),
    dict(pos_embed="frequency"),
], ids=["scan", "tucker", "pos_frequency"])
def test_checkpoint_round_trip(overrides, tmp_path):
    """load_jax_params -> the port's checkpoint -> restore into a model built
    afresh (other random weights): every tensor bit for bit, and the same
    forward."""
    _, _, tmodel, flat = _matched("sfno_dhealy_73ch", **overrides)
    for k, p in tmodel.named_parameters():
        np.testing.assert_array_equal(from_port_layout(k, p.detach().numpy()),
                                      flat[torch_key_to_jax(k)], err_msg=k)
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), tmodel.state_dict())
    _, tp = _configs("sfno_dhealy_73ch", **overrides)
    fresh = tregistry.get_model(tp, device="cpu", generator=torch.Generator().manual_seed(9))
    weights, _, _ = tckpt.restore_checkpoint(str(tmp_path / "ckpt"), fresh.state_dict())
    fresh.load_state_dict(weights)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    x = torch.from_numpy(inputs(15))
    with torch.inference_mode():
        assert torch.equal(fresh(x), tmodel(x))


def test_fused_adam_index_dims_cover_the_scanned_leaves(scanned):
    """The fused kernel's merged index dimensions of every leaf of the
    scanned model (the stacked dhconv weight behind its layer axis
    included) give each element's flat index in makani_tpu's layout, in at
    most the kernel's four dimensions."""
    _, _, tmodel, _ = scanned
    for k, p in tmodel.named_parameters():
        sizes, strides = fused_adam.kernel_index_dims(k, p.shape)
        assert len(sizes) <= 4 and np.prod(sizes) == p.numel(), k
        idx = np.zeros(sizes, np.int64)
        for d, (n, j) in enumerate(zip(sizes, strides)):
            shape = [1] * len(sizes)
            shape[d] = n
            idx = idx + np.arange(n).reshape(shape) * j
        want = fused_adam.jax_flat_index(k, p.shape, "cpu").reshape(-1).numpy()
        np.testing.assert_array_equal(idx.reshape(-1), want, err_msg=k)
