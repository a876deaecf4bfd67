"""makani_tpu_torch's training slice against makani_tpu on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port: the optimizer and the fused Adam update, the
losses and quadrature, the synthetic data, the gradients of a small SFNO and
the Trainer's steps. JAX runs on the CPU (its Pallas kernels in interpret
mode); the port runs its plain twins, which the kernels are held against on
the card (tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances:
  - Adam with bf16 moments, lowmem or fused: bit-identical (assert_array_equal
    on parameters and moments) over 3 steps; float32 moments and AdamW: 1e-6,
    optax's own float32 arithmetic against the port's.
  - losses, quadrature, synthetic data: equal, or 1e-6 relative where the
    reduction order differs (the spherical-harmonic H1 loss: 1e-5, its SHT
    runs the 3-pass twin against JAX's exact float32 dots).
  - gradients of the 3-block SFNO: GRAD_TOL relative per leaf (largest
    magnitude; measured up to 7e-5). JAX's CPU dots are exact float32
    (makani_tpu/ops/sht.py:156-160) while the port keeps the 3-pass bf16
    splits in every contraction, forward and backward (~1e-5 each;
    tests/test_torch_port_ops.py).
  - Trainer steps: losses at STEP_LOSS_TOL relative; parameter updates after 1
    and 3 steps compared norm-wise per leaf (||du_port - du_jax|| / ||du_jax||
    < UPDATE_TOL). Adam's first steps are sign-like (u ~ g/|g|), so an
    element whose gradient is near zero takes a full step of either sign from
    a gradient difference at the contractions' precision. Such elements exist
    by construction: the instance norm after each spectral filter removes
    nearly all of the l = 0 (mean) mode, and all of the MLP's output bias. The
    norm is therefore taken over the elements whose first gradient is at
    least SIGN_FLOOR of their leaf's largest (over 90% of every leaf; the
    gradients agree to GRAD_TOL of the largest), and the MLP's output bias,
    whose gradient is pure rounding noise on both sides, is checked finite
    only.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict

from makani_tpu.ops.pallas_adam import fused_adam_apply as jfused_adam_apply
from makani_tpu.utils import optimizers as jopt
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.ops import kernels
from makani_tpu_torch.ops.fused_adam import fused_adam_apply_plain
from makani_tpu_torch.tools.convert_jax_params import load_jax_opt_state, load_jax_params
from makani_tpu_torch.utils import optimizers as topt
from makani_tpu_torch.utils.param_layout import (
    jax_key_to_torch,
    jax_leaf_order,
    to_port_layout,
    torch_key_to_jax,
)
from makani_tpu_torch.utils.yparams import YParams as TYParams

GRAD_TOL = 2e-4
STEP_LOSS_TOL = 1e-4
UPDATE_TOL = 2e-2
SIGN_FLOOR = 1e-3
NLAT, NLON, CHANS = 36, 72, 5
FILTER = "model/blocks_0/SpectralFilterLayer_0/filter/weight"
ZERO_GRAD = "mlp.fc2.bias"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# --------------------------------------------------------------------------
# the optimizer (tests/test_pallas_adam.py's tree, plus a dhconv-shaped leaf
# that the port stores in its own layout)
# --------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {
        "a": (rng.randn(7) * scale).astype(np.float32),
        "b": {"w": (rng.randn(3, 65) * scale).astype(np.float32),
              "v": (rng.randn(2, 3, 129) * scale).astype(np.float32)},
        "model": {"blocks_0": {"SpectralFilterLayer_0": {"filter": {
            "weight": (rng.randn(5, 4, 3, 2) * scale).astype(np.float32)}}}},
    }


def _port(tree):
    """A flax-style tree as the port's flat dict, each leaf in the port's
    layout and in memory of its own."""
    return {jax_key_to_torch(k): torch.from_numpy(np.array(to_port_layout(jax_key_to_torch(k), v)))
            for k, v in flatten_dict(tree, sep="/").items()}


def _as_port(tree):
    """JAX arrays of a tree as float32 numpy in the port's layout."""
    return {jax_key_to_torch(k): to_port_layout(jax_key_to_torch(k), np.asarray(v, np.float32))
            for k, v in flatten_dict(tree, sep="/").items()}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_equal_trees(port, jax_tree):
    want = _as_port(jax_tree)
    assert set(port) == set(want)
    for k, v in port.items():
        np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=k)


def _jax_apply(tx, lr, wd=0.0):
    def step(p, s, g):
        updates, s = tx.update(g, s, p)
        if wd:
            updates = jax.tree.map(lambda u, q: u + wd * q, updates, p)
        return jax.tree.map(lambda q, u: q - lr * u, p, updates), s
    return jax.jit(step)


def test_leaf_order_is_jax_tree_flatten_order():
    tree = {"model": {f"blocks_{i}": {"norm0": {"bias": 0, "weight": 0},
                                      "SpectralFilterLayer_0": {"filter": {"weight": 0}}}
                      for i in (0, 2, 10)}}
    tree["model"].update(encoder={"fwd_0": {"bias": 0}}, decoder={"out": {"weight": 0}},
                         residual_transform=0)
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    port_keys = [jax_key_to_torch(p) for p in paths]
    assert [torch_key_to_jax(k) for k in port_keys] == paths
    assert jax_leaf_order(sorted(port_keys)) == port_keys


@pytest.mark.parametrize("path", ["lowmem", "fused"])
def test_adam_bf16_moments_bitwise_against_jax(path):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    jtx = jopt.scale_by_adam_lowmem(moment_dtype=jnp.bfloat16, seed=340, **kw)
    jp = _jax_tree(params)
    js = jax.jit(jtx.init)(jp)
    if path == "lowmem":
        jstep = _jax_apply(jtx, 1e-3)
    else:
        jstep = jax.jit(lambda p, s, g: jfused_adam_apply(p, g, s, 1e-3, seed=340, **kw))

    ttx = topt.scale_by_adam_lowmem(moment_dtype=torch.bfloat16, seed=340, **kw)
    tp = _port(params)
    ts = ttx.init(tp)
    for it in range(3):
        grads = _tree(np.random.RandomState(100 + it), scale=0.1)
        jp, js = jstep(jp, js, _jax_tree(grads))
        if path == "lowmem":
            updates, ts = ttx.update(_port(grads), ts)
            topt.apply_updates(tp, updates, 1e-3)
        else:
            fused_adam_apply_plain(tp, _port(grads), ts, 1e-3, seed=340, **kw)
    _assert_equal_trees(tp, jp)
    _assert_equal_trees(ts.mu, js.mu)
    _assert_equal_trees(ts.nu, js.nu)
    assert ts.count == int(js.count) == 3


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_f32_moments_and_adamw_against_jax(wd):
    rng = np.random.RandomState(1)
    params = _tree(rng)
    grads = _tree(np.random.RandomState(2), scale=0.1)
    lr = 3e-4
    jtx = optax.scale_by_adam(b1=0.9, b2=0.95, eps=1e-8)
    jp, _ = _jax_apply(jtx, lr, wd)(_jax_tree(params), jax.jit(jtx.init)(_jax_tree(params)),
                                    _jax_tree(grads))
    want = _as_port(jp)

    # the fused twin on float32 moments, AdamW's decay folded in
    tp = _port(params)
    ts = topt.scale_by_adam().init(tp)
    fused_adam_apply_plain(tp, _port(grads), ts, lr, b1=0.9, b2=0.95, eps=1e-8,
                           weight_decay=wd, stochastic_rounding=False)
    # build_optimizer's chain: scale_by_adam (+ add_decayed_weights)
    opt = topt.build_optimizer({"optimizer_type": "AdamW", "optimizer_beta1": 0.9,
                                "optimizer_beta2": 0.95, "weight_decay": wd})
    cp = _port(params)
    updates, _ = opt.update(_port(grads), opt.init(cp), cp)
    topt.apply_updates(cp, updates, lr)
    for got in (tp, cp):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_fused_settings_and_optimizer_gating():
    base = dict(optimizer_fused=True, optimizer_type="Adam", optimizer_moment_dtype="bfloat16",
                optimizer_beta1=0.9, optimizer_beta2=0.999, global_seed=333)
    cases = [base, dict(base, optimizer_fused=False), dict(base, optimizer_type="LAMB"),
             dict(base, gradient_clip_norm=1.0), dict(base, optimizer_moment_dtype="float32"),
             dict(base, optimizer_type="AdamW", weight_decay=0.05),
             dict(base, optimizer_moment_dtype="float16")]
    for case in cases:
        assert topt.fused_adam_settings(case) == jopt.fused_adam_settings(case), case
        # the port's Trainer takes the kernel whatever optimizer_fused says,
        # in its plain mode where makani_tpu's fused stage would run
        want = jopt.fused_adam_settings(dict(case, optimizer_fused=True))
        if want is not None:
            assert (topt.kernel_update_settings(case)
                    == dict(want, max_norm=None, lamb=False)), case
    assert topt.fused_adam_settings(base)["seed"] == 340
    # LAMB, Adafactor, SGD and clipping are ported (tests/test_torch_port_multistep.py);
    # an unknown optimizer is still refused, as in makani_tpu
    for build in (topt.build_optimizer, jopt.build_optimizer):
        with pytest.raises(ValueError, match="Unknown optimizer"):
            build({"optimizer_type": "Adagrad"})


@pytest.mark.parametrize("b", [0.9, 0.95, 0.999])
def test_bias_corrections_equal_jax(b):
    """1 - b**count in float32 for the first 20000 counts, bit for bit. XLA's
    float32 pow on the CPU is the C library's powf, which is one ulp off the
    correctly rounded power at 0.999**2958 and 0.999**3606."""
    from makani_tpu_torch.ops.fused_adam import bias_corrections
    counts = np.arange(1, 20001)
    want = np.asarray(jax.jit(lambda c: 1.0 - b ** c.astype(jnp.float32))(
        jnp.asarray(counts, jnp.int32)))
    got = np.array([bias_corrections(int(c), b, b)[0] for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)
    if b == 0.999:
        rounded = np.float32(1.0) - (np.float64(np.float32(b)) ** np.array([2958, 3606])).astype(
            np.float32)
        assert (rounded != want[[2957, 3605]]).all()


def test_dither_and_stochastic_round_match_jax():
    x = np.random.RandomState(3).randn(4, 33).astype(np.float32)
    for salt in (0, 1234, 0xDEADBEEF):
        np.testing.assert_array_equal(
            topt._dither_u16((4, 33), salt).numpy(),
            np.asarray(jopt._dither_u16((4, 33), jnp.uint32(salt))).astype(np.int64))
        np.testing.assert_array_equal(
            topt._stochastic_round(torch.from_numpy(x), torch.bfloat16, salt).float().numpy(),
            np.asarray(jopt._stochastic_round(jnp.asarray(x), jnp.bfloat16, jnp.uint32(salt)),
                       np.float32))


# validation losses fed to epoch_step: improvements, a tie, a plateau long
# enough to cut the lr twice at patience 1, then a new best
VALID_LOSSES = [1.0, 0.8, 0.8, 0.85, 0.9, 0.95, 0.7, 0.75, 0.71]
SCHEDULE_CASES = [pytest.param(s, None, {}, id=s) for s in
                  ("none", "StepLR", "CosineAnnealingLR", "OneCycleLR", "ReduceLROnPlateau")]
SCHEDULE_CASES += [pytest.param(s, VALID_LOSSES, {"scheduler_patience": p}, id=f"{s}-losses-p{p}")
                   for s in ("none", "StepLR", "CosineAnnealingLR", "OneCycleLR",
                             "ReduceLROnPlateau") for p in ((0, 1) if s == "ReduceLROnPlateau"
                                                             else (1,))]


@pytest.mark.parametrize("scheduler,losses,extra", SCHEDULE_CASES)
def test_lr_scheduler_matches_jax(scheduler, losses, extra):
    """Every schedule, float for float, fed no validation loss (training
    without validation) or one sequence of them; the state dict round trips
    mid-way into a fresh scheduler of each package."""
    cfg = {"lr": 2e-3, "scheduler": scheduler, "scheduler_T_max": 7, "scheduler_step_size": 2,
           "lr_warmup_steps": 3, "scheduler_patience": 0, "scheduler_factor": 0.3, **extra}
    from makani_tpu_torch.utils.yparams import ParamsBase
    ours, theirs = topt.LRScheduler(ParamsBase.from_dict(cfg)), jopt.LRScheduler(
        ParamsBase.from_dict(cfg))
    for epoch in range(9):
        for step in (0, 1, 5):
            assert ours(step) == theirs(step)
        loss = None if losses is None else losses[epoch]
        ours.epoch_step(loss)
        theirs.epoch_step(loss)
        assert ours.state_dict() == theirs.state_dict()
        if epoch == 4:
            state = json.loads(json.dumps(ours.state_dict()))
            ours = topt.LRScheduler(ParamsBase.from_dict(cfg))
            ours.load_state_dict(state)
            fresh = jopt.LRScheduler(ParamsBase.from_dict(cfg))
            fresh.load_state_dict(state)
            assert fresh.state_dict() == theirs.state_dict() == ours.state_dict()
    assert ours.epoch == theirs.state_dict()["epoch"] == 9
    if scheduler == "ReduceLROnPlateau" and losses is not None:
        assert ours._plateau_scale < 1.0


# --------------------------------------------------------------------------
# quadrature, losses and synthetic data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["naive", "clenshaw-curtiss", "legendre-gauss"])
def test_grid_quadrature_weights_equal_jax(rule):
    from makani_tpu.utils.grids import grid_quadrature_weights as jweights
    from makani_tpu_torch.utils.grids import grid_quadrature_weights as tweights
    for kw in ({}, dict(normalize=True, pole_mask=2, crop_shape=(20, 30), crop_offset=(3, 4))):
        np.testing.assert_array_equal(tweights(rule, (17, 40), **kw),
                                      np.asarray(jweights(rule, (17, 40), **kw)))


LOSS_SPECS = [
    "l2", "geometric l2", "absolute geometric l2", "squared geometric l2",
    "pole-masked geometric l2", "l1", "geometric l1", "weighted geometric l2",
    "absolute squared geometric l2", "absolute geometric h1", "geometric h1",
    "squared absolute geometric h1", "temp-std geometric l2", "squared temp-std geometric l2",
]


@pytest.mark.parametrize("spec", LOSS_SPECS)
def test_loss_handler_matches_jax(tmp_path, spec):
    """The spec matrix of tests/test_losses.py, value and (in the port)
    gradient finite."""
    from makani_tpu.utils.losses import LossHandler as JLoss
    from makani_tpu_torch.utils.losses import LossHandler as TLoss
    from makani_tpu_torch.utils.yparams import ParamsBase as TParams

    n_ch = 4
    np.save(tmp_path / "gstd.npy", np.asarray([1.0, 2.0, 3.0, 4.0], np.float32).reshape(1, 4, 1, 1))
    np.save(tmp_path / "dstd.npy", np.asarray([0.5, 1.0, 1.5, 2.0], np.float32).reshape(1, 4, 1, 1))
    cfg = {"loss": spec, "n_future": 0, "img_shape_x": NLAT, "img_shape_y": NLON,
           "img_crop_shape_x": NLAT, "img_crop_shape_y": NLON, "img_crop_offset_x": 0,
           "img_crop_offset_y": 0, "N_out_channels": n_ch, "out_channels": list(range(n_ch)),
           "channel_names": ["u10m", "v10m", "sst", "z500"], "channel_weights": "auto",
           "model_grid_type": "equiangular", "dt": 4,
           "global_stds_path": str(tmp_path / "gstd.npy"),
           "time_diff_stds_path": str(tmp_path / "dstd.npy")}
    rng = np.random.RandomState(0)
    prd = rng.randn(2, n_ch, NLAT, NLON).astype(np.float32)
    tar = rng.randn(2, n_ch, NLAT, NLON).astype(np.float32)
    jl, tl = JLoss(TParams.from_dict(cfg)), TLoss(TParams.from_dict(cfg))
    for training in (True, False):
        want = float(jl(jnp.asarray(prd), jnp.asarray(tar), training=training))
        prd_t = torch.from_numpy(prd).requires_grad_()
        got = tl(prd_t, torch.from_numpy(tar), training=training)
        got.backward()
        tol = 1e-5 if "h1" in spec else 1e-6
        np.testing.assert_allclose(float(got.detach()), want, rtol=tol)
        assert torch.isfinite(prd_t.grad).all()


def test_synthetic_loader_matches_jax(tmp_path):
    from makani_tpu.data.dataloader import DummyDataset as JDummy, PrefetchingLoader as JLoader
    from makani_tpu_torch.data.dataloader import get_dataloader
    from makani_tpu_torch.utils.yparams import ParamsBase

    cfg = dict(dt=1, n_history=1, n_future=0, valid_autoreg_steps=2, in_channels=[0, 1, 2],
               out_channels=[0, 1], add_zenith=True, n_train_samples_per_epoch=5,
               img_shape_x=6, img_shape_y=8, batch_size=2, global_seed=333,
               enable_synthetic_data=True, num_data_workers=2)
    loader, _ = get_dataloader(ParamsBase.from_dict(cfg), None)
    jds = JDummy(ParamsBase.from_dict(cfg), None, True)
    jloader = JLoader(jds, batch_size=2, shuffle=True, n_samples_per_epoch=5, base_seed=333)
    for _ in range(2):  # two epochs: the permutation follows the epoch
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # without enable_synthetic_data the loader reads files (????.h5 here)
    files = ParamsBase.from_dict(dict(cfg, enable_synthetic_data=False, dhours=6,
                                      h5_path="fields"))
    with pytest.raises(IOError, match="does not contain"):
        get_dataloader(files, str(tmp_path))


def test_augment_batch_rolls_consistently():
    from makani_tpu_torch.utils.trainer import augment_batch
    rng = np.random.RandomState(4)
    inp = torch.from_numpy(rng.randn(3, 2, 5, 16).astype(np.float32))
    tar = torch.from_numpy(rng.randn(3, 1, 5, 16).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    ri, rt, _, _ = augment_batch(inp, tar, None, None, gen, True, 0.0)
    for b in range(3):
        shift = next(s for s in range(16) if torch.equal(torch.roll(inp[b], s, -1), ri[b]))
        assert torch.equal(torch.roll(tar[b], shift, -1), rt[b])
    ni, nt, _, _ = augment_batch(inp, tar, None, None, gen, False, 0.5)
    assert torch.equal(nt, tar) and 0.3 < float((ni - inp).std()) < 0.7


# --------------------------------------------------------------------------
# a 3-block SFNO: gradients, checkpointing and the Trainer against JAX
# --------------------------------------------------------------------------

def _configs(**overrides):
    """Matching (JAX, port) params of a small flagship-shaped SFNO training on
    the synthetic data."""
    common = dict(img_shape_x=NLAT, img_shape_y=NLON, embed_dim=16, num_layers=3,
                  scale_factor=2, enable_synthetic_data=True, n_train_samples_per_epoch=3,
                  n_eval_samples=1, skip_validation=True, save_checkpoint="none",
                  optimizer_fused=True, max_epochs=1, num_data_workers=1, log_to_screen=False,
                  in_channels=list(range(CHANS)), out_channels=list(range(CHANS)),
                  channel_names=[f"c{i}" for i in range(CHANS)], batch_size=1, dhours=6)
    common.update(overrides)
    tp = TYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    jp = JYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    for p in (tp, jp):
        p.update_params(common)
    tregistry.update_channel_params(tp)
    jp.update_params({k: v for k, v in tp.to_dict().items() if k not in jp.to_dict()})
    return jp, tp


@pytest.fixture(scope="module")
def jax_trainer():
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    comm.reset()
    comm.init(devices=jax.devices()[:1])
    jp, tp = _configs()
    trainer = JTrainer(jp, world_rank=0)
    yield trainer, tp
    comm.reset()


def _port_trainer(tp, jtrainer, **kw):
    from makani_tpu_torch.utils.trainer import Trainer
    trainer = Trainer(tp, device="cpu", **kw)
    load_jax_params(trainer.model, {k: np.asarray(v) for k, v in
                                    flatten_dict(jtrainer.model_params, sep="/").items()})
    return trainer


def test_sfno_gradients_match_jax(jax_trainer):
    jtrainer, tp = jax_trainer
    batch = jtrainer.train_dataset[0]
    inp, tar = (x[None] for x in batch)
    jloss, jgrads = jtrainer._grad_step(jtrainer.model_params, jnp.asarray(inp),
                                        jnp.asarray(tar), None, None)
    trainer = _port_trainer(tp, jtrainer)
    loss, grads = trainer.loss_and_grads(torch.from_numpy(inp), torch.from_numpy(tar))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_TOL)
    want = _as_port(jgrads)
    assert set(grads) == set(want)
    # the MLP's output bias feeds an instance norm, which removes it: its
    # exact gradient is zero and both sides hold rounding noise, measured
    # against the largest gradient instead
    largest = max(np.abs(w).max() for w in want.values())
    for k, g in grads.items():
        scale = largest if k.endswith(ZERO_GRAD) else np.abs(want[k]).max()
        err = np.abs(g.numpy().astype(np.float64) - want[k]).max() / scale
        assert err < GRAD_TOL, k


def test_checkpointing_levels_agree(jax_trainer):
    jtrainer, tp = jax_trainer
    inp, tar = (torch.from_numpy(x[None]) for x in jtrainer.train_dataset[1])
    results = []
    for level in range(4):
        trainer = _port_trainer(TYParams.from_dict(dict(tp.to_dict(), checkpointing=level)),
                                jtrainer)
        assert trainer.model.model.checkpointing == level
        results.append(trainer.loss_and_grads(inp, tar))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        for k, g in grads.items():
            assert torch.equal(g, results[0][1][k]), k


def test_trainer_steps_match_jax(jax_trainer):
    """Three steps of the port's Trainer (fused Adam twin, bf16 moments)
    against makani_tpu's Trainer (fused Pallas Adam in interpret mode), on the
    same synthetic batches, from the same weights and optimizer state."""
    jtrainer, tp = jax_trainer
    trainer = _port_trainer(tp, jtrainer)
    flat_state = {"count": int(jtrainer.opt_state[0].count),
                  **{n: {k: np.asarray(v, np.float32) for k, v in
                         flatten_dict(getattr(jtrainer.opt_state[0], n), sep="/").items()}
                     for n in ("mu", "nu")}}
    load_jax_opt_state(trainer.opt_state[0], trainer.model, flat_state)
    # the kernel's plain mode: makani_tpu's fused settings, no clipping, not LAMB
    assert trainer.fused_kw == dict(jopt.fused_adam_settings(jtrainer.params), max_norm=None,
                                    lamb=False)
    start = {k: p.detach().clone() for k, p in trainer.model_params.items()}
    jstart = _as_port(jtrainer.model_params)

    # the JAX step donates its state: step on copies, keep the fixture's
    jparams, jstate = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
    batches = zip(trainer.train_dataloader, jtrainer.train_dataloader)
    for step, (tbatch, jbatch) in enumerate(batches, start=1):
        for x, y in zip(tbatch, jbatch):
            np.testing.assert_array_equal(x, y)
        lr = trainer.scheduler(step)
        if step == 1:
            _, g1 = trainer.loss_and_grads(*trainer._device_batch(tbatch))
            determined = {k: np.abs(g.numpy()) >= SIGN_FLOOR * np.abs(g.numpy()).max()
                          for k, g in g1.items()}
        loss = trainer.train_step(*trainer._device_batch(tbatch), lr)
        jinp, jtar, jzi, jzt = jtrainer._device_batch(jbatch)
        jparams, jstate, jloss = jtrainer.train_step(
            jparams, jstate, jinp, jtar, jzi, jzt, jnp.float32(lr),
            jax.random.fold_in(jtrainer.dropout_key, step))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_TOL)
        if step in (1, 3):
            want = _as_port(jparams)
            for k, p in trainer.model_params.items():
                du = p.detach().numpy() - start[k].numpy()
                assert np.isfinite(du).all(), (step, k)
                if k.endswith(ZERO_GRAD):
                    continue  # Adam scales its rounding-noise gradient to full steps
                keep = determined[k]
                assert keep.mean() > 0.9, k
                jdu = want[k] - jstart[k]
                assert (np.linalg.norm((du - jdu)[keep])
                        <= UPDATE_TOL * np.linalg.norm(jdu[keep])), (step, k)
    assert step == 3 and trainer.opt_state[0].count == int(jstate[0].count) == 3


def test_trainer_runs_an_epoch_and_refuses_what_is_not_ported(jax_trainer):
    from makani_tpu_torch.utils.trainer import Trainer
    _, tp = jax_trainer
    trainer = Trainer(tp, device="cpu", generator=torch.Generator().manual_seed(0))
    before = dict(kernels.launches)
    trainer.train()
    logs = trainer.last_logs["train"]
    assert logs["train_steps"] == 3 and np.isfinite(logs["step losses"]).all()
    assert kernels.launches == before  # the CPU runs the twins
    assert trainer.opt_state[0].count == 3
    unfused = Trainer(TYParams.from_dict(dict(tp.to_dict(), optimizer_fused=False)), device="cpu")
    assert unfused.fused_kw == trainer.fused_kw is not None
    # validation, checkpoints, resume, finetune and the dump are ported
    # (tests/test_torch_port_trainer.py), the unroll and dropout too
    # (tests/test_torch_port_multistep.py), the rollout videos too
    # (tests/test_torch_port_visualize.py), the data, h and w layouts too
    # (tests/test_torch_port_parallel*.py; a serial process asks for the
    # ranks), the fin and fout layouts too (tests/test_torch_port_tensor_parallel.py):
    for override, match in [(dict(model_parallel_sizes=[1, 1, 2, 1]), "ranks"),
                            (dict(model_parallel_sizes=[1, 1, 1, 2]), "ranks")]:
        with pytest.raises(ValueError, match=match):
            Trainer(TYParams.from_dict(dict(tp.to_dict(), **override)), device="cpu")
    for override in (dict(world_size=2), dict(model_parallel_sizes=[1, 2, 1, 1])):
        with pytest.raises(ValueError, match="ranks"):
            Trainer(TYParams.from_dict(dict(tp.to_dict(), **override)), device="cpu")
    validating = Trainer(TYParams.from_dict(dict(tp.to_dict(), skip_validation=False)),
                         device="cpu")
    _, _, valid_logs = validating.validate_one_epoch(1)
    assert np.isfinite(valid_logs["base"]["validation loss"])
    # without enable_synthetic_data the Trainer reads the config's data.json
    # and files, which this checkout does not hold
    with pytest.raises(OSError, match="data.json"):
        Trainer(TYParams.from_dict(dict(tp.to_dict(), enable_synthetic_data=False)),
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(tp)


def test_load_jax_opt_state_rejects_missing_and_unused(jax_trainer):
    jtrainer, tp = jax_trainer
    trainer = _port_trainer(tp, jtrainer)
    mu = {k: np.asarray(v, np.float32) for k, v in
          flatten_dict(jtrainer.opt_state[0].mu, sep="/").items()}
    short = {k: v for k, v in mu.items() if not k.endswith("residual_transform")}
    with pytest.raises(KeyError):
        load_jax_opt_state(trainer.opt_state[0], trainer.model,
                           {"count": 0, "mu": short, "nu": mu})
    with pytest.raises(KeyError):
        load_jax_opt_state(trainer.opt_state[0], trainer.model,
                           {"count": 0, "mu": dict(mu, extra=mu[FILTER]), "nu": mu})
