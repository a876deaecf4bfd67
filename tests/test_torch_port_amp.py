"""makani_tpu_torch under bf16 AMP against makani_tpu with amp_mode bf16, on
the CPU.

A 3-block SFNO at 36x72 (embed 16, 5 channels), flagship-shaped, goes through
both packages under `amp_mode: bf16` from the same weights
(tools/convert_jax_params.load_jax_params) and the same inputs, made with
numpy from a seed: the forward, each block on makani_tpu's own input to it,
a 3-step lite rollout and 3 Trainer steps, on both coefficient engines: the
port's "kernel" engine (the kernels' plain twins here) against makani_tpu's
"pallas" engine, and the port's "xla" engine (the complex dhconv kernel's
twin) against makani_tpu's "xla" engine.

The reference runs as an accelerator runs it (`_jax_engine`):
  - its contractions at DEFAULT round both operands to bf16, products and
    sums in float32, as the port's 1 pass does on every device: the
    Legendre contractions (ops/sht.py transform_einsum) and the complex
    einsums (complex_ops). makani_tpu's CPU forms are exact float32
    instead. The longitude DFT keeps its exact float32 einsum, which the
    port's float32 DFT matches (makani_tpu's accelerator form rounds it to 1
    pass, ROADMAP Queue 3 divergence 1);
  - the "pallas" engine, which makani_tpu takes only off the CPU
    (ops/sht.py `_stacked_engine_active`, `_legendre_dot`, complex_ops
    `contract_dhconv_stacked`): those three are told they run on an
    accelerator, the Pallas kernels run in interpret mode, the tables are
    the host's;
  - its programs compiled without excess precision (ROUND_EVERY_OP): XLA's
    CPU backend otherwise keeps a block's output in float32 where it feeds
    the next block's DFT, past the bf16 rounding its dtype asks for and the
    port makes.

Tolerances. An AMP forward differs from the float32 forward by the bf16
rounding of every activation (makani_tpu/utils/trainer.py:122-123 puts it at
~1.5e-2 for the model). Deviations are norm-wise (||a - b|| / ||b|| over the
whole output, `_dev`). Every check that holds the port to makani_tpu has a
control: the port's float32 run on the same input, which is what a port that
ignored amp_mode would give. The port's AMP run must come out below the
bound and the control above it. Readings, on an x86-64 CPU:
  - a block, or the decoder, on makani_tpu's own bf16 input: port AMP vs JAX
    AMP 0.274 of the control in block 0, 0.007-0.015 in blocks 1-2, ~0 in the
    decoder; bound BLOCK_SHARE = 0.5 of the control. Block 0's gap is the
    only one not at rounding level: at the 36x72 grid the two DFTs sum in
    other orders, and the float32 ulps flip some of the Legendre operands'
    bf16 roundings;
  - end to end, such flips spread through the blocks: port AMP vs JAX AMP
    0.654 of makani_tpu's own AMP deviation in the forward, 0.51-0.66 over
    the rollout's steps, 0.51 in the first step's gradients (over every
    leaf); the control 0.98-1.00, 0.98-0.99 and 0.98-1.00; bound AMP_SHARE =
    0.85 of makani_tpu's deviation;
  - after Adam's first steps, which are sign-like (tests/
    test_torch_port_train.py), rounding turns into lr-sized changes of the
    parameters, AMP or not: the updates (over every element whose first
    gradient is at least SIGN_FLOOR of its leaf's largest; the MLP's output
    bias, whose gradient is rounding noise, is checked finite only) read
    0.79-0.88 of makani_tpu's deviation, the control 0.96-1.07, and are held
    below 1.0 of it; the three losses read 2.8e-4 and 3.5e-4 (the control
    1.4e-4 and 5.7e-4) and are held below LOSS_TOL. Neither can tell AMP
    from float32; the first gradients do.

The rounding points found on the way: jax.nn.gelu on bf16 and its VJP are
chains of bf16 operations, each rounded (their constants too), where
PyTorch's fused GELU rounds once (`test_bf16_gelu_takes_jax_steps` prints
the share of elements that differ); the port's "gelu" on bf16 is
ops/gelu.py's `gelu_bf16`, which gives the bits of both. And the excess
precision above: without ROUND_EVERY_OP, blocks 1-2 on the same input read
1.0 of the control, and the forward 0.671 of makani_tpu's deviation.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict
from jax.experimental import pallas as pl

from makani_tpu.ops import complex_ops as jcomplex
from makani_tpu.ops import sht as jsht
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.ops import complex_ops as tcomplex
from makani_tpu_torch.ops import kernels
from makani_tpu_torch.ops import sht as tsht
from makani_tpu_torch.tools.convert_jax_params import load_jax_opt_state, load_jax_params
from makani_tpu_torch.utils.param_layout import jax_key_to_torch, to_port_layout
from makani_tpu_torch.utils.yparams import YParams as TYParams

NLAT, NLON, CHANS = 36, 72, 5
SIGN_FLOOR = 1e-3
ZERO_GRAD = "mlp.fc2.bias"
ROLLOUT_STEPS = 3
# the bounds, as shares of makani_tpu's own AMP deviation from float32
# (end to end) or of the port's float32 output's distance from makani_tpu's
# AMP output (a block on makani_tpu's own input); the readings they sit
# between are in the module docstring
AMP_SHARE = 0.85
BLOCK_SHARE = 0.5
# the three losses, norm-wise, after Adam's sign-like first steps
LOSS_TOL = 1e-3
# XLA may keep a value in float32 across a bf16 convert that feeds a float32
# one; the reference's programs round where their dtypes say, as the port does
ROUND_EVERY_OP = {"xla_allow_excess_precision": False}
# (port engine, makani_tpu engine)
ENGINES = [("kernel", "pallas"), ("xla", "xla")]


def _defaults():
    for mod in (tsht, jsht):
        mod.set_transform_precision("high")
    for mod in (tcomplex, jcomplex):
        mod.set_contraction_precision("high")
        mod.enable_pallas_kernels(False)
        mod.set_3m_contraction(True)
    tsht.set_coeff_engine("kernel")
    jsht.set_coeff_engine("xla")
    jsht.set_table_mode("auto")


@pytest.fixture(autouse=True)
def _globals():
    """Both packages' engine, precisions, kernel toggle, 3M flag and table
    mode are module globals, shared with every test file of the worker:
    start from the defaults and leave them so."""
    _defaults()
    yield
    _defaults()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Accelerator:
    """The jax module as makani_tpu's ops see it, with an accelerator as the
    default backend."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def _round_bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


def _one_pass_transform_einsum(eq, x, table, precision, stage="coeff"):
    """makani_tpu's transform_einsum as an accelerator runs it
    (makani_tpu/ops/sht.py:171-176): at DEFAULT the Legendre contractions
    round both operands to bf16, products and sums in float32. The longitude
    DFT ("grid") stays the exact float32 einsum of the CPU form, as the
    port's float32 DFT (ROADMAP Queue 3 divergence 1)."""
    x = x.astype(jnp.float32)
    if stage == "coeff" and precision == jax.lax.Precision.DEFAULT:
        x, table = _round_bf16(x), _round_bf16(table)
    return jnp.einsum(eq, x, table)


class _OnePassJnp:
    """jax.numpy as complex_ops sees it, with an einsum at DEFAULT that rounds
    its operands to bf16 as an accelerator's does."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(eq, *operands, precision=None, **kwargs):
        if precision == jax.lax.Precision.DEFAULT:
            operands = [_round_bf16(o) for o in operands]
        return jnp.einsum(eq, *operands, precision=precision, **kwargs)


@contextlib.contextmanager
def _jax_engine(name):
    """makani_tpu's coefficient engine `name` with its contractions as an
    accelerator runs them (the module docstring); every JAX program of the
    engine is traced inside."""
    mp = pytest.MonkeyPatch()
    jit = jax.jit
    mp.setattr(jax, "jit", lambda *a, **k: jit(*a, **{"compiler_options": ROUND_EVERY_OP, **k}))
    mp.setattr(jsht, "transform_einsum", _one_pass_transform_einsum)
    mp.setattr(jcomplex, "jnp", _OnePassJnp())
    if name == "pallas":
        call = pl.pallas_call
        mp.setattr(jsht, "jax", _Accelerator())
        mp.setattr(jcomplex, "jax", _Accelerator())
        mp.setattr(pl, "pallas_call", lambda *a, **k: call(*a, **{**k, "interpret": True}))
        jsht.set_table_mode("host")
    jsht.set_coeff_engine(name)
    try:
        yield
    finally:
        mp.undo()
        jsht.set_coeff_engine("xla")
        jsht.set_table_mode("auto")


def _precision(name):
    for mod in (tsht, jsht):
        mod.set_transform_precision(name)
    for mod in (tcomplex, jcomplex):
        mod.set_contraction_precision(name)


def _port_engine(name):
    tsht.set_coeff_engine(name)
    tcomplex.enable_pallas_kernels(name == "xla")


def _dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hold(label, err, amp_dev, control):
    """The port's AMP run, `err` from makani_tpu's AMP run, below AMP_SHARE of
    makani_tpu's own AMP deviation from float32 `amp_dev`; the port's float32
    run, `control` from makani_tpu's AMP run (what a port that ignored
    amp_mode would give), above it."""
    bound = AMP_SHARE * amp_dev
    print(f"{label}: port AMP vs JAX AMP {err:.3e} ({err / amp_dev:.3f} of AMP's); port float32 "
          f"vs JAX AMP {control:.3e} ({control / amp_dev:.3f}); bound {bound:.3e}")
    assert err < bound < control, label


def _configs(**overrides):
    """Matching (JAX, port) params of a small flagship-shaped SFNO training on
    the synthetic data under bf16 AMP."""
    common = dict(img_shape_x=NLAT, img_shape_y=NLON, embed_dim=16, num_layers=3,
                  scale_factor=2, enable_synthetic_data=True, n_train_samples_per_epoch=3,
                  n_eval_samples=1, skip_validation=True, save_checkpoint="none",
                  optimizer_fused=True, max_epochs=1, num_data_workers=1, log_to_screen=False,
                  in_channels=list(range(CHANS)), out_channels=list(range(CHANS)),
                  channel_names=[f"c{i}" for i in range(CHANS)], batch_size=1, dhours=6,
                  amp_mode="bf16")
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
    # makani_tpu's Trainer resolves AMP's precision as the port's does
    assert trainer.amp_dtype == jnp.bfloat16
    assert jsht.get_transform_precision() == jax.lax.Precision.DEFAULT
    _defaults()
    flat = {k: np.asarray(v) for k, v in flatten_dict(trainer.model_params, sep="/").items()}
    yield trainer, tp, flat
    comm.reset()


def _as_port(tree):
    return {jax_key_to_torch(k): to_port_layout(jax_key_to_torch(k), np.asarray(v, np.float32))
            for k, v in flatten_dict(tree, sep="/").items()}


def _port_model(tp, flat):
    model = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    model.eval()
    return model


# --------------------------------------------------------------------------
# the resolved precision
# --------------------------------------------------------------------------

@pytest.mark.parametrize("amp_mode,override,want_dtype,want", [
    ("bf16", None, torch.bfloat16, "default"), ("fp16", None, torch.bfloat16, "default"),
    ("none", None, None, "high"), ("bf16", "high", torch.bfloat16, "high"),
    ("bf16", "highest", torch.bfloat16, "highest"), ("none", "default", None, "default")])
def test_amp_resolves_the_precision(amp_mode, override, want_dtype, want):
    """AMP's transform and contraction precision is "default" (1 bf16 pass in
    the kernels), else "high"; transform_precision overrides either
    (makani_tpu/utils/trainer.py:110-135). The Inferencer takes the same
    amp_dtype and leaves the precision as it finds it."""
    from makani_tpu_torch.utils.inferencer import Inferencer
    from makani_tpu_torch.utils.trainer import Trainer
    _, tp = _configs(amp_mode=amp_mode, transform_precision=override)
    trainer = Trainer(tp, device="cpu")
    assert trainer.amp_dtype == want_dtype
    assert tsht.get_transform_precision() == want
    assert tcomplex.get_contraction_precision() == want
    assert tsht._coeff_passes() == {"default": 1, "high": 3, "highest": None}[want]
    tsht.set_transform_precision("split2")
    inferencer = Inferencer(tp, device="cpu")
    assert inferencer.amp_dtype == want_dtype
    assert tsht.get_transform_precision() == "split2"


def test_bf16_gelu_takes_jax_steps():
    """jax.nn.gelu on bf16 rounds each of its steps; the port's "gelu" on
    bf16 gives its bits, where PyTorch's fused GELU, rounded once, differs in
    a large share of the elements."""
    import torch.nn.functional as F
    from makani_tpu_torch.models.common.activations import get_activation
    x = (2 * np.random.RandomState(42).randn(2, 16, 18, 36)).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = get_activation("gelu")(xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    fused = F.gelu(xb, approximate="tanh").float().numpy()
    share = float(np.mean(fused != want))
    print(f"PyTorch's fused GELU differs from jax.nn.gelu on bf16 in {share:.1%} of the elements")
    assert share > 0.1
    # float32 keeps PyTorch's fused form, within float32 rounding of JAX's
    want32 = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    np.testing.assert_allclose(get_activation("gelu")(torch.from_numpy(x)).numpy(), want32,
                               rtol=1e-6, atol=1e-6)


def test_bf16_gelu_gradient_takes_jax_vjp_steps():
    """jax.nn.gelu's VJP on bf16 is a chain of bf16 operations too; the
    port's gradient gives its bits (x alone saved), where autograd through
    the forward's bf16 steps differs in a share of the elements."""
    from makani_tpu_torch.models.common.activations import get_activation
    from makani_tpu_torch.ops.gelu import gelu_bf16_plain
    rng = np.random.RandomState(43)
    x, g = (jnp.asarray(a * rng.randn(2, 16, 18, 36), jnp.bfloat16) for a in (3, 1))
    vjp = jax.jit(lambda x, g: jax.vjp(jax.nn.gelu, x)[1](g)[0],
                  compiler_options=ROUND_EVERY_OP)
    want = np.asarray(vjp(x, g).astype(jnp.float32))
    tx, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in (x, g))
    xr = tx.clone().requires_grad_()
    y = get_activation("gelu")(xr)
    assert len(y.grad_fn.saved_tensors) == 1  # x alone
    y.backward(tg)
    np.testing.assert_array_equal(xr.grad.float().numpy(), want)
    chain = tx.clone().requires_grad_()
    gelu_bf16_plain(chain).backward(tg)
    share = float(np.mean(chain.grad.float().numpy() != want))
    print(f"autograd through the forward's bf16 steps differs from jax's VJP in {share:.1%} "
          f"of the elements")
    assert share > 0.01


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------

def _jax_forward(jtrainer, x, dtype):
    jm = jtrainer.model
    fwd = jax.jit(lambda p, a: jm.apply({"params": p}, a.astype(dtype),
                                        deterministic=True).astype(jnp.float32))
    return np.asarray(fwd(jtrainer.model_params, jnp.asarray(x)))


@pytest.mark.parametrize("engine,jengine", ENGINES)
def test_amp_forward_matches_jax(jax_trainer, engine, jengine):
    jtrainer, tp, flat = jax_trainer
    x = np.random.RandomState(40).randn(2, CHANS, NLAT, NLON).astype(np.float32)
    _precision("default")
    with _jax_engine(jengine):
        jamp = _jax_forward(jtrainer, x, jnp.bfloat16)
        jf32 = _jax_forward(jtrainer, x, jnp.float32)
    _port_engine(engine)
    model = _port_model(tp, flat)
    before = dict(kernels.launches)
    with torch.inference_mode():
        out = model(torch.from_numpy(x).to(torch.bfloat16))
        pf32 = model(torch.from_numpy(x)).numpy()
    assert kernels.launches == before  # the CPU runs the twins
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, CHANS, NLAT, NLON)
    got = out.float().numpy()
    assert np.isfinite(got).all()
    amp_dev = _dev(jamp, jf32)
    assert 1e-3 < amp_dev < 5e-2  # AMP visibly rounds, at its expected size
    _hold(f"{engine} forward", _dev(got, jamp), amp_dev, _dev(pf32, jamp))


@pytest.mark.parametrize("engine,jengine", ENGINES)
def test_amp_blocks_match_jax_on_the_same_inputs(jax_trainer, engine, jengine):
    """Each of the port's blocks, and its decoder, given makani_tpu's own bf16
    input to it in makani_tpu's AMP forward: its AMP output against
    makani_tpu's, below BLOCK_SHARE of the distance of its float32 output on
    the same input (the control: the block ignoring AMP)."""
    jtrainer, tp, flat = jax_trainer
    x = np.random.RandomState(40).randn(2, CHANS, NLAT, NLON).astype(np.float32)
    _precision("default")
    with _jax_engine(jengine):
        jm = jtrainer.model
        _, state = jax.jit(lambda p, a: jm.apply(
            {"params": p}, a.astype(jnp.bfloat16), deterministic=True,
            capture_intermediates=True, mutable=["intermediates"]))(jtrainer.model_params,
                                                                   jnp.asarray(x))
    seen = flatten_dict(state["intermediates"], sep="/")
    _port_engine(engine)
    net = _port_model(tp, flat).model
    stages = [(f"model/blocks_{i}", blk) for i, blk in enumerate(net.blocks)]
    stages.append(("model/decoder", net.decoder))
    previous = "model/encoder"
    with torch.inference_mode():
        for name, module in stages:
            inp, want = (np.asarray(seen[f"{k}/__call__"][0].astype(jnp.float32))
                         for k in (previous, name))
            inp = torch.from_numpy(inp)
            got = module(inp.to(torch.bfloat16))
            assert got.dtype == torch.bfloat16, name
            err, control = _dev(got.float().numpy(), want), _dev(module(inp).numpy(), want)
            print(f"{engine} {name}: port AMP vs JAX AMP {err:.3e}; port float32 vs JAX AMP "
                  f"{control:.3e} ({err / control:.3f} of it)")
            assert err < BLOCK_SHARE * control, name
            previous = name


# --------------------------------------------------------------------------
# the lite rollout
# --------------------------------------------------------------------------

def _jax_rollout(jtrainer, x, amp_dtype):
    from makani_tpu.utils.inferencer import Inferencer as JInferencer
    jp = jtrainer.params
    steps = jp["valid_autoreg_steps"]
    jp["valid_autoreg_steps"] = ROLLOUT_STEPS - 1
    try:
        jinf = JInferencer.__new__(JInferencer)
        jinf.params, jinf.model = jp, jtrainer.model
        jinf.preprocessor = jtrainer.model.preprocessor
        jinf.loss_obj = jinf.metrics = None
        jinf.amp_dtype = amp_dtype
        jinf.data_parallel_size = 1
        jinf.sst_persistence_channels = ()
        jinf._build_inference_steps()
        return jinf._rollout_lite(jtrainer.model_params, jnp.asarray(x), None, None)
    finally:
        jp["valid_autoreg_steps"] = steps


@pytest.mark.parametrize("engine,jengine", ENGINES)
def test_amp_lite_rollout_matches_jax(jax_trainer, engine, jengine):
    from makani_tpu_torch.utils.inferencer import Inferencer
    jtrainer, tp, flat = jax_trainer
    tp = TYParams.from_dict(dict(tp.to_dict(), valid_autoreg_steps=ROLLOUT_STEPS - 1))
    x = np.random.RandomState(41).randn(1, 1, CHANS, NLAT, NLON).astype(np.float32)
    _precision("default")
    with _jax_engine(jengine):
        jamp = _jax_rollout(jtrainer, x, jnp.bfloat16)
        jf32 = _jax_rollout(jtrainer, x, None)
    _port_engine(engine)
    runs = {}
    for amp_mode in ("bf16", "none"):
        inf = Inferencer(TYParams.from_dict(dict(tp.to_dict(), amp_mode=amp_mode)), device="cpu")
        load_jax_params(inf.model, flat)
        runs[amp_mode] = inf._rollout_lite(x)
    # the Inferencer leaves the engine and the precision as set
    assert tsht.get_coeff_engine() == engine and tsht.get_transform_precision() == "default"
    got = runs["bf16"]
    assert got.dtype == np.float32 and got.shape == jamp.shape == (ROLLOUT_STEPS, 1, CHANS,
                                                                   NLAT, NLON)
    assert np.isfinite(got).all()
    for step in range(ROLLOUT_STEPS):
        _hold(f"{engine} rollout step {step}", _dev(got[step], jamp[step]),
              _dev(jamp[step], jf32[step]), _dev(runs["none"][step], jamp[step]))


# --------------------------------------------------------------------------
# the Trainer's steps
# --------------------------------------------------------------------------

def _jax_steps(jtrainer, batches, jengine, amp_dtype):
    """makani_tpu's train step (fused Pallas Adam in interpret mode) over
    `batches` from the fixture's weights and state, built afresh under
    `amp_dtype`; returns the losses, the parameters after the steps and the
    gradients of the first batch at the fixture's weights, in the port's
    layout, and the optimizer's step count."""
    jtrainer.amp_dtype = amp_dtype
    try:
        with _jax_engine(jengine):
            jtrainer._build_steps()
            params, state = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
            _, grads = jtrainer._grad_step(params, *jtrainer._device_batch(batches[0]))
            losses = []
            for step, batch in enumerate(batches, start=1):
                inp, tar, zen_inp, zen_tar = jtrainer._device_batch(batch)
                params, state, loss = jtrainer.train_step(
                    params, state, inp, tar, zen_inp, zen_tar, jnp.float32(1e-3),
                    jax.random.fold_in(jtrainer.dropout_key, step))
                losses.append(float(loss))
    finally:
        jtrainer.amp_dtype = jnp.bfloat16
    return np.asarray(losses), _as_port(params), _as_port(grads), int(state[0].count)


def _port_steps(tp, jtrainer, flat, batches, amp_mode):
    from makani_tpu_torch.utils.trainer import Trainer
    trainer = Trainer(TYParams.from_dict(dict(tp.to_dict(), amp_mode=amp_mode,
                                              transform_precision="default")), device="cpu")
    load_jax_params(trainer.model, flat)
    load_jax_opt_state(trainer.opt_state[0], trainer.model, {
        "count": int(jtrainer.opt_state[0].count),
        **{n: {k: np.asarray(v, np.float32) for k, v in
               flatten_dict(getattr(jtrainer.opt_state[0], n), sep="/").items()}
           for n in ("mu", "nu")}})
    _, g1 = trainer.loss_and_grads(*trainer._device_batch(batches[0]))
    losses = [float(trainer.train_step(*trainer._device_batch(b), 1e-3)) for b in batches]
    params = {k: p.detach().numpy() for k, p in trainer.model_params.items()}
    return np.asarray(losses), params, g1, trainer


@pytest.mark.parametrize("engine,jengine", ENGINES)
def test_amp_trainer_steps_match_jax(jax_trainer, engine, jengine):
    """Three steps of the port's Trainer under AMP (fused Adam twin, bf16
    moments) against makani_tpu's, on the same synthetic batches, from the
    same weights and optimizer state."""
    from makani_tpu_torch.utils.trainer import Trainer
    jtrainer, tp, flat = jax_trainer
    batches = list(Trainer(tp, device="cpu").train_dataloader)
    assert len(batches) == 3
    _precision("default")
    jamp = _jax_steps(jtrainer, batches, jengine, jnp.bfloat16)
    jf32 = _jax_steps(jtrainer, batches, jengine, None)
    assert jamp[3] == jf32[3] == 3
    _port_engine(engine)
    losses, params, g1, trainer = _port_steps(tp, jtrainer, flat, batches, "bf16")
    assert trainer.amp_dtype == torch.bfloat16 and trainer.opt_state[0].count == 3
    assert all(p.dtype == torch.float32 for p in trainer.model_params.values())
    assert all(m.dtype == torch.bfloat16 for m in trainer.opt_state[0].mu.values())
    f32_losses, f32_params, f32_g1 = _port_steps(tp, jtrainer, flat, batches, "none")[:3]
    assert np.isfinite(losses).all()

    loss_err = _dev(losses, jamp[0])
    print(f"{engine} losses: port AMP {losses}, JAX AMP {jamp[0]}, JAX float32 {jf32[0]}; "
          f"deviation {loss_err:.3e} (port float32 {_dev(f32_losses, jamp[0]):.3e})")
    assert loss_err < LOSS_TOL

    start = _as_port(jtrainer.model_params)
    keys = sorted(k for k in start if not k.endswith(ZERO_GRAD))

    def flat_grads(g):
        return np.concatenate([np.asarray(g[k], np.float32).ravel() for k in keys])

    jg = flat_grads(jamp[2])
    _hold(f"{engine} first gradients", _dev(flat_grads(g1), jg), _dev(jg, flat_grads(jf32[2])),
          _dev(flat_grads(f32_g1), jg))
    determined = {}
    for k, g in g1.items():
        g = np.abs(g.numpy())
        determined[k] = g >= SIGN_FLOOR * g.max()
        assert k.endswith(ZERO_GRAD) or determined[k].mean() > 0.9, k

    def updates(p):
        return np.concatenate([(p[k] - start[k])[determined[k]] for k in keys])

    for k, p in params.items():
        assert np.isfinite(p).all(), k
    jdu = updates(jamp[1])
    err, amp_dev = _dev(updates(params), jdu), _dev(jdu, updates(jf32[1]))
    print(f"{engine} updates: port AMP vs JAX AMP {err:.3e} ({err / amp_dev:.3f} of AMP's); "
          f"port float32 vs JAX AMP {_dev(updates(f32_params), jdu) / amp_dev:.3f} of AMP's")
    assert err < amp_dev
