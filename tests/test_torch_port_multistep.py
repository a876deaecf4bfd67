"""makani_tpu_torch's training leftovers against makani_tpu on the CPU: the
multi-step unroll, dropout, LAMB, Adafactor, SGD and gradient clipping.

Models: a 2-block SFNO of width 12 on a 20x44 grid, 5 channels, one history
step and the zenith channel (11 input channels), batch 2; for dropout a
3-block one with the non-linear filter, so that every dropout site runs
(after the encoder, in the non-linear filter, in the MLPs, DropPath). Weights
are made in JAX and carried into the port (load_jax_params); inputs come from
numpy seeds or the synthetic loader.

Tolerances:
  - the unroll (output, loss, gradients), and the dropout forward and
    gradients given JAX's masks: test_sfno_gradients_match_jax's (TOL 2e-4
    of the largest output, STEP_LOSS_TOL 1e-4 on the loss, GRAD_TOL 2e-4 of
    each leaf's largest gradient, the MLP's output bias against the largest
    of all). JAX's CPU dots are exact float32, the port's SHT keeps the
    3-pass bf16 splits (~1e-5 a contraction);
  - Trainer steps and the train CLI at n_future 1: test_trainer_steps_match_
    jax's (losses STEP_LOSS_TOL, updates UPDATE_TOL norm-wise over the
    elements whose first gradient is at least SIGN_FLOOR of their leaf's);
  - dropout in the port: bit for bit (deterministic or rate 0 against no
    dropout; checkpointing 0, 2 and 3; resume);
  - optimizers, 3 updates on a model-shaped tree: bf16 moments without a
    global norm (LAMB's Adam part) bit for bit; where the global norm enters
    (clipping) or a per-leaf norm (the trust ratio), or optax's float32
    arithmetic against the port's (float32 moments, Adafactor, SGD),
    OPT_TOL relative to each leaf's largest magnitude: the norms are sums
    in another order (~1e-7 relative). bf16 moments fed a clipped gradient:
    under 1% of the elements differ, by less than 2**-7 of the leaf's
    largest (a float32 moment that moved by its last bits rounds to the
    neighbouring bf16 value now and then).
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from makani_tpu.models import model_registry as jregistry
from makani_tpu.models.common.layers import DropPath as JDropPath
from makani_tpu.utils import optimizers as jopt
from makani_tpu.utils.losses import LossHandler as JLoss
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.data.dataloader import get_dataloader
from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.models.common import layers as tlayers
from makani_tpu_torch.ops.fused_adam import fused_adam_apply_plain
from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
from makani_tpu_torch.tools.convert_jax_params import load_jax_params
from makani_tpu_torch.utils import optimizers as topt
from makani_tpu_torch.utils.losses import LossHandler as TLoss
from makani_tpu_torch.utils.param_layout import jax_key_to_torch, to_port_layout
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_train import (
    GRAD_TOL,
    SIGN_FLOOR,
    STEP_LOSS_TOL,
    UPDATE_TOL,
    ZERO_GRAD,
    _as_port,
    _jax_tree,
    _port,
)

TOL = 2e-4
OPT_TOL = 2e-5
NLAT, NLON, CHANS = 20, 44, 5
RATES = dict(pos_drop_rate=0.2, path_drop_rate=0.3, mlp_drop_rate=0.25)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _configs(**overrides):
    """Matching (JAX, port) params of the small SFNO with one history step
    and zenith, training on synthetic data."""
    common = dict(img_shape_x=NLAT, img_shape_y=NLON, embed_dim=12, num_layers=2,
                  scale_factor=2, add_zenith=True, n_history=1, enable_synthetic_data=True,
                  n_train_samples_per_epoch=2, n_eval_samples=2, batch_size=2,
                  in_channels=list(range(CHANS)), out_channels=list(range(CHANS)),
                  channel_names=[f"c{i}" for i in range(CHANS)], dhours=6,
                  num_data_workers=1, log_to_screen=False, skip_validation=True,
                  save_checkpoint="none", max_epochs=1, global_seed=333)
    common.update(overrides)
    tp = TYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    jp = JYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    for p in (tp, jp):
        p.update_params(common)
    tregistry.update_channel_params(tp)
    jp.update_params({k: v for k, v in tp.to_dict().items() if k not in jp.to_dict()})
    return jp, tp


def _batch(tp):
    """The first synthetic batch: (inp, tar, zen_inp, zen_tar) numpy."""
    loader, _ = get_dataloader(tp, None, train=True)
    return next(iter(loader))


def _jax_params(jmodel, inp, zen):
    v = jax.jit(lambda k: jmodel.init(k, jnp.asarray(inp), unpredicted_inp=jnp.asarray(zen),
                                      deterministic=True))(jax.random.PRNGKey(5))
    return v["params"], {k: np.asarray(a) for k, a in flatten_dict(v["params"], sep="/").items()}


def _assert_grads_close(tmodel, want):
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert set(got) == {jax_key_to_torch(k) for k in want}
    largest = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        tk = jax_key_to_torch(k)
        gt = to_port_layout(tk, g, got[tk].shape)
        scale = largest if tk.endswith(ZERO_GRAD) else np.abs(g).max()
        assert np.abs(got[tk].astype(np.float64) - gt).max() / scale < GRAD_TOL, k


# --------------------------------------------------------------------------
# the unroll
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_future", [1, 2])
def test_unroll_matches_jax(n_future):
    """MultiStepWrapper in training: n_future + 1 steps with the history
    appended and the zenith window advanced, against makani_tpu's, through
    both packages' loss (the multistep channel weights) and its gradients."""
    jp, tp = _configs(n_future=n_future)
    assert tp.N_target_channels == (n_future + 1) * CHANS == jp.N_target_channels
    inp, tar, zen_inp, zen_tar = _batch(tp)
    assert tar.shape[1] == n_future + 1 and zen_tar.shape[1] == n_future + 1
    jmodel = jregistry.get_model(jp)
    prep = jmodel.preprocessor
    jinp, jtar = prep.flatten_history(jnp.asarray(inp)), prep.flatten_history(jnp.asarray(tar))
    jparams, flat = _jax_params(jmodel, jinp, zen_inp)
    jloss_fn = JLoss(jp)

    def loss(p):
        pred = jmodel.apply({"params": p}, jinp, unpredicted_inp=jnp.asarray(zen_inp),
                            unpredicted_tar=jnp.asarray(zen_tar), deterministic=False)
        return jloss_fn(pred, jtar, jinp, training=True), pred

    (jloss, jpred), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)

    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    assert type(tmodel).__name__ == "MultiStepWrapper" and tmodel.n_future == n_future
    tprep = tmodel.preprocessor
    tinp = tprep.flatten_history(torch.from_numpy(inp))
    ttar = tprep.flatten_history(torch.from_numpy(tar))
    tloss_fn = TLoss(tp, device="cpu")
    assert tloss_fn.train_channel_weights.shape == (1, (n_future + 1) * CHANS)
    np.testing.assert_array_equal(
        tloss_fn.train_channel_weights.numpy().ravel(),
        (jloss_fn.channel_weights * jloss_fn.multistep_weight).ravel())
    assert (jloss_fn.multistep_weight.ravel() == np.float32(1.0 / (n_future + 1))).all()
    pred = tmodel(tinp, unpredicted_inp=torch.from_numpy(zen_inp),
                  unpredicted_tar=torch.from_numpy(zen_tar), deterministic=False)
    assert pred.shape == jpred.shape == (2, (n_future + 1) * CHANS, NLAT, NLON)
    assert _rel(pred.detach().numpy(), jpred) < TOL
    tloss = tloss_fn(pred, ttar, tinp, training=True)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=STEP_LOSS_TOL)
    _assert_grads_close(tmodel, {k: np.asarray(g) for k, g in
                                 flatten_dict(jgrads, sep="/").items()})


# --------------------------------------------------------------------------
# the Trainer and the train CLI at --multistep_count 2
# --------------------------------------------------------------------------

CLI_CHANNELS = ["u10m", "t2m", "z500", "q700", "v850"]
# 18 degrees in the filter: the l = 0 row, which the instance norm after the
# filter leaves without gradient, is under a tenth of its weight
CLI_SHAPE = (36, 46)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """makani_tpu's and the port's train CLI on one dataset, config
    smoke_test at --multistep_count 2 (1 epoch of 3 steps, no validation or
    checkpoints); the port starts from makani_tpu's initial weights."""
    import sys
    from makani_tpu import train as jtrain
    from makani_tpu.parallel import comm
    from makani_tpu.utils import trainer as jtrainer_mod
    from makani_tpu_torch import train as ttrain
    from makani_tpu_torch.utils import trainer as ttrainer_mod
    root = tmp_path_factory.mktemp("multistep_cli")
    data = root / "data"
    tsynth.make_dataset(str(data), img_shape=CLI_SHAPE, channels=CLI_CHANNELS,
                        n_samples_per_year=5, n_valid_samples=4, mode="ar", fmt="bin", seed=7)
    cfg = TYParams("config/sfnonet.yaml", "smoke_test").to_dict()
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    for key, value in list(cfg.items()):
        if isinstance(value, str) and value.startswith("./datasets/synthetic"):
            cfg[key] = value.replace("./datasets/synthetic", str(data))
    cfg.update(exp_dir=str(root / "runs"), img_shape_x=CLI_SHAPE[0], img_shape_y=CLI_SHAPE[1],
               embed_dim=12,
               n_train_samples_per_epoch=3, num_data_workers=1, log_to_screen=False)
    (root / "smoke.yaml").write_text(yaml.safe_dump({"smoke_test": cfg}))
    common = ["--yaml_config", str(root / "smoke.yaml"), "--config", "smoke_test",
              "--multistep_count", "2", "--skip_validation", "--save_checkpoint", "none"]
    seen = {}

    class JRecording(jtrainer_mod.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["jax"] = self
            seen["init"] = jax.tree.map(jnp.copy, (self.model_params, self.opt_state))

    class TCrossed(ttrainer_mod.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            load_jax_params(self.model, {k: np.asarray(v) for k, v in
                                         flatten_dict(seen["init"][0], sep="/").items()})

    init = comm.init
    argv_before = sys.argv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(comm, "init", lambda **kw: init(devices=jax.devices()[:1], **kw))
        mp.setattr(jtrainer_mod, "Trainer", JRecording)
        mp.setattr(ttrainer_mod, "Trainer", TCrossed)
        sys.argv = ["train.py", *common, "--run_num", "j"]
        try:
            jtrain.main()
        finally:
            sys.argv = argv_before
        port = ttrain.main([*common, "--run_num", "t", "--device", "cpu"])
    yield dict(jax=seen["jax"], init=seen["init"], port=port)
    comm.reset()


def test_train_cli_multistep_count_matches_jax(cli_runs):
    jt, port = cli_runs["jax"], cli_runs["port"]
    for p in (jt.params, port.params):
        assert (p.multistep_count, p.n_future) == (2, 1)
        assert p.N_target_channels == 2 * p.N_out_channels == 2 * len(CLI_CHANNELS)
    assert type(port.model).__name__ == "MultiStepWrapper" and port.model.n_future == 1
    assert (port.iters, port.epoch) == (jt.iters, jt.epoch) == (3, 1)
    losses = port.last_logs["train"]["step losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    np.testing.assert_allclose(port.last_logs["train"]["loss"], jt._last_train_loss,
                               rtol=STEP_LOSS_TOL)
    assert port.adam_state().count == 3
    for k, p in port.model_params.items():
        assert torch.isfinite(p).all(), k


def test_trainer_steps_match_jax(cli_runs):
    """Three steps of a port Trainer at n_future 1 against makani_tpu's (the
    CLI run's, from its initial state), on the same batches from the files."""
    from makani_tpu_torch.utils.trainer import Trainer
    jt = cli_runs["jax"]
    jparams, jstate = jax.tree.map(jnp.copy, cli_runs["init"])
    trainer = Trainer(TYParams.from_dict(cli_runs["port"].params.to_dict()), device="cpu")
    load_jax_params(trainer.model, {k: np.asarray(v) for k, v in
                                    flatten_dict(jparams, sep="/").items()})
    start = {k: p.detach().clone() for k, p in trainer.model_params.items()}
    jstart = _as_port(jparams)
    jt.train_dataloader.epoch = 0
    step = 0
    for step, (tbatch, jbatch) in enumerate(zip(trainer.train_dataloader, jt.train_dataloader),
                                            start=1):
        for x, y in zip(tbatch, jbatch):
            np.testing.assert_array_equal(x, y)
        assert tbatch[1].shape[1] == 2  # two target frames a sample
        lr = trainer.scheduler(step)
        batch = trainer._device_batch(tbatch)
        if step == 1:
            _, g1 = trainer.loss_and_grads(*batch)
            determined = {k: np.abs(g.numpy()) >= SIGN_FLOOR * np.abs(g.numpy()).max()
                          for k, g in g1.items()}
        loss = trainer.train_step(*batch, lr)
        jparams, jstate, jloss = jt.train_step(
            jparams, jstate, *jt._device_batch(jbatch), jnp.float32(lr),
            jax.random.fold_in(jt.dropout_key, step))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_TOL)
        if step in (1, 3):
            want = _as_port(jparams)
            for k, p in trainer.model_params.items():
                du = p.detach().numpy() - start[k].numpy()
                assert np.isfinite(du).all(), (step, k)
                if k.endswith(ZERO_GRAD):
                    continue
                keep = determined[k]
                assert keep.mean() > 0.9, k
                jdu = want[k] - jstart[k]
                assert (np.linalg.norm((du - jdu)[keep])
                        <= UPDATE_TOL * np.linalg.norm(jdu[keep])), (step, k)
    assert step == 3


# --------------------------------------------------------------------------
# dropout
# --------------------------------------------------------------------------

def _dropout_configs(**overrides):
    return _configs(num_layers=3, filter_type="non-linear", operator_type="diagonal",
                    spectral_layers=2, **overrides)


@pytest.fixture(scope="module")
def dropout_models():
    """A non-linear SFNO with dropout at RATES and the same without, from one
    set of JAX weights; the first synthetic batch."""
    jp, tp = _dropout_configs(n_future=1, **RATES)
    _, tp0 = _dropout_configs(n_future=1)
    inp, tar, zen_inp, zen_tar = _batch(tp)
    jmodel = jregistry.get_model(jp)
    jinp = jmodel.preprocessor.flatten_history(jnp.asarray(inp))
    jparams, flat = _jax_params(jmodel, jinp, zen_inp)
    drop = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    plain = load_jax_params(tregistry.get_model(tp0, device="cpu"), flat)
    return dict(jp=jp, tp=tp, jmodel=jmodel, jparams=jparams, flat=flat, drop=drop,
                plain=plain, batch=(np.asarray(jinp), tar, zen_inp, zen_tar))


def _run(model, batch, deterministic, key=None):
    inp, _, zen_inp, zen_tar = (None if b is None else torch.from_numpy(np.array(b))
                                for b in batch)
    with tlayers.use_dropout_key(key):
        return model(inp, unpredicted_inp=zen_inp, unpredicted_tar=zen_tar,
                     deterministic=deterministic)


def test_dropout_sites_are_numbered(dropout_models):
    net = dropout_models["drop"].model
    kinds = [type(m).__name__ for m in net.modules()
             if isinstance(m, (tlayers.Dropout, tlayers.DropPath))]
    # the encoder's, then per block the filter's 2, the MLP's 2 and DropPath
    assert kinds == ["Dropout"] + (["Dropout"] * 4 + ["DropPath"]) * 3
    assert sorted(m.site for m in net.modules() if hasattr(m, "site")) == list(range(16))
    assert net.n_dropout_sites == 16
    assert [b.drop_path.drop_prob for b in net.blocks] == [0.0, 0.15, 0.3]
    assert net.blocks[2].filter_layer.filter.drop_0.rate == 0.3
    assert net.blocks[1].mlp.drop1.broadcast_dims == (2, 3)


@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
def test_dropout_is_the_identity_when_deterministic_or_at_rate_zero(dropout_models, rate):
    d = dropout_models
    _, tp = _dropout_configs(n_future=1, **{k: rate for k in RATES})
    drop = load_jax_params(tregistry.get_model(tp, device="cpu"), d["flat"])
    with torch.no_grad():
        want = _run(d["plain"], d["batch"], True)
        assert torch.equal(_run(drop, d["batch"], True), want)
        # at rate 0 the training forward draws nothing and needs no key
        train_plain = _run(d["plain"], d["batch"], False)
        assert torch.equal(train_plain[:, :CHANS], want)
    with pytest.raises(RuntimeError, match="dropout key"):
        with torch.no_grad():
            _run(d["drop"], d["batch"], False)


def test_dropout_masks_shapes_and_scaling(dropout_models, monkeypatch):
    """Each kind of site: the shape of its draw and its output, (x / keep)
    where kept and 0 elsewhere; one draw a site and unrolled step, a new one
    at the next step or substep, the same for the same key."""
    d = dropout_models
    drawn = []
    draw = tlayers.drop_mask

    def recording(shape, keep, site, device):
        mask = draw(shape, keep, site, device)
        drawn.append((tuple(shape), keep, site, mask))
        return mask
    monkeypatch.setattr(tlayers, "drop_mask", recording)
    seen = []

    def hook(module, args, out):
        seen.append((module, args[0], out))
    net = d["drop"].model
    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (tlayers.Dropout, tlayers.DropPath))]
    key = tlayers.DropoutKey(11, 4, 0)
    with torch.no_grad():
        _run(d["drop"], d["batch"], False, key)
    for h in handles:
        h.remove()
    active = [(m, x, y) for m, x, y in seen
              if getattr(m, "rate", getattr(m, "drop_prob", 0.0)) > 0]
    # at a nonzero rate: the encoder's, block 0's MLP (its path rate is 0) and
    # all five sites of blocks 1 and 2; two unrolled steps
    assert len(active) == len(drawn) == 2 * 13
    b, e = 2, 12
    for (m, x, y), (shape, keep, site, mask) in zip(active, drawn):
        assert site == m.site and mask.dtype == torch.bool and tuple(mask.shape) == shape
        if isinstance(m, tlayers.DropPath):
            assert shape == (b, 1, 1, 1) and keep == 1.0 - m.drop_prob
            assert torch.equal(y, (x / keep) * mask.to(x.dtype))
            continue
        assert keep == 1.0 - m.rate
        if m.broadcast_dims:   # the MLP's: a draw per feature map
            assert shape == (b, x.shape[1], 1, 1) and x.shape[1] in (e, 2 * e)
        else:                  # the encoder's, and the filter's on complex coefficients
            assert shape == tuple(x.shape)
            assert x.is_complex() == (m is not net.pos_drop)
        assert torch.equal(y, torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype)))
    # the two unrolled steps draw other masks at every site
    n = len(drawn) // 2
    for (_, _, s0, m0), (_, _, s1, m1) in zip(drawn[:n], drawn[n:]):
        assert s0 == s1 and (m0.numel() < 8 or not torch.equal(m0, m1))
    # the kept count of every large draw: binomial within 5 sigma
    for _, k, _, m in drawn:
        if m.numel() > 1000:
            assert abs(int(m.sum()) - k * m.numel()) < 5 * (k * (1 - k) * m.numel()) ** 0.5
    # the same key and substep draw the same masks; another step other ones
    with tlayers.use_dropout_key(key):
        assert all(torch.equal(m, draw(s, k, site, "cpu")) for s, k, site, m in drawn[:n])
    with tlayers.use_dropout_key(key._replace(step=5)):
        assert not torch.equal(draw(*drawn[0][:3], "cpu"), drawn[0][3])


def _jax_masks(d, rngs):
    """makani_tpu's realised masks, in call order, read off a probe input of
    ones at every dropout site of one eager training forward (the probe's
    output is 1/keep where kept, 0 where dropped); the forward goes on with
    the same draw, so it is the forward flax computes."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__" or not isinstance(mod, (fnn.Dropout, JDropPath)):
            return next_fun(*args, **kwargs)
        x = args[0]
        rate = mod.rate if isinstance(mod, fnn.Dropout) else mod.drop_prob
        if rate == 0.0 or kwargs.get("deterministic", True):
            return next_fun(*args, **kwargs)
        mask = np.asarray(next_fun(jnp.ones_like(x), **kwargs)) != 0
        masks.append((mask, 1.0 - rate))
        return _apply_jax_mask(mod, x, mask, 1.0 - rate)

    inp, _, zen_inp, zen_tar = d["batch"]
    with fnn.intercept_methods(interceptor):
        out = d["jmodel"].apply({"params": d["jparams"]}, jnp.asarray(inp),
                                unpredicted_inp=jnp.asarray(zen_inp),
                                unpredicted_tar=jnp.asarray(zen_tar), deterministic=False,
                                rngs=rngs)
    return masks, np.asarray(out)


def _apply_jax_mask(mod, x, mask, keep):
    if isinstance(mod, fnn.Dropout):
        return jax.lax.select(jnp.asarray(mask), x / keep, jnp.zeros_like(x))
    return (x / keep) * jnp.asarray(mask).astype(x.dtype)


def test_dropout_given_jax_masks_matches_jax(dropout_models, monkeypatch):
    d = dropout_models
    rngs = {"dropout": jax.random.PRNGKey(17)}
    masks, recorded = _jax_masks(d, rngs)
    assert len(masks) == 2 * 13
    inp, tar, zen_inp, zen_tar = d["batch"]
    plain = np.asarray(d["jmodel"].apply(
        {"params": d["jparams"]}, jnp.asarray(inp), unpredicted_inp=jnp.asarray(zen_inp),
        unpredicted_tar=jnp.asarray(zen_tar), deterministic=False, rngs=rngs))
    np.testing.assert_array_equal(recorded, plain)   # the probe changes nothing
    r = np.random.RandomState(3).randn(*plain.shape).astype(np.float32)

    def replaying():
        queue = list(masks)

        def interceptor(next_fun, args, kwargs, context):
            mod = context.module
            if (context.method_name == "__call__" and isinstance(mod, (fnn.Dropout, JDropPath))
                    and not kwargs.get("deterministic", True)
                    and (mod.rate if isinstance(mod, fnn.Dropout) else mod.drop_prob) > 0):
                mask, keep = queue.pop(0)
                return _apply_jax_mask(mod, args[0], mask, keep)
            return next_fun(*args, **kwargs)
        return interceptor

    def loss(p):
        with fnn.intercept_methods(replaying()):
            y = d["jmodel"].apply({"params": p}, jnp.asarray(inp),
                                  unpredicted_inp=jnp.asarray(zen_inp),
                                  unpredicted_tar=jnp.asarray(zen_tar), deterministic=False)
        return jnp.sum(y * jnp.asarray(r)), y

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(d["jparams"])
    assert _rel(jout, plain) < 1e-5

    queue = list(masks)

    def given(shape, keep, site, device):
        mask, want_keep = queue.pop(0)
        assert keep == want_keep
        return torch.from_numpy(np.ascontiguousarray(mask[tuple(slice(0, s) for s in shape)]))
    monkeypatch.setattr(tlayers, "drop_mask", given)
    model = d["drop"]
    model.zero_grad(set_to_none=True)
    out = _run(model, d["batch"], False)
    assert not queue
    assert _rel(out.detach().numpy(), plain) < TOL
    tloss = (out * torch.from_numpy(r)).sum()
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=STEP_LOSS_TOL)
    _assert_grads_close(model, {k: np.asarray(g) for k, g in
                                flatten_dict(jgrads, sep="/").items()})


def _dropout_trainer(tmp_path=None, **overrides):
    from makani_tpu_torch.utils.trainer import Trainer
    _, tp = _dropout_configs(n_future=1, **RATES, **overrides)
    if tmp_path is not None:
        tp.update_params(dict(save_checkpoint="flexible", checkpoint_path=str(tmp_path / "ckpt"),
                              best_checkpoint_path=str(tmp_path / "best_ckpt")))
    return Trainer(tp, device="cpu", generator=torch.Generator().manual_seed(1))


def test_dropout_gradients_equal_across_checkpointing_levels():
    """A block recomputed in backward draws its forward's masks: the
    gradients at checkpointing 0, 2 and 3 are bit-equal with dropout on; the
    losses of two steps differ (other masks)."""
    results = []
    for level in (0, 2, 3):
        trainer = _dropout_trainer(checkpointing=level)
        assert trainer.model.model.checkpointing == level
        batch = trainer._device_batch(next(iter(trainer.train_dataloader)))
        trainer.iters = 7
        results.append(trainer.loss_and_grads(*batch))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        for k, g in grads.items():
            assert torch.equal(g, results[0][1][k]), k
    trainer.iters = 8
    assert not torch.equal(trainer.loss_and_grads(*batch)[0], results[-1][0])


def test_resume_with_dropout_is_bit_for_bit(tmp_path):
    straight = _dropout_trainer(tmp_path / "straight", max_epochs=2)
    straight.train()
    first = _dropout_trainer(tmp_path / "split", max_epochs=1)
    first.train()
    resumed = _dropout_trainer(tmp_path / "split", max_epochs=2, resuming=True)
    assert (resumed.iters, resumed.epoch) == (1, 1)
    assert resumed.counters()["dropout_seed"] == straight.dropout_seed == 334
    resumed.train()
    for k, p in straight.model.state_dict().items():
        assert torch.equal(p, resumed.model.state_dict()[k]), k
    assert straight.counters() == resumed.counters()
    assert straight.last_logs["train"]["step losses"] == resumed.last_logs["train"]["step losses"]


# --------------------------------------------------------------------------
# the optimizers
# --------------------------------------------------------------------------

def _opt_tree(rng, scale=1.0):
    """A model-shaped tree: biases, 1x1 weights, and a dhconv filter weight
    (C, O, L, 2) with two dimensions past Adafactor's 128, which the port
    stores (2, L, C, O)."""
    return {
        "model": {
            "encoder": {"fwd_0": {"bias": (rng.randn(12) * scale).astype(np.float32),
                                  "weight": (rng.randn(12, 7) * scale).astype(np.float32)}},
            "blocks_0": {
                "SpectralFilterLayer_0": {"filter": {
                    "weight": (rng.randn(130, 129, 3, 2) * scale).astype(np.float32)}},
                "mlp": {"fc1": {"weight": (rng.randn(200, 131) * scale).astype(np.float32)}},
                "norm0": {"weight": (rng.randn(131) * scale).astype(np.float32)}},
            "residual_transform": (rng.randn(5, 7) * scale).astype(np.float32),
        }
    }


def _jax_steps(jtx, params, grads_list, lr):
    jp = _jax_tree(params)
    js = jax.jit(jtx.init)(jp)

    @jax.jit
    def step(p, s, g):
        u, s = jtx.update(g, s, p)
        return jax.tree.map(lambda q, v: q - lr * v, p, u), s
    for g in grads_list:
        jp, js = step(jp, js, _jax_tree(g))
    return jp, js


def _assert_close_trees(port, jax_tree, tol=OPT_TOL):
    want = _as_port(jax_tree)
    assert set(port) == set(want)
    for k, v in port.items():
        assert _rel(v.float().numpy(), want[k]) < tol, k


def _assert_bf16_moments_close(got, want, what):
    """bf16 moments a clipped gradient fed: the stochastic rounding of a
    float32 moment that moved by its last bits lands on the neighbouring bf16
    value now and then, and the next steps carry it: under 1% of the elements
    differ, by less than bf16's precision (2**-7) of the leaf's largest."""
    got = got.float().numpy()
    assert _rel(got, want) < 2.0 ** -7, what
    assert (got != want).mean() < 0.01, what


OPT_CASES = {
    "LAMB-bf16": dict(optimizer_type="LAMB", optimizer_moment_dtype="bfloat16",
                      weight_decay=0.01, optimizer_max_grad_norm=0.5),
    "FusedLAMB-f32": dict(optimizer_type="FusedLAMB", weight_decay=0.01,
                          optimizer_max_grad_norm=0.5),
    "LAMB-bf16-noclip": dict(optimizer_type="LAMB", optimizer_moment_dtype="bfloat16",
                             weight_decay=0.0),
    "Adam-clip": dict(optimizer_type="Adam", gradient_clip_norm=0.5,
                      optimizer_max_grad_norm=32.0),
    "AdamW-clip-bf16": dict(optimizer_type="AdamW", weight_decay=0.05, gradient_clip_norm=0.5,
                            optimizer_moment_dtype="bfloat16"),
    "Adam-maxnorm-only": dict(optimizer_type="Adam", optimizer_max_grad_norm=0.5),
    "Adafactor": dict(optimizer_type="Adafactor"),
    "SGD": dict(optimizer_type="SGD"),
    "SGD-momentum": dict(optimizer_type="SGD", momentum=0.9),
    "SGD-momentum-clip": dict(optimizer_type="SGD", momentum=0.9, gradient_clip_norm=0.5),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_build_optimizer_matches_jax(case):
    """3 updates of build_optimizer's chain against makani_tpu's, and, for the
    Adam family, of the fused update's plain twin (the kernel's arithmetic,
    which the Trainer runs) in the config's mode."""
    cfg = dict(optimizer_beta1=0.9, optimizer_beta2=0.95, global_seed=333, **OPT_CASES[case])
    lr = 2e-3
    params = _opt_tree(np.random.RandomState(0))
    grads = [_opt_tree(np.random.RandomState(10 + i), scale=0.1) for i in range(3)]
    jp, js = _jax_steps(jopt.build_optimizer(cfg), params, grads, lr)

    opt = topt.build_optimizer(cfg)
    cp = _port(params)
    state = opt.init(cp)
    for g in grads:
        updates, state = opt.update(_port(g), state, cp)
        topt.apply_updates(cp, updates, lr)
    _assert_close_trees(cp, jp)

    kw = topt.kernel_update_settings(cfg)
    if cfg["optimizer_type"] in ("Adafactor", "SGD"):
        assert kw is None
        return
    assert kw["lamb"] == ("LAMB" in case)
    assert kw["max_norm"] == (None if case in ("Adam-maxnorm-only", "LAMB-bf16-noclip")
                              else 0.5)
    fp = _port(params)
    adam = next(s for s in opt.init(fp) if isinstance(s, topt.AdamState))
    for g in grads:
        fused_adam_apply_plain(fp, _port(g), adam, lr, **kw)
    _assert_close_trees(fp, jp)
    jadam = next(s for s in js if hasattr(s, "mu"))
    port_adam = next(s for s in state if isinstance(s, topt.AdamState))
    assert adam.count == port_adam.count == int(jadam.count) == 3
    for name in ("mu", "nu"):
        want = _as_port(getattr(jadam, name))
        for k, v in getattr(adam, name).items():
            if case == "LAMB-bf16-noclip":   # no global norm: the Adam part bit for bit
                np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=k)
                np.testing.assert_array_equal(
                    getattr(port_adam, name)[k].float().numpy(), want[k], err_msg=k)
            elif v.dtype == torch.bfloat16:
                _assert_bf16_moments_close(v, want[k], (name, k))
            else:
                assert _rel(v.float().numpy(), want[k]) < OPT_TOL, (name, k)


def test_clipping_and_lamb_modes_are_the_chain():
    """The fused update's twin in its two modes against build_optimizer's
    chain of the same config, step by step: clipping scales by the global
    norm (a clipped and an unclipped step), LAMB applies the trust ratio."""
    lr = 1e-3
    params = _opt_tree(np.random.RandomState(1))
    small = _opt_tree(np.random.RandomState(2), scale=1e-4)
    large = _opt_tree(np.random.RandomState(3), scale=1.0)
    for cfg in (dict(optimizer_type="AdamW", weight_decay=0.1, gradient_clip_norm=1.0),
                dict(optimizer_type="LAMB", weight_decay=0.1, optimizer_max_grad_norm=1.0,
                     optimizer_moment_dtype="bfloat16")):
        opt = topt.build_optimizer(cfg)
        kw = topt.kernel_update_settings(cfg)
        cp, fp = _port(params), _port(params)
        state = opt.init(cp)
        adam = next(s for s in opt.init(fp) if isinstance(s, topt.AdamState))
        for g in (small, large):
            norm = float(topt.global_norm(_port(g).values()))
            assert (norm < 1.0) == (g is small)
            updates, state = opt.update(_port(g), state, cp)
            topt.apply_updates(cp, updates, lr)
            fused_adam_apply_plain(fp, _port(g), adam, lr, **kw)
            for k in cp:
                assert _rel(fp[k].numpy(), cp[k].numpy()) < OPT_TOL, (cfg["optimizer_type"], k)


def test_adafactor_factors_makani_tpu_layout():
    """Adafactor's statistics are kept on makani_tpu's layout of each leaf.
    A dhconv weight whose degree count ties its channel count, (C, O, L, 2) =
    (128, 3, 128, 2), factors over C and L there; on the port's (2, L, C, O)
    the tie would pick the axes the other way round and the row and column
    statistics would hold other sums in other shapes. Over 3 steps the state
    and the updates equal optax's on makani_tpu's layout."""
    key = "model.blocks.0.filter_layer.filter.weight"

    def tree(seed, scale):
        w = (np.random.RandomState(seed).randn(128, 3, 128, 2) * scale).astype(np.float32)
        return {"model": {"blocks_0": {"SpectralFilterLayer_0": {"filter": {"weight": w}}}}}
    params = tree(4, 1.0)
    tp = _port(params)
    assert tuple(tp[key].shape) == (2, 128, 128, 3)
    tx, jtx = topt.scale_by_factored_rms(), optax.scale_by_factored_rms()
    state, jstate = tx.init(tp), jtx.init(_jax_tree(params))
    for i in range(3):
        g = tree(5 + i, 0.1)
        updates, state = tx.update(_port(g), state, tp)
        ju, jstate = jtx.update(_jax_tree(g), jstate, _jax_tree(params))
        assert _rel(updates[key].numpy(), _as_port(ju)[key]) < OPT_TOL
    assert state.count == int(jstate.count) == 3
    want_row = np.asarray(flatten_dict(jstate.v_row, sep="/")[
        "model/blocks_0/SpectralFilterLayer_0/filter/weight"])
    want_col = np.asarray(flatten_dict(jstate.v_col, sep="/")[
        "model/blocks_0/SpectralFilterLayer_0/filter/weight"])
    assert want_row.shape == tuple(state.v_row[key].shape) == (128, 3, 2)
    assert want_col.shape == tuple(state.v_col[key].shape) == (3, 128, 2)
    assert _rel(state.v_row[key].numpy(), want_row) < OPT_TOL
    assert _rel(state.v_col[key].numpy(), want_col) < OPT_TOL
    # the port's own layout factors the other way round
    on_port = optax.scale_by_factored_rms().init(jnp.asarray(tp[key].numpy()))
    assert on_port.v_row.shape == on_port.v_col.shape == (2, 128, 3)


F16_CASES = {
    "Adam": dict(optimizer_type="Adam"),
    "AdamW-SR-asked": dict(optimizer_type="AdamW", weight_decay=0.05,
                           optimizer_stochastic_rounding=True),
    "LAMB-noclip": dict(optimizer_type="LAMB", weight_decay=0.0),
}


@pytest.mark.parametrize("case", sorted(F16_CASES))
def test_float16_moments_match_jax_bit_for_bit(case):
    """float16 moments (optimizer_moment_dtype "float16"), 3 updates: the
    chain and the fused update's twin against makani_tpu's build_optimizer,
    the moments bit for bit. The gradients are scaled so that nu, about
    (1-b2) g^2, lands below float16's smallest normal (6.1e-5) for most
    elements and mu for some: subnormal float16 values, which XLA's CPU
    conversion and PyTorch's round the same (to nearest, none flushed). XLA
    contracts this graph's multiply-adds otherwise than the bf16 one's
    (ops/fused_adam.adam_moments). The parameters: bit for bit under Adam;
    OPT_TOL where the weight decay or a norm enters (AdamW, whose decay the
    fused update folds into p*(1-lr*wd), an ulp from the chain's u + wd*p,
    as tests/test_torch_port_train.py holds it; LAMB's trust ratio)."""
    cfg = dict(optimizer_beta1=0.9, optimizer_beta2=0.95, global_seed=333,
               optimizer_moment_dtype="float16", **F16_CASES[case])
    lr = 2e-3
    params = _opt_tree(np.random.RandomState(0))
    grads = [_opt_tree(np.random.RandomState(20 + i), scale=10.0 ** -(2 + i)) for i in range(3)]
    jp, js = _jax_steps(jopt.build_optimizer(cfg), params, grads, lr)
    jadam = next(s for s in js if hasattr(s, "mu"))
    nu = np.concatenate([np.asarray(v, np.float32).ravel() for v in jax.tree.leaves(jadam.nu)])
    mu = np.concatenate([np.asarray(v, np.float32).ravel() for v in jax.tree.leaves(jadam.mu)])
    tiny = np.finfo(np.float16).tiny
    assert (np.abs(nu) < tiny).mean() > 0.5 and ((np.abs(mu) < tiny) & (mu != 0)).any()

    kw = topt.kernel_update_settings(cfg)
    assert not kw["stochastic_rounding"] and kw["lamb"] == (case == "LAMB-noclip")
    opt = topt.build_optimizer(cfg)
    cp, fp = _port(params), _port(params)
    state = opt.init(cp)
    adam = next(s for s in opt.init(fp) if isinstance(s, topt.AdamState))
    for g in grads:
        updates, state = opt.update(_port(g), state, cp)
        topt.apply_updates(cp, updates, lr)
        fused_adam_apply_plain(fp, _port(g), adam, lr, **kw)
    chain_adam = next(s for s in state if isinstance(s, topt.AdamState))
    for name in ("mu", "nu"):
        want = _as_port(getattr(jadam, name))
        for st in (adam, chain_adam):
            for k, v in getattr(st, name).items():
                assert v.dtype == torch.float16
                np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=(name, k))
    for got in (cp, fp):
        if case != "Adam":
            _assert_close_trees(got, jp)
        else:
            want = _as_port(jp)
            for k, v in got.items():
                np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_kernel_update_settings_follow_the_config():
    base = dict(optimizer_beta1=0.9, optimizer_beta2=0.95, global_seed=333,
                optimizer_max_grad_norm=32.0)
    adam = topt.kernel_update_settings(dict(base, optimizer_type="Adam"))
    assert adam["max_norm"] is None and not adam["lamb"] and adam["weight_decay"] == 0.0
    lamb = topt.kernel_update_settings(dict(base, optimizer_type="FusedLAMB", weight_decay=0.02))
    assert lamb["max_norm"] == 32.0 and lamb["lamb"] and lamb["weight_decay"] == 0.02
    clip = topt.kernel_update_settings(dict(base, optimizer_type="AdamW", weight_decay=0.02,
                                            gradient_clip_norm=2.0))
    assert clip["max_norm"] == 2.0 and not clip["lamb"]
    for opt_type in ("Adafactor", "SGD"):
        assert topt.kernel_update_settings(dict(base, optimizer_type=opt_type)) is None
    # float16 moments round to nearest whatever optimizer_stochastic_rounding says
    f16 = topt.kernel_update_settings(dict(base, optimizer_moment_dtype="float16"))
    assert f16 is not None and not f16["stochastic_rounding"] and not f16["lamb"]
    # the Trainer's update: the kernel for LAMB, with its clip
    from makani_tpu_torch.utils.trainer import Trainer
    _, tp = _configs(optimizer_type="LAMB", optimizer_moment_dtype="bfloat16",
                     optimizer_max_grad_norm=1.0, weight_decay=0.01)
    trainer = Trainer(tp, device="cpu")
    assert trainer.fused_kw["lamb"] and trainer.fused_kw["max_norm"] == 1.0
    assert trainer.adam_state() is trainer.opt_state[1]   # after the clip stage
    trainer.train()
    assert trainer.adam_state().count == 1
    assert np.isfinite(trainer.last_logs["train"]["step losses"]).all()


def test_checkpoint_levels_tool_on_the_cpu(capsys):
    """tools/checkpoint_levels.py, which chose the ICML unroll's level, on a
    cut ICML config: one record a level, the same loss at every level."""
    from makani_tpu_torch.ops import complex_ops, sht
    from makani_tpu_torch.tools import checkpoint_levels
    # the tool's Trainers set the process's precisions ("default" under its
    # AMP); put them back for the tests that run after this one
    prev = sht.get_transform_precision(), complex_ops.get_contraction_precision()
    try:
        records = checkpoint_levels.main([
            "--yaml_config", "config/icml_models.yaml", "--config", "sfno_dhealy_73ch_2step",
            "--multistep_count", "2", "--levels", "0", "3", "--steps", "2", "--img_shape", "24",
            "48", "--embed_dim", "8", "--num_layers", "2", "--device", "cpu"])
    finally:
        sht.set_transform_precision(prev[0])
        complex_ops.set_contraction_precision(prev[1])
    assert [r["level"] for r in records] == [0, 3]
    assert all(r["n_future"] == 1 and r["leaves"] == 3 + 2 * 10 + 3 + 1 and len(r["step_ms"]) == 1
               and r["launches"] == {} and r["peak_gib"] is None for r in records)
    assert records[0]["loss"] == records[1]["loss"]
    assert len(capsys.readouterr().out.strip().splitlines()) == 2

