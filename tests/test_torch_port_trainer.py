"""makani_tpu_torch's full Trainer and its CLIs against makani_tpu on the CPU.

One small makani_tpu Trainer is built once for the module: the canonical
recipe `sfno_linear_73chq_sc3_layers8_edim384_wstgl2` (the temp-std loss
with auto channel weights, AdamW beta2 0.95 with bf16 moments, every
auxiliary channel) cut to a 2-block SFNO of width 12 on a 20x44 dataset of 5
channels written by the port's tools/make_synthetic_dataset.py (npy shards,
NetCDF invariants), 3 train samples an epoch, 2 evaluation windows of 3 AR
steps; every dimension distinct. Its initial weights cross over into each
port Trainer (`load_jax_params`), and both read the same files. Both run at
precision "highest": JAX's CPU dots are exact float32 at every precision
(makani_tpu/ops/sht.py:156-160), and at "high" the port's 3-pass bf16
splits differ from them by ~1e-5 a contraction (tests/test_torch_port_serve.py).
makani_tpu's steps reuse its compiled programs: between runs the test resets
its weights, optimizer state, counters, scheduler and loaders.

Tolerances:
  - validation logs and metrics: VALID_TOL (2e-4) of the reference's largest
    magnitude, the serving gate of tests/test_torch_port_serve.py;
  - train() over 2 epochs: the lr of every step and the scheduler state
    equal; the best epochs and the checkpoint steps on disk equal; the
    counters' keys and integers equal, the losses in them within VALID_TOL;
    the weights within test_trainer_steps_match_jax's tolerance (UPDATE_TOL
    norm-wise per leaf over the elements whose first gradient is at least
    SIGN_FLOOR of their leaf's largest; the MLP's output bias finite only),
    and the elements whose gradient is exactly zero (those that feed sst
    alone, which the auto channel weights leave out of the loss) unchanged
    on both sides;
  - the weights-and-grads dump: the same keys, the weights bit for bit, the
    gradients within GRAD_TOL of each leaf's largest (the MLP's output bias,
    whose exact gradient is zero, against the largest gradient);
  - LRScheduler: float for float;
  - resume in the port: bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu.utils import optimizers as jopt
from makani_tpu.utils.dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.ops import complex_ops, sht
from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
from makani_tpu_torch.tools.convert_jax_params import load_jax_params
from makani_tpu_torch.utils import checkpoint as tckpt
from makani_tpu_torch.utils import optimizers as topt
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_train import GRAD_TOL, SIGN_FLOOR, UPDATE_TOL, ZERO_GRAD, _as_port

CANONICAL = "sfno_linear_73chq_sc3_layers8_edim384_wstgl2"
NLAT, NLON = 20, 44
CHANNELS = ["u10m", "t2m", "sst", "z500", "q700"]
TRAIN_SAMPLES, VALID_SAMPLES = 4, 5
VALID_TOL = 2e-4
SLICE_MODULES = ["makani_tpu_torch.train", "makani_tpu_torch.train_profile",
                 "makani_tpu_torch.utils.trainer", "makani_tpu_torch.utils.wandb_compat",
                 "makani_tpu_torch.utils.checkpoint", "makani_tpu_torch.utils.optimizers",
                 "makani_tpu_torch.models.networks.debug",
                 # the other model families (ROADMAP Queue 1 item 8)
                 "makani_tpu_torch.models.model_registry",
                 "makani_tpu_torch.models.networks.afnonet",
                 "makani_tpu_torch.models.networks.afnonet_v2",
                 "makani_tpu_torch.models.networks.vit",
                 "makani_tpu_torch.models.common.attention", "makani_tpu_torch.ops.fft3d"]


@pytest.fixture(autouse=True, scope="module")
def _highest():
    """Both packages' Trainers set the precision, a module global shared
    with every test file of the worker: back to the default, "high", after."""
    from makani_tpu.ops import complex_ops as jcomplex
    from makani_tpu.ops import sht as jsht
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    for mod in (sht, jsht):
        mod.set_transform_precision("high")
    for mod in (complex_ops, jcomplex):
        mod.set_contraction_precision("high")
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _overrides(data, exp):
    stats, inv = data / "stats", data / "invariant"
    return dict(
        img_shape_x=NLAT, img_shape_y=NLON, embed_dim=12, num_layers=2, scale_factor=2,
        grid_num_frequencies=2, metadata_json_path=str(data / "data.json"),
        train_data_path=str(data / "train"), valid_data_path=str(data / "test"),
        inf_data_path=str(data / "test"),
        **{f"{n}_path": str(stats / f"{n}.npy") for n in (
            "global_means", "global_stds", "time_means", "time_diff_means", "time_diff_stds")},
        min_path=str(stats / "mins.npy"), max_path=str(stats / "maxs.npy"),
        orography_path=str(inv / "orography.nc"), landmask_path=str(inv / "land_sea_mask.nc"),
        n_train_samples_per_epoch=TRAIN_SAMPLES - 1, n_eval_samples=2, valid_autoreg_steps=2,
        max_epochs=2, num_data_workers=1, log_to_screen=False, batch_size=1, n_future=0,
        transform_precision="highest", optimizer_fused=False, checkpoint_max_to_keep=1,
        experiment_dir=str(exp), checkpoint_path=str(exp / "ckpt"),
        best_checkpoint_path=str(exp / "best_ckpt"))


def _port_params(data, exp, **overrides):
    tp = TYParams("config/sfnonet.yaml", CANONICAL)
    tp.update_params({**_overrides(data, exp), **overrides})
    return tp


class _Recording:
    """The lr of every optimizer step, (global step, lr)."""

    def __call__(self, global_step):
        lr = super().__call__(global_step)
        self.seen.append((global_step, lr))
        return lr


class JScheduler(_Recording, jopt.LRScheduler):
    seen = None


class TScheduler(_Recording, topt.LRScheduler):
    seen = None


def _recording(cls, params):
    s = cls(params)
    s.seen = []
    return s


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """makani_tpu's Trainer of the cut canonical recipe, with copies of its
    initial weights and optimizer state."""
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    root = tmp_path_factory.mktemp("trainer")
    data = root / "data"
    tsynth.make_dataset(str(data), img_shape=(NLAT, NLON), channels=CHANNELS,
                        n_samples_per_year=TRAIN_SAMPLES, n_valid_samples=VALID_SAMPLES,
                        mode="ar", fmt="bin", invariants=True, seed=21)
    comm.reset()
    comm.init(devices=jax.devices()[:1])
    jp = JYParams("config/sfnonet.yaml", CANONICAL)
    jp.update_params(_overrides(data, root / "jax_init"))
    jparse(jp.metadata_json_path, jp)
    jtrainer = JTrainer(jp, world_rank=0)
    init = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
    flat = {k: np.asarray(v) for k, v in flatten_dict(init[0], sep="/").items()}
    yield dict(root=root, data=data, jtrainer=jtrainer, init=init, flat=flat,
               params=dict(jtrainer.params.to_dict()))
    comm.reset()


def _reset_jax(ref, exp, **overrides):
    """makani_tpu's Trainer back at its initial state, writing into `exp`."""
    jt = ref["jtrainer"]
    jt.params.update_params(ref["params"])
    jt.params.update_params(dict(experiment_dir=str(exp), checkpoint_path=str(exp / "ckpt"),
                                 best_checkpoint_path=str(exp / "best_ckpt"), **overrides))
    os.makedirs(exp, exist_ok=True)
    jt.model_params, jt.opt_state = jax.tree.map(jnp.copy, ref["init"])
    jt.iters = jt.epoch = jt.startEpoch = 0
    jt.best_valid_loss = 1.0e6
    jt.scheduler = _recording(JScheduler, jt.params)
    jt._ckpt_mgr = None
    for dl in (jt.train_dataloader, jt.valid_dataloader):
        dl.epoch = 0
    return jt


def _port(ref, exp, cross=True, **overrides):
    """A port Trainer; `cross`: with makani_tpu's initial weights (a Trainer
    that restores a checkpoint keeps the checkpoint's)."""
    from makani_tpu_torch.utils.trainer import Trainer
    trainer = Trainer(_port_params(ref["data"], exp, **overrides), device="cpu")
    if cross:
        load_jax_params(trainer.model, ref["flat"])
    return trainer


def _record_saves(trainer):
    saves = []
    save = trainer.save_checkpoint

    def recording(path, *args, **kwargs):
        saves.append((trainer.epoch, os.path.basename(str(path))))
        return save(path, *args, **kwargs)
    trainer.save_checkpoint = recording
    return saves


def _steps_on_disk(root):
    return sorted(int(n) for n in os.listdir(root) if n.isdigit())


def _assert_logs_close(got, want):
    assert got["base"]["validation steps"] == want["base"]["validation steps"] == 2
    for key in ("validation loss", "validation L1"):
        assert _rel(got["base"][key], want["base"][key]) < VALID_TOL, key
    assert set(got["metrics"]) == set(want["metrics"])
    for key, value in want["metrics"].items():
        if key == "rollouts":
            rows = got["metrics"][key]
            assert [r[:3] for r in rows] == [r[:3] for r in value]
            assert _rel([r[3] for r in rows], [r[3] for r in value]) < VALID_TOL
        else:
            assert _rel(got["metrics"][key], value) < VALID_TOL, key


def test_validate_one_epoch_matches_jax(ref, tmp_path):
    """Validation's base logs and metrics (loss, L1, RMSE, ACC AUC and the
    rollouts table) on the same weights and evaluation files."""
    jt = _reset_jax(ref, tmp_path / "jax")
    _, _, want = jt.validate_one_epoch(1)
    trainer = _port(ref, tmp_path / "port")
    _, _, got = trainer.validate_one_epoch(1)
    assert trainer.params.N_in_channels == jt.params.N_in_channels == 5 + 1 + 4 + 1 + 2
    assert {"validation u10m", "ACC AUC z500"} <= set(got["metrics"])
    _assert_logs_close(got, want)
    # eval_forward: one deterministic forward of a window
    inp, _, zen_inp, _ = (x[None] for x in trainer.valid_dataset[1])
    want_y = jt.eval_forward(jt.model_params, jnp.asarray(inp), jnp.asarray(zen_inp))
    got_y = trainer.eval_forward(torch.from_numpy(inp), torch.from_numpy(zen_inp))
    assert got_y.dtype == torch.float32 and _rel(got_y.numpy(), want_y) < VALID_TOL


SCHEDULES = {
    "plateau_warmup": dict(scheduler="ReduceLROnPlateau", scheduler_patience=0,
                           scheduler_factor=0.5, lr_warmup_steps=4),
    "steplr": dict(scheduler="StepLR", scheduler_step_size=1, scheduler_gamma=0.5),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_train_with_validation_matches_jax(ref, tmp_path, schedule):
    """train() over 2 epochs with validation and save_checkpoint "flexible"
    against makani_tpu's: the lr of every step, the best epochs, the steps
    on disk (keep 1), the counters and the weights."""
    overrides = dict(SCHEDULES[schedule], save_checkpoint="flexible")
    jt = _reset_jax(ref, tmp_path / "jax", **overrides)
    jsaves = _record_saves(jt)
    jlogs = []
    log_epoch = jt.log_epoch

    def recording_log(train_logs, valid_logs, timing_logs):
        jlogs.append(valid_logs)
        log_epoch(train_logs, valid_logs, timing_logs)
    jt.log_epoch = recording_log
    jt.train()
    trainer = _port(ref, tmp_path / "port", **overrides)
    trainer.scheduler = _recording(TScheduler, trainer.params)
    batch = trainer.train_dataset[int(trainer.train_dataloader._epoch_indices()[0])]
    _, g1 = trainer.loss_and_grads(*trainer._device_batch(tuple(x[None] for x in batch)))
    start = {k: p.detach().clone() for k, p in trainer.model_params.items()}
    saves = _record_saves(trainer)
    trainer.train()

    assert trainer.scheduler.seen == jt.scheduler.seen
    assert [s for s, _ in trainer.scheduler.seen] == list(range(1, 7))
    assert trainer.scheduler.state_dict()["epoch"] == jt.scheduler.state_dict()["epoch"] == 2
    assert trainer.scheduler._plateau_scale == jt.scheduler._plateau_scale
    assert trainer.scheduler._bad_epochs == jt.scheduler._bad_epochs
    if schedule == "steplr":
        assert [lr for _, lr in trainer.scheduler.seen] == [1e-3] * 3 + [5e-4] * 3
    assert saves == jsaves and ("best_ckpt" in {p for _, p in saves})
    assert _steps_on_disk(tmp_path / "port" / "ckpt") == _steps_on_disk(tmp_path / "jax" / "ckpt") \
        == [2]

    with open(tmp_path / "port" / "ckpt" / "counters-2.json") as f:
        counters = json.load(f)
    with open(tmp_path / "jax" / "ckpt" / "counters-2.json") as f:
        want = json.load(f)
    # makani_tpu's dropout key is the port's dropout seed and generator state
    assert set(counters) - {"aug_generator_state", "dropout_seed"} == set(want) - {"dropout_key"}
    assert counters["dropout_seed"] == trainer.params.get("global_seed", 333) + 1
    for key in ("iters", "epoch", "scheduler_epoch"):
        assert counters[key] == want[key], key
    assert (counters["iters"], counters["epoch"]) == (6, 2)
    assert _rel(counters["best_valid_loss"], want["best_valid_loss"]) < VALID_TOL
    state, jstate = counters["scheduler_state"], want["scheduler_state"]
    assert set(state) == set(jstate)
    for key in ("epoch", "plateau_scale", "plateau_bad_epochs"):
        assert state[key] == jstate[key], key
    if jstate["plateau_best"] is None:
        assert state["plateau_best"] is None
    else:
        assert _rel(state["plateau_best"], jstate["plateau_best"]) < VALID_TOL
    _assert_logs_close(trainer.last_logs["valid"], jlogs[-1])

    want_p = _as_port(jt.model_params)
    jstart = _as_port(ref["init"][0])
    for k, p in trainer.model_params.items():
        du = p.detach().numpy() - start[k].numpy()
        assert np.isfinite(du).all(), k
        if k.endswith(ZERO_GRAD):
            continue
        g = np.abs(g1[k].numpy())
        jdu = want_p[k] - jstart[k]
        # the sst output rows: the auto channel weights give sst no loss, so
        # their gradient is exactly zero and neither side moves them
        zero = g == 0
        assert not du[zero].any() and not jdu[zero].any(), k
        keep = g >= SIGN_FLOOR * g.max()
        assert keep.sum() > 0.9 * (~zero).sum(), k
        assert np.linalg.norm((du - jdu)[keep]) <= UPDATE_TOL * np.linalg.norm(jdu[keep]), k


def test_dump_weights_and_grads_matches_jax(ref, tmp_path):
    """The npz of the weights-and-grads dump on one batch: makani_tpu's keys
    (weights/<flax path>, grads/<flax path>) and layout."""
    jt = _reset_jax(ref, tmp_path / "jax")
    trainer = _port(ref, tmp_path / "port")
    data = tuple(x[None] for x in trainer.train_dataset[1])
    jt.epoch = trainer.epoch = 1
    jt.dump_weights_and_grads(jt._device_batch(data))
    fname = trainer.dump_weights_and_grads(trainer._device_batch(data))
    assert os.path.basename(fname) == "weights_and_grads_epoch1_rank0.npz"
    want = np.load(tmp_path / "jax" / "weights_and_grads" / os.path.basename(fname))
    got = np.load(fname)
    assert set(got.files) == set(want.files)
    assert any("SpectralFilterLayer_0/filter/weight" in k for k in got.files)
    largest = max(np.abs(want[k]).max() for k in want.files if k.startswith("grads/"))
    for k in got.files:
        assert got[k].shape == want[k].shape, k
        if k.startswith("weights/"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            scale = largest if k.endswith(ZERO_GRAD.replace(".", "/")) else np.abs(want[k]).max()
            assert np.abs(got[k].astype(np.float64) - want[k]).max() / scale < GRAD_TOL, k


@pytest.mark.parametrize("history_and_zenith", [False, True], ids=["plain", "history_zenith"])
def test_autoregression_pipeline_debugnet(ref, tmp_path, history_and_zenith):
    """The DebugNet self-test (tests/test_trainer.py:147-168) in both
    packages: 0 errors over the same steps; its one parameter crosses over."""
    from makani_tpu.utils.trainer import Trainer as JTrainer
    from makani_tpu_torch.utils.trainer import Trainer
    overrides = dict(nettype="DebugNet", valid_autoreg_steps=2, add_grid=False,
                     add_orography=False, add_landmask=False, add_zenith=history_and_zenith,
                     n_history=1 if history_and_zenith else 0, n_eval_samples=1)
    jp = JYParams("config/sfnonet.yaml", CANONICAL)
    jp.update_params({**_overrides(ref["data"], tmp_path / "jax"), **overrides})
    jparse(jp.metadata_json_path, jp)
    jt = JTrainer(jp, world_rank=0)
    trainer = Trainer(_port_params(ref["data"], tmp_path / "port", **overrides), device="cpu")
    flat = {k: np.asarray(v) for k, v in flatten_dict(jt.model_params, sep="/").items()}
    assert set(flat) == {"model/factor"}
    load_jax_params(trainer.model, flat)
    assert jt.test_autoregression_pipeline() == trainer.test_autoregression_pipeline() == 0
    with pytest.raises(ValueError, match="DebugNet"):
        _port(ref, tmp_path / "sfno").test_autoregression_pipeline()


# --------------------------------------------------------------------------
# the port alone: resume, finetune, failed writes, the CLIs
# --------------------------------------------------------------------------

def _port_seeded(ref, exp, cross=True, **overrides):
    """A port Trainer with augmentation on (roll and noise draw from its
    generator), so a resume has the generator's state to restore."""
    return _port(ref, exp, cross=cross, save_checkpoint="flexible", roll=True, add_noise=True,
                 noise_std=0.05, **overrides)


def test_resume_is_bit_for_bit(ref, tmp_path):
    """2 epochs straight equal 1 epoch, a resume from its checkpoint, then
    1 epoch: the weights, the bf16 moments, the counters, the generator, the
    losses and the validation logs, bit for bit."""
    straight = _port_seeded(ref, tmp_path / "straight")
    straight.train()
    first = _port_seeded(ref, tmp_path / "split", max_epochs=1)
    first.train()
    resumed = _port_seeded(ref, tmp_path / "split", cross=False, resuming=True)
    assert (resumed.iters, resumed.epoch, resumed.startEpoch) == (3, 1, 1)
    assert resumed.train_dataloader.epoch == 1
    resumed.train()
    for k, p in straight.model.state_dict().items():
        assert torch.equal(p, resumed.model.state_dict()[k]), k
    adam, radam = straight.opt_state[0], resumed.opt_state[0]
    assert adam.count == radam.count == 6
    for name in ("mu", "nu"):
        for k, v in getattr(adam, name).items():
            assert v.dtype == torch.bfloat16 and torch.equal(v, getattr(radam, name)[k]), k
    assert straight.counters() == resumed.counters()
    assert straight.last_logs["train"]["step losses"] == resumed.last_logs["train"]["step losses"]
    assert straight.last_logs["valid"] == resumed.last_logs["valid"]
    assert _steps_on_disk(tmp_path / "split" / "ckpt") == [2]


def test_finetune_loads_weights_only(ref, tmp_path):
    trained = _port_seeded(ref, tmp_path / "pre", max_epochs=1)
    trained.train()
    tuned = _port(ref, tmp_path / "tune", cross=False, finetune=True,
                  pretrained_checkpoint_path=str(tmp_path / "pre" / "best_ckpt"))
    for k, p in trained.model.state_dict().items():
        assert torch.equal(p, tuned.model.state_dict()[k]), k
    adam = tuned.opt_state[0]
    assert adam.count == 0 and all(not v.any() for v in adam.mu.values())
    assert (tuned.iters, tuned.epoch, tuned.best_valid_loss) == (0, 0, 1.0e6)
    assert tuned.scheduler.epoch == 0 and tuned.train_dataloader.epoch == 0


def test_failed_asynchronous_write_raises(ref, tmp_path, monkeypatch):
    """A checkpoint write that fails in the background raises out of train()
    (at the next wait), never swallowed; the restore of a structure that no
    longer fits names the mismatch."""
    trainer = _port(ref, tmp_path / "fail", save_checkpoint="flexible", max_epochs=1)

    def fail(tensors, path):
        raise OSError("no space left on device")
    monkeypatch.setattr(tckpt, "_save_tensors", fail)
    with pytest.raises(OSError, match="no space left"):
        trainer.train()
    monkeypatch.undo()
    # each failed write raises once: the best checkpoint's too, unless the
    # per-epoch write had already failed when the best one was submitted
    raised = 1
    while True:
        try:
            tckpt.wait_for_saves()
            break
        except OSError:
            raised += 1
    assert raised in (1, 2) and not os.path.exists(tmp_path / "fail" / "ckpt" / "1")
    ok = _port(ref, tmp_path / "ok", save_checkpoint="flexible", max_epochs=1)
    ok.train()
    wider = _port(ref, tmp_path / "wider", cross=False, embed_dim=16)
    with pytest.raises(RuntimeError, match="structure mismatch"):
        wider.restore_checkpoint(str(tmp_path / "ok" / "ckpt"))


def test_trainer_refuses_what_is_not_ported(ref, tmp_path):
    from makani_tpu_torch.utils.trainer import Trainer
    params = _port_params(ref["data"], tmp_path / "exp")
    # the multi-step unroll and dropout are ported (tests/test_torch_port_multistep.py),
    # the rollout videos too (tests/test_torch_port_visualize.py)
    for override, match in [(dict(model_parallel_sizes=[2, 1, 1, 1]), "item 7"),
                            (dict(world_size=2), "item 7")]:
        with pytest.raises(NotImplementedError, match=match):
            Trainer(TYParams.from_dict(dict(params.to_dict(), **override)), device="cpu")


def _cli_yaml(ref, tmp_path, max_epochs):
    """config/sfnonet.yaml's smoke_test on the module's dataset, as a YAML
    in tmp_path."""
    cfg = TYParams("config/sfnonet.yaml", "smoke_test").to_dict()
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    for key, value in list(cfg.items()):
        if isinstance(value, str) and value.startswith("./datasets/synthetic"):
            cfg[key] = value.replace("./datasets/synthetic", str(ref["data"]))
    cfg.update(exp_dir=str(tmp_path / "runs"), img_shape_x=NLAT, img_shape_y=NLON,
               n_train_samples_per_epoch=TRAIN_SAMPLES - 1, max_epochs=max_epochs,
               num_data_workers=1, log_to_wandb=True)
    path = tmp_path / "smoke.yaml"
    path.write_text(yaml.safe_dump({"smoke_test": cfg}))
    return str(path)


def test_train_cli_smoke_test_and_resume(ref, tmp_path):
    """`train.py --config smoke_test --device cpu` end to end, then again
    with one more epoch: it resumes from its checkpoint; the counters carry
    makani_tpu's keys; the JSON-lines log holds both runs' epochs with the
    rollouts table as makani_tpu writes it."""
    from makani_tpu_torch import train
    argv = ["--yaml_config", _cli_yaml(ref, tmp_path, 1), "--config", "smoke_test",
            "--device", "cpu"]
    trainer = train.main(argv)
    assert (trainer.iters, trainer.epoch) == (3, 1)
    _cli_yaml(ref, tmp_path, 2)
    trainer = train.main(argv)
    assert trainer.params.resuming and trainer.startEpoch == 1
    assert (trainer.iters, trainer.epoch) == (6, 2)
    exp = tmp_path / "runs" / "smoke_test" / "00"
    ckpts = exp / "training_checkpoints"
    assert _steps_on_disk(ckpts / "ckpt") == [1, 2] and tckpt.checkpoint_exists(ckpts / "best_ckpt")
    with open(ckpts / "ckpt" / "counters-2.json") as f:
        counters = json.load(f)
    assert set(counters) - {"aug_generator_state", "dropout_seed"} == {
        "iters", "epoch", "scheduler_epoch", "scheduler_state", "best_valid_loss"}
    assert set(counters["scheduler_state"]) == set(ref["jtrainer"].scheduler.state_dict())
    lines = [json.loads(x) for x in (exp / "wandb_log.jsonl").read_text().splitlines()]
    assert [x["event"] for x in lines].count("init") == 2
    tables = [x["data"]["rollouts"] for x in lines if "rollouts" in x.get("data", {})]
    assert len(tables) == 2 and tables[0]["_type"] == "table"
    assert tables[0]["columns"] == ["metric type", "variable name", "time [h]", "value"]
    assert all(np.isfinite(r[3]) for r in tables[1]["data"])
    assert (exp / "out.log").exists() and (exp / "config.json").exists()
    # --mode test: the DebugNet self-test on the same config
    test_trainer = train.main(argv + ["--mode", "test", "--run_num", "selftest"])
    assert test_trainer.params.nettype == "DebugNet"


def test_train_profile_writes_a_trace(ref, tmp_path):
    from makani_tpu_torch import train_profile
    argv = ["--yaml_config", _cli_yaml(ref, tmp_path, 1), "--config", "smoke_test",
            "--device", "cpu", "--profile", "1", "--save_checkpoint", "none"]
    trainer = train_profile.main(argv)
    assert trainer.params.profile_steps == 1
    trace = json.loads(open(trainer.profile_path).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train_step.forward" in names and "train_step.backward" in names


def test_entry_points_need_cuda_unless_cpu(ref, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    from makani_tpu_torch import train, train_profile
    from makani_tpu_torch.utils.trainer import Trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_port_params(ref["data"], tmp_path / "exp"))
    argv = ["--yaml_config", _cli_yaml(ref, tmp_path, 1), "--config", "smoke_test"]
    for main in (train.main, train_profile.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not (tmp_path / "runs").exists()


def test_slice_modules_import_without_jax(tmp_path):
    """The slice's modules import in a process that brings in no JAX, flax,
    orbax or makani_tpu."""
    code = ("import sys, importlib\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'orbax', 'makani_tpu'))\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": root})
