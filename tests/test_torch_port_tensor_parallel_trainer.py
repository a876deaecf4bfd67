"""makani_tpu_torch's Trainer and train CLI on channel-parallel ranks.

The dataset is written by the port's tools/make_synthetic_dataset.py (HDF5,
17x36, 3 channels), the config is config/sfnonet.yaml's smoke_test (zenith
input, dhconv SFNO) at width 12 with the 2-frequency sinusoidal grid as
static features, trained at --multistep_count 2 (n_future 1). makani_tpu's
Trainer runs serially in this process (one Trainer for the file, on one
device of the conftest's virtual CPU devices); its mesh
runs give its serial numbers (tests/test_distributed.py:230, :316). The port
runs as spawned ranks on the CPU (tests/torch_port_parallel_ranks.py, gloo,
no JAX imported):

  - 2 Trainer steps at multistep_count 2 on h 2 x fin 2 (4 ranks, data 1,
    the JAX gate's mesh without its data axis) against makani_tpu's, from
    the same weights: the losses at STEP_LOSS_TOL relative and the updates
    norm-wise per leaf within UPDATE_TOL (tests/test_torch_port_train.py's
    tolerances and their reasons) over the elements whose first gradient
    is at least SIGN_FLOOR of their leaf's (over 3/4 of each leaf: the
    2-block dhconv weight at 17x36 has 86%), the MLP's output bias (an
    exact zero gradient) finite only;
  - validation on fin 2 x fout 2 with split_data_channels on and off: the
    3 data channels over 4 ranks are 1, 1, 1 and 0 (split_shapes), the logs
    identical, and equal to makani_tpu's within 1e-4 relative (the port's
    "kernel" engine's 3-pass contractions against JAX's float32 dots);
  - the Inferencer's scored epoch on fin 2 x fout 2 against the serial
    port's (validation loss within 1e-5 relative, the exported scores);
  - the train CLI under torchrun with --fin_parallel_size 2 (2 ranks, data
    1) against the serial CLI at the same global batch: the losses within
    1e-5 relative (sums in another order).
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

from makani_tpu.utils.dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
from makani_tpu_torch.tools.convert_jax_params import _map_flat
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_train import SIGN_FLOOR, STEP_LOSS_TOL, UPDATE_TOL, ZERO_GRAD, _as_port
from torch_port_parallel_ranks import run_cases, run_ranks, trainer_steps, validation_loss

IMG = (17, 36)
CHANNELS = ["u10m", "t2m", "z500"]
STEPS = 2
H_FIN = [2, 1, 2, 1]
FIN_FOUT = [1, 1, 2, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tensor_parallel")
    tsynth.make_dataset(str(root), img_shape=IMG, channels=CHANNELS,
                        n_samples_per_year=2 * STEPS + 3, n_valid_samples=5, mode="ar",
                        fmt="h5", seed=7)
    return root


def _overrides(root, exp):
    stats = root / "stats"
    return dict(
        metadata_json_path=str(root / "data.json"), train_data_path=str(root / "train"),
        valid_data_path=str(root / "test"), inf_data_path=str(root / "test"),
        global_means_path=str(stats / "global_means.npy"),
        global_stds_path=str(stats / "global_stds.npy"),
        time_means_path=str(stats / "time_means.npy"),
        time_diff_means_path=str(stats / "time_diff_means.npy"),
        time_diff_stds_path=str(stats / "time_diff_stds.npy"),
        min_path=str(stats / "mins.npy"), max_path=str(stats / "maxs.npy"),
        img_shape_x=IMG[0], img_shape_y=IMG[1], embed_dim=12, batch_size=1,
        n_train_samples_per_epoch=STEPS, n_eval_samples=2, valid_autoreg_steps=1,
        skip_validation=False, save_checkpoint="none", num_data_workers=1,
        log_to_screen=False, log_to_wandb=False, multistep_count=2, n_future=1,
        experiment_dir=str(exp), optimizer_type="AdamW", weight_decay=0.1,
        optimizer_moment_dtype="bfloat16", add_grid=True, gridtype="sinusoidal",
        grid_num_frequencies=2)


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    """makani_tpu's Trainer, serial: its initial weights and validation
    logs, and the losses and weights of STEPS steps."""
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    exp = tmp_path_factory.mktemp("jexp")
    tp, jp = TYParams("config/sfnonet.yaml", "smoke_test"), JYParams("config/sfnonet.yaml",
                                                                     "smoke_test")
    for p in (tp, jp):
        p.update_params(_overrides(dataset, exp))
    jparse(jp.metadata_json_path, jp)
    comm.reset()
    comm.init(model_parallel_sizes=[1, 1, 1, 1], devices=jax.devices()[:1])
    try:
        jtrainer = JTrainer(jp, world_rank=0)
        start = _as_port(jtrainer.model_params)
        flat = {k: np.asarray(v)
                for k, v in flatten_dict(jtrainer.model_params, sep="/").items()}
        _, _, jlogs = jtrainer.validate_one_epoch(1)
        # the JAX step donates its state: step on copies
        jparams, jstate = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
        losses, weights = [], []
        for step, jbatch in enumerate(jtrainer.train_dataloader, start=1):
            batch = jtrainer._device_batch(jbatch)
            jparams, jstate, jloss = jtrainer.train_step(
                jparams, jstate, *batch, jnp.float32(jtrainer.scheduler(step)),
                jax.random.fold_in(jtrainer.dropout_key, step))
            losses.append(float(jloss))
            weights.append(_as_port(jparams))
    finally:
        comm.reset()
    assert jtrainer.params.n_future == 1
    return dict(start=start, losses=losses, weights=weights, flat=flat, tp=tp,
                logs=jlogs, resolved=dict(jtrainer.params.to_dict()))


def _port_state(run):
    from makani_tpu_torch.models.model_registry import get_model
    model = get_model(TYParams.from_dict(run["resolved"]), device="cpu")
    return _map_flat(model.state_dict(), run["flat"], "parameters")


def _first_gradients(tp, state):
    """The serial port Trainer's gradients of the first batch (which
    elements' updates are determined: SIGN_FLOOR)."""
    from makani_tpu_torch.utils.trainer import Trainer
    trainer = Trainer(TYParams.from_dict(dict(tp.to_dict(), skip_validation=True)),
                      device="cpu")
    trainer.model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    batch = trainer._device_batch(next(iter(trainer.train_dataloader)))
    _, grads = trainer.loss_and_grads(*batch)
    return {k: g.numpy() for k, g in grads.items()}


def test_multistep_trainer_steps_on_h_fin_ranks_match_jax(jax_run):
    tp_dict = dict(jax_run["tp"].to_dict(), model_parallel_sizes=H_FIN, world_size=4,
                   skip_validation=True)
    state = _port_state(jax_run)
    ranks = run_ranks(trainer_steps, H_FIN, 4, tp_dict, state)
    assert all(r["data"] == 1 for r in ranks)
    shards = ranks[0]["shards"]
    assert shards["model.blocks.0.filter_layer.filter.weight"].splits[1].axis == "fin"
    assert shards["model.blocks.0.mlp.fc1.weight"].splits[0].axis == "fin"
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    got = ranks[0]
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=STEP_LOSS_TOL)
    start, grads = jax_run["start"], _first_gradients(jax_run["tp"], state)
    for step in range(STEPS):
        want = jax_run["weights"][step]
        for key, w in got["weights"][step].items():
            du, jdu = w - start[key], want[key] - start[key]
            assert np.isfinite(du).all(), (step, key)
            if key.endswith(ZERO_GRAD):
                continue
            keep = np.abs(grads[key]) >= SIGN_FLOOR * np.abs(grads[key]).max()
            assert keep.mean() > 0.75, key
            assert (np.linalg.norm((du - jdu)[keep])
                    <= UPDATE_TOL * np.linalg.norm(jdu[keep])), (step, key)


def test_split_data_channels_gives_the_same_validation_logs(jax_run, tmp_path):
    base = dict(jax_run["tp"].to_dict(), model_parallel_sizes=FIN_FOUT, world_size=4)
    state = _port_state(jax_run)
    cases = [("validation_logs", (dict(base, split_data_channels=split,
                                       experiment_dir=str(tmp_path / str(split))), state))
             for split in (False, True)]
    ranks = run_ranks(run_cases, FIN_FOUT, 4, cases)
    want = jax_run["logs"]
    for off, on in ranks:
        assert on["split"] and not off["split"]
        assert on["channels"] != off["channels"]
        assert on["logs"] == off["logs"]
        for key in ("validation loss", "validation L1"):
            np.testing.assert_allclose(on["logs"]["base"][key], want["base"][key], rtol=1e-4)
        for key, val in want["metrics"].items():
            if np.isscalar(val):
                np.testing.assert_allclose(on["logs"]["metrics"][key], val, rtol=1e-4,
                                           err_msg=key)
    # 3 channels over 4 ranks: 1, 1, 1 and 0
    assert [r[1]["channels"] for r in ranks] == [[0, 1], [1, 2], [2, 3], [3, 3]]


def test_inferencer_epoch_on_fin_fout_ranks_matches_serial(jax_run, tmp_path):
    """The Inferencer's scored epoch (single-step rollouts) on fin 2 x fout
    2 against the serial port's: the validation loss within 1e-5 relative
    (sums in another order) and rank 0's exported scores of the whole
    field."""
    from makani_tpu_torch.utils.inferencer import Inferencer
    single = dict(jax_run["tp"].to_dict(), multistep_count=1, n_future=0)
    state = _port_state(jax_run)
    os.makedirs(tmp_path / "s")
    serial = Inferencer(TYParams.from_dict(dict(single, experiment_dir=str(tmp_path / "s"))),
                        device="cpu", weights={k: torch.from_numpy(v.copy())
                                               for k, v in state.items()})
    want = serial.inference_epoch(output_channels=list(serial.params.out_channels))
    os.makedirs(tmp_path / "d")
    losses = run_ranks(validation_loss, FIN_FOUT, 4,
                       dict(single, experiment_dir=str(tmp_path / "d"),
                            model_parallel_sizes=FIN_FOUT, world_size=4), state)
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], want["base"]["validation loss"], rtol=1e-5)
    for name in ("acc_curves.npy", "RMSE_over_space.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "d" / name),
                                   np.load(tmp_path / "s" / name), rtol=1e-4, atol=1e-6)


def _cli_yaml(root, tmp_path):
    cfg = TYParams("config/sfnonet.yaml", "smoke_test").to_dict()
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    cfg.update(_overrides(root, tmp_path / "unused"))
    for key in ("experiment_dir", "save_checkpoint", "skip_validation", "batch_size",
                "multistep_count", "n_future"):
        cfg.pop(key)
    cfg.update(exp_dir=str(tmp_path / "runs"), batch_size=2, max_epochs=1, log_to_wandb=True,
               n_train_samples_per_epoch=2)
    path = tmp_path / "smoke.yaml"
    path.write_text(yaml.safe_dump({"smoke_test": cfg}))
    return str(path)


def _logged(tmp_path, run):
    lines = [json.loads(x) for x in (tmp_path / "runs" / "smoke_test" / run /
                                      "wandb_log.jsonl").read_text().splitlines()]
    data = [x.get("data", {}) for x in lines]
    return ([d["training loss"] for d in data if "training loss" in d],
            [d["validation loss"] for d in data if "validation loss" in d])


def test_train_cli_with_fin_parallel_size_matches_serial(dataset, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    args = ["-m", "makani_tpu_torch.train", "--yaml_config", _cli_yaml(dataset, tmp_path),
            "--config", "smoke_test", "--device", "cpu", "--save_checkpoint", "none"]
    subprocess.run([sys.executable, *args, "--run_num", "serial"], env=env, cwd=repo,
                   check=True, timeout=300)
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", "2", *args, "--fin_parallel_size", "2",
                    "--split_data_channels", "--run_num", "ranks"], env=env, cwd=repo,
                   check=True, timeout=300)
    serial_train, serial_valid = _logged(tmp_path, "serial")
    ranks_train, ranks_valid = _logged(tmp_path, "ranks")
    assert len(serial_train) == len(ranks_train) == 1 and len(ranks_valid) == 1
    np.testing.assert_allclose(ranks_train, serial_train, rtol=1e-5)
    np.testing.assert_allclose(ranks_valid, serial_valid, rtol=1e-5)
