"""makani_tpu_torch's Trainer, Inferencer and train CLI on several ranks.

The dataset is written by the port's tools/make_synthetic_dataset.py (HDF5,
33x70, 3 channels, data.json and stats), and the config is
config/sfnonet.yaml's smoke_test (zenith input, dhconv SFNO) cut to width
11, with the 2-frequency sinusoidal grid as static features (cut to each
rank's window). makani_tpu runs in this process on the conftest's virtual CPU devices,
its mesh (data 2, h 2) made by `comm.init(model_parallel_sizes=[2, 1, 1, 1],
devices=jax.devices()[:4])`; the port runs as 4 spawned ranks on the CPU
(tests/torch_port_parallel_ranks.py, gloo, no JAX imported) with the same
per-rank batch of 1, so that both take the same global batches of 2: each
port rank reads its row and its 17- or 16-latitude window of each.

Tolerances (tests/test_torch_port_train.py's, whose module docstring says
why): the losses of 2 steps at STEP_LOSS_TOL relative; the weights after
each step compared by their updates (AdamW, bf16 moments under stochastic rounding:
makani_tpu's optax chain on its mesh, the port's fused kernel's twin on each
rank's shards), norm-wise per leaf over the elements
whose first gradient is at least SIGN_FLOOR of their leaf's largest, within
UPDATE_TOL (the port's 3-pass contractions against JAX's exact float32
dots; Adam's first steps are sign-like), the MLP's output bias (an exact
zero gradient) finite only.

The Inferencer's validation loss is the data ranks' mean, invariant to the
layout: 2 ranks (data 2) and 4 (data 2, h 2) against one, rtol 1e-5 (sums
in another order). The train CLI under torchrun with 2 data ranks against
the serial CLI at the same global batch of 2: makani_tpu divides the loss by
the data size, so each of the 2-rank losses is half the serial batch-sum,
within 1e-5 relative: the gradients are halved too, which Adam's update
undoes but for its eps (1e-8 against gradients of 1e-3 and more).
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
from torch_port_parallel_ranks import run_ranks, trainer_steps, validation_loss

IMG = (33, 70)
CHANNELS = ["u10m", "t2m", "z500"]
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    tsynth.make_dataset(str(root), img_shape=IMG, channels=CHANNELS,
                        n_samples_per_year=2 * STEPS + 2, n_valid_samples=5, mode="ar",
                        fmt="h5", seed=7)
    return root


def _overrides(root, exp, **extra):
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
        img_shape_x=IMG[0], img_shape_y=IMG[1], embed_dim=11, batch_size=1,
        n_train_samples_per_epoch=2 * STEPS, n_eval_samples=2, valid_autoreg_steps=1,
        skip_validation=True, save_checkpoint="none", num_data_workers=1,
        log_to_screen=False, log_to_wandb=False, n_future=0, experiment_dir=str(exp),
        optimizer_type="AdamW", weight_decay=0.1, optimizer_moment_dtype="bfloat16",
        add_grid=True, gridtype="sinusoidal", grid_num_frequencies=2, **extra)


def _configs(root, exp, **extra):
    tp, jp = TYParams("config/sfnonet.yaml", "smoke_test"), JYParams("config/sfnonet.yaml",
                                                                     "smoke_test")
    for p in (tp, jp):
        p.update_params(_overrides(root, exp, **extra))
    jparse(jp.metadata_json_path, jp)
    return jp, tp


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    """makani_tpu's Trainer on the (data 2, h 2) mesh: its initial weights,
    the first step's gradients, and the losses and weights of STEPS steps."""
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    exp = tmp_path_factory.mktemp("jexp")
    jp, tp = _configs(dataset, exp)
    comm.reset()
    comm.init(model_parallel_sizes=[2, 1, 1, 1], devices=jax.devices()[:4])
    try:
        jtrainer = JTrainer(jp, world_rank=0)
        assert jtrainer.data_parallel_size == 2
        start = _as_port(jtrainer.model_params)
        flat = {k: np.asarray(v) for k, v in flatten_dict(jtrainer.model_params, sep="/").items()}
        # the JAX step donates its state: step on copies
        jparams, jstate = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
        losses, weights = [], []
        for step, jbatch in enumerate(jtrainer.train_dataloader, start=1):
            batch = jtrainer._device_batch(jbatch)
            if step == 1:
                _, g1 = jtrainer._grad_step(jparams, *batch)
                grads = _as_port(g1)
            jparams, jstate, jloss = jtrainer.train_step(
                jparams, jstate, *batch, jnp.float32(jtrainer.scheduler(step)),
                jax.random.fold_in(jtrainer.dropout_key, step))
            losses.append(float(jloss))
            weights.append(_as_port(jparams))
    finally:
        comm.reset()
    return dict(start=start, grads=grads, losses=losses, weights=weights, flat=flat, tp=tp,
                resolved=dict(jtrainer.params.to_dict()))


def _port_state(run):
    """makani_tpu's initial weights as the port's whole state dict (numpy),
    on the model of makani_tpu's resolved params."""
    from makani_tpu_torch.models.model_registry import get_model
    model = get_model(TYParams.from_dict(run["resolved"]), device="cpu")
    return _map_flat(model.state_dict(), run["flat"], "parameters")


def test_trainer_steps_on_data_and_h_ranks_match_jax(jax_run):
    """STEPS steps of the port's Trainer on 4 ranks (data 2, h 2) against
    makani_tpu's on the same mesh, from the same weights."""
    tp = jax_run["tp"]
    tp_dict = dict(tp.to_dict(), model_parallel_sizes=[2, 1, 1, 1], world_size=4)
    state = _port_state(jax_run)
    ranks = run_ranks(trainer_steps, [2, 1, 1, 1], 4, tp_dict, state)
    assert all(r["data"] == 2 for r in ranks)
    # the dhconv weights are split over h (their l axis)
    assert {k for k in ranks[0]["shards"]} == {
        f"model.blocks.{i}.filter_layer.filter.weight" for i in range(2)}
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    got = ranks[0]
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=STEP_LOSS_TOL)
    start, grads = jax_run["start"], jax_run["grads"]
    for step in range(STEPS):
        want = jax_run["weights"][step]
        for key, w in got["weights"][step].items():
            du, jdu = w - start[key], want[key] - start[key]
            assert np.isfinite(du).all(), (step, key)
            if key.endswith(ZERO_GRAD):
                continue
            keep = np.abs(grads[key]) >= SIGN_FLOOR * np.abs(grads[key]).max()
            assert keep.mean() > 0.9, key
            assert (np.linalg.norm((du - jdu)[keep])
                    <= UPDATE_TOL * np.linalg.norm(jdu[keep])), (step, key)


@pytest.mark.parametrize("sizes,world", [([1, 1, 1, 1], 2), ([2, 1, 1, 1], 4)],
                         ids=["data2", "data2_h2"])
def test_validation_loss_is_invariant_to_the_layout(jax_run, dataset, tmp_path, sizes, world):
    from makani_tpu_torch.utils.inferencer import Inferencer
    tp = jax_run["tp"]
    state = _port_state(jax_run)
    serial_params = TYParams.from_dict(dict(tp.to_dict(), experiment_dir=str(tmp_path / "s")))
    os.makedirs(tmp_path / "s")
    serial = Inferencer(serial_params, device="cpu",
                        weights={k: torch.from_numpy(v) for k, v in state.items()})
    want = serial.inference_epoch(output_channels=list(serial.params.out_channels))
    os.makedirs(tmp_path / "d")
    dist_dict = dict(tp.to_dict(), experiment_dir=str(tmp_path / "d"),
                     model_parallel_sizes=sizes, world_size=world)
    losses = run_ranks(validation_loss, sizes, world, dist_dict, state)
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], want["base"]["validation loss"], rtol=1e-5)
    # rank 0 wrote the scores of the whole field
    for name in ("acc_curves.npy", "RMSE_over_space.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "d" / name),
                                   np.load(tmp_path / "s" / name), rtol=1e-4, atol=1e-6)


def _cli_yaml(root, tmp_path):
    cfg = TYParams("config/sfnonet.yaml", "smoke_test").to_dict()
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    cfg.update(_overrides(root, tmp_path / "unused"))
    for key in ("experiment_dir", "save_checkpoint", "skip_validation", "batch_size"):
        cfg.pop(key)
    cfg.update(exp_dir=str(tmp_path / "runs"), batch_size=2, max_epochs=1,
               log_to_wandb=True)
    path = tmp_path / "smoke.yaml"
    path.write_text(yaml.safe_dump({"smoke_test": cfg}))
    return str(path)


def _logged(tmp_path, run):
    lines = [json.loads(x) for x in (tmp_path / "runs" / "smoke_test" / run /
                                      "wandb_log.jsonl").read_text().splitlines()]
    data = [x.get("data", {}) for x in lines]
    return ([d["training loss"] for d in data if "training loss" in d],
            [d["validation loss"] for d in data if "validation loss" in d])


def test_train_cli_under_torchrun_matches_serial(dataset, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    args = ["-m", "makani_tpu_torch.train", "--yaml_config", _cli_yaml(dataset, tmp_path),
            "--config", "smoke_test", "--device", "cpu"]
    subprocess.run([sys.executable, *args, "--run_num", "serial"], env=env, cwd=repo,
                   check=True, timeout=300)
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", "2", *args, "--run_num", "ranks"], env=env, cwd=repo,
                   check=True, timeout=300)
    serial_train, serial_valid = _logged(tmp_path, "serial")
    ranks_train, ranks_valid = _logged(tmp_path, "ranks")
    assert len(serial_train) == len(ranks_train) == 1 and len(ranks_valid) == 1
    np.testing.assert_allclose(2 * np.asarray(ranks_train), serial_train, rtol=1e-5)
    np.testing.assert_allclose(2 * np.asarray(ranks_valid), serial_valid, rtol=1e-5)
    # rank 0 alone logged and wrote the checkpoints
    ckpt = tmp_path / "runs" / "smoke_test" / "ranks" / "training_checkpoints"
    assert (ckpt / "best_ckpt" / "model.pt").exists()
