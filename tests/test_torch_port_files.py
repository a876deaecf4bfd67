"""makani_tpu_torch training and serving from files, against makani_tpu on
the CPU.

A synthetic dataset at 36x72 with 73 channels, written by the port's
tools/make_synthetic_dataset.py (npy shards and HDF5 files, synthetic
orography and land-sea mask), feeds both packages' Trainer and the rollout of
a 3-block SFNO with flagship_synth_drive's channel set: 73 channels, the
zenith angle, a sinusoidal grid of 16 frequencies on the data's explicit
latitudes and longitudes, orography and the two land-sea mask classes, 109
input channels in all.

Tolerances:
  - the preprocessor's static features, the batches read from the files and
    the rollout's targets: bit for bit;
  - two Trainer steps from the files: the tolerances of
    tests/test_torch_port_train.py's test_trainer_steps_match_jax, which the
    3-pass contractions set (losses at STEP_LOSS_TOL relative, parameter
    updates norm-wise at UPDATE_TOL over the elements whose first gradient is
    at least SIGN_FLOOR of their leaf's largest, the MLP's output bias finite
    only);
  - a 10-step capture rollout from the evaluation dataset: 2e-4 of the
    reference's largest magnitude at every step, the bound of
    tests/test_torch_port_model.py; the zenith channel advances from the
    dataset's target times through the whole rollout. The port runs it at
    precision "highest" (float32 contractions), the arithmetic of JAX's CPU
    dots, which are exact float32 at every precision
    (makani_tpu/ops/sht.py:156-160). At "high" the port's 3-pass bf16
    splits differ from them by ~1e-5 a contraction, and the random-weight
    model amplifies a difference ~1.4x an AR step: 2.2e-5 at step 1, 5.5e-4
    at step 10, against 1.0e-6 and 2.1e-5 at "highest". The two Trainer
    steps run at "high".
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu.utils.dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models.preprocessor import Preprocessor2D as TPrep
from makani_tpu_torch.ops import complex_ops, sht
from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
from makani_tpu_torch.tools.convert_jax_params import load_jax_opt_state, load_jax_params
from makani_tpu_torch.utils.dataset_metadata import parse_dataset_metadata as tparse
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_train import SIGN_FLOOR, STEP_LOSS_TOL, UPDATE_TOL, ZERO_GRAD, _as_port

NLAT, NLON, CHANS = 36, 72, 73
TRAIN_STEPS, ROLLOUT_STEPS = 2, 10
ROLLOUT_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """One train year of TRAIN_STEPS + 1 samples; one test year long enough
    for one rollout of ROLLOUT_STEPS."""
    root = tmp_path_factory.mktemp("flagship_channels")
    tsynth.make_dataset(str(root), img_shape=(NLAT, NLON),
                        channels=[f"c{i}" for i in range(CHANS)], n_samples_per_year=TRAIN_STEPS + 1, n_valid_samples=ROLLOUT_STEPS + 1,
                        mode="ar", fmt="both", invariants=True, seed=11)
    return root


def _configs(root, **overrides):
    """Matching (JAX, port) params of flagship_synth_drive cut to a 3-block
    SFNO at 36x72 on the dataset at `root`. JAX's is parsed from data.json as
    makani_tpu's train.py parses it; the port's Trainer and Inferencer parse
    it themselves."""
    stats = root / "stats"
    common = dict(
        img_shape_x=NLAT, img_shape_y=NLON, embed_dim=16, num_layers=3, scale_factor=2,
        metadata_json_path=str(root / "data.json"), train_data_path=str(root / "train"),
        valid_data_path=str(root / "test"), inf_data_path=str(root / "test"),
        global_means_path=str(stats / "global_means.npy"),
        global_stds_path=str(stats / "global_stds.npy"),
        time_means_path=str(stats / "time_means.npy"),
        time_diff_means_path=str(stats / "time_diff_means.npy"),
        time_diff_stds_path=str(stats / "time_diff_stds.npy"),
        min_path=str(stats / "mins.npy"), max_path=str(stats / "maxs.npy"),
        orography_path=str(root / "invariant" / "orography.nc"),
        landmask_path=str(root / "invariant" / "land_sea_mask.nc"),
        n_train_samples_per_epoch=TRAIN_STEPS, n_eval_samples=1,
        valid_autoreg_steps=ROLLOUT_STEPS - 1, skip_validation=True, save_checkpoint="none",
        optimizer_fused=True, max_epochs=1, num_data_workers=1, log_to_screen=False,
        batch_size=1, n_future=0)
    common.update(overrides)
    tp = TYParams("config/sfnonet.yaml", "flagship_synth_drive")
    jp = JYParams("config/sfnonet.yaml", "flagship_synth_drive")
    for p in (tp, jp):
        p.update_params(common)
    jparse(jp.metadata_json_path, jp)
    return jp, tp


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(gridtype="linear", model_grid_type="legendre-gauss"),
    dict(img_crop_shape_x=20, img_crop_offset_x=9, img_crop_shape_y=50, img_crop_offset_y=7,
         grid_num_frequencies=3),
], ids=["flagship", "linear_legendre_gauss", "crop"])
def test_static_features_bitwise_equal_jax(dataset_dir, overrides):
    """The grid on the data's explicit lat/lon (through GridConverter),
    orography z-scored, the land-sea mask one-hot, cut to the crop window."""
    from makani_tpu.models.preprocessor import Preprocessor2D as JPrep
    jp, tp = _configs(dataset_dir, **overrides)
    tparse(tp.metadata_json_path, tp)
    assert tp.lat == jp.lat and len(tp.lat) == NLAT
    want = JPrep(jp).static_features
    got = TPrep(tp).static_features.numpy()
    freqs = overrides.get("grid_num_frequencies", 16)
    shape = (overrides.get("img_crop_shape_x", NLAT), overrides.get("img_crop_shape_y", NLON))
    n_grid = 2 * (freqs if overrides.get("gridtype", "sinusoidal") == "sinusoidal" else 1)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (1, n_grid + 3, *shape)
    np.testing.assert_array_equal(got, want)
    # the mask's two classes sum to one everywhere; orography is z-scored
    np.testing.assert_array_equal(got[0, -2] + got[0, -1], 1.0)
    if "img_crop_shape_x" not in overrides:
        assert abs(float(got[0, -3].mean())) < 1e-5


@pytest.fixture(scope="module")
def jax_trainer(dataset_dir):
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    comm.reset()
    comm.init(devices=jax.devices()[:1])
    jp, tp = _configs(dataset_dir)
    trainer = JTrainer(jp, world_rank=0)
    yield trainer, tp
    comm.reset()


def test_trainer_steps_from_files_match_jax(jax_trainer):
    """Two steps of the port's Trainer on batches it reads from the files
    (the native reader: the directory holds npy shards beside HDF5 files)
    against makani_tpu's Trainer on its own reads, from the same weights and
    optimizer state (AdamW, beta2 0.95, bf16 moments)."""
    from makani_tpu_torch.utils.trainer import Trainer
    jtrainer, tp = jax_trainer
    tp["enable_native_loader"] = True
    trainer = Trainer(tp, device="cpu")
    assert type(trainer.train_dataset).__name__ == "BinaryDataset"
    assert type(jtrainer.train_dataset).__name__ == "MultifilesDataset"
    for key in ("N_in_channels", "N_out_channels", "N_in_predicted_channels",
                "N_target_channels", "img_crop_shape_x", "img_local_shape_y",
                "aux_channel_names", "in_channels", "dhours"):
        assert getattr(trainer.params, key) == getattr(jtrainer.params, key), key
    assert trainer.params.N_in_channels == CHANS + 1 + 32 + 1 + 2

    load_jax_params(trainer.model, {k: np.asarray(v) for k, v in
                                    flatten_dict(jtrainer.model_params, sep="/").items()})
    flat_state = {"count": int(jtrainer.opt_state[0].count),
                  **{n: {k: np.asarray(v, np.float32) for k, v in
                         flatten_dict(getattr(jtrainer.opt_state[0], n), sep="/").items()}
                     for n in ("mu", "nu")}}
    load_jax_opt_state(trainer.opt_state[0], trainer.model, flat_state)
    start = {k: p.detach().clone() for k, p in trainer.model_params.items()}
    jstart = _as_port(jtrainer.model_params)

    jparams, jstate = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
    steps = 0
    for step, (tbatch, jbatch) in enumerate(zip(trainer.train_dataloader,
                                                jtrainer.train_dataloader), start=1):
        assert len(tbatch) == 4  # inp, tar and their zenith fields
        for x, y in zip(tbatch, jbatch):
            np.testing.assert_array_equal(x, y)
        lr = trainer.scheduler(step)
        if step == 1:
            _, g1 = trainer.loss_and_grads(*trainer._device_batch(tbatch))
            determined = {k: np.abs(g.numpy()) >= SIGN_FLOOR * np.abs(g.numpy()).max()
                          for k, g in g1.items()}
        loss = trainer.train_step(*trainer._device_batch(tbatch), lr)
        jparams, jstate, jloss = jtrainer.train_step(
            jparams, jstate, *jtrainer._device_batch(jbatch), jnp.float32(lr),
            jax.random.fold_in(jtrainer.dropout_key, step))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_TOL)
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
        steps = step
    assert steps == TRAIN_STEPS and trainer.opt_state[0].count == TRAIN_STEPS


def test_capture_rollout_from_files_matches_jax(jax_trainer, dataset_dir):
    """A 10-step capture rollout of the port's Inferencer, fed from its
    evaluation dataset (inf_data_path, valid_autoreg_steps 9), against
    makani_tpu's capture steps on makani_tpu's evaluation sample, from the
    same weights."""
    from makani_tpu.utils.inferencer import Inferencer as JInferencer
    from makani_tpu_torch.utils.inferencer import Inferencer
    jtrainer, _ = jax_trainer
    _, tp = _configs(dataset_dir, enable_native_loader=True)
    inf = Inferencer(tp, device="cpu")
    load_jax_params(inf.model, {k: np.asarray(v) for k, v in
                                flatten_dict(jtrainer.model_params, sep="/").items()})
    assert type(inf.valid_dataset).__name__ == "BinaryDataset"  # npy shards beside h5
    assert len(inf.valid_dataset) == len(jtrainer.valid_dataset) == 1
    sample = inf.valid_dataset[0]
    jsample = jtrainer.valid_dataset[0]
    for x, y in zip(sample, jsample):
        np.testing.assert_array_equal(x, y)
    inp, tar, zen_inp, zen_tar = (f[None] for f in sample)
    assert tar.shape == (1, ROLLOUT_STEPS, CHANS, NLAT, NLON)
    assert zen_tar.shape == (1, ROLLOUT_STEPS, 1, NLAT, NLON)

    jinf = JInferencer.__new__(JInferencer)
    jinf.params, jinf.model = jtrainer.params, jtrainer.model
    jinf.preprocessor = jtrainer.model.preprocessor
    jinf.loss_obj = jinf.metrics = jinf.amp_dtype = None
    jinf.data_parallel_size = 1
    jinf.sst_persistence_channels = ()
    jinf._build_inference_steps()
    jpred, jtarg = jinf._rollout_capture(jtrainer.model_params,
                                         *(jnp.asarray(f[None]) for f in jsample))

    settings = sht.get_transform_precision(), complex_ops.get_contraction_precision()
    sht.set_transform_precision("highest")
    complex_ops.set_contraction_precision("highest")
    try:
        pred, targ = inf._rollout_capture(inp, tar, zen_inp, zen_tar)
    finally:
        sht.set_transform_precision(settings[0])
        complex_ops.set_contraction_precision(settings[1])
    assert pred.shape == jpred.shape == (ROLLOUT_STEPS, 1, CHANS, NLAT, NLON)
    np.testing.assert_array_equal(targ, jtarg)
    for step in range(ROLLOUT_STEPS):
        assert _rel(pred[step], jpred[step]) < ROLLOUT_TOL, step
