"""makani_tpu_torch's SFNO, stepper and rollout against makani_tpu on the CPU.

A 3-block SFNO (embed 32, 36x72 equiangular -> 18x36 Legendre-Gauss, scale
factor 2, 7 channels) is initialized in JAX; its weights are carried into the
port by tools/convert_jax_params.load_jax_params, and the same numpy inputs go
through both.

Tolerance: 2e-4 relative to the reference's largest magnitude. JAX's CPU dots
are exact float32 (makani_tpu/ops/sht.py:156-160) while the port's plain twins
keep the 3-pass bf16 splits (~1e-5 per contraction, tests/test_torch_port_ops
.py); each block runs three contractions and two instance norms, which pass a
relative error on unchanged, and the blocks and AR steps compound it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu.models import model_registry as jregistry
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.tools.convert_jax_params import load_jax_params
from makani_tpu_torch.utils.inferencer import Inferencer
from makani_tpu_torch.utils.yparams import YParams as TYParams

TOL = 2e-4
NLAT, NLON, CHANS = 36, 72, 7


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
    """Matching (JAX, port) params of the tiny flagship-shaped SFNO."""
    out = []
    for cls in (TYParams, JYParams):
        p = cls("config/sfnonet.yaml", "flagship_synth_drive_bare")
        p.update_params(dict(img_shape_x=NLAT, img_shape_y=NLON, embed_dim=32, num_layers=3,
                             scale_factor=2, **overrides))
        out.append(p)
    tp, jp = out
    tregistry.update_channel_params(tp, n_channels=CHANS)
    jp.update_params({k: v for k, v in tp.to_dict().items() if k not in jp.to_dict()})
    return jp, tp


def _jax_flat(jmodel):
    v = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, CHANS, NLAT, NLON)),
                                      deterministic=True))(jax.random.PRNGKey(0))
    return v["params"], {k: np.asarray(a) for k, a in flatten_dict(v["params"], sep="/").items()}


@pytest.fixture(scope="module")
def matched():
    jp, tp = _configs()
    jmodel = jregistry.get_model(jp)
    jparams, flat = _jax_flat(jmodel)
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    return jp, tp, jmodel, jparams, tmodel, flat


def _inputs(seed, batch=2):
    return np.random.RandomState(seed).randn(batch, CHANS, NLAT, NLON).astype(np.float32)


def test_channel_params_follow_trainer_math():
    p = TYParams("config/sfnonet.yaml", "flagship_synth_drive")
    tregistry.update_channel_params(p, n_channels=73)
    # trainer.py:308-332: 73 + zenith 1 + sinusoidal grid 2*16 + orography 1 + landmask 2
    assert p.N_in_channels == 73 + 1 + 32 + 1 + 2
    assert p.N_out_channels == 73 and p.N_in_predicted_channels == 73
    assert (p.img_crop_shape_x, p.img_crop_shape_y) == (721, 1440)
    assert p.n_future == 0 and p.N_target_channels == 73


def test_sfno_forward_matches_jax(matched):
    jp, tp, jmodel, jparams, tmodel, _ = matched
    x = _inputs(1)
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a, deterministic=True))(
        jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, CHANS, NLAT, NLON)
    assert _rel(got, want) < TOL


def test_sfno_resolution_change_matches_jax(matched):
    """out_shape != inp_shape: the big skip goes through the complex-layout
    SHT wrappers (trans_down, then itrans_up on the output grid)."""
    *_, jparams, _, flat = matched
    jp, tp = _configs(out_shape_x=30, out_shape_y=60)
    jmodel = jregistry.get_model(jp)
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    x = _inputs(10)
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a, deterministic=True))(
        jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, CHANS, 30, 60)
    assert _rel(got, want) < TOL


def test_load_jax_params_rejects_missing_and_unused(matched):
    *_, tmodel, flat = matched
    extra = dict(flat, **{"model/blocks_9/norm0/weight": np.ones(32, np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(tmodel, extra)
    short = {k: v for k, v in flat.items() if not k.endswith("residual_transform")}
    with pytest.raises(KeyError):
        load_jax_params(tmodel, short)


def test_single_step_lsm_gate_matches_jax(matched):
    *_, jparams, _, flat = matched
    jp, tp = _configs(lsm_mask_channels=[1, 4])
    jmodel = jregistry.get_model(jp)
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    assert tmodel.lsm_mask_channels == (1, 4)
    x = _inputs(2)
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a, deterministic=True))(
        jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < TOL


def _jax_inferencer(jp, jmodel, sst):
    """makani_tpu's Inferencer with its rollout steps built, minus the
    dataset, metrics and checkpoint it would otherwise load."""
    from makani_tpu.utils.inferencer import Inferencer as JInferencer
    inf = JInferencer.__new__(JInferencer)
    inf.params, inf.model, inf.preprocessor = jp, jmodel, jmodel.preprocessor
    inf.loss_obj = inf.metrics = inf.amp_dtype = None
    inf.data_parallel_size = 1
    inf.sst_persistence_channels = sst
    inf._build_inference_steps()
    return inf


def test_lite_rollout_matches_jax(matched):
    jp, tp, jmodel, jparams, _, flat = matched
    jp["valid_autoreg_steps"] = tp["valid_autoreg_steps"] = 2
    tp["sst_persistence_channels"] = [2]
    x = _inputs(3, batch=1)[:, None]  # (B, T=1, C, H, W)

    want = _jax_inferencer(jp, jmodel, (2,))._rollout_lite(jparams, jnp.asarray(x), None, None)
    inf = Inferencer(tp, device="cpu")
    load_jax_params(inf.model, flat)
    got = inf._rollout_lite(x)
    assert got.shape == want.shape == (3, 1, CHANS, NLAT, NLON)
    np.testing.assert_array_equal(got[:, :, 2], np.broadcast_to(x[:, 0, 2], got[:, :, 2].shape))
    for step in range(3):
        assert _rel(got[step], want[step]) < TOL, step


def test_capture_rollout_matches_jax(matched):
    jp, tp, jmodel, jparams, _, flat = matched
    jp["valid_autoreg_steps"] = tp["valid_autoreg_steps"] = 1
    x = _inputs(4, batch=1)[:, None]
    tar = np.random.RandomState(5).randn(1, 2, CHANS, NLAT, NLON).astype(np.float32)

    jpred, jtarg = _jax_inferencer(jp, jmodel, ())._rollout_capture(
        jparams, jnp.asarray(x), jnp.asarray(tar), None, None)
    inf = Inferencer(tp, device="cpu")
    load_jax_params(inf.model, flat)
    pred, targ = inf._rollout_capture(x, tar)
    np.testing.assert_array_equal(targ, jtarg)
    for step in range(2):
        assert _rel(pred[step], jpred[step]) < TOL, step


@pytest.mark.parametrize("mode", ["mean", "exponential"])
def test_preprocessor_history_matches_jax(mode):
    from makani_tpu.models.preprocessor import Preprocessor2D as JPrep
    from makani_tpu_torch.models.preprocessor import Preprocessor2D as TPrep

    jp, tp = _configs(n_history=1, history_normalization_mode=mode,
                      history_normalization_decay=0.5, add_zenith=True)
    jprep, tprep = JPrep(jp), TPrep(tp)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 2, 3, NLAT, NLON).astype(np.float32)
    zen = rng.randn(2, 2, 1, NLAT, NLON).astype(np.float32)
    zen_tar = rng.randn(2, 3, 1, NLAT, NLON).astype(np.float32)

    def both(fn):
        return fn(jprep, jnp.asarray), fn(tprep, torch.from_numpy)

    def chain(prep, to):
        xa = prep.append_channels(prep.flatten_history(to(x)), to(zen))
        stats = prep.history_compute_stats(xa)
        xn = prep.history_normalize(xa, stats)
        back = prep.history_denormalize(xn, stats)
        nxt = prep.append_history(xa, xa[:, :4])
        u = prep.advance_unpredicted_dyn(to(zen), to(zen_tar), 5)
        return [np.asarray(t) for t in (*stats, xn, back, nxt, u)]

    for j, t in zip(*both(chain)):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    _, tp = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tregistry.get_model(tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        Inferencer(tp)
    assert next(tregistry.get_model(tp, device="cpu").parameters()).device.type == "cpu"


def test_unported_features_and_models_raise():
    _, tp = _configs(add_orography=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tregistry.get_model(tp, device="cpu")
    _, tp = _configs(nettype="AFNO")
    with pytest.raises(NotImplementedError, match="SFNO"):
        tregistry.get_model(tp, device="cpu")
    for override in (dict(filter_type="non-linear"), dict(factorization="cp")):
        _, tp = _configs(**override)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tregistry.get_model(tp, device="cpu")


def test_multistep_wrapper_evaluates_one_step(matched):
    *_, tmodel, flat = matched
    _, tp = _configs(n_future=2)
    multi = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    assert type(multi).__name__ == "MultiStepWrapper" and multi.n_future == 2
    x = torch.from_numpy(_inputs(9))
    with torch.inference_mode():
        assert torch.equal(multi(x), tmodel(x))
    with pytest.raises(NotImplementedError):
        multi(x, deterministic=False)
