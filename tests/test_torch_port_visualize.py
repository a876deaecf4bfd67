"""makani_tpu_torch's rollout videos, plots and experiment log against
makani_tpu's on the CPU.

utils/visualize copies makani_tpu's arithmetic, so for the same arrays its
files are held equal: the AVI and GIF files byte for byte, the PNG files
pixel for pixel (decoded by PIL). utils/wandb_compat's events (init, log, a
Table, watch, log_artifact, finish) equal makani_tpu's file backend's, less
each event's time and the run id; its dispatch to the wandb package is
checked with a stub wandb module (wandb is not installed).

The Trainer: one small makani_tpu Trainer is built for the module, the cut
canonical recipe of tests/test_torch_port_trainer.py (a 2-block SFNO of
width 12 on a 20x44 dataset of 5 channels from files, 2 evaluation windows
of 3 AR steps) with log_video 1, and its initial weights cross over into the
port's Trainer. Both validate epoch 0 and render it. Tolerances: the target
frames bit for bit (both read the same files); the prediction frames and the
one-step comparison within VALID_TOL (2e-4) of the reference's largest
magnitude, the validation tolerance of tests/test_torch_port_trainer.py and
the rollout tolerance of test_trainer_steps_from_files_match_jax's file, at
precision "highest". In the port alone: every frame equals the prediction
and the target its AR step scored, bit for bit, and the validation logs with
log_video equal those without it, bit for bit.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from flax.traverse_util import flatten_dict

from makani_tpu.utils import visualize as jviz
from makani_tpu.utils.dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.ops import complex_ops, sht
from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
from makani_tpu_torch.tools.convert_jax_params import load_jax_params
from makani_tpu_torch.utils import visualize as tviz
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_trainer import (
    CANONICAL,
    CHANNELS,
    NLAT,
    NLON,
    TRAIN_SAMPLES,
    VALID_SAMPLES,
    VALID_TOL,
    _overrides,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _pixels(path):
    return np.asarray(Image.open(path))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# --------------------------------------------------------------------------
# the files
# --------------------------------------------------------------------------

def test_avi_and_gif_bytes_match_jax(tmp_path):
    """The MJPEG AVI (odd and even JPEG payloads, the index) and the GIF of
    the same uint8 frames, and the rollout video of the same fields in both
    containers, byte for byte."""
    rng = np.random.RandomState(0)
    frames = (rng.rand(5, 24, 48, 3) * 255).astype(np.uint8)
    for fps in (4, 2):
        for writer in ("write_mjpeg_avi", "write_gif"):
            ext = "avi" if writer == "write_mjpeg_avi" else "gif"
            want = getattr(jviz, writer)(frames, str(tmp_path / f"j{fps}.{ext}"), fps=fps)
            got = getattr(tviz, writer)(frames, str(tmp_path / f"t{fps}.{ext}"), fps=fps)
            assert _read(got) == _read(want), (writer, fps)
    data = _read(tmp_path / "t4.avi")
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI " and int.from_bytes(
        data[4:8], "little") == len(data) - 8
    pred = rng.randn(3, 20, 40).astype(np.float32)
    targ = rng.randn(3, 20, 40).astype(np.float32)
    for ext in ("avi", "gif"):
        want = jviz.render_rollout_video(pred, targ, str(tmp_path / f"jr.{ext}"), fps=2)
        got = tviz.render_rollout_video(pred, targ, str(tmp_path / f"tr.{ext}"), fps=2)
        assert _read(got) == _read(want), ext
    assert Image.open(tmp_path / "tr.gif").n_frames == 3
    np.testing.assert_array_equal(tviz._colorize(pred[0], -1.0, 1.0),
                                  jviz._colorize(pred[0], -1.0, 1.0))


def test_comparison_and_rollout_plots_pixels_match_jax(tmp_path):
    """_render_comparison (mollweide and plain) and plot_rollout_metrics,
    pixel for pixel, under makani_tpu's file names."""
    rng = np.random.RandomState(1)
    pred = rng.randn(2, 18, 36).astype(np.float32)
    targ = rng.randn(2, 18, 36).astype(np.float32)
    for projection in ("mollweide", None):
        want = jviz._render_comparison(("tag", pred, targ, str(tmp_path / "j.png"), projection))
        got = tviz._render_comparison(("tag", pred, targ, str(tmp_path / "t.png"), projection))
        np.testing.assert_array_equal(_pixels(got), _pixels(want))
    acc, rmse = rng.rand(3, 4), rng.rand(3, 4) * 2

    def params(exp):
        return types.SimpleNamespace(experiment_dir=str(exp), dt=1, dhours=6,
                                     channel_names=["u10m", "t2m"])
    want = jviz.plot_rollout_metrics(acc, rmse, params(tmp_path / "j"), epoch=3, model_name="m")
    got = tviz.plot_rollout_metrics(acc, rmse, params(tmp_path / "t"), epoch=3, model_name="m")
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == [
        os.path.relpath(p, tmp_path / "j") for p in want] == [
        f"rollout_plots/rollout_{n}_epoch3.png" for n in ("u10m", "t2m", "ch2")]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_pixels(g), _pixels(w))


@pytest.mark.parametrize("workers", [1, 2])
def test_wrapper_with_spawn_workers(tmp_path, workers):
    """The wrapper's spawned workers write what the functions write in this
    process, under <experiment_dir>/visualizations; the module imports no
    torch, so the workers do not."""
    rng = np.random.RandomState(2)
    pred, targ = rng.randn(3, 16, 32), rng.randn(3, 16, 32)
    viz = tviz.VisualizationWrapper(types.SimpleNamespace(experiment_dir=str(tmp_path)),
                                    num_workers=workers)
    assert viz.executor._mp_context.get_start_method() == "spawn"
    viz.add("epoch0_step1", pred[:2], targ[:2])
    viz.add_video("epoch0_rollout_ch0", pred, targ)
    viz.add_video("gif", pred, targ, fmt="gif")
    paths = viz.finalize()
    viz.close()
    assert [os.path.basename(p) for p in paths] == ["epoch0_step1.png", "epoch0_rollout_ch0.avi",
                                                    "gif.gif"]
    here = tmp_path / "here"
    here.mkdir()
    want = tviz._render_comparison(("epoch0_step1", pred[:2], targ[:2], str(here / "a.png"),
                                    "mollweide"))
    np.testing.assert_array_equal(_pixels(paths[0]), _pixels(want))
    assert _read(paths[1]) == _read(tviz.render_rollout_video(pred, targ, str(here / "v.avi")))
    assert _read(paths[2]) == _read(tviz.render_rollout_video(pred, targ, str(here / "v.gif")))
    code = ("import sys; import makani_tpu_torch.utils.visualize\n"
            "assert 'torch' not in sys.modules and 'matplotlib' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=60,
                   env={**os.environ, "PYTHONPATH": ROOT})


# --------------------------------------------------------------------------
# the experiment log
# --------------------------------------------------------------------------

def _events(path):
    """The log's events less each event's time and the run id."""
    out = []
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            e.pop("time", None)
            e.pop("run_id", None)
            out.append(e)
    return out


def test_experiment_log_events_match_jax(tmp_path):
    """init, log with a Table, watch (the parameter histograms), an artifact
    of a file and a directory, finish: makani_tpu's events, and the same
    copies under artifacts/."""
    import makani_tpu.utils.wandb_compat as jw
    import makani_tpu_torch.utils.wandb_compat as tw
    assert jw._real_wandb is None and tw._real_wandb is None
    rng = np.random.RandomState(3)
    arrays = {"encoder.fwd_0.weight": rng.randn(6, 4).astype(np.float32),
              "blocks.0.norm0.bias": rng.randn(6).astype(np.float32),
              "empty": np.zeros((0,), np.float32)}
    (tmp_path / "model.bin").write_bytes(b"weights")
    (tmp_path / "stats").mkdir()
    (tmp_path / "stats" / "global_means.npy").write_bytes(b"npy")

    for mod, leaves, run in ((jw, arrays, "jax"),
                             (tw, {k: torch.from_numpy(v) for k, v in arrays.items()}, "port")):
        mod.init(dir=str(tmp_path / run), name="run", config={"lr": 1e-3, "embed_dim": 12},
                 project="p")
        mod.log({"loss": np.float32(0.5), "rollouts": mod.Table(data=[["acc", "u10m", 6, 0.9]],
                                                                columns=["a", "b", "c", "d"])},
                step=1)
        mod.watch(leaves)
        art = mod.Artifact("best-model", type="model", metadata={"epoch": 3})
        art.add_file(str(tmp_path / "model.bin"))
        art.add_dir(str(tmp_path / "stats"))
        art.add_file(str(tmp_path / "missing.bin"))
        mod.log_artifact(art)
        mod.login()
        mod.finish()
    got, want = _events(tmp_path / "port" / "wandb_log.jsonl"), _events(
        tmp_path / "jax" / "wandb_log.jsonl")
    assert got == want
    assert [e["event"] for e in got] == ["init", "log", "log", "log", "finish"]
    hist = got[2]["data"]["watch"]
    assert set(hist) == {"param/encoder.fwd_0.weight", "param/blocks.0.norm0.bias"}
    assert sum(hist["param/encoder.fwd_0.weight"]["counts"]) == 24
    assert got[3]["data"]["artifact"]["files"] == ["model.bin", "stats"]
    for name in ("model.bin", "stats/global_means.npy"):
        assert _read(tmp_path / "port" / "artifacts" / "best-model" / name) == _read(
            tmp_path / "jax" / "artifacts" / "best-model" / name)
    # tree_histograms of a mapping of tensors equals makani_tpu's of the arrays,
    # and watch() of a module reads its named_parameters()
    assert tw.tree_histograms({k: torch.from_numpy(v) for k, v in arrays.items()},
                              prefix="p/") == jw.tree_histograms(arrays, prefix="p/")
    module = torch.nn.Linear(4, 3)
    run = tw.JsonlRun()
    run.init(dir=str(tmp_path / "module"))
    run.watch(module, log="parameters")
    run.finish()
    logged = _events(tmp_path / "module" / "wandb_log.jsonl")[1]["data"]["watch"]
    assert logged == tw.tree_histograms(dict(module.named_parameters()), prefix="param/")
    assert set(logged) == {"param/weight", "param/bias"}


def test_experiment_log_dispatches_to_wandb_where_it_imports(monkeypatch):
    """With a wandb module importable, the module's functions and classes are
    wandb's, as in makani_tpu, and the Trainer's log is wandb itself."""
    import importlib
    import makani_tpu_torch.utils.wandb_compat as tw
    stub = types.ModuleType("wandb")
    for name in ("init", "log", "watch", "login", "finish", "log_artifact"):
        setattr(stub, name, lambda *a, _n=name, **k: _n)
    stub.Table = type("Table", (), {})
    stub.Artifact = type("Artifact", (), {})
    monkeypatch.setitem(sys.modules, "wandb", stub)
    try:
        importlib.reload(tw)
        assert tw._real_wandb is stub and tw.experiment_log() is stub
        for name in ("init", "log", "watch", "login", "finish", "log_artifact", "Table",
                     "Artifact"):
            assert getattr(tw, name) is getattr(stub, name), name
    finally:
        monkeypatch.delitem(sys.modules, "wandb")
        importlib.reload(tw)
    assert tw._real_wandb is None and isinstance(tw.experiment_log(), tw.JsonlRun)


# --------------------------------------------------------------------------
# the Trainer and the Inferencer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """makani_tpu's Trainer of the cut canonical recipe with log_video 1, and
    its initial weights."""
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    root = tmp_path_factory.mktemp("videos")
    data = root / "data"
    tsynth.make_dataset(str(data), img_shape=(NLAT, NLON), channels=CHANNELS,
                        n_samples_per_year=TRAIN_SAMPLES, n_valid_samples=VALID_SAMPLES,
                        mode="ar", fmt="bin", invariants=True, seed=22)
    comm.reset()
    comm.init(devices=jax.devices()[:1])
    jp = JYParams("config/sfnonet.yaml", CANONICAL)
    jp.update_params(dict(_overrides(data, root / "jax"), log_video=1))
    jparse(jp.metadata_json_path, jp)
    jtrainer = JTrainer(jp, world_rank=0)
    flat = {k: np.asarray(v) for k, v in flatten_dict(jtrainer.model_params, sep="/").items()}
    yield dict(root=root, data=data, jtrainer=jtrainer, flat=flat)
    comm.reset()


def _recording_wrapper(monkeypatch, module):
    """Records the arrays each VisualizationWrapper of `module` is given."""
    seen = {"add": [], "add_video": []}
    cls = module.VisualizationWrapper
    for name in seen:
        method = getattr(cls, name)

        def recording(self, tag, *arrays, _method=method, _name=name, **kwargs):
            seen[_name].append((tag, *(np.array(a) for a in arrays)))
            return _method(self, tag, *arrays, **kwargs)
        monkeypatch.setattr(cls, name, recording)
    return seen


def _port_trainer(ref, exp, **overrides):
    from makani_tpu_torch.utils.trainer import Trainer
    tp = TYParams("config/sfnonet.yaml", CANONICAL)
    tp.update_params({**_overrides(ref["data"], exp), "log_video": 1, **overrides})
    trainer = Trainer(tp, device="cpu")
    load_jax_params(trainer.model, ref["flat"])
    return trainer


def test_trainer_rollout_videos_match_jax(ref, tmp_path, monkeypatch):
    """Validation of epoch 0 with log_video 1 in both packages: the same
    files under visualizations/, the frames and the comparison within the
    module's tolerances; in the port the frames are the scored predictions
    and targets bit for bit, and the logs equal those of log_video 0 bit for
    bit."""
    jseen = _recording_wrapper(monkeypatch, jviz)
    tseen = _recording_wrapper(monkeypatch, tviz)
    jt = ref["jtrainer"]
    jt.validate_one_epoch(0)
    trainer = _port_trainer(ref, tmp_path / "port")

    scored = []
    update = trainer.metrics.update

    def recording(buffers, pred, targ, loss, idt):
        scored.append((pred[0, 0].numpy().copy(), targ[0, 0].numpy().copy()))
        return update(buffers, pred, targ, loss, idt)
    monkeypatch.setattr(trainer.metrics, "update", recording)
    valid_s, viz_s, logs = trainer.validate_one_epoch(0)
    assert valid_s >= viz_s > 0.0

    names = sorted(os.listdir(tmp_path / "port" / "visualizations"))
    assert names == sorted(os.listdir(ref["root"] / "jax" / "visualizations")) == [
        "epoch0_rollout_ch0.avi", "epoch0_step1.png"]
    (tag, pf, tf), = tseen["add_video"]
    (jtag, jpf, jtf), = jseen["add_video"]
    steps = trainer.params.valid_autoreg_steps + 1
    assert tag == jtag == "epoch0_rollout_ch0" and pf.shape == jpf.shape == (steps, NLAT, NLON)
    np.testing.assert_array_equal(tf, jtf)
    assert _rel(pf, jpf) < VALID_TOL
    (tag, pimg, timg), = tseen["add"]
    (jtag, jpimg, jtimg), = jseen["add"]
    assert tag == jtag == "epoch0_step1" and pimg.shape == jpimg.shape == (2, NLAT, NLON)
    np.testing.assert_array_equal(timg, jtimg)
    assert _rel(pimg, jpimg) < VALID_TOL
    # the frames are what the first batch's AR steps scored
    for t in range(steps):
        np.testing.assert_array_equal(pf[t], scored[t][0])
        np.testing.assert_array_equal(tf[t], scored[t][1])

    # the logs do not depend on log_video
    trainer.params["log_video"] = 0
    valid_s, viz_s, plain = trainer.validate_one_epoch(0)
    assert plain == logs and len(tseen["add_video"]) == 1

    # train() renders on the epochs log_video picks, times the renders, and
    # stops the renderer's workers at its end
    trainer = _port_trainer(ref, tmp_path / "train", log_video=2, max_epochs=3,
                            save_checkpoint="none")
    trainer.train()
    assert sorted(os.listdir(tmp_path / "train" / "visualizations")) == [
        "epoch0_rollout_ch0.avi", "epoch0_step1.png", "epoch2_rollout_ch0.avi",
        "epoch2_step1.png"]
    timing = [e["timing"]["visualization time [s]"] for e in trainer.epoch_logs]
    assert timing[0] > 0.1 and timing[1] < 0.01 and timing[2] > 0.1
    assert trainer.visualizer is None


def test_log_video_needs_matplotlib_and_pil_at_construction(ref, tmp_path, monkeypatch):
    """Without matplotlib (or PIL) a Trainer that would render raises
    ImportError naming log_video when it is built; one that skips
    validation, or sets log_video 0, is built."""
    for module in ("matplotlib", "PIL"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, module, None)
            with pytest.raises(ImportError, match=f"log_video 1 .*needs {module}"):
                _port_trainer(ref, tmp_path / module)
            _port_trainer(ref, tmp_path / "skip", skip_validation=True)
            _port_trainer(ref, tmp_path / "off", log_video=0)


def test_inference_epoch_plots_match_jax(ref, tmp_path, monkeypatch, caplog):
    """inference_epoch plots each output channel's curves as makani_tpu's
    plot_rollout_metrics does from the same curves, pixel for pixel; without
    matplotlib it warns and still writes the four npy files."""
    from makani_tpu_torch.utils.inferencer import Inferencer
    trainer = _port_trainer(ref, tmp_path / "train", log_video=0)
    exp = tmp_path / "exp"
    exp.mkdir()
    tp = TYParams("config/sfnonet.yaml", CANONICAL)
    tp.update_params(_overrides(ref["data"], exp))
    inf = Inferencer(tp, weights=trainer.model.state_dict(), device="cpu")
    inf.inference_epoch(output_channels=inf.params.out_channels)
    acc, rmse = np.load(exp / "acc_curves.npy"), np.load(exp / "rmse_curves.npy")
    assert acc.shape == (len(CHANNELS), 3)
    want = jviz.plot_rollout_metrics(acc, rmse, types.SimpleNamespace(
        experiment_dir=str(tmp_path / "jax"), dt=inf.params.dt, dhours=inf.params.dhours,
        channel_names=inf.params.channel_names), epoch=0, model_name=inf.params.nettype)
    got = sorted(os.listdir(exp / "rollout_plots"))
    assert got == sorted(os.path.basename(p) for p in want) == sorted(
        f"rollout_{n}_epoch0.png" for n in CHANNELS)
    for path in want:
        np.testing.assert_array_equal(_pixels(exp / "rollout_plots" / os.path.basename(path)),
                                      _pixels(path))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bare = tmp_path / "bare"
    bare.mkdir()
    inf.params["experiment_dir"] = str(bare)
    with caplog.at_level("WARNING"):
        inf.inference_epoch(output_channels=inf.params.out_channels)
    assert "rollout plotting failed" in caplog.text and "matplotlib" in caplog.text
    assert sorted(os.listdir(bare)) == ["RMSE_over_space.npy", "RMSE_over_time.npy",
                                        "acc_curves.npy", "rmse_curves.npy"]
