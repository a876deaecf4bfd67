"""makani_tpu_torch's inference and predict CLIs, model packages and the
reference-checkpoint converter, against makani_tpu on the CPU.

The small SFNO of tests/test_torch_port_serve.py (its `crossed` fixture:
makani_tpu's Trainer trains one epoch, its orbax checkpoint crosses over into
the port's format) serves through both packages' entry points: the inference
CLI's `score`, `epoch` and `lite` modes (in-process `main()`, on one
data.json-backed HDF5 dataset), `load_time_loop` of a model package, and
`Predict.run` on an HDF5 file of initial conditions (the port's through its
CLI). A reference-style torch archive goes through both
tools/convert_torch_checkpoint.

Tolerances: 2e-4 of the reference's largest magnitude for every output
(ROADMAP Queue 1 item 3's gate), the port at precision "highest" as in
tests/test_torch_port_serve.py, whose docstring says why; the converted
checkpoints and the targets read from the files: bit for bit.
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from makani_tpu.utils import checkpoint as jckpt

from makani_tpu_torch.ops import complex_ops, sht
from makani_tpu_torch.utils import checkpoint as tckpt
from makani_tpu_torch.utils.nctools import read_netcdf_var, write_netcdf
from makani_tpu_torch.utils.yparams import ParamsBase as TParams

from test_torch_port_serve import EXPORTS, SERVE_TOL, _jparams, _rel, crossed  # noqa: F401
from test_torch_port_train import _as_port

CHANNELS = ["u10m", "v10m", "t2m", "z500"]
NLAT, NLON = 36, 72


@pytest.fixture(autouse=True, scope="module")
def _highest():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    settings = sht.get_transform_precision(), complex_ops.get_contraction_precision()
    sht.set_transform_precision("highest")
    complex_ops.set_contraction_precision("highest")
    yield
    sht.set_transform_precision(settings[0])
    complex_ops.set_contraction_precision(settings[1])
    torch.set_num_threads(prev)


def _lat_lon():
    return np.linspace(90, -90, NLAT).tolist(), np.arange(0, 360, 360 / NLON).tolist()


@pytest.fixture(scope="module")
def cli_config(crossed):
    """A data.json for the serve dataset and a YAML config of the small SFNO
    on it; returns (yaml path, config name)."""
    root = crossed["root"]
    lat, lon = _lat_lon()
    with open(root / "data.json", "w") as f:
        json.dump({"dataset_name": "serve", "h5_path": "fields", "dhours": 24,
                   "coords": {"grid_type": "equiangular", "lat": lat, "lon": lon,
                              "channel": CHANNELS}}, f)
    cfg = dict(crossed["raw"], metadata_json_path=str(root / "data.json"),
               exp_dir=str(root / "cli"), log_to_screen=True)
    for key in ("ic_perturbation_std", "sst_persistence_channels"):
        cfg.pop(key)
    with open(root / "serve.yaml", "w") as f:
        yaml.safe_dump({"serve": cfg}, f)
    return str(root / "serve.yaml"), "serve"


def _run_jax_cli(argv):
    """makani_tpu's inference CLI in-process (the caller puts its mesh on one
    device of the test mesh)."""
    from makani_tpu import inference as jinference
    argv_before = sys.argv
    sys.argv = ["inference.py", *argv]
    try:
        jinference.main()
    finally:
        sys.argv = argv_before


def test_inference_cli_score_and_epoch_match_jax(cli_config, crossed, monkeypatch, tmp_path):
    """`--mode score`: the denormalized predictions and targets of one
    initial condition as NetCDF; `--mode epoch`: the four npy exports;
    `--mode lite`: the denormalized predictions without targets."""
    from makani_tpu_torch import inference as tinference
    yaml_path, name = cli_config
    exp = crossed["root"] / "cli" / name
    common = ["--yaml_config", yaml_path, "--config", name, "--inference_ic", "1"]
    runs = {"j": crossed["jp"].checkpoint_path, "t": str(crossed["port_ckpt"])}
    from makani_tpu.parallel import comm
    init = comm.init
    monkeypatch.setattr(comm, "init", lambda **kw: init(devices=jax.devices()[:1], **kw))
    for run, ckpt in runs.items():
        for mode in ("score", "epoch", "lite"):
            out = f"{run}_lite.nc" if mode == "lite" else f"{run}_pred.nc"
            argv = [*common, "--mode", mode, "--run_num", run, "--checkpoint_path", ckpt,
                    "--inference_output_path", str(tmp_path / out),
                    "--inference_target_path", str(tmp_path / f"{run}_targ.nc")]
            if run == "j":
                _run_jax_cli(argv)
            else:
                assert tinference.main([*argv, "--device", "cpu"]) == 0
    for i in range(len(CHANNELS)):
        for out in ("pred", "lite"):
            want = read_netcdf_var(str(tmp_path / f"j_{out}.nc"), f"var{i}")
            got = read_netcdf_var(str(tmp_path / f"t_{out}.nc"), f"var{i}")
            assert got.shape == want.shape == (3, NLAT, NLON)
            assert _rel(got, want) < SERVE_TOL, (out, i)
        np.testing.assert_array_equal(read_netcdf_var(str(tmp_path / "t_targ.nc"), f"var{i}"),
                                      read_netcdf_var(str(tmp_path / "j_targ.nc"), f"var{i}"))
    for fname in EXPORTS:
        want = np.load(exp / "j" / fname)
        got = np.load(exp / "t" / fname)
        assert got.shape == want.shape and np.isfinite(got).all(), fname
        assert _rel(got, want) < SERVE_TOL, fname
    assert os.path.exists(exp / "t" / "inference_out.log")


def test_inference_cli_refuses_model_parallelism(cli_config):
    """The h, w, fin and fout layouts are ported
    (tests/test_torch_port_parallel*.py, tests/test_torch_port_tensor_parallel.py);
    in a serial process each asks for the ranks that torchrun starts, as
    --split_data_channels changes nothing there."""
    from makani_tpu_torch import inference as tinference
    yaml_path, name = cli_config
    for flag in ("--fin_parallel_size", "--fout_parallel_size", "--h_parallel_size"):
        with pytest.raises(ValueError, match="ranks"):
            tinference.main(["--yaml_config", yaml_path, "--config", name, flag, "2",
                             "--split_data_channels", "--device", "cpu"])


# --------------------------------------------------------------------------
# model packages
# --------------------------------------------------------------------------

def _package_params(crossed, exp_dir, **overrides):
    """The port's resolved params of the small SFNO, for a package at
    exp_dir."""
    from makani_tpu_torch.models.model_registry import update_channel_params
    raw = dict(crossed["raw"], experiment_dir=str(exp_dir), **overrides)
    return update_channel_params(TParams.from_dict(raw), n_channels=len(CHANNELS))


def test_time_loop_matches_jax(crossed, tmp_path):
    """A package of each, the same weights as best_ckpt: three steps of
    physical fields from the same initial condition and time."""
    from makani_tpu.models.model_package import load_time_loop as jload_time_loop
    from makani_tpu.models.model_package import save_model_package as jsave_model_package
    from makani_tpu_torch.models.model_package import load_time_loop, save_model_package
    jpkg, tpkg = tmp_path / "jpkg", tmp_path / "tpkg"
    jparams = _jparams(dict(crossed["jp"].to_dict(), experiment_dir=str(jpkg)))
    jsave_model_package(jparams)
    jckpt.save_checkpoint(str(jpkg / "training_checkpoints" / "best_ckpt"),
                          crossed["jparams"], None, background=False)
    save_model_package(_package_params(crossed, tpkg))
    tckpt.save_checkpoint(str(tpkg / "training_checkpoints" / "best_ckpt"),
                          crossed["model"].state_dict())
    with open(tpkg / "metadata.json") as f:
        assert json.load(f)["entrypoint"]["name"] == \
            "makani_tpu_torch.models.model_package:load_time_loop"

    x = np.random.RandomState(3).randn(1, 1, len(CHANNELS), NLAT, NLON).astype(np.float32)
    t0 = datetime.datetime(2019, 5, 17, 6, tzinfo=datetime.timezone.utc)
    jloop = jload_time_loop(str(jpkg))
    loop = load_time_loop(str(tpkg), device="cpu")
    assert loop.in_channel_names == jloop.in_channel_names == CHANNELS
    assert loop.time_step == jloop.time_step
    for step, ((t, got), (jt, want)) in enumerate(zip(loop(x, t0), jloop(x, t0))):
        assert t == jt
        assert got.shape == want.shape == (1, len(CHANNELS), NLAT, NLON)
        assert _rel(got, want) < SERVE_TOL, step
        if step == 3:
            break


def _invariants(root, suffix):
    """Orography and land-sea mask fields written as .npy or NetCDF."""
    rng = np.random.RandomState(9)
    oro = rng.rand(NLAT, NLON).astype(np.float32)
    lsm = (rng.rand(NLAT, NLON) > 0.5).astype(np.float32)
    paths = {}
    for stem, name, field in (("oro", "orography", oro), ("lsm", "lsm", lsm)):
        path = root / f"{stem}{suffix}"
        if suffix == ".npy":
            np.save(path, field)
        else:
            write_netcdf(str(path), {name: (("lat", "lon"), field, None)},
                         {"lat": np.arange(NLAT), "lon": np.arange(NLON)})
        paths[stem] = str(path)
    return paths


def test_package_invariant_layouts(crossed, tmp_path):
    """The port names .npy invariants orography.npy / land_mask.npy and
    NetCDF ones orography.nc / land_mask.nc (makani_tpu's names); both
    packages rebuild the same static features. makani_tpu copies a .npy
    source to orography.nc, which the port's reader takes for NetCDF
    (ROADMAP Queue 3)."""
    from makani_tpu.models.model_package import save_model_package as jsave_model_package
    from makani_tpu_torch.models.model_package import load_model_package, save_model_package
    from makani_tpu_torch.utils.conditioning_inputs import get_orography
    features = {}
    for suffix in (".npy", ".nc"):
        paths = _invariants(tmp_path, suffix)
        pkg = tmp_path / f"pkg{suffix}"
        save_model_package(_package_params(crossed, pkg, add_orography=True, add_landmask=True,
                                           orography_path=paths["oro"],
                                           landmask_path=paths["lsm"]))
        assert {"orography" + suffix, "land_mask" + suffix} <= set(os.listdir(pkg))
        wrapper = load_model_package(str(pkg), pretrained=False, device="cpu")
        assert wrapper.params.orography_path == str(pkg / ("orography" + suffix))
        features[suffix] = wrapper.model.preprocessor.static_features
    assert features[".npy"].shape == (1, 3, NLAT, NLON)
    assert torch.equal(features[".npy"], features[".nc"])

    jpkg = tmp_path / "jpkg"
    jsave_model_package(_jparams(dict(crossed["jp"].to_dict(), experiment_dir=str(jpkg),
                                      add_orography=True, add_landmask=True,
                                      orography_path=str(tmp_path / "oro.npy"),
                                      landmask_path=str(tmp_path / "lsm.npy"))))
    assert {"orography.nc", "land_mask.nc"} <= set(os.listdir(jpkg))
    with pytest.raises(OSError):
        get_orography(str(jpkg / "orography.nc"))


# --------------------------------------------------------------------------
# Predict
# --------------------------------------------------------------------------

def test_predict_run_matches_jax(cli_config, crossed, tmp_path):
    """Predict.run of two initial conditions from an HDF5 file, the port's
    through its CLI (`main`, the best checkpoint in the experiment dir):
    the NetCDF files' fields, time axes and attributes."""
    import shutil
    import h5py
    from makani_tpu.predict import Predict as JPredict
    from makani_tpu_torch import predict as tpredict
    rng = np.random.RandomState(4)
    ic_path = tmp_path / "ics.h5"
    with h5py.File(ic_path, "w") as f:
        f.create_dataset("fields", data=rng.randn(3, len(CHANNELS), NLAT, NLON).astype(np.float32))
    lat, lon = _lat_lon()
    cfg = dict(crossed["raw"], lat=lat, lon=lon, predict_ic_path=str(ic_path),
               predict_ic_mode="incontinuous", predict_ic_list=[2, 0], prediction_length=3,
               predict_ic_year=2019,
               best_checkpoint_path=crossed["jp"].checkpoint_path)
    JPredict(_jparams(dict(cfg, predict_output_dir=str(tmp_path / "j")))).run()
    tcfg = dict(cfg, predict_output_dir=str(tmp_path / "t"), exp_dir=str(tmp_path / "exp"),
                metadata_json_path=str(crossed["root"] / "data.json"))
    for key in ("lat", "lon", "best_checkpoint_path"):
        tcfg.pop(key)  # from data.json and the experiment dir
    with open(tmp_path / "predict.yaml", "w") as f:
        yaml.safe_dump({"predict": tcfg}, f)
    shutil.copytree(crossed["port_ckpt"],
                    tmp_path / "exp" / "predict" / "0" / "training_checkpoints" / "best_ckpt")
    assert tpredict.main(["--yaml_config", str(tmp_path / "predict.yaml"), "--config", "predict",
                          "--run_num", "0", "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == ["prediction_ic0.nc", "prediction_ic2.nc"]
    for ic in (0, 2):
        want_path = str(tmp_path / "j" / f"prediction_ic{ic}.nc")
        got_path = str(tmp_path / "t" / f"prediction_ic{ic}.nc")
        for dim in ("time", "lat", "lon"):
            np.testing.assert_array_equal(read_netcdf_var(got_path, dim),
                                          read_netcdf_var(want_path, dim))
        for name in CHANNELS:
            got, want = read_netcdf_var(got_path, name), read_netcdf_var(want_path, name)
            assert got.shape == want.shape == (3, NLAT, NLON)
            assert _rel(got, want) < SERVE_TOL, (ic, name)
        with h5py.File(got_path) as g, h5py.File(want_path) as w:
            assert g.attrs["ic_index"] == w.attrs["ic_index"] == ic
            assert g.attrs["time_units"] == w.attrs["time_units"]


# --------------------------------------------------------------------------
# the reference-checkpoint converter
# --------------------------------------------------------------------------

def test_convert_torch_checkpoint_matches_jax(tmp_path):
    """A reference-style ckpt_mp0.tar (tests/test_convert_checkpoint.py's
    state dict) through makani_tpu's converter (orbax) and the port's: the
    same parameters bit for bit, the same counters."""
    from makani_tpu.models import model_registry as jregistry
    from makani_tpu.tools.convert_torch_checkpoint import convert as jconvert
    from makani_tpu_torch.models.model_registry import get_model, update_channel_params
    from makani_tpu_torch.tools.convert_torch_checkpoint import convert
    from test_convert_checkpoint import _fake_reference_state
    from testutils import get_default_parameters

    embed, chans, layers = 8, 3, 2
    params = get_default_parameters()
    params.update_params({
        "nettype": "SFNO", "in_channels": [0, 1, 2], "out_channels": [0, 1, 2],
        "channel_names": ["u10m", "v10m", "t2m"], "img_shape_x": 16, "img_shape_y": 32,
        "embed_dim": embed, "num_layers": layers, "scale_factor": 2,
        "normalization_layer": "instance_norm", "hard_thresholding_fraction": 1.0,
        "use_mlp": True, "mlp_ratio": 2.0, "activation_function": "gelu",
        "pos_embed": "none", "operator_type": "dhconv", "filter_type": "linear",
    })
    raw = params.to_dict()
    params.img_crop_shape_x, params.img_crop_shape_y = 16, 32
    params.img_crop_offset_x = params.img_crop_offset_y = 0
    params.N_in_channels = params.N_out_channels = chans

    sd = _fake_reference_state(embed, chans, layers, lmax=8)
    tar = tmp_path / "ckpt_mp0.tar"
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in sd.items()},
                "iters": 7, "epoch": 3}, str(tar))

    missing, unused = jconvert(str(tar), str(tmp_path / "jax"), params)
    assert not missing and not unused
    jckpt.wait_for_saves()
    jmodel = jregistry.get_model(params)
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jax.numpy.zeros((1, chans, 16, 32)))
    jrestored, _, jcounters = jckpt.restore_checkpoint(str(tmp_path / "jax"), template["params"])

    tp = update_channel_params(TParams.from_dict(raw))
    convert(str(tar), str(tmp_path / "port"), tp)
    template = get_model(tp, device="cpu").state_dict()
    restored, _, counters = tckpt.restore_checkpoint(str(tmp_path / "port"), template)
    assert counters == jcounters == {"iters": 7, "epoch": 3}
    want = _as_port(jrestored)
    assert set(restored) == set(want)
    for k, v in restored.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)

    # a map that leaves a parameter uncovered raises
    del sd["module.model.residual_transform.weight"]
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in sd.items()}}, str(tar))
    with pytest.raises(KeyError, match="residual_transform"):
        convert(str(tar), str(tmp_path / "port2"), tp)


# --------------------------------------------------------------------------
# imports, h5py and the device
# --------------------------------------------------------------------------

SLICE_MODULES = ("makani_tpu_torch.utils.metric", "makani_tpu_torch.utils.metrics",
                 "makani_tpu_torch.utils.checkpoint", "makani_tpu_torch.utils.nctools",
                 "makani_tpu_torch.utils.logging_utils", "makani_tpu_torch.inference",
                 "makani_tpu_torch.predict", "makani_tpu_torch.models.model_package",
                 "makani_tpu_torch.tools.convert_torch_checkpoint")


def test_slice_modules_import_without_h5py_or_jax(tmp_path):
    """Every module of the serving slice imports in a process where h5py
    cannot be imported and brings in no JAX or makani_tpu; each function
    that needs h5py raises ImportError naming what it was for."""
    code = (
        "import sys, types, importlib; sys.modules['h5py'] = None\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'makani_tpu'))\n"
        "assert not bad, bad\n"
        "import numpy as np\n"
        "from makani_tpu_torch.utils import nctools\n"
        "from makani_tpu_torch.predict import Predict\n"
        f"p = {str(tmp_path / 'x.nc')!r}\n"
        "calls = [(lambda: nctools.write_prediction_file(p, np.zeros((1, 1, 2, 2))), 'writing NetCDF'),\n"
        "         (lambda: nctools.read_netcdf_var(p, 'v'), 'reading NetCDF'),\n"
        "         (lambda: nctools.var_shape(p, 'v'), 'reading NetCDF'),\n"
        "         (lambda: nctools.create_netcdf(p, 'v', (2,), ['t']), 'writing NetCDF'),\n"
        "         (lambda: Predict._read_ic(types.SimpleNamespace(params=types.SimpleNamespace(\n"
        "             predict_ic_path=p)), 0), 'reading initial conditions')]\n"
        "for call, what in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert what in str(e) and 'h5py' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(what)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": root})


def test_serving_entry_points_need_cuda_unless_cpu(cli_config, crossed, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    from makani_tpu_torch import inference as tinference
    from makani_tpu_torch.models.model_package import load_model_package, save_model_package
    from makani_tpu_torch.predict import Predict
    from makani_tpu_torch.utils.inferencer import Inferencer
    yaml_path, name = cli_config
    with pytest.raises(RuntimeError, match="CUDA"):
        tinference.main(["--yaml_config", yaml_path, "--config", name, "--mode", "epoch",
                         "--run_num", "nocuda", "--checkpoint_path", str(crossed["port_ckpt"])])
    with pytest.raises(RuntimeError, match="CUDA"):
        Inferencer(TParams.from_dict(dict(crossed["raw"])))
    save_model_package(_package_params(crossed, tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model_package(str(tmp_path), pretrained=False)
    lat, lon = _lat_lon()
    with pytest.raises(RuntimeError, match="CUDA"):
        Predict(TParams.from_dict(dict(crossed["raw"], lat=lat, lon=lon,
                                       best_checkpoint_path=str(crossed["port_ckpt"]))))
