"""makani_tpu_torch's data-preparation tools against makani_tpu's on the CPU.

Each tool of makani_tpu_torch/tools (and the convert_legacy_to_flexible CLI)
runs beside its makani_tpu counterpart on the same small HDF5, NetCDF and
npy inputs, made from a seed. The tools copy makani_tpu's arithmetic, so
the outputs are held equal, not close: npy and JSON files byte for byte;
HDF5 files object by object (the same datasets and groups, their dtypes,
shapes, chunks and values, NaN where NaN, and the same attributes on every
object and on the file); checkpoints tensor for tensor. zarr and cdsapi are
not installed: zarr_convert runs under tests/test_zarr.py's writeable zarr
stub and get_era5_data under a stub cdsapi that records its retrievals.
Nothing reaches the network.
"""

import json
import os
import runpy
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = tuple(f"makani_tpu_torch.tools.{m}" for m in (
    "make_era5_metadata", "h5_convert", "h5_align", "get_stats", "get_histograms",
    "create_merged", "parallel_copy", "zarr_convert", "get_era5_data")) + (
    "makani_tpu_torch.convert_legacy_to_flexible", "makani_tpu_torch.utils.visualize",
    "makani_tpu_torch.utils.wandb_compat", "makani_tpu_torch.utils.nctools",
    "makani_tpu_torch.utils.trainer", "makani_tpu_torch.utils.inferencer")


def _tools(name):
    """(makani_tpu's module, the port's) of tool `name`."""
    import importlib
    return (importlib.import_module(f"makani_tpu.tools.{name}"),
            importlib.import_module(f"makani_tpu_torch.tools.{name}"))


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _plain(f, v):
    """An attribute value in plain Python, each object reference (the
    dimension scales' DIMENSION_LIST and REFERENCE_LIST) as the name of the
    object it points to."""
    if isinstance(v, h5py.Reference):
        return f[v].name
    if isinstance(v, (np.ndarray, list, tuple, np.void)):
        return [_plain(f, x) for x in v]
    return v.item() if isinstance(v, np.generic) else v


def _attrs(obj):
    return {k: _plain(obj.file, v) for k, v in obj.attrs.items()}


def _assert_h5_equal(got, want):
    """The same objects, each dataset's dtype, shape, chunks and values (NaN
    for NaN), and the same attributes everywhere."""
    with h5py.File(got, "r") as g, h5py.File(want, "r") as w:
        names = []
        w.visit(names.append)
        got_names = []
        g.visit(got_names.append)
        assert sorted(got_names) == sorted(names)
        assert _attrs(g) == _attrs(w)
        for name in names:
            a, b = g[name], w[name]
            assert type(a) is type(b), name
            assert _attrs(a) == _attrs(b), name
            if isinstance(b, h5py.Dataset):
                assert (a.dtype, a.shape, a.chunks) == (b.dtype, b.shape, b.chunks), name
                np.testing.assert_array_equal(a[()], b[()], err_msg=name)


def _write_years(root, years=(2017, 2018), shape=(5, 3, 8, 16), seed=0, extras=True):
    """Yearly ????.h5 files of a 'fields' dataset (and, with `extras`, a
    sibling dataset and attributes on the file and on the dataset)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, year in enumerate(years):
        path = os.path.join(root, f"{year}.h5")
        with h5py.File(path, "w") as f:
            data = (rng.randn(*shape) * (1 + np.arange(shape[1]))[:, None, None]
                    + 10 * i).astype(np.float32)
            d = f.create_dataset("fields", data=data)
            if extras:
                d.attrs["units"] = "K"
                f.create_dataset("timestamp", data=np.arange(shape[0], dtype=np.float64))
                f.attrs["source"] = "synthetic"
                f.attrs["levels"] = np.array([500, 850])
        paths.append(path)
    return paths


# --------------------------------------------------------------------------
# metadata, conversion and alignment
# --------------------------------------------------------------------------

def test_make_era5_metadata_same_bytes(tmp_path):
    jtool, ttool = _tools("make_era5_metadata")
    assert ttool.era5_channel_names() == jtool.era5_channel_names()
    assert len(ttool.era5_channel_names()) == 8 + 5 * 13
    for kwargs in (dict(), dict(nlat=73, nlon=144, dhours=3, channels=["a", "b"], name="x")):
        want = jtool.make_metadata(str(tmp_path / "j.json"), **kwargs)
        got = ttool.make_metadata(str(tmp_path / "t.json"), **kwargs)
        assert got == want
        assert _same_bytes(tmp_path / "t.json", tmp_path / "j.json")
    ttool.main(["--output", str(tmp_path / "cli" / "data.json"), "--nlat", "73", "--nlon", "144",
                "--dhours", "3"])
    jtool.make_metadata(str(tmp_path / "cli.json"), 73, 144, 3)
    assert _same_bytes(tmp_path / "cli" / "data.json", tmp_path / "cli.json")


@pytest.mark.parametrize("kwargs", [dict(), dict(chunk_channels=2, batch=2, dtype="float16")],
                         ids=["default", "float16_2ch"])
def test_h5_convert_matches_jax(tmp_path, kwargs):
    jtool, ttool = _tools("h5_convert")
    _write_years(str(tmp_path / "src"))
    jouts = jtool.convert_dir(str(tmp_path / "src"), str(tmp_path / "jax"), **kwargs)
    touts = ttool.convert_dir(str(tmp_path / "src"), str(tmp_path / "port"), **kwargs)
    assert [os.path.basename(p) for p in touts] == [os.path.basename(p) for p in jouts] == [
        "2017.h5", "2018.h5"]
    for got, want in zip(touts, jouts):
        _assert_h5_equal(got, want)
    with h5py.File(touts[0], "r") as f:
        assert f["fields"].chunks == (1, kwargs.get("chunk_channels", 1), 8, 16)
    # the CLI on one file
    ttool.main(["--src", str(tmp_path / "src" / "2017.h5"), "--dst", str(tmp_path / "one.h5"),
                "--chunk_channels", "3"])
    jtool.convert_file(str(tmp_path / "src" / "2017.h5"), str(tmp_path / "jone.h5"),
                       chunk_channels=3)
    _assert_h5_equal(str(tmp_path / "one.h5"), str(tmp_path / "jone.h5"))


def test_h5_align_and_verify_match_jax(tmp_path, capsys):
    jtool, ttool = _tools("h5_align")
    src = _write_years(str(tmp_path / "src"), years=(1979,), shape=(6, 3, 8, 16),
                       extras=False)[0]
    for transpose in (False, True):
        tag = "nhwc" if transpose else "nchw"
        want, got = str(tmp_path / f"j_{tag}.h5"), str(tmp_path / f"t_{tag}.h5")
        jtool.align_file(src, want, batch_size=4, transpose=transpose)
        ttool.align_file(src, got, batch_size=4, transpose=transpose)
        _assert_h5_equal(got, want)
        assert ttool.verify_file(got) == jtool.verify_file(want)
        shape, offset, aligned = ttool.verify_file(got)
        assert aligned and offset % 4096 == 0 and offset > 0
    # main: convert a directory, skip what is there, then verify it
    args = ttool.parse_args(["--input_dir", str(tmp_path / "src"),
                             "--output_dir", str(tmp_path / "out"), "--batch_size", "4"])
    ttool.main(args)
    _assert_h5_equal(str(tmp_path / "out" / "1979.h5"), str(tmp_path / "j_nchw.h5"))
    ttool.main(args)
    assert "already exists, skipping" in capsys.readouterr().out
    ttool.main(ttool.parse_args(["--input_dir", str(tmp_path / "out"), "--output_dir",
                                 str(tmp_path / "unused"), "--verify_integrity"]))
    assert "aligned=True" in capsys.readouterr().out
    with pytest.raises(IOError, match="no h5 files"):
        ttool.main(ttool.parse_args(["--input_dir", str(tmp_path / "unused"),
                                     "--output_dir", str(tmp_path / "x")]))


# --------------------------------------------------------------------------
# statistics and histograms
# --------------------------------------------------------------------------

STATS_FILES = ("global_means.npy", "global_stds.npy", "mins.npy", "maxs.npy", "time_means.npy",
               "time_diff_means.npy", "time_diff_stds.npy")


@pytest.mark.parametrize("rule", ["naive", "legendre-gauss"])
def test_get_stats_same_bytes_with_1_and_2_workers(tmp_path, rule):
    """The seven npy files byte for byte with 1 and 2 workers (3 years, a
    batch that does not divide a year)."""
    jtool, ttool = _tools("get_stats")
    data = str(tmp_path / "data")
    _write_years(data, years=(2016, 2017, 2018), shape=(5, 3, 8, 16), seed=3)
    for workers in (1, 2):
        want, got = tmp_path / f"j{workers}", tmp_path / f"t{workers}"
        jtool.compute_stats(data, str(want), quadrature_rule=rule, batch=2, workers=workers)
        ttool.compute_stats(data, str(got), quadrature_rule=rule, batch=2, workers=workers)
        for name in STATS_FILES:
            assert _same_bytes(got / name, want / name), (workers, name)
    assert np.load(got / "time_means.npy").shape == (1, 3, 8, 16)
    assert np.load(got / "global_stds.npy").shape == (1, 3, 1, 1)
    # the Welford merge of partial statistics equals one pass over all
    parts = [ttool._file_stats((p, "fields", rule, 2)) for p in sorted(
        os.path.join(data, f) for f in os.listdir(data))]
    merged = ttool._merge(ttool._merge(ttool._merge(None, parts[0]), parts[1]), parts[2])
    assert merged["count"] == 15 and merged["dcount"] == 12
    ttool.main(["--data_dir", data, "--output_dir", str(tmp_path / "cli"),
                "--quadrature_rule", rule, "--batch", "2", "--workers", "1"])
    for name in STATS_FILES:
        assert _same_bytes(tmp_path / "cli" / name, tmp_path / "j1" / name), name
    with pytest.raises(IOError, match="no yearly h5 files"):
        ttool.compute_stats(str(tmp_path / "j1"), str(tmp_path / "x"))


def test_get_histograms_same_bytes(tmp_path, monkeypatch):
    """histograms.npy and histogram_bin_edges.npy byte for byte, with 1 and 2
    workers and with reads of 2 steps (the streamed chunks)."""
    jtool, ttool = _tools("get_histograms")
    data = str(tmp_path / "data")
    _write_years(data, years=(2017, 2018), shape=(5, 3, 8, 16), seed=4)
    for workers in (1, 2):
        want, got = tmp_path / f"j{workers}", tmp_path / f"t{workers}"
        jtool.compute_histograms(data, str(want), bins=17, workers=workers)
        ttool.compute_histograms(data, str(got), bins=17, workers=workers)
        for name in ("histograms.npy", "histogram_bin_edges.npy"):
            assert _same_bytes(got / name, want / name), (workers, name)
    hist = np.load(got / "histograms.npy")
    assert hist.shape == (3, 17) and (hist.sum(axis=1) == 2 * 5 * 8 * 16).all()
    with h5py.File(os.path.join(data, "2017.h5"), "r") as f:
        assert ttool._chunk_steps(f["fields"]) == jtool._chunk_steps(f["fields"])
        monkeypatch.setattr(ttool, "_DEFAULT_CHUNK_BYTES", 2 * 3 * 8 * 16 * 4)
        assert ttool._chunk_steps(f["fields"]) == 2
    edges = np.load(got / "histogram_bin_edges.npy")
    counts = ttool._file_histogram((os.path.join(data, "2017.h5"), "fields", edges))
    want = jtool._file_histogram((os.path.join(data, "2017.h5"), "fields", edges))
    np.testing.assert_array_equal(counts, want)


# --------------------------------------------------------------------------
# the merged ERA5 + HYCOM files and the parallel assembly
# --------------------------------------------------------------------------

def _write_source(path, name, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=data)


def test_create_merged_end_to_end_matches_jax(tmp_path):
    """tests/test_tools.py's end-to-end case through both tools: the same
    NetCDF file (fields with ssh's masked cells filled, the time axis, the
    descending latitudes, the f{i:02d} attributes)."""
    jtool, ttool = _tools("create_merged")
    year, dlat, nt, ny, nx = 2015, 30.0, 1460, 7, 12
    rng = np.random.RandomState(1)
    u10 = rng.randn(nt, ny, nx).astype(np.float32)
    ssh = rng.randn(nt, 1, ny, nx).astype(np.float32)  # a singleton level axis
    ssh[:, :, 2:4, 3:6] = 99.0
    src = tmp_path / "source"
    _write_source(src / "ERA5" / str(year) / f"ERA5_u10_{year}_6h.nc", "u10", u10)
    _write_source(src / "HYCOM" / "ssh" / f"ssh_{year}.nc", "ssh", ssh)
    for tool, out in ((jtool, "jax"), (ttool, "port")):
        tool.run(year, str(tmp_path / out / f"{year}.nc"), str(src), ["u10", "ssh@HYCOM"],
                 num_smooths=10, time_chunk=512, dlat=dlat)
    got, want = str(tmp_path / "port" / f"{year}.nc"), str(tmp_path / "jax" / f"{year}.nc")
    _assert_h5_equal(got, want)
    with h5py.File(got, "r") as f:
        assert f["fields"].shape == (nt, 2, ny, nx) and np.isfinite(f["fields"][:, 1]).all()
        assert (f["fields"].attrs["f00"], f["fields"].attrs["f01"]) == ("u10", "ssh")
        assert f["latitude"][0] == 90.0 and f["latitude"][-1] == -90.0
    # the pieces
    field = rng.randn(9, 16).astype(np.float32)
    field[3:6, 4:12] = np.nan
    np.testing.assert_array_equal(ttool.fill_nans_2d(field, 7), jtool.fill_nans_2d(field, 7))
    assert ttool.Variable.parse("mslp:msl@era5") == ttool.Variable("mslp", "ERA5", "msl")
    assert [ttool.is_leap(y) for y in (1900, 2000, 2015, 2016)] == [False, True, False, True]
    for spec in ("u10", "ssh@HYCOM"):
        assert ttool.source_path("r", ttool.Variable.parse(spec), year) == jtool.source_path(
            "r", jtool.Variable.parse(spec), year)
    with pytest.raises(ValueError, match="Unknown source"):
        ttool.source_path("r", ttool.Variable.parse("x@GFS"), year)


def test_create_merged_partial_write_and_validation_match_jax(tmp_path):
    """tests/test_tools.py's partial-write case: only u10 written, ssh's slot
    NaN and its missing source not checked; then a source of the wrong shape
    refused before any write, by both."""
    jtool, ttool = _tools("create_merged")
    year, dlat, nt, ny, nx = 2016, 30.0, 1464, 7, 12
    src = tmp_path / "source"
    p = src / "ERA5" / str(year) / f"ERA5_u10_{year}_6h.nc"
    _write_source(p, "u10", np.ones((nt, ny, nx), np.float32))
    for tool, out in ((jtool, "jax"), (ttool, "port")):
        tool.run(year, str(tmp_path / out / f"{year}.nc"), str(src), ["u10", "ssh@HYCOM"],
                 partial=["u10"], num_smooths=2, dlat=dlat)
    got = str(tmp_path / "port" / f"{year}.nc")
    _assert_h5_equal(got, str(tmp_path / "jax" / f"{year}.nc"))
    with h5py.File(got, "r") as f:
        assert (f["fields"][:, 0] == 1.0).all() and np.isnan(f["fields"][:, 1]).all()
    _write_source(p, "u10", np.ones((nt, ny, nx - 1), np.float32))
    for tool in (jtool, ttool):
        with pytest.raises(ValueError, match="shape"):
            tool.run(year, str(tmp_path / "bad.nc"), str(src), ["u10"], num_smooths=2, dlat=dlat)
    with pytest.raises(FileNotFoundError):
        ttool.run(year, str(tmp_path / "bad.nc"), str(src), ["v10"], dlat=dlat)
    # the CLI, and overwrite=False leaves an existing file alone
    _write_source(p, "u10", np.full((nt, ny, nx), 2.0, np.float32))
    ttool.main(["--year", str(year), "--output", got, "--source-root", str(src),
                "--variables", "u10", "--dlat", str(dlat)])
    before = os.path.getmtime(got)
    ttool.run(year, got, str(src), ["u10"], dlat=dlat, overwrite=False)
    assert os.path.getmtime(got) == before
    with h5py.File(got, "r") as f:
        assert f["fields"].shape == (nt, 1, ny, nx) and (f["fields"][()] == 2.0).all()


def test_parallel_copy_matches_jax(tmp_path):
    jtool, ttool = _tools("parallel_copy")
    rng = np.random.RandomState(2)
    nt, ny, nx = 10, 6, 12
    plan = []
    for ch, name in enumerate(("u", "v", "z")):
        p = tmp_path / f"{name}.nc"
        shape = (nt, 1, ny, nx) if name == "z" else (nt, ny, nx)
        _write_source(p, name, rng.randn(*shape).astype(np.float32))
        plan.append({"src": str(p), "var": name, "channel": 2 - ch})
    jtool.parallel_copy(plan, str(tmp_path / "j.h5"), n_channels=4, workers=2, batch=3)
    ttool.parallel_copy(plan, str(tmp_path / "t.h5"), n_channels=4, workers=2, batch=3)
    _assert_h5_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    ttool.main(["--plan", str(tmp_path / "plan.json"), "--dest", str(tmp_path / "cli.h5"),
                "--n-channels", "4", "--workers", "1", "--batch", "4"])
    _assert_h5_equal(str(tmp_path / "cli.h5"), str(tmp_path / "j.h5"))


# --------------------------------------------------------------------------
# zarr, the ERA5 download plan, the legacy checkpoint CLI
# --------------------------------------------------------------------------

def _writeable_zarr_stub():
    """tests/test_zarr.py's writeable stub: a group is a directory, an array
    an .npy memmap with a dict of attributes."""
    stub = types.ModuleType("zarr")

    class _Array:
        def __init__(self, path, shape, dtype, chunks):
            self._mm = np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape)
            self.chunks = chunks
            self.attrs = {}

        def __setitem__(self, k, v):
            self._mm[k] = v

    class _Group:
        def __init__(self, path):
            self.path = path
            self.arrays = {}

        def create_array(self, name, shape=None, dtype=None, chunks=None):
            self.arrays[name] = _Array(os.path.join(self.path, name + ".npy"), shape, dtype,
                                       chunks)
            return self.arrays[name]

    def open_group(path, mode="w"):
        os.makedirs(path, exist_ok=True)
        stub.groups[path] = _Group(path)
        return stub.groups[path]

    stub.open_group = open_group
    stub.groups = {}
    return stub


def test_zarr_convert_under_the_stub_matches_jax(tmp_path, monkeypatch, capsys):
    jtool, ttool = _tools("zarr_convert")
    src = _write_years(str(tmp_path / "h5"), years=(2018,), shape=(5, 3, 8, 16))[0]
    meta = {"coords": {"channel": ["a", "b", "c"], "lat": [1.0, 2.0], "lon": [],
                       "grid_type": "equiangular"}}
    stub = _writeable_zarr_stub()
    monkeypatch.setitem(sys.modules, "zarr", stub)
    for tool, out in ((jtool, "jax"), (ttool, "port")):
        dst = str(tmp_path / out / "2018.zarr")
        assert tool.convert_file(src, dst, "fields", metadata=meta, time_chunk=2) == dst
    got, want = (stub.groups[str(tmp_path / out / "2018.zarr")].arrays["fields"]
                 for out in ("port", "jax"))
    assert got.chunks == want.chunks == (2, 3, 8, 16)
    assert got.attrs == want.attrs and "lon" not in got.attrs
    assert _same_bytes(tmp_path / "port" / "2018.zarr" / "fields.npy",
                       tmp_path / "jax" / "2018.zarr" / "fields.npy")
    # an existing store is kept without overwrite, replaced with it
    ttool.convert_file(src, str(tmp_path / "port" / "2018.zarr"))
    assert "already exists, skipping" in capsys.readouterr().out
    ttool.main(["--input_dir", str(tmp_path / "h5"), "--output_dir", str(tmp_path / "port"),
                "--time_chunk", "4", "--overwrite"])
    assert stub.groups[str(tmp_path / "port" / "2018.zarr")].arrays["fields"].chunks == (
        4, 3, 8, 16)
    # without zarr: the CLI exits with makani_tpu's message, the function
    # raises ImportError naming the tool
    monkeypatch.setitem(sys.modules, "zarr", None)
    with pytest.raises(SystemExit, match="zarr is not installed"):
        ttool.main(["--input_dir", str(tmp_path / "h5"), "--output_dir", str(tmp_path / "x")])
    with pytest.raises(ImportError, match="zarr_convert"):
        ttool.convert_file(src, str(tmp_path / "x.zarr"))


def test_get_era5_data_plan_dry_run_and_stub_cdsapi(tmp_path, monkeypatch, capsys):
    jtool, ttool = _tools("get_era5_data")
    argv = ["--output_dir", str(tmp_path), "--years", "2018", "2019", "--pressure_level",
            "500", "850", "--hourly_subsample", "6"]
    args = ttool.parse_args(argv)
    plan = ttool.build_plan(str(tmp_path), [2018, 2019], [500, 850], 6, 0.25, False)
    assert plan == jtool.build_plan(str(tmp_path), [2018, 2019], [500, 850], 6, 0.25, False)
    assert len(plan) == 2 * 12 * 3
    assert plan[0][1]["time"] == ["00:00", "06:00", "12:00", "18:00"]
    # an existing file drops out of the plan, unless overwrite
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "sfc_2018-01.nc").write_bytes(b"old")
    assert len(ttool.build_plan(str(tmp_path), [2018, 2019], [500, 850], 6, 0.25, False)) == 71
    assert len(ttool.build_plan(str(tmp_path), [2018, 2019], [500, 850], 6, 0.25, True)) == 72

    # the dry run prints the plan, as makani_tpu's does, and deletes nothing
    dry = ttool.parse_args(argv + ["--dry_run", "--overwrite"])
    ttool.main(dry)
    got = capsys.readouterr().out
    jtool.main(dry)
    assert got == capsys.readouterr().out and got.startswith("72 retrievals to run")
    assert (raw / "sfc_2018-01.nc").read_bytes() == b"old"

    # without cdsapi: makani_tpu's RuntimeError
    monkeypatch.setitem(sys.modules, "cdsapi", None)
    errors = []
    for tool in (jtool, ttool):
        with pytest.raises(RuntimeError, match="cdsapi") as e:
            tool.main(args)
        errors.append(str(e.value))
    assert errors[0] == errors[1]

    # a stub client records the retrievals; overwrite removes the old file
    # just before its retrieval
    calls = []

    class Client:
        def retrieve(self, name, request, target):
            calls.append((name, request, target, os.path.exists(target)))

    monkeypatch.setitem(sys.modules, "cdsapi", types.SimpleNamespace(Client=Client))
    ttool.main(ttool.parse_args(argv + ["--overwrite"]))
    port_calls = list(calls)
    calls.clear()
    (raw / "sfc_2018-01.nc").write_bytes(b"old")
    jtool.main(ttool.parse_args(argv + ["--overwrite"]))
    assert port_calls == calls and len(calls) == 72
    assert {c[0] for c in calls} == {"reanalysis-era5-complete"}
    assert not any(c[3] for c in calls)


def test_convert_legacy_to_flexible_cli_matches_jax(tmp_path, monkeypatch):
    """A reference-style ckpt_mp0.tar through makani_tpu's
    convert_legacy_to_flexible CLI (orbax) and the port's (its checkpoint
    format): the same parameters bit for bit and the same counters."""
    import jax
    from makani_tpu.models import model_registry as jregistry
    from makani_tpu.utils import checkpoint as jckpt
    from makani_tpu_torch.models.model_registry import get_model, update_channel_params
    from makani_tpu_torch.utils import checkpoint as tckpt
    from makani_tpu_torch.utils.yparams import YParams as TParams
    from test_convert_checkpoint import _fake_reference_state
    from test_torch_port_train import _as_port
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
        "img_crop_shape_x": 16, "img_crop_shape_y": 32, "img_crop_offset_x": 0,
        "img_crop_offset_y": 0, "N_in_channels": chans, "N_out_channels": chans})
    config = tmp_path / "small.yaml"
    config.write_text(yaml.safe_dump({"small": params.to_dict()}))
    sd = _fake_reference_state(embed, chans, layers, lmax=8)
    tar = tmp_path / "ckpt_mp0.tar"
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in sd.items()},
                "iters": 7, "epoch": 3}, str(tar))

    for module, out in (("makani_tpu.convert_legacy_to_flexible", "jax"),
                        ("makani_tpu_torch.convert_legacy_to_flexible", "port")):
        monkeypatch.setattr(sys, "argv", [module, "--input", str(tar), "--output",
                                          str(tmp_path / out), "--yaml_config", str(config),
                                          "--config", "small"])
        sys.modules.pop(module, None)
        runpy.run_module(module, run_name="__main__")
    jckpt.wait_for_saves()
    jmodel = jregistry.get_model(params)
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jax.numpy.zeros((1, chans, 16, 32)))
    jrestored, _, jcounters = jckpt.restore_checkpoint(str(tmp_path / "jax"), template["params"])
    tp = update_channel_params(TParams.from_dict(params.to_dict()))
    template = get_model(tp, device="cpu").state_dict()
    restored, _, counters = tckpt.restore_checkpoint(str(tmp_path / "port"), template)
    assert counters == jcounters == {"iters": 7, "epoch": 3}
    want = _as_port(jrestored)
    assert set(restored) == set(want)
    for k, v in restored.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


# --------------------------------------------------------------------------
# imports
# --------------------------------------------------------------------------

def test_new_modules_import_without_h5py_or_jax(tmp_path):
    """Every module of this slice imports in a process where h5py, zarr,
    jax, flax, orbax and makani_tpu cannot be imported, and brings none of
    them in; each tool that needs h5py raises ImportError naming the tool
    when it is used."""
    code = (
        "import sys, importlib\n"
        "for m in ('h5py', 'zarr', 'jax', 'flax', 'orbax', 'makani_tpu'): sys.modules[m] = None\n"
        f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None and m.split('.')[0] "
        "in ('jax', 'flax', 'orbax', 'makani_tpu', 'h5py', 'matplotlib', 'PIL'))\n"
        "assert not bad, bad\n"
        "from makani_tpu_torch.tools import (create_merged, get_histograms, get_stats, h5_align,\n"
        "    h5_convert, parallel_copy, zarr_convert)\n"
        f"d = {str(tmp_path)!r}\n"
        "open(d + '/2018.h5', 'wb').close()\n"
        "calls = [(lambda: h5_convert.convert_file(d + '/2018.h5', d + '/o.h5'), 'h5_convert'),\n"
        "         (lambda: h5_align.align_file(d + '/2018.h5', d + '/o.h5'), 'h5_align'),\n"
        "         (lambda: h5_align.verify_file(d + '/2018.h5'), 'h5_align'),\n"
        "         (lambda: get_stats.compute_stats(d, d + '/s', workers=1), 'get_stats'),\n"
        "         (lambda: get_histograms._channel_minmax((d + '/2018.h5', 'fields')),\n"
        "          'get_histograms'),\n"
        "         (lambda: parallel_copy.parallel_copy([{'src': d + '/2018.h5', 'var': 'u',\n"
        "                                                'channel': 0}], d + '/o.h5', 1),\n"
        "          'parallel_copy'),\n"
        "         (lambda: zarr_convert.convert_file(d + '/2018.h5', d + '/o.zarr'),\n"
        "          'zarr_convert'),\n"
        "         (lambda: create_merged.run(2015, d + '/m.nc', d, ['u10'], dlat=30.0),\n"
        "          'create_merged')]\n"
        "for call, name in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert name in str(e) and 'h5py' in str(e), (name, str(e))\n"
        "    else:\n"
        "        raise AssertionError(name + ' did not raise')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
