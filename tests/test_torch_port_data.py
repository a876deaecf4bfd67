"""makani_tpu_torch's data plane against makani_tpu's on the CPU.

The port keeps its own copies of makani_tpu's host-side data modules (time
arithmetic, the solar zenith angle, the auxiliary channel names, data.json,
the invariant fields, the latitude regridding, the synthetic dataset writer,
the HDF5, native and zarr datasets, the loaders). Each is held against
makani_tpu's on the same seeded inputs and files.

Tolerances: every comparison is exact (assert_array_equal, bytes of files
equal), but one. makani_tpu's GridConverter lerps in jnp float32,
lo + (hi - lo)·w (makani_tpu/utils/grids.py:55-62); called eagerly, as its
datasets call it, each operation rounds on its own, as in the port's numpy
and torch lerp, and the values are equal. Compiled, XLA contracts the lerp to
a fused multiply-add, which skips the product's rounding: there the port's
values are held within 1 ulp of the larger of the result and the product
(under cancellation the result's own ulp is far smaller than the product's).
"""

import datetime
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from makani_tpu.data import dataloader as jdataloader
from makani_tpu.data import native_loader as jnative
from makani_tpu.data.dataset import MultifilesDataset as JMultifiles
from makani_tpu.tools import make_synthetic_dataset as jsynth
from makani_tpu.utils import ParamsBase as JParams
from makani_tpu.utils import conditioning_inputs as jcond
from makani_tpu.utils import dataset_metadata as jmeta
from makani_tpu.utils import features as jfeatures
from makani_tpu.utils import timetools as jtime
from makani_tpu.utils import zenith_angle as jzenith
from makani_tpu.utils.grids import GridConverter as JGridConverter

from makani_tpu_torch.data import dataloader as tdataloader
from makani_tpu_torch.data import native_loader as tnative
from makani_tpu_torch.data.dataset import MultifilesDataset as TMultifiles
from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
from makani_tpu_torch.utils import conditioning_inputs as tcond
from makani_tpu_torch.utils import dataset_metadata as tmeta
from makani_tpu_torch.utils import features as tfeatures
from makani_tpu_torch.utils import timetools as ttime
from makani_tpu_torch.utils import zenith_angle as tzenith
from makani_tpu_torch.utils.grids import GridConverter as TGridConverter
from makani_tpu_torch.utils.yparams import ParamsBase as TParams

NLAT, NLON = 36, 72
CHANNELS = ["u10m", "v10m", "t2m", "z500", "q700"]
SAMPLES, YEARS, VALID_SAMPLES = 7, 2, 6


# --------------------------------------------------------------------------
# small modules
# --------------------------------------------------------------------------

def test_timetools_equal_jax():
    naive = datetime.datetime(2019, 12, 31, 18)
    aware = datetime.datetime(1987, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)
    for dt in (naive, aware):
        assert ttime.datetime_to_days2000(dt) == jtime.datetime_to_days2000(dt)
    for days in (-4567.25, 0.0, 7300.125):
        assert ttime.days2000_to_datetime(days) == jtime.days2000_to_datetime(days)
    assert ttime.year_start_days2000(2018) == jtime.year_start_days2000(2018)
    assert ttime.hours_range(aware, 5, 6) == jtime.hours_range(aware, 5, 6)


def test_cos_zenith_angle_bitwise_equal_jax():
    rng = np.random.RandomState(0)
    start = datetime.datetime(2017, 12, 30, tzinfo=datetime.timezone.utc)
    times = [start + datetime.timedelta(hours=int(h)) for h in rng.randint(0, 24 * 400, 5)]
    lat = np.linspace(90, -90, NLAT)
    lon = np.arange(0, 360, 360 / NLON)
    lon2d, lat2d = np.meshgrid(lon, lat)
    for t in (times, times[0], [7300.3, -12.5]):
        want = jzenith.cos_zenith_angle(t, lon2d, lat2d)
        got = tzenith.cos_zenith_angle(t, lon2d, lat2d)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tzenith.cos_zenith_angle_grid(times, lon, lat),
                                  jzenith.cos_zenith_angle_grid(times, lon, lat))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(add_zenith=True, add_grid=True, grid_type="sinusoidal", grid_num_frequencies=16,
         add_orography=True, add_landmask=True),
    dict(add_grid=True, grid_type="linear", add_landmask=True, unrelated=3),
])
def test_auxiliary_channels_equal_jax(kw):
    assert tfeatures.get_auxiliary_channels(**kw) == jfeatures.get_auxiliary_channels(**kw)


# --------------------------------------------------------------------------
# a synthetic dataset, written once by the port's writer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    tsynth.make_dataset(str(root), img_shape=(NLAT, NLON), channels=CHANNELS,
                        n_samples_per_year=SAMPLES, n_years=YEARS, mode="ar", fmt="both",
                        n_valid_samples=VALID_SAMPLES, invariants=True, seed=21)
    return root


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """makani_tpu's native loader built into a directory of this module's own,
    so that no other test's build of csrc/libmakani_loader.so runs beside
    this one's."""
    lib = tmp_path_factory.mktemp("jax_native") / "libmakani_loader.so"
    src = jnative._src_path()
    patch = pytest.MonkeyPatch()
    patch.setattr(jnative, "_lib_path", lambda: str(lib))
    patch.setattr(jnative, "_src_path", lambda: src)
    patch.setattr(jnative, "_LIB", None)
    yield
    patch.undo()


def _params(root, **overrides):
    """Matching (makani_tpu, port) params of the dataset at `root`, after
    data.json."""
    cfg = dict(dt=1, n_history=0, n_future=0, valid_autoreg_steps=2, normalization="zscore",
               model_grid_type="equiangular", add_zenith=True, batch_size=2,
               num_data_workers=2, global_seed=333, io_grid=[1, 1, 1], io_rank=[0, 0, 0],
               global_means_path=str(root / "stats" / "global_means.npy"),
               global_stds_path=str(root / "stats" / "global_stds.npy"),
               min_path=str(root / "stats" / "mins.npy"),
               max_path=str(root / "stats" / "maxs.npy"),
               train_data_path=str(root / "train"), valid_data_path=str(root / "test"))
    cfg.update(overrides)
    out = []
    for cls, meta in ((JParams, jmeta), (TParams, tmeta)):
        p = cls()
        p.update_params(cfg)
        meta.parse_dataset_metadata(str(root / "data.json"), p)
        out.append(p)
    return out


def test_parse_dataset_metadata_equal_jax(dataset_dir):
    for subset in (None, ["t2m", "u10m", "q700"]):
        jp, tp = _params(dataset_dir, channel_names=subset)
        assert tp.to_dict() == jp.to_dict()
        assert tp.in_channels == ([2, 0, 4] if subset else list(range(len(CHANNELS))))
    with pytest.raises(ValueError, match="not found"):
        _params(dataset_dir, channel_names=["nope"])


def test_conditioning_inputs_equal_jax(dataset_dir, tmp_path):
    inv = dataset_dir / "invariant"
    oro, lsm = tsynth.invariant_fields((NLAT, NLON), seed=22)
    np.save(tmp_path / "oro.npy", oro)
    np.save(tmp_path / "lsm.npy", lsm)
    for read, path in (("get_orography", inv / "orography.nc"),
                       ("get_orography", tmp_path / "oro.npy"),
                       ("get_land_mask", inv / "land_sea_mask.nc"),
                       ("get_land_mask", tmp_path / "lsm.npy")):
        want = getattr(jcond, read)(str(path))
        got = getattr(tcond, read)(str(path))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the .npy fields are the ones the .nc files hold
    np.testing.assert_array_equal(tcond.get_land_mask(str(tmp_path / "lsm.npy")),
                                  tcond.get_land_mask(str(inv / "land_sea_mask.nc")))


def test_grid_converter_to_legendre_gauss_matches_jax():
    lat = np.deg2rad(np.linspace(90, -90, NLAT))
    lon = np.deg2rad(np.arange(0, 360, 360 / NLON))
    want = JGridConverter("equiangular", "legendre-gauss", lat, lon)
    got = TGridConverter("equiangular", "legendre-gauss", lat, lon)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.interp_weights, want.interp_weights)
    for a, b in zip(got.get_dst_coords() + got.get_src_coords(),
                    want.get_dst_coords() + want.get_src_coords()):
        np.testing.assert_array_equal(a, b)
    x = np.random.RandomState(3).randn(2, 3, NLAT, NLON).astype(np.float32)
    eager, fused = np.asarray(want(x)), np.asarray(jax.jit(want)(x))
    product = (x[..., got.indices + 1, :] - x[..., got.indices, :]) * got.interp_weights
    for out in (got(x), got(torch.from_numpy(x)).numpy()):
        assert out.dtype == np.float32 and out.shape == eager.shape == fused.shape
        np.testing.assert_array_equal(out, eager)
        ulp = np.spacing(np.maximum(np.abs(fused), np.abs(product)))
        assert (np.abs(out.astype(np.float64) - fused) <= ulp).all()
    same = TGridConverter("equiangular", "equiangular", lat, lon)
    assert same(x) is x


# --------------------------------------------------------------------------
# the synthetic dataset writer
# --------------------------------------------------------------------------

def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.mark.parametrize("mode", ["random", "ar"])
@pytest.mark.parametrize("fmt", ["h5", "bin", "both"])
def test_synthetic_dataset_files_equal_jax(tmp_path, mode, fmt):
    kw = dict(img_shape=(10, 20), channels=["a", "b", "c"], n_samples_per_year=4, n_years=2,
              mode=mode, fmt=fmt, n_valid_samples=3, invariants=True, seed=5)
    jsynth.make_dataset(str(tmp_path / "jax"), **kw)
    tsynth.make_dataset(str(tmp_path / "port"), **kw)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(got) == (18 if fmt == "both" else 14) and got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name


def test_synthetic_dataset_command_line(tmp_path):
    tsynth.main(["--output", str(tmp_path / "port"), "--nlat", "6", "--nlon", "12",
                 "--channels", "3", "--samples", "3", "--format", "bin", "--mode", "ar"])
    jsynth.make_dataset(str(tmp_path / "jax"), img_shape=(6, 12), channels=["c0", "c1", "c2"],
                        n_samples_per_year=3, fmt="bin", mode="ar")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


# --------------------------------------------------------------------------
# the datasets
# --------------------------------------------------------------------------

DATASET_CASES = {
    "two_years_zenith": dict(),
    "channel_subset": dict(channel_names=["u10m", "z500", "q700"]),
    "crop": dict(crop_size_x=20, crop_anchor_x=5, crop_size_y=40, crop_anchor_y=17),
    "history_dt2": dict(n_history=1, dt=2),
    "legendre_gauss": dict(model_grid_type="legendre-gauss"),
    "no_zenith_minmax": dict(add_zenith=False, normalization="minmax"),
}


def _assert_samples_equal(got, want, idx):
    assert len(got) == len(want), idx
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape, idx
        np.testing.assert_array_equal(a, b, err_msg=str(idx))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_datasets_bitwise_equal_jax(dataset_dir, jax_native_lib, case, train):
    """Every sample of the HDF5 and the native datasets, against makani_tpu's
    own, over two yearly files: a window that straddles the year boundary is
    among them."""
    jp, tp = _params(dataset_dir, **DATASET_CASES[case])
    location = str(dataset_dir / ("train" if train else "test"))
    pairs = [(TMultifiles(tp, location, train), JMultifiles(jp, location, train)),
             (tnative.BinaryDataset(tp, location, train),
              jnative.BinaryDataset(jp, location, train))]
    n_samples = (SAMPLES if train else VALID_SAMPLES) * YEARS
    n_future = 0 if train else 2
    for got_ds, want_ds in pairs:
        assert len(got_ds) == len(want_ds) == n_samples - tp.dt * (tp.n_history + n_future + 1)
        for key in ("img_shape_x", "img_crop_shape_y", "img_crop_offset_x", "img_local_shape_y",
                    "img_local_offset_y"):
            assert getattr(got_ds, key) == getattr(want_ds, key), key
        for idx in range(len(want_ds)):
            _assert_samples_equal(got_ds[idx], want_ds[idx], idx)
        for a, b in zip(got_ds.get_input_normalization() + got_ds.get_output_normalization(),
                        want_ds.get_input_normalization() + want_ds.get_output_normalization()):
            np.testing.assert_array_equal(a, b)


def test_native_reader_reads_and_builds_into_build_dir(dataset_dir):
    path = tnative.build_native_loader()
    assert path == str(tnative.BUILD_DIR / "libmakani_loader.so") and os.path.exists(path)
    shard = str(dataset_dir / "train" / "2018.npy")
    reader = tnative.NativeReader([shard], n_threads=2)
    direct = np.load(shard, mmap_mode="r")
    np.testing.assert_array_equal(reader.read_window(0, 2, 3), direct[2:5])
    np.testing.assert_array_equal(reader.read_batch([0, 0], [4, 1]), direct[[4, 1]])
    np.testing.assert_array_equal(reader.read_subwindow(0, 1, 2, [3, 0], 4, 9, 10, 30),
                                  direct[1:3][:, [3, 0], 4:13, 10:40])


def test_convert_h5_to_bin_equal_jax(dataset_dir, tmp_path):
    got = tnative.convert_h5_to_bin(str(dataset_dir / "train"), str(tmp_path / "port"))
    want = jnative.convert_h5_to_bin(str(dataset_dir / "train"), str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    # the shards the writer made with --format both are the same bytes
    assert open(got[0], "rb").read() == open(dataset_dir / "train" / "2018.npy", "rb").read()


# --------------------------------------------------------------------------
# the loaders
# --------------------------------------------------------------------------

@pytest.fixture()
def jax_serial():
    from makani_tpu.parallel import comm
    comm.reset()
    comm.init(devices=jax.devices()[:1])
    yield
    comm.reset()


def _batches(loader, epochs):
    return [batch for _ in range(epochs) for batch in loader]


@pytest.mark.parametrize("files", ["h5", "npy"])
def test_get_dataloader_batches_equal_jax(dataset_dir, jax_native_lib, jax_serial, tmp_path,
                                          files):
    """Train (shuffled, two epochs) and evaluation (in order, from
    samples_offset, valid_autoreg_steps targets) batches of both packages'
    get_dataloader, with the dataset each dispatches to."""
    jp, tp = _params(dataset_dir, n_train_samples_per_epoch=6, n_eval_samples=3,
                     samples_offset=2)
    if files == "h5":  # a directory with HDF5 files only
        for split in ("train", "test"):
            os.makedirs(tmp_path / split)
            for name in os.listdir(dataset_dir / split):
                if name.endswith(".h5"):
                    os.symlink(dataset_dir / split / name, tmp_path / split / name)
        root = tmp_path
    else:  # npy shards beside HDF5 files: the native reader on request
        root = dataset_dir
        jp["enable_native_loader"] = tp["enable_native_loader"] = True
    want_type = {"h5": "MultifilesDataset", "npy": "BinaryDataset"}[files]
    for train, location, epochs in ((True, root / "train", 2), (False, root / "test", 1)):
        tloader, tds = tdataloader.get_dataloader(tp, str(location), train=train)
        jloader, jds = jdataloader.get_dataloader(jp, str(location), train=train)
        assert type(tds).__name__ == type(jds).__name__ == want_type
        assert len(tloader) == len(jloader) == (3 if train else 1)
        got, want = _batches(tloader, epochs), _batches(jloader, epochs)
        assert len(got) == len(want) == len(tloader) * epochs
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_samples_equal(a, b, i)
        if not train:  # samples 2 and 3, in order
            _assert_samples_equal(tuple(f[1] for f in got[0]), tds[3], "eval order")


def test_get_dataloader_dispatch(dataset_dir, tmp_path):
    _, tp = _params(dataset_dir)
    bins = tmp_path / "bin"
    os.makedirs(bins)
    os.symlink(dataset_dir / "train" / "2018.npy", bins / "2018.npy")
    _, ds = tdataloader.get_dataloader(tp, str(bins))
    assert type(ds).__name__ == "BinaryDataset"
    _, ds = tdataloader.get_dataloader(tp, str(dataset_dir / "train"))
    assert type(ds).__name__ == "MultifilesDataset"
    with pytest.raises(IOError, match="does not contain"):
        tdataloader.get_dataloader(tp, str(tmp_path / "empty"))
    tp["enable_benchy"] = True
    loader, _ = tdataloader.get_dataloader(tp, str(bins))
    assert type(loader).__name__ == "BenchyLoader" and len(list(loader)) == len(loader) == 3


def _jparams(cfg):
    p = JParams()
    p.update_params(cfg)
    return p


def test_dummy_dataset_splits_equal_jax():
    """The synthetic dataset's training and evaluation splits against
    makani_tpu's DummyDataset, and get_dataloader's evaluation loader on it."""
    cfg = dict(dt=1, n_history=1, n_future=0, valid_autoreg_steps=3, in_channels=[0, 1, 2],
               out_channels=[1, 2], add_zenith=True, n_train_samples_per_epoch=5,
               n_eval_samples=4, img_shape_x=6, img_shape_y=8, batch_size=2, global_seed=333,
               enable_synthetic_data=True, num_data_workers=2, samples_offset=1)
    for train in (True, False):
        tds = tdataloader.DummyDataset(TParams.from_dict(cfg), None, train)
        jds = jdataloader.DummyDataset(_jparams(cfg), None, train)
        assert len(tds) == len(jds) == (5 if train else 4) and tds.n_future == jds.n_future
        for idx in range(len(jds)):
            _assert_samples_equal(tds[idx], jds[idx], idx)
    loader, ds = tdataloader.get_dataloader(TParams.from_dict(cfg), None, train=False)
    jloader = jdataloader.PrefetchingLoader(
        jdataloader.DummyDataset(_jparams(cfg), None, False), batch_size=2,
        shuffle=False, n_samples_per_epoch=4, samples_offset=1)
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == 1 and got[0][1].shape == (2, 4, 2, 6, 8)
    _assert_samples_equal(got[0], want[0], "eval")


# --------------------------------------------------------------------------
# the optional packages
# --------------------------------------------------------------------------

def _zarr_stub():
    """A fake zarr module: each YYYY.zarr is a directory holding
    <dataset_path>.npy, as tests/test_zarr.py makes it."""
    stub = types.ModuleType("zarr")

    def open_store(path, mode="r"):
        return {f[:-4]: np.load(os.path.join(path, f), mmap_mode="r")
                for f in os.listdir(path) if f.endswith(".npy")}

    stub.open = open_store
    return stub


def test_zarr_gate_and_stub(dataset_dir, tmp_path, monkeypatch):
    from makani_tpu.data.zarr_helper import ZarrDataset as JZarr
    from makani_tpu_torch.data.zarr_helper import ZarrDataset as TZarr
    jp, tp = _params(dataset_dir)
    stores = tmp_path / "zarr"
    for year in (2018, 2019):
        os.makedirs(stores / f"{year}.zarr")
        os.symlink(dataset_dir / "train" / f"{year}.npy", stores / f"{year}.zarr" / "fields.npy")
    monkeypatch.setitem(sys.modules, "zarr", None)
    with pytest.raises(ImportError, match="ZarrDataset"):
        TZarr(tp, str(stores), True)
    with pytest.raises(ImportError, match="ZarrDataset"):
        tdataloader.get_dataloader(tp, str(stores))
    monkeypatch.setitem(sys.modules, "zarr", _zarr_stub())
    _, ds = tdataloader.get_dataloader(tp, str(stores))
    want, h5 = JZarr(jp, str(stores), True), TMultifiles(tp, str(dataset_dir / "train"), True)
    assert type(ds).__name__ == "ZarrDataset" and len(ds) == len(want) == len(h5)
    for idx in (0, SAMPLES - 1, len(ds) - 1):
        _assert_samples_equal(ds[idx], want[idx], idx)
        _assert_samples_equal(ds[idx], h5[idx], idx)


def test_files_without_h5py(dataset_dir, tmp_path, monkeypatch):
    """Without h5py: npy shards and .npy invariants still load; every branch
    that needs h5py raises ImportError naming what it was for."""
    jp, tp = _params(dataset_dir)
    want = JMultifiles(jp, str(dataset_dir / "train"), True)[SAMPLES - 1]
    monkeypatch.setitem(sys.modules, "h5py", None)
    tp["enable_native_loader"] = True
    _, ds = tdataloader.get_dataloader(tp, str(dataset_dir / "train"))
    _assert_samples_equal(ds[SAMPLES - 1], want, "bin")
    oro, _ = tsynth.invariant_fields((NLAT, NLON))
    np.save(tmp_path / "oro.npy", oro)
    assert tcond.get_orography(str(tmp_path / "oro.npy")).shape == (NLAT, NLON)
    tsynth.make_dataset(str(tmp_path / "bin"), img_shape=(6, 12), fmt="bin",
                        n_samples_per_year=2)
    for call, match in [
            (lambda: TMultifiles(tp, str(dataset_dir / "train"), True), r"\?\?\?\?\.h5"),
            (lambda: tcond.get_orography(str(dataset_dir / "invariant" / "orography.nc")),
             "orography.nc"),
            (lambda: tsynth.make_dataset(str(tmp_path / "h5"), img_shape=(6, 12), fmt="h5"),
             "h5 format"),
            (lambda: tsynth.make_dataset(str(tmp_path / "inv"), img_shape=(6, 12), fmt="bin",
                                         invariants=True), "invariant"),
            (lambda: tnative.convert_h5_to_bin(str(dataset_dir / "train"), str(tmp_path / "c")),
             "convert_h5_to_bin")]:
        with pytest.raises(ImportError, match=match):
            call()


def test_phase_10_modules_import_without_h5py_or_jax():
    """The modules on the card's file path import in a process where h5py
    cannot be imported, and none of them brings in JAX or makani_tpu."""
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import chip_smoke\n"
            "import makani_tpu_torch.data.dataloader, makani_tpu_torch.data.native_loader\n"
            "import makani_tpu_torch.data.zarr_helper, makani_tpu_torch.utils.trainer\n"
            "import makani_tpu_torch.utils.inferencer, makani_tpu_torch.tools.make_synthetic_dataset\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'orbax', 'makani_tpu'))\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": root})
