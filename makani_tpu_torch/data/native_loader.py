"""ctypes bindings and dataset for the native (C++) raw-shard reader.

Counterpart of makani_tpu/data/native_loader.py over the port's own copy of
the reader, makani_tpu_torch/csrc/makani_loader.cpp: yearly raw float32
shards read with positioned preads across a C++ thread pool (optionally
O_DIRECT), normalized in the read workers. `BinaryDataset` gives the samples
of data/dataset.MultifilesDataset, bit for bit, so `get_dataloader` dispatches
to it by the files it finds; `convert_h5_to_bin` writes the shards from HDF5
files.

`build_native_loader` compiles the reader with the host compiler (g++ -O3
-shared -fPIC -std=c++17 -pthread) at first use into build/native/ at the
root of the checkout, through a temporary file renamed into place, so that
processes building at once never load a half-written library; a failed
build raises with the command that failed.

Shard layout: <year>.npy (standard npy, C-order (T, C, H, W) float32). The
npy header is parsed here for the data offset, so the C reader never touches
the format.
"""

import ast
import ctypes
import datetime
import glob
import operator
import os
import shutil
import subprocess
import tempfile
from bisect import bisect_right
from itertools import accumulate
from pathlib import Path

import numpy as np

from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.utils.grids import GridConverter
from makani_tpu_torch.utils.imports import import_optional
from makani_tpu_torch.utils.zenith_angle import cos_zenith_angle

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "makani_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None


def build_native_loader(force=False):
    """Compile the C++ reader into BUILD_DIR unless a library newer than the
    source is there (or `force`); returns the library's path."""
    lib = BUILD_DIR / "libmakani_loader.so"
    if lib.exists() and not force and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        return str(lib)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("building the native loader needs g++, which is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib)


def get_lib():
    global _LIB
    if _LIB is None:
        path = build_native_loader()
        lib = ctypes.CDLL(path)
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.loader_read_batch.restype = ctypes.c_int
        lib.loader_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_char_p]
        lib.loader_read_window.restype = ctypes.c_int
        lib.loader_read_window.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p]
        lib.loader_read_subwindow.restype = ctypes.c_int
        lib.loader_read_subwindow.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
        lib.loader_read_subwindow_norm.restype = ctypes.c_int
        lib.loader_read_subwindow_norm.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p]
        lib.loader_odirect_active.restype = ctypes.c_int
        lib.loader_odirect_active.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _npy_header(path):
    """Parse an npy file header: returns (shape, dtype, data_offset)."""
    with open(path, "rb") as f:
        magic = f.read(6)
        assert magic == b"\x93NUMPY", f"{path} is not an npy file"
        major, minor = f.read(2)
        if major == 1:
            hlen = int.from_bytes(f.read(2), "little")
        else:
            hlen = int.from_bytes(f.read(4), "little")
        header = ast.literal_eval(f.read(hlen).decode("latin1"))
        offset = f.tell()
    return header["shape"], np.dtype(header["descr"]), offset


def convert_h5_to_bin(src_dir, dst_dir, dataset_path="fields", batch=8):
    """HDF5 yearly files -> npy raw shards for the native reader."""
    h5py = import_optional("h5py", "convert_h5_to_bin")
    os.makedirs(dst_dir, exist_ok=True)
    outs = []
    for src in sorted(glob.glob(os.path.join(src_dir, "????.h5"))):
        year = os.path.splitext(os.path.basename(src))[0]
        dst = os.path.join(dst_dir, f"{year}.npy")
        with h5py.File(src, "r") as f:
            ds = f[dataset_path]
            out = np.lib.format.open_memmap(dst, mode="w+", dtype=np.float32, shape=ds.shape)
            for t0 in range(0, ds.shape[0], batch):
                out[t0: t0 + batch] = ds[t0: t0 + batch]
            del out
        outs.append(dst)
    return outs


class NativeReader:
    """Thin RAII wrapper over the C loader handle."""

    def __init__(self, paths, n_threads=4, use_odirect=False):
        self.paths = list(paths)
        self.shapes = []
        offsets = []
        counts = []
        for p in self.paths:
            shape, dtype, off = _npy_header(p)
            assert dtype == np.float32, f"{p}: expected float32 shards"
            self.shapes.append(shape)
            counts.append(shape[0])
            offsets.append(off)
        self.sample_shape = self.shapes[0][1:]
        self.sample_bytes = int(np.prod(self.sample_shape)) * 4
        self.n_samples = counts

        lib = get_lib()
        c_paths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        c_counts = (ctypes.c_int64 * len(counts))(*counts)
        c_offs = (ctypes.c_int64 * len(offsets))(*offsets)
        self._handle = lib.loader_create(
            c_paths, len(self.paths), c_counts, c_offs,
            self.sample_bytes, n_threads, int(use_odirect))
        if not self._handle:
            raise IOError(f"native loader failed to open {self.paths}")
        self._lib = lib
        # True only when every file actually opened with O_DIRECT (the C
        # side falls back to buffered IO per-file if the fs rejects it)
        self.odirect_active = bool(lib.loader_odirect_active(self._handle))

    def read_batch(self, file_indices, sample_indices):
        n = len(file_indices)
        out = np.empty((n,) + tuple(self.sample_shape), dtype=np.float32)
        fi = (ctypes.c_int * n)(*file_indices)
        si = (ctypes.c_int64 * n)(*sample_indices)
        rc = self._lib.loader_read_batch(
            self._handle, fi, si, n, out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError("native batch read failed")
        return out

    def read_window(self, file_idx, start, count):
        out = np.empty((count,) + tuple(self.sample_shape), dtype=np.float32)
        rc = self._lib.loader_read_window(
            self._handle, file_idx, start, count, out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError("native window read failed")
        return out

    def read_subwindow(self, file_idx, start, count, chans, x0, nx, y0, ny,
                       bias=None, inv_scale=None):
        """Read `count` consecutive samples' (chans, x0:x0+nx, y0:y0+ny)
        patches -> (count, len(chans), nx, ny). The io-sharded/channel-
        subset read path. bias/inv_scale (length len(chans)) fuse the
        per-channel z-score normalization into the C++ read workers."""
        chans = np.asarray(chans, dtype=np.int32)
        C, H, W = self.sample_shape
        out = np.empty((count, len(chans), nx, ny), dtype=np.float32)
        c_chans = chans.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        fptr = ctypes.POINTER(ctypes.c_float)
        if bias is None:
            b_ptr = s_ptr = ctypes.cast(None, fptr)
        else:
            bias = np.ascontiguousarray(bias, dtype=np.float32)
            inv_scale = np.ascontiguousarray(inv_scale, dtype=np.float32)
            b_ptr = bias.ctypes.data_as(fptr)
            s_ptr = inv_scale.ctypes.data_as(fptr)
        rc = self._lib.loader_read_subwindow_norm(
            self._handle, file_idx, start, count, c_chans, len(chans),
            H, W, x0, nx, y0, ny, b_ptr, s_ptr,
            out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise IOError("native subwindow read failed")
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None


class BinaryDataset:
    """MultifilesDataset's samples, read from native raw shards."""

    def __init__(self, params, location, train, enable_logging=True):
        self.dt = params.dt
        self.dhours = params.dhours
        self.n_history = params.n_history
        self.n_future = params.valid_autoreg_steps if not train else params.n_future
        self.in_channels = np.array(params.in_channels)
        self.out_channels = np.array(params.out_channels)
        self.add_zenith = params.get("add_zenith", False)

        files = sorted(glob.glob(os.path.join(location, "????.npy")))
        if not files:
            raise IOError(f"no npy shards in {location}")
        self.years = [int(os.path.splitext(os.path.basename(p))[0]) for p in files]
        self.reader = NativeReader(files,
                                   n_threads=params.get("num_data_workers", 4),
                                   use_odirect=params.get("enable_odirect", False))

        shape = self.reader.shapes[0]
        self.img_shape = shape[2:4]
        self.total_channels = shape[1]
        self.n_samples_year = self.reader.n_samples
        self.year_offsets = list(accumulate(self.n_samples_year, operator.add))[:-1]
        self.year_offsets.insert(0, 0)
        self.n_samples_total = sum(self.n_samples_year)

        # crops and io-sharded read windows, as data/dataset.py sets them
        crop_size = [params.get("crop_size_x", None) or self.img_shape[0],
                     params.get("crop_size_y", None) or self.img_shape[1]]
        crop_anchor = [params.get("crop_anchor_x", 0), params.get("crop_anchor_y", 0)]
        assert crop_anchor[0] + crop_size[0] <= self.img_shape[0]
        assert crop_anchor[1] + crop_size[1] <= self.img_shape[1]
        io_grid = list(params.get("io_grid", [1, 1, 1]))[-2:]
        io_rank = list(params.get("io_rank", [0, 0, 0]))[-2:]
        split_x = spmd.split_shapes(crop_size[0], io_grid[0])
        split_y = spmd.split_shapes(crop_size[1], io_grid[1])
        self.read_shape = [split_x[io_rank[0]], split_y[io_rank[1]]]
        self.read_anchor = [crop_anchor[0] + sum(split_x[: io_rank[0]]),
                            crop_anchor[1] + sum(split_y[: io_rank[1]])]

        # compat properties
        self.img_shape_x, self.img_shape_y = self.img_shape
        self.img_crop_shape_x, self.img_crop_shape_y = crop_size
        self.img_crop_offset_x, self.img_crop_offset_y = crop_anchor
        self.img_local_shape_x, self.img_local_shape_y = self.read_shape
        self.img_local_offset_x, self.img_local_offset_y = self.read_anchor

        # normalization (separate input/output stats — out_channels may
        # differ from in_channels)
        if params.normalization == "zscore":
            means = np.load(params.global_means_path)
            stds = np.load(params.global_stds_path)
            self.in_bias, self.in_scale = means[:, self.in_channels], stds[:, self.in_channels]
            self.out_bias, self.out_scale = means[:, self.out_channels], stds[:, self.out_channels]
        elif params.normalization == "minmax":
            mins = np.load(params.min_path)
            maxs = np.load(params.max_path)
            self.in_bias = mins[:, self.in_channels]
            self.in_scale = maxs[:, self.in_channels] - self.in_bias
            self.out_bias = mins[:, self.out_channels]
            self.out_scale = maxs[:, self.out_channels] - self.out_bias
        else:
            self.in_bias = np.zeros((1, len(self.in_channels), 1, 1), np.float32)
            self.in_scale = np.ones((1, len(self.in_channels), 1, 1), np.float32)
            self.out_bias = np.zeros((1, len(self.out_channels), 1, 1), np.float32)
            self.out_scale = np.ones((1, len(self.out_channels), 1, 1), np.float32)

        # flattened per-selected-channel (bias, 1/scale) pairs for the fused
        # C++ normalization; a shared read serves inp+tar when the channel
        # selections and stats coincide (the flagship case)
        self._in_norm = (self.in_bias.ravel().astype(np.float32),
                         (1.0 / self.in_scale).ravel().astype(np.float32))
        self._out_norm = (self.out_bias.ravel().astype(np.float32),
                          (1.0 / self.out_scale).ravel().astype(np.float32))
        self._shared_selection = (
            np.array_equal(self.in_channels, self.out_channels)
            and np.array_equal(self._in_norm[0], self._out_norm[0])
            and np.array_equal(self._in_norm[1], self._out_norm[1]))

        if hasattr(params, "lat") and params.get("lat") is not None:
            lat, lon = np.asarray(params.lat), np.asarray(params.lon)
        else:
            # the multifiles dataset's grid when data.json gives none
            resolution = 360.0 / float(self.img_shape[1])
            lon = np.arange(0, 360, resolution)
            lat = np.arange(-90, 90 + resolution, resolution)[::-1]

        if self.add_zenith:
            self.lon_grid, self.lat_grid = np.meshgrid(lon, lat)
            ra, rs = self.read_anchor, self.read_shape
            self.lat_grid = self.lat_grid[ra[0]: ra[0] + rs[0], ra[1]: ra[1] + rs[1]]
            self.lon_grid = self.lon_grid[ra[0]: ra[0] + rs[0], ra[1]: ra[1] + rs[1]]

        # latitude regridding when the model grid differs from the data grid
        self.grid_converter = GridConverter(
            params.get("data_grid_type", "equiangular"),
            params.get("model_grid_type", "equiangular"),
            np.deg2rad(np.asarray(lat, dtype=np.float64)),
            np.deg2rad(np.asarray(lon, dtype=np.float64)),
        )

    def __len__(self):
        return self.n_samples_total - self.dt * (self.n_history + self.n_future + 1)

    def _read_frames(self, global_idx, chans, norm):
        """(n_history + n_future + 2, len(chans), nx, ny) frames at stride
        dt, z-score normalized in the C++ read workers (norm = (bias,
        inv_scale) per selected channel)."""
        year_idx = bisect_right(self.year_offsets, global_idx) - 1
        local_idx = global_idx - self.year_offsets[year_idx]
        n_frames = self.n_history + self.n_future + 2
        (x0, y0), (nx, ny) = self.read_anchor, self.read_shape
        bias, iscale = norm

        total = self.dt * (n_frames - 1) + 1
        if local_idx + total <= self.n_samples_year[year_idx]:
            window = self.reader.read_subwindow(
                year_idx, local_idx, total, chans, x0, nx, y0, ny,
                bias=bias, inv_scale=iscale)
            return window[:: self.dt]
        # year-boundary: per-frame reads
        frames = []
        for off in range(n_frames):
            g = global_idx + self.dt * off
            yi = bisect_right(self.year_offsets, g) - 1
            si = g - self.year_offsets[yi]
            frames.append(self.reader.read_subwindow(
                yi, si, 1, chans, x0, nx, y0, ny,
                bias=bias, inv_scale=iscale)[0])
        return np.stack(frames, axis=0)

    def __getitem__(self, global_idx):
        n_inp = self.n_history + 1
        n_tar = self.n_future + 1
        year_idx = bisect_right(self.year_offsets, global_idx) - 1
        local_idx = global_idx - self.year_offsets[year_idx]

        if self._shared_selection:
            # one fused read+normalize serves both (channel stats agree);
            # inp/tar are zero-copy views of the window
            frames = self._read_frames(global_idx, self.in_channels, self._in_norm)
            inp = frames[:n_inp]
            tar = frames[n_inp: n_inp + n_tar]
        else:
            inp = self._read_frames(global_idx, self.in_channels, self._in_norm)[:n_inp]
            tar = self._read_frames(global_idx, self.out_channels, self._out_norm)[n_inp: n_inp + n_tar]
        result = (inp, tar)

        if self.add_zenith:
            # zenith anchored at the newest input time, as in
            # data/dataset.py
            anchor = local_idx + self.dt * self.n_history
            year = self.years[year_idx]
            jan01 = datetime.datetime(year, 1, 1, tzinfo=datetime.timezone.utc)
            inp_times = [jan01 + datetime.timedelta(hours=i * self.dhours)
                         for i in range(anchor - self.dt * self.n_history, anchor + 1, self.dt)]
            tar_times = [jan01 + datetime.timedelta(hours=i * self.dhours)
                         for i in range(anchor + self.dt,
                                        anchor + self.dt * (self.n_future + 1) + 1, self.dt)]
            zen_inp = np.expand_dims(cos_zenith_angle(inp_times, self.lon_grid, self.lat_grid), 1)
            zen_tar = np.expand_dims(cos_zenith_angle(tar_times, self.lon_grid, self.lat_grid), 1)
            result = result + (zen_inp.astype(np.float32), zen_tar.astype(np.float32))

        result = tuple(np.asarray(self.grid_converter(r)) for r in result)
        return result

    def get_output_normalization(self):
        return self.out_bias, self.out_scale

    def get_input_normalization(self):
        return self.in_bias, self.in_scale
