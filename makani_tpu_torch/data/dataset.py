"""Host-side multifile HDF5 dataset reader.

Counterpart of makani_tpu/data/dataset.py: the index arithmetic over yearly
files, the per-channel normalization, the zenith channels, the crop and the
io-sharded read window, and the latitude regridding, all numpy on the host.
The samples are makani_tpu's, bit for bit. h5py is imported where a file is
opened, so that the module imports without it.
"""

import datetime
import glob
import logging
import operator
import os
import time
from bisect import bisect_right
from itertools import accumulate

import numpy as np

from makani_tpu_torch.parallel import spmd
from makani_tpu_torch.utils.grids import GridConverter
from makani_tpu_torch.utils.imports import import_optional
from makani_tpu_torch.utils.zenith_angle import cos_zenith_angle

logger = logging.getLogger(__name__)


def compute_split_shapes(size, num_chunks):
    """Split `size` into num_chunks parts, the remainder spread over the
    first chunks."""
    chunk = size // num_chunks
    rem = size % num_chunks
    return [chunk + 1 if i < rem else chunk for i in range(num_chunks)]


class MultifilesDataset:
    def __init__(self, params, location, train, enable_logging=True):
        self.params = params
        self.location = location
        self.train = train
        self.dt = params.dt
        self.dhours = params.dhours
        self.n_history = params.n_history
        self.n_future = params.valid_autoreg_steps if not train else params.n_future
        self.in_channels = np.array(params.in_channels)
        self.out_channels = np.array(params.out_channels)
        self.n_in_channels = len(self.in_channels)
        self.n_out_channels = len(self.out_channels)
        self.add_zenith = params.get("add_zenith", False)
        self.dataset_path = params.h5_path
        if hasattr(params, "lat") and hasattr(params, "lon") and params.get("lat") is not None:
            self.lat_lon = (params.lat, params.lon)
        else:
            self.lat_lon = None

        assert params.io_grid[0] == 1
        self.io_grid = params.io_grid[1:]
        self.io_rank = params.io_rank[1:]

        crop_size = [params.get("crop_size_x", None), params.get("crop_size_y", None)]
        crop_anchor = [params.get("crop_anchor_x", 0), params.get("crop_anchor_y", 0)]
        self.crop_size = crop_size
        self.crop_anchor = crop_anchor

        self._get_files_stats()

        if enable_logging:
            logger.info(
                "Found %d yearly files in %s: %d samples total, image shape "
                "%dx%d (%d channels), local read window %dx%d @ (%d,%d)",
                self.n_years, location, self.n_samples_total,
                self.img_shape[0], self.img_shape[1], self.total_channels,
                self.read_shape[0], self.read_shape[1],
                self.read_anchor[0], self.read_anchor[1])

        # normalization stats
        self.normalize = True
        if params.normalization == "minmax":
            self.in_bias = np.load(params.min_path)[:, self.in_channels]
            self.in_scale = np.load(params.max_path)[:, self.in_channels] - self.in_bias
            self.out_bias = np.load(params.min_path)[:, self.out_channels]
            self.out_scale = np.load(params.max_path)[:, self.out_channels] - self.out_bias
        elif params.normalization == "zscore":
            self.in_bias = np.load(params.global_means_path)[:, self.in_channels]
            self.in_scale = np.load(params.global_stds_path)[:, self.in_channels]
            self.out_bias = np.load(params.global_means_path)[:, self.out_channels]
            self.out_scale = np.load(params.global_stds_path)[:, self.out_channels]
        else:
            self.in_bias = np.zeros((1, self.n_in_channels, 1, 1), np.float32)
            self.in_scale = np.ones((1, self.n_in_channels, 1, 1), np.float32)
            self.out_bias = np.zeros((1, self.n_out_channels, 1, 1), np.float32)
            self.out_scale = np.ones((1, self.n_out_channels, 1, 1), np.float32)

        if self.lat_lon is None:
            resolution = 360.0 / float(self.img_shape[1])
            longitude = np.arange(0, 360, resolution)
            latitude = np.arange(-90, 90 + resolution, resolution)[::-1]
            self.lat_lon = (latitude.tolist(), longitude.tolist())

        if self.add_zenith:
            latitude = np.array(self.lat_lon[0])
            longitude = np.array(self.lat_lon[1])
            self.lon_grid, self.lat_grid = np.meshgrid(longitude, latitude)
            ra, rs = self.read_anchor, self.read_shape
            self.lat_grid_local = self.lat_grid[ra[0]: ra[0] + rs[0], ra[1]: ra[1] + rs[1]]
            self.lon_grid_local = self.lon_grid[ra[0]: ra[0] + rs[0], ra[1]: ra[1] + rs[1]]

        self.grid_converter = GridConverter(
            params.data_grid_type,
            params.model_grid_type,
            np.deg2rad(np.asarray(self.lat_lon[0], dtype=np.float64)),
            np.deg2rad(np.asarray(self.lat_lon[1], dtype=np.float64)),
        )

    # storage hooks (overridden by ZarrDataset in data/zarr_helper.py)
    _file_pattern = "????.h5"

    def _peek_shape(self, path):
        with import_optional("h5py", "reading ????.h5 files").File(path, "r") as f:
            return f[self.dataset_path].shape

    def _get_files_stats(self):
        self.files_paths = []
        locations = [self.location] if not isinstance(self.location, list) else self.location
        for location in locations:
            self.files_paths += glob.glob(os.path.join(location, self._file_pattern))
        if not self.files_paths:
            raise IOError(
                f"Error, the specified file path {locations} does not contain "
                f"{self._file_pattern} files.")
        self.files_paths.sort()
        self.years = [int(os.path.splitext(os.path.basename(x))[0]) for x in self.files_paths]
        self.files = [None] * len(self.files_paths)
        self.n_years = len(self.files_paths)

        shape0 = self._peek_shape(self.files_paths[0])
        self.img_shape = shape0[2:4]
        self.total_channels = shape0[1]

        self.n_samples_year = [shape0[0]]
        for filename in self.files_paths[1:]:
            self.n_samples_year.append(self._peek_shape(filename)[0])

        # crops and io-sharded read windows
        if self.crop_size[0] is None:
            self.crop_size[0] = self.img_shape[0]
        if self.crop_size[1] is None:
            self.crop_size[1] = self.img_shape[1]
        assert self.crop_anchor[0] + self.crop_size[0] <= self.img_shape[0]
        assert self.crop_anchor[1] + self.crop_size[1] <= self.img_shape[1]

        split_x = spmd.split_shapes(self.crop_size[0], self.io_grid[0])
        split_y = spmd.split_shapes(self.crop_size[1], self.io_grid[1])
        self.read_shape = [split_x[self.io_rank[0]], split_y[self.io_rank[1]]]
        self.read_anchor = [
            self.crop_anchor[0] + sum(split_x[: self.io_rank[0]]),
            self.crop_anchor[1] + sum(split_y[: self.io_rank[1]]),
        ]

        self.year_offsets = list(accumulate(self.n_samples_year, operator.add))[:-1]
        self.year_offsets.insert(0, 0)
        self.n_samples_available = sum(self.n_samples_year)
        self.n_samples_total = self.n_samples_available

        # compat properties (consumed by trainer._update_parameters)
        self.img_shape_x, self.img_shape_y = self.img_shape
        self.img_crop_shape_x, self.img_crop_shape_y = self.crop_size
        self.img_crop_offset_x, self.img_crop_offset_y = self.crop_anchor
        self.img_local_shape_x, self.img_local_shape_y = self.read_shape
        self.img_local_offset_x, self.img_local_offset_y = self.read_anchor

    def _compute_zenith_angle(self, local_idx, year_idx):
        """cos(zenith) at the input times (backward from local_idx, at stride
        dt) and at the target times (forward from local_idx + dt)."""
        year = self.years[year_idx]
        jan_01 = datetime.datetime(year, 1, 1, 0, 0, 0, tzinfo=datetime.timezone.utc)

        inp_times = [jan_01 + datetime.timedelta(hours=idx * self.dhours)
                     for idx in range(local_idx - self.dt * self.n_history, local_idx + 1, self.dt)]
        cos_zenith_inp = np.expand_dims(
            cos_zenith_angle(inp_times, self.lon_grid_local, self.lat_grid_local), axis=1)

        tar_times = [jan_01 + datetime.timedelta(hours=idx * self.dhours)
                     for idx in range(local_idx + self.dt, local_idx + self.dt * (self.n_future + 1) + 1, self.dt)]
        cos_zenith_tar = np.expand_dims(
            cos_zenith_angle(tar_times, self.lon_grid_local, self.lat_grid_local), axis=1)

        return cos_zenith_inp, cos_zenith_tar

    def _open_file(self, year_idx, num_retries=5, retry_wait=5.0):
        """Open a yearly file, retrying: a transient error of a network file
        system must not end a long run."""
        h5py = import_optional("h5py", "reading ????.h5 files")
        for attempt in range(num_retries):
            try:
                f = h5py.File(self.files_paths[year_idx], "r")
                self.files[year_idx] = f[self.dataset_path]
                return
            except OSError:
                if attempt == num_retries - 1:
                    raise OSError(
                        f"Unable to open {self.files_paths[year_idx]} "
                        f"after {num_retries} attempts, aborting.")
                logger.warning(
                    f"Cannot open {self.files_paths[year_idx]} "
                    f"(attempt {attempt + 1}/{num_retries}), retrying.")
                time.sleep(retry_wait)

    def __len__(self):
        return self.n_samples_total - self.dt * (self.n_history + self.n_future + 1)

    def __getitem__(self, global_idx):
        start_x = self.read_anchor[0]
        end_x = start_x + self.read_shape[0]
        start_y = self.read_anchor[1]
        end_y = start_y + self.read_shape[1]

        def read(offset_idx, channels, bias, scale):
            year_idx = bisect_right(self.year_offsets, global_idx + self.dt * offset_idx) - 1
            local_idx = global_idx + self.dt * offset_idx - self.year_offsets[year_idx]
            if self.files[year_idx] is None:
                self._open_file(year_idx)
            arr = self.files[year_idx][local_idx: local_idx + 1, channels, start_x:end_x, start_y:end_y]
            if self.normalize:
                arr = (arr - bias) / scale
            return arr

        inp = np.concatenate(
            [read(o, self.in_channels, self.in_bias, self.in_scale) for o in range(self.n_history + 1)],
            axis=0).astype(np.float32)
        tar = np.concatenate(
            [read(o, self.out_channels, self.out_bias, self.out_scale)
             for o in range(self.n_history + 1, self.n_history + self.n_future + 2)],
            axis=0).astype(np.float32)

        if self.add_zenith:
            # zenith is anchored at the newest input time, global_idx +
            # dt*n_history, since the field windows above run forward from
            # global_idx; anchored at global_idx (as the upstream multifiles
            # loader does) it would lag the fields by dt*n_history
            year_idx = bisect_right(self.year_offsets, global_idx) - 1
            local_idx = global_idx - self.year_offsets[year_idx]
            zen_inp, zen_tar = self._compute_zenith_angle(
                local_idx + self.dt * self.n_history, year_idx)
            result = (inp, tar, zen_inp.astype(np.float32), zen_tar.astype(np.float32))
        else:
            result = (inp, tar)

        # convert latitude grid if model grid differs from data grid
        result = tuple(np.asarray(self.grid_converter(r)) for r in result)
        return result

    def get_output_normalization(self):
        return self.out_bias, self.out_scale

    def get_input_normalization(self):
        return self.in_bias, self.in_scale
