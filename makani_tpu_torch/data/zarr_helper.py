"""Zarr dataset support (gated on the ``zarr`` package).

Counterpart of makani_tpu/data/zarr_helper.py: yearly ``????.zarr`` stores
holding the same (time, channel, lat, lon) array as the HDF5 files.
ZarrDataset shares the window, normalization and zenith logic of
MultifilesDataset; only the storage hooks differ, since zarr arrays support
the same numpy-style slicing as h5py datasets. Without zarr, construction
raises ImportError.
"""

from makani_tpu_torch.data.dataset import MultifilesDataset
from makani_tpu_torch.utils.imports import import_optional

_HINT = ("convert the dataset to yearly HDF5 files or to raw npy shards "
         "(makani_tpu_torch.data.native_loader.convert_h5_to_bin) for the HDF5 or native loader")


def _zarr():
    return import_optional("zarr", "ZarrDataset (????.zarr stores)", _HINT)


class ZarrDataset(MultifilesDataset):
    """MultifilesDataset over yearly ``????.zarr`` stores."""

    _file_pattern = "????.zarr"

    def __init__(self, params, location, train, enable_logging=True):
        _zarr()
        super().__init__(params, location, train, enable_logging)

    def _peek_shape(self, path):
        return _zarr().open(path, mode="r")[self.dataset_path].shape

    def _open_file(self, year_idx):
        store = _zarr().open(self.files_paths[year_idx], mode="r")
        self.files[year_idx] = store[self.dataset_path]
