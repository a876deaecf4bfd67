"""Dataset dispatch and the host-side prefetching loader.

Counterpart of DummyDataset, PrefetchingLoader, get_dataloader and
BenchyLoader in makani_tpu/data/dataloader.py, for a single process: the same
datasets (synthetic, native npy shards, zarr, HDF5 multifiles), the same
seeded per-epoch permutation, the same evaluation loader (valid_autoreg_steps
targets, n_eval_samples, no shuffle, samples_offset) and the same batches.
Batches are numpy arrays; the Trainer and the Inferencer move them to their
device.

On several ranks (parallel/comm), `init_distributed_io` sets the io grid as
makani_tpu's does: a rank reads only its (lat/h, lon/w) window of the crop
(`io_grid`, `io_rank`; the datasets' read_anchor and read_shape), and the
loader of data rank r yields rows [r*b, (r+1)*b) of the global batch of
b * data samples, so that across its data ranks the port's global batch k
holds the samples, in the order, of makani_tpu's single-process global
batch k on the same mesh (makani_tpu/data/dataloader.py:29-55, 225-250).
Synthetic data is drawn whole and cut to the window.
"""

import concurrent.futures
import glob
import logging
import os
import time

import numpy as np
import torch

from makani_tpu_torch.data.dataset import MultifilesDataset
from makani_tpu_torch.parallel import comm, spmd
from makani_tpu_torch.utils.dataset_metadata import parse_dataset_metadata

logger = logging.getLogger(__name__)


class DummyDataset:
    """Synthetic random data matching all shape/normalization metadata: the
    training split (n_future targets, n_train_samples_per_epoch samples) or
    the evaluation split (valid_autoreg_steps targets, n_eval_samples)."""

    def __init__(self, params, location=None, train=True):
        self.dt = params.dt
        self.n_history = params.n_history
        self.n_future = params.valid_autoreg_steps if not train else params.n_future
        self.in_channels = np.array(params.in_channels)
        self.out_channels = np.array(params.out_channels)
        self.n_in_channels = len(self.in_channels)
        self.n_out_channels = len(self.out_channels)
        self.add_zenith = params.get("add_zenith", False)
        self.n_samples = (params.get("n_train_samples_per_epoch", 64) if train
                          else params.get("n_eval_samples", 16))

        self.img_shape = (params.img_shape_x, params.img_shape_y)
        self.img_shape_x, self.img_shape_y = self.img_shape
        self.img_crop_shape_x, self.img_crop_shape_y = self.img_shape
        self.img_crop_offset_x = self.img_crop_offset_y = 0
        io_grid = list(params.get("io_grid", [1, 1, 1]))[-2:]
        io_rank = list(params.get("io_rank", [0, 0, 0]))[-2:]
        split = [spmd.split_shapes(n, g) for n, g in zip(self.img_shape, io_grid)]
        self.read_shape = [s[r] for s, r in zip(split, io_rank)]
        self.read_anchor = [sum(s[:r]) for s, r in zip(split, io_rank)]
        self.img_local_shape_x, self.img_local_shape_y = self.read_shape
        self.img_local_offset_x, self.img_local_offset_y = self.read_anchor

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        (x0, y0), (nx, ny) = self.read_anchor, self.read_shape

        def draw(*lead):
            field = rng.randn(*lead, *self.img_shape).astype(np.float32)
            if (nx, ny) == tuple(self.img_shape):
                return field
            return np.ascontiguousarray(field[..., x0:x0 + nx, y0:y0 + ny])

        inp = draw(self.n_history + 1, self.n_in_channels)
        tar = draw(self.n_future + 1, self.n_out_channels)
        if self.add_zenith:
            return inp, tar, draw(self.n_history + 1, 1), draw(self.n_future + 1, 1)
        return inp, tar

    def get_output_normalization(self):
        n = self.n_out_channels
        return np.zeros((1, n, 1, 1), np.float32), np.ones((1, n, 1, 1), np.float32)

    def get_input_normalization(self):
        n = self.n_in_channels
        return np.zeros((1, n, 1, 1), np.float32), np.ones((1, n, 1, 1), np.float32)


# batches read ahead of the one being yielded
_PREFETCH_DEPTH = 2


class PrefetchingLoader:
    """Iterates batches with background read-ahead.

    Per epoch: the samples from `samples_offset` on, in a permutation seeded
    with (base_seed + epoch) when `shuffle`, else in order, truncated to
    n_samples_per_epoch and grouped into full batches (a partial last batch
    is dropped).
    """

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=2,
                 n_samples_per_epoch=None, base_seed=333, samples_offset=0, num_shards=1,
                 shard_id=0):
        self.dataset = dataset
        self.batch_size = batch_size
        # data ranks: the epoch is cut into global batches of
        # batch_size * num_shards, of which this loader yields rows
        # [shard_id * batch_size, (shard_id + 1) * batch_size)
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.base_seed = base_seed
        # offset of the first initial condition an evaluation reads
        self.samples_offset = samples_offset
        self.epoch = 0

        n_avail = len(dataset) - samples_offset
        self.n_samples_per_epoch = min(n_samples_per_epoch or n_avail, n_avail)
        self.num_batches = self.n_samples_per_epoch // (batch_size * num_shards)
        if self.num_batches <= 0:
            raise ValueError(f"Not enough samples ({self.n_samples_per_epoch}) for one batch "
                             f"of {batch_size * num_shards}")

        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=self.num_workers)

    def __len__(self):
        return self.num_batches

    def _epoch_indices(self):
        if self.shuffle:
            rng = np.random.RandomState(self.base_seed + self.epoch)
            perm = rng.permutation(len(self.dataset) - self.samples_offset)
            perm = perm[: self.n_samples_per_epoch]
        else:
            perm = np.arange(self.n_samples_per_epoch)
        return perm + self.samples_offset

    def _collate(self, samples):
        n_fields = len(samples[0])
        if len(samples) == 1:
            # batch 1 (the flagship case): a view, no copy of the sample
            return tuple(samples[0][i][None] for i in range(n_fields))
        return tuple(np.stack([s[i] for s in samples], axis=0) for i in range(n_fields))

    def __iter__(self):
        indices = self._epoch_indices()
        global_batch = self.batch_size * self.num_shards
        first = self.shard_id * self.batch_size
        batches = [indices[i * global_batch + first: i * global_batch + first + self.batch_size]
                   for i in range(self.num_batches)]
        self.epoch += 1

        def load_batch(batch_idx):
            return self._collate([self.dataset[int(i)] for i in batches[batch_idx]])

        depth = min(_PREFETCH_DEPTH, len(batches))
        futures = [self._executor.submit(load_batch, i) for i in range(depth)]
        for i in range(len(batches)):
            batch = futures[i % depth].result()
            nxt = i + depth
            if nxt < len(batches):
                futures[nxt % depth] = self._executor.submit(load_batch, nxt)
            yield batch


def init_data_params(params):
    """Before the Trainer or the Inferencer builds its loaders: for data from
    files, data.json (`metadata_json_path`, where the config names one) sets
    the channel lists, the grid and the time step, as makani_tpu's train.py
    and inference.py parse it; synthetic data takes the config's channels.
    n_future defaults to 0, one-step targets, as train.py sets it from its
    default multistep_count of 1."""
    if params.get("n_future", None) is None:
        params["n_future"] = 0
    if params.get("enable_synthetic_data", False):
        if params.get("in_channels", None) is None or params.get("out_channels", None) is None:
            raise ValueError("synthetic data needs in_channels/out_channels in the config")
    elif params.get("metadata_json_path", None):
        parse_dataset_metadata(params.metadata_json_path, params)
    return params


def init_distributed_io(params):
    """The data shard and the io window of this rank (parallel/comm): the
    data rank's shard of each global batch, and the rank's (h, w) window of
    the crop (makani_tpu's init_distributed_io, with every rank a process).
    Serial: one shard, the whole crop."""
    params["data_num_shards"] = comm.get_size("data")
    params["data_shard_id"] = comm.get_rank("data")
    params["io_grid"] = [1, comm.get_size("h"), comm.get_size("w")]
    params["io_rank"] = [0, comm.get_rank("h"), comm.get_rank("w")]
    return params


def to_device(data, device):
    """A loader batch, (inp, tar) or (inp, tar, zen_inp, zen_tar), as four
    tensors on `device` (the zenith fields None without them)."""
    if len(data) == 4:
        inp, tar, zen_inp, zen_tar = data
    else:
        (inp, tar), zen_inp, zen_tar = data, None, None
    return tuple(None if x is None else torch.as_tensor(x).to(device)
                 for x in (inp, tar, zen_inp, zen_tar))


def _holds(location, pattern):
    return isinstance(location, str) and bool(glob.glob(os.path.join(location, pattern)))


def get_dataloader(params, location, train=True, final_eval=False, enable_logging=True):
    """(dataloader, dataset) of the data at `location` for a single process:
    synthetic data under enable_synthetic_data, the native reader for npy
    shards (or enable_native_loader), zarr stores (or enable_zarr), else the
    HDF5 multifiles dataset. `train` shuffles n_train_samples_per_epoch
    samples of n_future targets; the evaluation loader reads n_eval_samples
    from samples_offset on, in order, each with valid_autoreg_steps targets.
    `final_eval` is makani_tpu's flag, which chooses nothing there either.
    On several ranks the loader yields the rank's rows of each global batch
    and the datasets read the rank's window (`init_distributed_io`)."""
    init_distributed_io(params)

    if params.get("enable_synthetic_data", False):
        dataset = DummyDataset(params, location, train)
    elif params.get("enable_native_loader", False) or (
            _holds(location, "????.npy") and not _holds(location, "????.h5")):
        from makani_tpu_torch.data.native_loader import BinaryDataset
        dataset = BinaryDataset(params, location, train, enable_logging)
    elif params.get("enable_zarr", False) or (
            _holds(location, "????.zarr") and not _holds(location, "????.h5")):
        from makani_tpu_torch.data.zarr_helper import ZarrDataset
        dataset = ZarrDataset(params, location, train, enable_logging)
    else:
        dataset = MultifilesDataset(params, location, train, enable_logging)

    n_samples_per_epoch = None
    if train and params.get("n_train_samples_per_epoch", None):
        n_samples_per_epoch = params.n_train_samples_per_epoch
    if (not train) and params.get("n_eval_samples", None):
        n_samples_per_epoch = params.n_eval_samples

    loader = PrefetchingLoader(
        dataset,
        batch_size=int(params.batch_size),
        shuffle=train,
        num_workers=params.get("num_data_workers", 2),
        n_samples_per_epoch=n_samples_per_epoch,
        base_seed=params.get("global_seed", 333),
        samples_offset=0 if train else params.get("samples_offset", 0) or 0,
        num_shards=params.data_num_shards,
        shard_id=params.data_shard_id,
    )
    loader.get_output_normalization = dataset.get_output_normalization
    loader.get_input_normalization = dataset.get_input_normalization

    if train and params.get("enable_benchy", False):
        loader = BenchyLoader(loader)
    return loader, dataset


class BenchyLoader:
    """Throughput-instrumented loader wrapper: logs batches/s and the
    effective MB/s of each epoch."""

    def __init__(self, loader):
        self._loader = loader

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __iter__(self):
        t0 = time.perf_counter()
        n, nbytes = 0, 0
        for batch in self._loader:
            n += 1
            nbytes += sum(int(b.nbytes) for b in batch)
            yield batch
        dt = max(time.perf_counter() - t0, 1e-9)
        logger.info(f"[benchy] {n} batches in {dt:.2f}s: {n / dt:.2f} batches/s, "
                    f"{nbytes / dt / 1e6:.2f} MB/s effective")
