"""Synthetic dataset and the host-side prefetching loader.

Counterpart of DummyDataset, PrefetchingLoader and the synthetic training
branch of get_dataloader in makani_tpu/data/dataloader.py: the same samples
(numpy RandomState seeded by the sample index), the same seeded per-epoch
permutation and the same batches. Batches are numpy arrays; the Trainer
moves them to its device.

Not ported yet (ROADMAP, Queue 1): the evaluation loader (validation, item
14), the file datasets (HDF5, zarr, the native binary reader), sharding over
data ranks (parallelism) and the benchy wrapper.
"""

import concurrent.futures

import numpy as np


class DummyDataset:
    """Synthetic random training data matching all shape/normalization
    metadata."""

    def __init__(self, params):
        self.dt = params.dt
        self.n_history = params.n_history
        self.n_future = params.n_future
        self.in_channels = np.array(params.in_channels)
        self.out_channels = np.array(params.out_channels)
        self.n_in_channels = len(self.in_channels)
        self.n_out_channels = len(self.out_channels)
        self.add_zenith = params.get("add_zenith", False)
        self.n_samples = params.get("n_train_samples_per_epoch", 64)

        self.img_shape = (params.img_shape_x, params.img_shape_y)
        self.img_shape_x, self.img_shape_y = self.img_shape
        self.img_crop_shape_x, self.img_crop_shape_y = self.img_shape
        self.img_crop_offset_x = self.img_crop_offset_y = 0
        self.img_local_shape_x, self.img_local_shape_y = self.img_shape
        self.img_local_offset_x = self.img_local_offset_y = 0

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        inp = rng.randn(self.n_history + 1, self.n_in_channels, *self.img_shape).astype(np.float32)
        tar = rng.randn(self.n_future + 1, self.n_out_channels, *self.img_shape).astype(np.float32)
        if self.add_zenith:
            zen_inp = rng.randn(self.n_history + 1, 1, *self.img_shape).astype(np.float32)
            zen_tar = rng.randn(self.n_future + 1, 1, *self.img_shape).astype(np.float32)
            return inp, tar, zen_inp, zen_tar
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
    """Iterates training batches with background read-ahead.

    Per epoch: a permutation seeded with (base_seed + epoch), truncated to
    n_samples_per_epoch, grouped into full batches (a partial last batch is
    dropped).
    """

    def __init__(self, dataset, batch_size, num_workers=2, n_samples_per_epoch=None,
                 base_seed=333):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.base_seed = base_seed
        self.epoch = 0

        self.n_samples_per_epoch = min(n_samples_per_epoch or len(dataset), len(dataset))
        self.num_batches = self.n_samples_per_epoch // batch_size
        if self.num_batches == 0:
            raise ValueError(f"Not enough samples ({self.n_samples_per_epoch}) for one batch "
                             f"of {batch_size}")

        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=self.num_workers)

    def __len__(self):
        return self.num_batches

    def _epoch_indices(self):
        rng = np.random.RandomState(self.base_seed + self.epoch)
        return rng.permutation(len(self.dataset))[: self.n_samples_per_epoch]

    def _collate(self, samples):
        n_fields = len(samples[0])
        if len(samples) == 1:
            # batch 1 (the flagship case): a view, no copy of the sample
            return tuple(samples[0][i][None] for i in range(n_fields))
        return tuple(np.stack([s[i] for s in samples], axis=0) for i in range(n_fields))

    def __iter__(self):
        indices = self._epoch_indices()
        batches = [indices[i * self.batch_size: (i + 1) * self.batch_size]
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


def get_dataloader(params):
    """(dataloader, dataset) of the training data of a single process;
    synthetic data only."""
    if not params.get("enable_synthetic_data", False):
        raise NotImplementedError("file datasets are not ported yet; set "
                                  "enable_synthetic_data (ROADMAP: Queue 1, data)")
    dataset = DummyDataset(params)
    loader = PrefetchingLoader(
        dataset,
        batch_size=int(params.batch_size),
        num_workers=params.get("num_data_workers", 2),
        n_samples_per_epoch=params.get("n_train_samples_per_epoch", None),
        base_seed=params.get("global_seed", 333),
    )
    loader.get_output_normalization = dataset.get_output_normalization
    loader.get_input_normalization = dataset.get_input_normalization
    return loader, dataset
