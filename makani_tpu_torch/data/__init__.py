from makani_tpu_torch.data.dataloader import DummyDataset, PrefetchingLoader, get_dataloader

__all__ = ["DummyDataset", "PrefetchingLoader", "get_dataloader"]
