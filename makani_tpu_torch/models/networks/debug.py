"""Identity-times-scalar debug network of the autoregression pipeline
self-test (counterpart of makani_tpu/models/networks/debug.py)."""

import torch
from torch import nn


class DebugNet(nn.Module):
    """One parameter, `factor` (ones, shape (1,)): returns factor * x in x's
    dtype. Pointwise, so it runs on a spatial rank's patch as it is."""

    # runs on a spatial decomposition (spmd.spatially_parallel reads it)
    spatially_parallel = True

    def __init__(self, device="cpu", generator=None):
        super().__init__()
        del generator  # nothing is drawn
        self.factor = nn.Parameter(torch.ones(1, device=device))

    def forward(self, x, deterministic=True):
        return self.factor.to(x.dtype) * x
