"""Device selection for the port's entry points.

Entry points (get_model, Inferencer) run on the GPU unless the caller asks for
the CPU: there is no silent CPU fallback when CUDA is missing. Under a
process group (parallel/comm) "cuda" is the rank's card.
"""

import torch

from makani_tpu_torch.parallel import comm


def resolve_device(device=None):
    """None -> "cuda". Raises when a CUDA device is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    rank_device = comm.get_device()
    if device.type == "cuda" and device.index is None and rank_device is not None \
            and rank_device.type == "cuda":
        device = rank_device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
