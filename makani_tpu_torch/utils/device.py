"""Device selection for the port's entry points.

Entry points (get_model, Inferencer) run on the GPU unless the caller asks for
the CPU: there is no silent CPU fallback when CUDA is missing.
"""

import torch


def resolve_device(device=None):
    """None -> "cuda". Raises when a CUDA device is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
