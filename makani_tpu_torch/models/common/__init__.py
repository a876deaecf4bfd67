from makani_tpu_torch.models.common.activations import get_activation
from makani_tpu_torch.models.common.layers import (
    MLP,
    Conv1x1,
    DropPath,
    EncoderDecoder,
    InstanceNorm2d,
)
from makani_tpu_torch.models.common.spectral_convolution import SpectralConv

__all__ = ["get_activation", "Conv1x1", "DropPath", "MLP", "EncoderDecoder",
           "InstanceNorm2d", "SpectralConv"]
