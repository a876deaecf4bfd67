from makani_tpu_torch.models.common.activations import (
    ComplexActivation,
    ComplexReLU,
    get_activation,
)
from makani_tpu_torch.models.common.layers import (
    MLP,
    Conv1x1,
    DropPath,
    Dropout,
    EncoderDecoder,
    InstanceNorm2d,
    LayerNorm2d,
)
from makani_tpu_torch.models.common.spectral_convolution import SpectralAttention, SpectralConv

__all__ = ["get_activation", "ComplexReLU", "ComplexActivation", "Conv1x1", "DropPath",
           "Dropout", "MLP", "EncoderDecoder", "InstanceNorm2d", "LayerNorm2d", "SpectralAttention",
           "SpectralConv"]
