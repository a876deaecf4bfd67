from makani_tpu_torch.models.common.activations import (
    ComplexActivation,
    ComplexReLU,
    get_activation,
)
from makani_tpu_torch.models.common.attention import (
    scaled_dot_product_attention,
    set_attention_block_size,
)
from makani_tpu_torch.models.common.layers import (
    MLP,
    Conv1x1,
    DenseLayer,
    DropPath,
    Dropout,
    EncoderDecoder,
    InstanceNorm2d,
    LayerNorm,
    LayerNorm2d,
    PatchEmbed,
)
from makani_tpu_torch.models.common.spectral_convolution import SpectralAttention, SpectralConv

__all__ = ["get_activation", "ComplexReLU", "ComplexActivation", "Conv1x1", "DenseLayer",
           "DropPath", "Dropout", "MLP", "EncoderDecoder", "InstanceNorm2d", "LayerNorm",
           "LayerNorm2d", "PatchEmbed", "SpectralAttention", "SpectralConv",
           "scaled_dot_product_attention", "set_attention_block_size"]
