from makani_tpu_torch.models.networks.afnonet import (
    AdaptiveFourierNeuralOperatorNetV1,
    PeriodicPad2d,
    PrecipNet,
)
from makani_tpu_torch.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNet
from makani_tpu_torch.models.networks.debug import DebugNet
from makani_tpu_torch.models.networks.sfnonet import (
    FourierNeuralOperatorNet,
    SphericalFourierNeuralOperatorNet,
)
from makani_tpu_torch.models.networks.vit import VisionTransformer

__all__ = ["AdaptiveFourierNeuralOperatorNet", "AdaptiveFourierNeuralOperatorNetV1", "DebugNet",
           "FourierNeuralOperatorNet", "PeriodicPad2d", "PrecipNet",
           "SphericalFourierNeuralOperatorNet", "VisionTransformer"]
