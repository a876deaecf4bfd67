from makani_tpu_torch.models.networks.debug import DebugNet
from makani_tpu_torch.models.networks.sfnonet import (
    FourierNeuralOperatorNet,
    SphericalFourierNeuralOperatorNet,
)

__all__ = ["DebugNet", "FourierNeuralOperatorNet", "SphericalFourierNeuralOperatorNet"]
