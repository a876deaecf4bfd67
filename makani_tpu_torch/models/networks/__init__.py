from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet

__all__ = ["SphericalFourierNeuralOperatorNet"]
