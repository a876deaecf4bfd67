from makani_tpu_torch.ops.sht import InverseRealSHT, RealSHT

__all__ = ["RealSHT", "InverseRealSHT"]
