from makani_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
from makani_tpu_torch.ops.fft3d import InverseRealFFT3, RealFFT3
from makani_tpu_torch.ops.sht import InverseRealSHT, RealSHT

__all__ = ["RealSHT", "InverseRealSHT", "RealFFT2", "InverseRealFFT2", "RealFFT3",
           "InverseRealFFT3"]
