from makani_tpu_torch.utils.metrics.functions import (
    GeometricACC,
    GeometricL1,
    GeometricRMSE,
    Quadrature,
    SimpsonQuadrature,
    TrapezoidQuadrature,
)
