"""Device ms a unit of kernels that are neither the port's own nor cuBLAS
nor cuFFT, nor copies to the host: PyTorch's elementwise work, reductions,
norms, other copies and sets."""


def read(r, name):
    s = r.trace.by_category().get("eager", 0.0)
    return 1e3 * s / r.units if s else None
