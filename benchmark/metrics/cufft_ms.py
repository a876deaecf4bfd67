"""Device ms a unit of cuFFT transforms (kernels named as FFTs, or launched
by an FFT operator): the AFNO filter's rfft2 and irfft2."""


def read(r, name):
    s = r.trace.by_category().get("cufft", 0.0)
    return 1e3 * s / r.units if s else None
