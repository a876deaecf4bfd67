"""Device ms a unit of kernels, copies and sets launched inside the
program's span "model.filter", forward and backward: the blocks' spectral
filters (the SFNO's SHT, dhconv and inverse SHT with the eager work between
them; the AFNO v2 block's FFT, block MLP and inverse FFT), by
harness/spans.py."""

from benchmark.harness.spans import span_ms


def read(r, name):
    return span_ms(r, "model.filter")
