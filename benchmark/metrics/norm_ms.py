"""Device ms a unit of kernels, copies and sets launched inside the
program's span "model.norm", forward and backward: the norms
(models/common/layers.apply_norm: InstanceNorm2d, LayerNormHW), by
harness/spans.py."""

from benchmark.harness.spans import span_ms


def read(r, name):
    return span_ms(r, "model.norm")
