"""Device ms a unit of kernels, copies and sets launched inside the
program's span "model.mlp", forward and backward: the blocks' MLPs (their
1x1 mixes, GELU and dropout), by harness/spans.py."""

from benchmark.harness.spans import span_ms


def read(r, name):
    return span_ms(r, "model.mlp")
