"""The span readers (harness/spans.py; metrics norm_ms, filter_ms, mlp_ms)
on a hand-built Chrome trace, and host_lead_ms on a patched counter.

The trace: on the main thread a "model.norm" range, an op outside every
span, and a "model.filter" range holding a nested "model.mlp" range and a
kernel launched by the filter's range itself; on the autograd thread the
backward's "evaluate_function" ops with the forward's sequence numbers.
Each kernel's span, worked out by hand, is in the comment beside it.
"""

import json
import sys
from types import SimpleNamespace

import pytest

from benchmark.harness.spans import innermost, span_seconds
from benchmark.harness.spec import load_reader
from benchmark.harness.trace import Trace

EVAL = "autograd::engine::evaluate_function: "


def op(name, ts, dur, ext, seq=None, tid=1, cat="cpu_op"):
    args = {"External id": ext}
    if seq is not None:
        args["Sequence number"] = seq
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def kernel(ts, dur, ext=None, cat="kernel"):
    return {"name": f"k{ts}", "cat": cat, "ts": ts, "dur": dur, "tid": 7,
            "args": {} if ext is None else {"External id": ext}}


HOST = [
    {"name": "bench.traced", "cat": "user_annotation", "ts": 0, "dur": 10000, "tid": 1},
    op("model.norm", 100, 100, 1, cat="user_annotation"),
    op("aten::native_batch_norm", 110, 50, 2, seq=5),
    op("aten::view", 170, 5, 3, seq=6),
    # records 7 but makes no node: aten::gelu, outside, makes node 7
    op("aten::to", 190, 5, 4, seq=7),
    op("aten::gelu", 250, 20, 5, seq=7),
    op("model.filter", 300, 400, 6, cat="user_annotation"),
    op("aten::mm", 310, 5, 7, seq=8),
    op("_LegDot", 320, 10, 30, seq=11),
    op("model.mlp", 400, 100, 8, cat="user_annotation"),
    op("aten::bmm", 410, 30, 9, seq=9),
    # the backward, on the autograd thread; each node's apply inside its op
    op(EVAL + "GeluBackward0", 1000, 50, 20, seq=7, tid=2),
    op("GeluBackward0", 1001, 40, 21, seq=7, tid=2),
    op("aten::gelu_backward", 1005, 30, 22, tid=2),
    op(EVAL + "NativeBatchNormBackward0", 1100, 50, 23, seq=5, tid=2),
    op("NativeBatchNormBackward0", 1101, 40, 24, seq=5, tid=2),
    op("aten::native_batch_norm_backward", 1105, 30, 25, tid=2),
    op(EVAL + "MmBackward0", 1200, 50, 26, seq=8, tid=2),
    op("aten::mm", 1210, 30, 27, tid=2),
    op(EVAL + "BmmBackward0", 1300, 50, 28, seq=9, tid=2),
    op("aten::bmm", 1310, 30, 29, tid=2),
    op(EVAL + "_LegDotBackward", 1500, 50, 31, seq=11, tid=2),
]
DEVICE = [
    kernel(2000, 10, 2),    # norm, forward
    kernel(2010, 1, 3),     # norm, forward
    kernel(2020, 4, 5),     # outside
    kernel(2030, 20, 7),    # filter, forward
    kernel(2050, 8, 9),     # mlp, forward (nested in the filter: innermost)
    kernel(2060, 6, 6),     # filter, forward (launched by the range itself)
    kernel(2070, 5, 30),    # filter, forward
    kernel(3000, 7, 22),    # outside: node 7 is aten::gelu's
    kernel(3010, 12, 25),   # norm, backward
    kernel(3030, 3, 24, "gpu_memcpy"),  # norm, backward (the node's apply)
    kernel(3040, 30, 27),   # filter, backward
    kernel(3070, 16, 29),   # mlp, backward
    kernel(3090, 9, 31),    # filter, backward (launched by the backward op itself)
    kernel(3100, 2),        # outside: no External id
    kernel(3110, 1, 999),   # outside: no such op
]
UNITS = 2


def readings(tmp_path, host=HOST):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": host + DEVICE}))
    return SimpleNamespace(trace=Trace(path), units=UNITS)


def test_span_seconds_by_hand(tmp_path):
    table = span_seconds(readings(tmp_path).trace)
    assert table == pytest.approx({
        ("model.norm", "forward"): 11e-6, ("model.norm", "backward"): 15e-6,
        ("model.filter", "forward"): 31e-6, ("model.filter", "backward"): 39e-6,
        ("model.mlp", "forward"): 8e-6, ("model.mlp", "backward"): 16e-6,
        (None, None): 14e-6})
    assert sum(table.values()) == pytest.approx(sum(e["dur"] for e in DEVICE) / 1e6)


@pytest.mark.parametrize("name, ms", [("norm_ms.train", 26e-3 / UNITS),
                                      ("filter_ms.serve", 70e-3 / UNITS),
                                      ("mlp_ms.train", 24e-3 / UNITS)])
def test_span_readers(tmp_path, name, ms):
    assert load_reader(name)(readings(tmp_path), name) == pytest.approx(ms)


def test_no_spans_read_nothing(tmp_path):
    # a program without spans (the parent's): nothing, and no error
    host = [e for e in HOST if not e["name"].startswith("model.")]
    r = readings(tmp_path, host)
    for name in ("norm_ms.train", "filter_ms.serve", "mlp_ms.train"):
        assert load_reader(name)(r, name) is None


def test_innermost():
    ranges = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d"), (200, 300, "e")]
    points = [5, 25, 20, 30, 40, 65, 80, 150, 300, -1]
    assert innermost(ranges, points) == ["a", "c", "c", "c", "b", "d", "a", None, "e", None]
    assert innermost([], [1, 2]) == [None, None]


def test_host_lead_reads_the_programs_counter(monkeypatch):
    from makani_tpu_torch.utils import tracing
    asked = []
    monkeypatch.setattr(tracing, "leads", lambda loop: asked.append(loop) or [4.0, 0.5, 30.0])
    read = load_reader("host_lead_ms.serve")
    assert read(None, "host_lead_ms.serve") == 4.0
    assert read(None, "host_lead_ms.train") == 4.0
    assert asked == ["serve", "train"]
    monkeypatch.setattr(tracing, "leads", lambda loop: [])
    assert read(None, "host_lead_ms.serve") is None


def test_host_lead_without_the_counter(monkeypatch):
    # a program without utils/tracing.py (the parent's): nothing, and no error
    import makani_tpu_torch.utils
    monkeypatch.delattr(makani_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "makani_tpu_torch.utils.tracing", None)
    assert load_reader("host_lead_ms.train")(None, "host_lead_ms.train") is None
