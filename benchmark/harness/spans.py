"""Device time by the program's spans ("model.norm", "model.filter",
"model.mlp": makani_tpu_torch/utils/tracing.py), forward and backward.

A device event (kernel, copy, set) is put down to the op that launched it,
found by its "External id" as harness/trace.category finds it (among the
host's cpu ops and ranges). Forward: the event belongs to span X when that op
starts inside a host range X on its thread. Backward: when the op starts
inside an "autograd::engine::evaluate_function: ..." op whose "Sequence
number" is that of the autograd node made inside X. A node's number is the
one its forward op recorded; of the forward ops that recorded a number, the
last to start made the node (the counter moves on after it), leaving out
the node's own apply, which runs inside its backward op and records it too.
The counter is a thread's, and the program's forward runs on one thread.
Where spans nest the innermost wins. Events outside every span are put down
to None.
"""

import weakref
from collections import defaultdict

PREFIX = "model."
BACKWARD = "autograd::engine::evaluate_function:"
LAUNCHERS = ("cpu_op", "user_annotation")
_TABLES = weakref.WeakKeyDictionary()


def innermost(ranges, points):
    """For each point, the payload of the innermost range (start, stop,
    payload) holding it, or None; a thread's ranges nest."""
    order = sorted(range(len(points)), key=points.__getitem__)
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [None] * len(points), [], 0
    for k in order:
        t = points[k]
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def _by_thread(items, tid=lambda e: e.get("tid")):
    out = defaultdict(list)
    for e in items:
        out[tid(e)].append(e)
    return out


def _range(e, payload):
    return (e["ts"], e["ts"] + e["dur"], payload)


def _seq(e):
    return e.get("args", {}).get("Sequence number")


def span_seconds(trace, prefix=PREFIX):
    """{(span, "forward" | "backward"): device seconds} of the trace's device
    events, (None, None) for those outside every span."""
    host = [e for e in trace.host if e.get("cat") in LAUNCHERS]
    launcher = {e["args"]["External id"]: e for e in host if "External id" in e.get("args", {})}
    spans = _by_thread(e for e in host
                       if e["cat"] == "user_annotation" and e["name"].startswith(prefix))
    spans = {tid: [_range(e, e["name"]) for e in es] for tid, es in spans.items()}
    ops = [e for e in host if e["cat"] == "cpu_op" and _seq(e) is not None]
    backward = _by_thread(e for e in ops if e["name"].startswith(BACKWARD))
    backward = {tid: [_range(e, _seq(e)) for e in es] for tid, es in backward.items()}
    # each autograd node's span: that of the last forward op to record its
    # number (not the node's own apply, which runs inside its backward op)
    node, started = {}, {}
    for tid, fwd in _by_thread(e for e in ops if not e["name"].startswith(BACKWARD)).items():
        starts = [op["ts"] for op in fwd]
        for op, name, under in zip(fwd, innermost(spans.get(tid, []), starts),
                                   innermost(backward.get(tid, []), starts)):
            seq = _seq(op)
            if seq != under and op["ts"] >= started.get(seq, op["ts"]):
                started[seq], node[seq] = op["ts"], name
    out = defaultdict(float)
    pairs = [(ev, launcher.get(ev.get("args", {}).get("External id"))) for ev in trace.device]
    by_launcher = _by_thread(pairs, lambda p: None if p[1] is None else p[1].get("tid"))
    for tid, group in by_launcher.items():
        if tid is None:
            out[(None, None)] += sum(ev["dur"] for ev, _ in group) / 1e6
            continue
        starts = [op["ts"] for _, op in group]
        fwd = innermost(spans.get(tid, []), starts)
        seqs = innermost(backward.get(tid, []), starts)
        for (ev, _), name, seq in zip(group, fwd, seqs):
            if name is not None:
                key = (name, "forward")
            elif node.get(seq) is not None:
                key = (node[seq], "backward")
            else:
                key = (None, None)
            out[key] += ev["dur"] / 1e6
    return dict(out)


def span_ms(r, span):
    """Device ms a unit inside `span`, forward and backward, or None where
    the trace has no such span (a program without spans)."""
    table = _TABLES.get(r.trace)
    if table is None:
        table = _TABLES[r.trace] = span_seconds(r.trace)
    s = sum(v for (name, _), v in table.items() if name == span)
    return 1e3 * s / r.units if s else None
