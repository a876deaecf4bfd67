"""Reading a torch.profiler Chrome trace of the traced window.

A frozen copy of the program's trace arithmetic
(makani_tpu_torch/tools/profile_forward.py: `_OWN`, `device_events`,
`busy_ms`), so that the yardstick does not move when the program's tool
does. Device time is split into the port's own kernels (by name), cuBLAS
products, cuFFT transforms, copies to the host, and the rest (elementwise
work, reductions, norms, other copies and sets); a kernel's phase is the
profiler range of the step it ran in (the Trainer's
"train_step.forward" / ".backward" / ".optimizer").
"""

import json
from collections import defaultdict
from pathlib import Path

# the port's kernels by name; the prep kernels are the port's own but are
# no one kernel's work
OWN = {"legmm_kernel": "legmm", "dhconv_dw_kernel": "dhconv_dw",
       "fused_adam_kernel": "fused_adam", "dhconv_gemm<false": "dhconv_mm",
       "dhconv_gemm<true": "dhconv_complex", "prep_weight": "dhconv weight prep",
       "gridmm_kernel": "gridmm", "prep_table": "gridmm table prep",
       "gelu_bf16_kernel": "gelu_bf16", "gelu_bf16_grad_kernel": "gelu_bf16_grad"}
GEMM_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::addbmm",
            "aten::matmul", "aten::linear"}
FFT_OPS = {"aten::_fft_r2c", "aten::_fft_c2r", "aten::_fft_c2c"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def own_kernel(name):
    for key, label in OWN.items():
        if any(key + end in name for end in "<(,"):
            return label
    return None


def category(event, ops):
    """"own:<kernel>", "cublas", "cufft", "d2h" or "eager"."""
    name = event["name"]
    own = own_kernel(name)
    if own is not None:
        return "own:" + own
    if event["cat"] == "gpu_memcpy":
        return "d2h" if "DtoH" in name else "eager"
    if event["cat"] != "kernel":
        return "eager"
    op = ops.get(event.get("args", {}).get("External id"))
    opname = op["name"] if op is not None else ""
    low = name.lower()
    if "fft" in low or opname in FFT_OPS:
        return "cufft"
    if "gemm" in low or "cutlass" in low or "xmma" in low or opname in GEMM_OPS:
        return "cublas"
    return "eager"


def merged(intervals):
    """The union of (start, stop) intervals, as sorted disjoint intervals."""
    out = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def busy_us(intervals):
    """The length of the union of (start, stop) intervals."""
    return sum(stop - start for start, stop in merged(intervals))


class Trace:
    """The device's and the host's events of the traced window, which the
    host range named `window` spans."""

    def __init__(self, path, window="bench.traced"):
        events = json.loads(Path(path).read_text())["traceEvents"]
        spans = [e for e in events if e.get("name") == window and e.get("cat") in HOST_CATS]
        if not spans:
            raise ValueError(f"no {window!r} range in the trace {path}")
        self.t0 = spans[0]["ts"]
        self.t1 = spans[0]["ts"] + spans[0]["dur"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
                       and self.t0 <= e["ts"] <= self.t1]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
                     and e.get("name") != window]
        cpu_ops = [e for e in events if e.get("cat") == "cpu_op" and "args" in e]
        self.ops = {e["args"].get("External id"): e for e in cpu_ops}
        self.phases = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "gpu_user_annotation" and "dur" in e]

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self):
        return busy_us([(e["ts"], min(e["ts"] + e["dur"], self.t1)) for e in self.device]) / 1e6

    def seconds_by(self, key):
        """Device seconds summed by key(event)."""
        out = defaultdict(float)
        for e in self.device:
            out[key(e)] += e["dur"] / 1e6
        return dict(out)

    def by_category(self):
        return self.seconds_by(lambda e: category(e, self.ops))

    def phase_of(self, event):
        """The profiler range on the device whose span holds the event's
        start (None outside every range)."""
        for name, a, b in self.phases:
            if a <= event["ts"] <= b:
                return name
        return None

    def by_phase(self):
        return self.seconds_by(lambda e: self.phase_of(e) or "none")

    def top_ops(self, n=10):
        """The n device operations that took most time, by name, seconds."""
        table = self.seconds_by(lambda e: e["name"])
        return sorted(([k, v] for k, v in table.items()), key=lambda kv: -kv[1])[:n]

    def host_at(self, t):
        """The innermost host range running at time t (its name)."""
        best = None
        for e in self.host:
            if e["ts"] <= t <= e["ts"] + e["dur"]:
                if best is None or e["dur"] < best["dur"]:
                    best = e
        return best["name"] if best is not None else "host, between operators"

    def idle_gaps(self, n=10):
        """The n longest stretches of the window with nothing on the device,
        each named by what the host was doing when it began, seconds."""
        busy = merged([(e["ts"], e["ts"] + e["dur"]) for e in self.device])
        gaps, last = [], self.t0
        for start, stop in busy:
            if start > last:
                gaps.append((start - last, last))
            last = max(last, stop)
        if self.t1 > last:
            gaps.append((self.t1 - last, last))
        gaps.sort(reverse=True)
        return [[self.host_at(t), d / 1e6] for d, t in gaps[:n]]
