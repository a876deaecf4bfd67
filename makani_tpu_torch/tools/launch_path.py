"""The host's launch path of the probe kernels on the card, taken apart.

    python3 -m makani_tpu_torch.tools.launch_path [--json PATH]

At scripts/pallas_isolate.py's shapes (tools/kernel_isolate.py's CASES) a
probe's body runs for about a microsecond, so what a caller waits for is the
host's path from the Python call to the kernel reaching the card. This tool
measures that path four ways:

  parts    the host time of each step a launch path can take (the checks,
           `no_work`, the output's allocation, the device test, the stream
           lookup, the `data_ptr`s, the ctypes call with every argument
           prepared, the counters), each timed alone for probe_copy and
           probe_dot_plain, beside the whole wrapper and its PyTorch call;
  enqueue  the host time of one call of each of the seven probe wrappers and
           of its PyTorch call, and of `spectral_mm.legdot` at the flagship's
           inner grid (z (482, 384, 240), p (241, 240, 240), 3 passes),
           forward and backward;
  events   CUDA events around one call on an idle card (as chip_smoke.py
           times a kernel), the median of EVENT_REPS calls, the probe and its
           PyTorch call in ROUNDS interleaved rounds;
  device   kernel_isolate.device_ms of each probe and its PyTorch call
           (torch.profiler's kernel records), ROUNDS times;
  after    the enqueue once more, after those profiler sessions (it reads a
           few microseconds higher after them on the H100, so an enqueue
           that is compared is read before any session).

Host times are medians over batches of BATCH calls timed with
time.perf_counter_ns, the card synchronised between batches and never
inside one, so the launch queue stays far from full; the loop's own cost (a
call of an empty function) is subtracted. It also checks that probe_copy
gives its twin's bits and probe_dot_plain those of probe_dot_transposed on
aᵀ (both keep the fused multiply-adds in the order of c).

The package imported is whichever is first on the path, so the tool times an
older checkout's launch path from that checkout's root:
`cd OLD && PYTHONPATH=$PWD python3 NEW/makani_tpu_torch/tools/launch_path.py`;
it uses nothing of the package that such a checkout lacks. The card only:
it exits 1 without CUDA.
"""

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time

import torch

from makani_tpu_torch.ops import kernels, spectral_mm
from makani_tpu_torch.tools import kernel_isolate
from makani_tpu_torch.tools.bench_fused_adam import cuda_ms

BATCH = 256
HOST_CALLS = 40 * BATCH
EVENT_REPS = 50
ROUNDS = 3
# the flagship's inner grid: 241 orders (re and im rows), 384 channels, 240
# degrees and latitudes
LEGDOT_SHAPES = ((482, 384, 240), (241, 240, 240))
LEGDOT_CALLS = 128


def library_call(name, a, b=None):
    """One PyTorch call of probe case `name`'s function, its operands
    prepared here: the yardstick a probe is timed beside, never a path of
    the port."""
    if name == "copy":
        return lambda: torch.mul(a, 2.0)
    if name == "dot_plain":
        return lambda: torch.matmul(a, b)
    if name in ("dot_transposed", "bf16_split"):
        return lambda: torch.matmul(a.T, b)
    wt = b.transpose(-1, -2)
    if name == "grid_blocks":
        return lambda: torch.matmul(wt, a)
    # stacked_output_5d and multi_output: r and -r from one product with
    # [w^T, -w^T]
    w2 = torch.stack([wt, -wt]).unsqueeze(1)
    return lambda: torch.matmul(w2, a)


def host_ns(fn, calls=HOST_CALLS, batch=BATCH):
    """Median host nanoseconds of one call of `fn` over batches of `batch`
    calls, after one warm-up batch; a synchronise between batches only."""
    for _ in range(batch):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls // batch):
        t0 = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        per_call.append((time.perf_counter_ns() - t0) / batch)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def loop_ns():
    """The timing loop's own cost a call: an empty function's."""
    return host_ns(lambda: None)


def enqueue_us(fn, calls=HOST_CALLS, batch=BATCH):
    """Host microseconds to enqueue one call of `fn` on a card that is kept
    from filling its queue, the loop's cost subtracted."""
    return (host_ns(fn, calls, batch) - loop_ns()) / 1e3


def parts(name, inputs, shapes, dims, depth):
    """{step: host ns a call} of probe `name`'s launch, each step alone on
    prepared state; `ctypes call` launches the kernel."""
    f32 = torch.float32
    dev, first = inputs[0].device, inputs[0]
    index = dev.index
    outputs = [torch.empty(s, device=dev, dtype=f32) for s in shapes]
    ptrs = [t.data_ptr() for t in (*inputs, *outputs)]
    fn = kernels.launcher(name)
    # the same launcher called without releasing the GIL
    held = getattr(ctypes.PyDLL(str(kernels.BUILD_DIR / "libprobes.so")), f"{name}_launch")
    held.argtypes, held.restype = fn.argtypes, fn.restype
    # the handle kernels.stream gives, looked up here once: the tool also
    # runs against checkouts whose kernels module has no `stream`
    stream = torch._C._cuda_getCurrentRawStream(index)

    def checks():
        for t in inputs:
            if t.device != dev or t.dtype != f32 or not t.is_contiguous():
                raise ValueError(name)

    def counters():
        kernels.raise_on(0, name)
        kernels.launches[name] += 1

    def on_device():
        ctx = (contextlib.nullcontext() if index == torch.cuda.current_device()
               else torch.cuda.device(dev))
        with ctx:
            pass

    steps = {
        "dispatch: x.device.type": lambda: first.device.type == "cuda",
        "dispatch: x.is_cuda": lambda: first.is_cuda,
        "checks: device, dtype, contiguity": checks,
        "no_work, each output": lambda: [kernels.no_work(s, depth, dev) for s in shapes],
        "no work test: 0 in dims": lambda: 0 in dims,
        "torch.empty(shape, device=, dtype=)": lambda: [torch.empty(s, device=dev, dtype=f32)
                                                        for s in shapes],
        "x.new_empty(shape)": lambda: [first.new_empty(s) for s in shapes],
        "x.new_empty(*shape)": lambda: [first.new_empty(*s) for s in shapes],
        "torch.empty_like(x), (x's shape)": lambda: torch.empty_like(first),
        "device context: current_device() + nullcontext": on_device,
        "device test: torch._C._cuda_getDevice()": lambda: torch._C._cuda_getDevice() == index,
        "launcher(name)": lambda: kernels.launcher(name),
        "data_ptrs": lambda: [t.data_ptr() for t in (*inputs, *outputs)],
        "stream: current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "stream: _cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(index),
        "ctypes call, arguments prepared": lambda: fn(*ptrs, *dims, stream),
        "ctypes call, PyDLL (the GIL held)": lambda: held(*ptrs, *dims, stream),
        "counters: raise_on + the launch count": counters,
    }
    base = loop_ns()
    return {step: host_ns(call) - base for step, call in steps.items()}


def legdot_enqueue_us(dev, passes=3):
    """Host microseconds to enqueue legdot's forward and its backward at the
    inner grid (analysis), medians of LEGDOT_CALLS calls, synchronised every
    four calls (a call is ~0.3 ms on the card)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    zs, ps = LEGDOT_SHAPES
    z = torch.randn(zs, device=dev, generator=gen).requires_grad_()
    p = torch.randn(ps, device=dev, generator=gen)
    g = torch.randn((zs[0], zs[1], ps[1]), device=dev, generator=gen)
    fwd, bwd = [], []
    for i in range(LEGDOT_CALLS + 4):
        t0 = time.perf_counter_ns()
        y = spectral_mm.legdot(z, p, "k", passes)
        t1 = time.perf_counter_ns()
        y.backward(g)
        t2 = time.perf_counter_ns()
        if i >= 4:  # warm-up
            fwd.append((t1 - t0) / 1e3)
            bwd.append((t2 - t1) / 1e3)
        if i % 4 == 3:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(fwd), statistics.median(bwd)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def bits(dev):
    """(probe_copy equals its twin bit for bit, probe_dot_plain equals
    probe_dot_transposed on aᵀ bit for bit), at the script's shapes and at
    ragged ones whose rows are not a multiple of 4 floats."""
    (x,) = kernel_isolate.case_inputs([(8, 128)], 0, dev)
    copy_same = torch.equal(kernel_isolate.probe_copy(x), kernel_isolate.copy_plain(x))
    dot_same = True
    for shapes in ([(16, 16), (16, 128)], [(33, 70), (70, 130)], [(5, 7), (7, 9)]):
        a, b = kernel_isolate.case_inputs(shapes, 1, dev)
        got = kernel_isolate.probe_dot_plain(a, b)
        same = kernel_isolate.probe_dot_transposed(a.T.contiguous(), b)
        dot_same &= torch.equal(got.view(torch.int32), same.view(torch.int32))
    return copy_same, dot_same


def run():
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"card": card(), "device": torch.cuda.get_device_name(dev)}
    print(f"card: {rec['card']}", flush=True)
    kernels.build()
    cases = {c[0]: c for c in kernel_isolate.CASES[:7]}
    inputs = {name: kernel_isolate.case_inputs(c[1], 0, dev) for name, c in cases.items()}

    rec["bits"] = dict(zip(("copy_equals_twin", "dot_plain_equals_transposed"), bits(dev)))
    print(f"bits: {rec['bits']}", flush=True)

    # parts of the two redesigned probes' launch path
    (x,), (a, b) = inputs["copy"], inputs["dot_plain"]
    rec["parts_ns"] = {
        "copy": parts("probe_copy", (x,), [x.shape], (x.numel(),), 1),
        "dot_plain": parts("probe_dot_plain", (a, b), [(16, 128)], (16, 16, 128), 16)}
    for name, steps in rec["parts_ns"].items():
        print(f"[parts {name}] host ns a call, each step alone:", flush=True)
        for step, ns in steps.items():
            print(f"  {step}: {ns:.0f}", flush=True)

    # host enqueue of each probe and its PyTorch call
    rec["enqueue_us"] = {}
    for name, (_, _, kernel, _) in cases.items():
        args = inputs[name]
        rec["enqueue_us"][name] = (enqueue_us(lambda: kernel(*args)),
                                   enqueue_us(library_call(name, *args)))
    fwd, bwd = legdot_enqueue_us(dev)
    rec["legdot_inner_enqueue_us"] = {"forward": fwd, "backward": bwd}
    print("[enqueue] host us a call, the probe / its PyTorch call: " + "; ".join(
        f"{n} {k:.2f} / {lib:.2f}" for n, (k, lib) in rec["enqueue_us"].items())
        + f"; legdot inner analysis p3 forward {fwd:.1f}, backward {bwd:.1f}", flush=True)

    # CUDA events and device time, ROUNDS interleaved rounds
    events = {name: ([], []) for name in cases}
    device = {name: ([], []) for name in cases}
    for _ in range(ROUNDS):
        for name, (_, _, kernel, _) in cases.items():
            args = inputs[name]
            for i, fn in enumerate((lambda: kernel(*args), library_call(name, *args))):
                events[name][i].append(cuda_ms(fn, EVENT_REPS))
                device[name][i].append(1e3 * kernel_isolate.device_ms(
                    fn, kernel_isolate.DEVICE_REPS))
    rec["event_ms"], rec["device_us"] = events, device
    for label, table, fmt in (("events ms", events, "{:.4f}"), ("device us", device, "{:.3f}")):
        print(f"[{label}] the probe / its PyTorch call, median (all {ROUNDS} rounds):", flush=True)
        for name, (k, lib) in table.items():
            print(f"  {name}: {fmt.format(statistics.median(k))} "
                  f"({', '.join(fmt.format(t) for t in k)}) / "
                  f"{fmt.format(statistics.median(lib))} ({', '.join(fmt.format(t) for t in lib)})",
                  flush=True)

    # the enqueue again, after the profiler's sessions above
    rec["enqueue_after_profiler_us"] = {}
    for name, (_, _, kernel, _) in cases.items():
        args = inputs[name]
        rec["enqueue_after_profiler_us"][name] = (enqueue_us(lambda: kernel(*args)),
                                                  enqueue_us(library_call(name, *args)))
    print("[enqueue after the profiler] host us a call, the probe / its PyTorch call: "
          + "; ".join(f"{n} {k:.2f} / {lib:.2f}"
                      for n, (k, lib) in rec["enqueue_after_profiler_us"].items()), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the measurements here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_path: CUDA is not available", file=sys.stderr)
        return 1
    rec = run()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    ok = all(rec["bits"].values())
    print(f"launch_path: {'ok' if ok else 'FAILED: bits differ'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
