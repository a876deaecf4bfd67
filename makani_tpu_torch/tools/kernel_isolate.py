"""The probe battery on the card: the counterpart of scripts/pallas_isolate.py.

    python3 -m makani_tpu_torch.tools.kernel_isolate [case ...] [--device cpu]

Nine cases, the script's names and shapes (C = O = 16, M = 128, B = 2, L = 4,
float32): the seven probe kernels of csrc/probes.cu, each isolating one
construct of the dhconv kernel, and the complex dhconv kernel
(csrc/dhconv_complex.cu, through complex_kernels.contract_dhconv_kernel)
forward and through its autograd backward. The script fed constants (ones,
1.234567); here each case's inputs are normal values from a numpy seed, so a
transposed operand cannot hide. Each case runs its kernel, checks it against
the plain twin on the same inputs (TWIN_TOL of the largest magnitude) and
prints PASS or FAIL as the script does; a case that raises is reported as
FAIL and the battery goes on. `main` returns 1 if any case failed.

Each probe has a wrapper that launches its kernel on CUDA tensors (counted in
kernels.launches["probe_<name>"]) and runs its twin, `<name>_plain`, on CPU
tensors (device="cpu", as the tests run it). On a CUDA tensor with nothing to
compute (an empty output, or a contraction of length 0) a wrapper returns the
empty output or zeros, as the twin does, without a launch.
"""

import argparse
import json
import sys

import numpy as np
import torch

from makani_tpu_torch.ops import complex_kernels
from makani_tpu_torch.ops.kernels import BUILD_DIR, dispatch, launch, no_work
from makani_tpu_torch.ops.spectral_mm import split_bf16
from makani_tpu_torch.utils.device import resolve_device

C, O, M = 16, 16, 128
B, L = 2, 4
# kernel vs twin: the same float32 products (bf16 parts for bf16_split)
# summed in another order, a few ulps of the largest partial sum
TWIN_TOL = 1e-5
# calls a device time is summed over (device_ms)
DEVICE_REPS = 200
# profiler sessions device_ms threw away for lost records
discarded_sessions = 0
# the spin kernel that opens and closes a profiler session (_device_records)
SPIN_CYCLES = 1000


def _device_of(name, inputs):
    """The device of probe `name`'s inputs, which must be contiguous float32
    tensors on one device (the first's; each other is compared with it)."""
    dev = inputs[0].device
    for t in inputs:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors on one device")
    for t in inputs[1:]:
        if t.device != dev:
            raise ValueError(f"{name} takes contiguous float32 tensors on one device")
    return dev


def _launch(name, inputs, shapes, *dims, depth=1):
    """Launches probe `name` on CUDA tensors (`_device_of`) and returns its
    float32 outputs, one of each shape in `shapes`; the launcher takes the
    inputs' and the outputs' addresses, then `dims`. Every probe's dims hold
    its output's sizes and its contraction length `depth`, so a 0 among them
    is a call with nothing to compute (kernels.no_work: the outputs empty,
    or zeros for a contraction of length 0), which returns them without a
    launch or a count."""
    dev = _device_of(name, inputs)
    if 0 in dims:
        return [no_work(s, depth, dev) for s in shapes]
    outputs = [inputs[0].new_empty(*s) for s in shapes]
    launch(name, dev.index, *[t.data_ptr() for t in inputs],
           *[t.data_ptr() for t in outputs], *dims)
    return outputs


def _dot_shapes(a, b, transposed):
    sa, sb = a.shape, b.shape
    if len(sa) != 2 or len(sb) != 2 or sa[0 if transposed else 1] != sb[0]:
        raise ValueError(f"{tuple(sa)} does not contract with {tuple(sb)}")
    return sa[1] if transposed else sa[0], sb[0], sb[1]


def _block_shapes(x, w):
    if x.ndim != 4 or w.ndim != 3 or (x.shape[1], x.shape[2]) != (w.shape[0], w.shape[1]):
        raise ValueError(f"expected x (B, L, C, M) and w (L, C, O), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    return x.shape[0], x.shape[1], x.shape[2], w.shape[2], x.shape[3]


# ---- the plain twins ----

def copy_plain(x):
    return x * 2.0


def dot_plain_plain(a, b):
    """a (O, C) . b (C, M)."""
    _dot_shapes(a, b, False)
    return torch.matmul(a, b)


def dot_transposed_plain(a, b):
    """a (C, O), b (C, M), contracting dim 0 of both."""
    _dot_shapes(a, b, True)
    return torch.matmul(a.T, b)


def grid_blocks_plain(x, w):
    """out[b, l] = w[l]^T x[b, l]: x (B, L, C, M), w (L, C, O) -> (B, L, O, M)."""
    _block_shapes(x, w)
    return torch.matmul(w.transpose(-1, -2), x)


def stacked_output_plain(x, w):
    r = grid_blocks_plain(x, w)
    return torch.stack([r, -r])


def multi_output_plain(x, w):
    r = grid_blocks_plain(x, w)
    return r, -r


def bf16_split_plain(a, b):
    """a (C, O), b (C, M): (ah^T bh + ah^T bl) + al^T bh in float32."""
    _dot_shapes(a, b, True)
    ah, al = split_bf16(a.T)
    bh, bl = split_bf16(b)
    return (torch.matmul(ah, bh) + torch.matmul(ah, bl)) + torch.matmul(al, bh)


# ---- the kernels' wrappers ----
# A probe runs for a microsecond or two on the card, so a caller waits on the
# host's path to the launch: probe_copy and the dot probes take the least
# Python to kernels.launch (no lists, no packed arguments), the gridded ones
# `_launch`.

def probe_copy(x):
    if not dispatch(x):
        return copy_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe_copy takes contiguous float32 tensors on one device")
    n = x.numel()
    if n == 0:
        return no_work(x.shape, 1, x.device)
    out = torch.empty_like(x)
    launch("probe_copy", x.device.index, x.data_ptr(), out.data_ptr(), n)
    return out


def _dot(name, a, b, transposed, *strides):
    o, c, m = _dot_shapes(a, b, transposed)
    dev = _device_of(name, (a, b))
    if not (o and c and m):
        return no_work((o, m), c, dev)
    out = a.new_empty(o, m)
    launch(name, dev.index, a.data_ptr(), b.data_ptr(), out.data_ptr(), o, c, m, *strides)
    return out


def probe_dot_plain(a, b):
    if not dispatch(a):
        return dot_plain_plain(a, b)
    return _dot("probe_dot_plain", a, b, False)


def probe_dot_transposed(a, b):
    if not dispatch(a):
        return dot_transposed_plain(a, b)
    return _dot("probe_dot_transposed", a, b, True)


def probe_bf16_split(a, b):
    if not dispatch(a):
        return bf16_split_plain(a, b)
    return _dot("probe_bf16_split", a, b, True)


def dot_chain(a, b, transposed=False):
    """The dot probes' bit reference (csrc/probes.cu probe_dot_chain): each
    output the fused multiply-adds of its products in order of c from 0, one
    thread an output reading a through its strides; a (O, C), or (C, O) when
    `transposed`. For the card tests and chip_smoke.py, never a probe's
    path; on CPU tensors the twin."""
    if not dispatch(a):
        return (dot_transposed_plain if transposed else dot_plain_plain)(a, b)
    _dot_shapes(a, b, transposed)
    n = a.shape[1]  # a's row: O when transposed, else C
    return _dot("probe_dot_chain", a, b, transposed, *((1, n) if transposed else (n, 1)))


def probe_grid_blocks(x, w):
    if not dispatch(x):
        return grid_blocks_plain(x, w)
    b, l, c, o, m = _block_shapes(x, w)
    return _launch("probe_grid_blocks", (x, w), [(b, l, o, m)], b, l, c, o, m, depth=c)[0]


def probe_stacked_output(x, w):
    if not dispatch(x):
        return stacked_output_plain(x, w)
    b, l, c, o, m = _block_shapes(x, w)
    return _launch("probe_stacked_output", (x, w), [(2, b, l, o, m)], b, l, c, o, m,
                   depth=c)[0]


def probe_multi_output(x, w):
    if not dispatch(x):
        return multi_output_plain(x, w)
    b, l, c, o, m = _block_shapes(x, w)
    out1, out2 = _launch("probe_multi_output", (x, w), [(b, l, o, m)] * 2, b, l, c, o, m,
                         depth=c)
    return out1, out2


# ---- the complex dhconv kernel, on the script's stacked real planes ----

def _complex(planes):
    return torch.complex(planes[0], planes[1])


def dhconv_tiny(xp, wp):
    """xp (2, B, C, L, M), wp (2, C, O, L) real planes -> (re, im) of the
    complex dhconv contraction, through the kernel's differentiable wrapper."""
    o = complex_kernels.contract_dhconv_kernel(_complex(xp), _complex(wp), 3)
    return o.real, o.imag


def dhconv_tiny_plain(xp, wp):
    o = complex_kernels.contract_dhconv_plain(_complex(xp), _complex(wp), 3)
    return o.real, o.imag


def dhconv_grad(xp, wp):
    """Gradients with respect to the real planes of sum |o|^2, through the
    kernel's autograd backward (dx by the kernel, dw an einsum)."""
    xp, wp = xp.detach().requires_grad_(), wp.detach().requires_grad_()
    with torch.enable_grad():
        o = complex_kernels.contract_dhconv_kernel(_complex(xp), _complex(wp), 3)
        loss = (o.real.square() + o.imag.square()).sum()
        return torch.autograd.grad(loss, (xp, wp))


def dhconv_grad_plain(xp, wp):
    """The same gradients by hand: g = 2 o, dx = sum_o conj(w) g (the twin on
    conj(w) transposed), dw = sum_{b,m} conj(x) g."""
    x, w = _complex(xp), _complex(wp)
    g = 2 * complex_kernels.contract_dhconv_plain(x, w, 3)
    dx = complex_kernels.contract_dhconv_plain(g, w.conj().transpose(0, 1), 3)
    dw = torch.einsum("bilm,bolm->iol", x.conj(), g)
    return torch.stack([dx.real, dx.imag]), torch.stack([dw.real, dw.imag])


# name, the inputs' shapes, kernel, twin: the script's CASES in its order
CASES = [
    ("copy", [(8, 128)], probe_copy, copy_plain),
    ("dot_plain", [(O, C), (C, M)], probe_dot_plain, dot_plain_plain),
    ("dot_transposed", [(C, O), (C, M)], probe_dot_transposed, dot_transposed_plain),
    ("grid_blocks", [(B, L, C, M), (L, C, O)], probe_grid_blocks, grid_blocks_plain),
    ("stacked_output_5d", [(B, L, C, M), (L, C, O)], probe_stacked_output,
     stacked_output_plain),
    ("multi_output", [(B, L, C, M), (L, C, O)], probe_multi_output, multi_output_plain),
    ("bf16_split", [(C, O), (C, M)], probe_bf16_split, bf16_split_plain),
    ("dhconv_tiny", [(2, B, C, L, M), (2, C, O, L)], dhconv_tiny, dhconv_tiny_plain),
    ("dhconv_grad", [(2, B, C, L, M), (2, C, O, L)], dhconv_grad, dhconv_grad_plain),
]


def case_inputs(shapes, seed, dev):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev) for s in shapes]


def rel_err(got, want):
    """Largest difference relative to the largest magnitude of `want` (0 for
    empty tensors; the largest difference itself when `want` is all zeros)."""
    if want.numel() == 0:
        return 0.0
    diff = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    return diff / scale if scale > 0 else diff


def _device_records(fn, reps):
    """The durations (us) of the kernels, copies and sets that `reps` calls
    of `fn` ran on the card, one torch.profiler session. The session starts
    and ends with a short spin kernel (torch.cuda._sleep), left out of the
    records: the profiler can lose the first or the last record of a
    session, and then it is one of these."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    trace = BUILD_DIR / "device_ms_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    return [e["dur"] for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "spin_kernel" not in e.get("name", "")]


def device_ms(fn, reps):
    """Device time of `fn` a call: the summed durations of the kernels, copies
    and sets it ran on the card, from torch.profiler's CUDA records over
    `reps` calls after one warm-up (for calls so short that CUDA events
    around one call time the host's launch path). A session of one call
    gives the records a call leaves; a session of `reps` calls that did not
    keep reps times as many lost records, and is discarded (counted in
    `discarded_sessions`) and taken again, three tries at most: a dropped
    record raises instead of lowering the time."""
    global discarded_sessions
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        per_call = len(_device_records(fn, 1))
        durs = _device_records(fn, reps)
        if per_call > 0 and len(durs) == reps * per_call:
            return sum(durs) / 1e3 / reps
        discarded_sessions += 1
    raise RuntimeError(f"the profiler kept {len(durs)} device records of {reps} calls, "
                       f"{per_call} a call, three times")


def run_case(name, shapes, kernel, twin, dev, seed=0):
    """Runs one case, prints PASS or FAIL; True when it passed."""
    try:
        inputs = case_inputs(shapes, seed, dev)
        got, want = kernel(*inputs), twin(*inputs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        err = 0.0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape:
                raise AssertionError(f"shape {tuple(g.shape)}, twin {tuple(w.shape)}")
            err = max(err, rel_err(g, w))
        if not err < TWIN_TOL:
            raise AssertionError(f"rel err vs twin {err:.3g} >= {TWIN_TOL:g}")
        print(f"PASS {name}: " + ", ".join(str(tuple(g.shape)) for g in got)
              + f"; rel err vs twin {err:.3g}", flush=True)
        return True
    except Exception as e:  # the report goes on; main's return code carries the failure
        msg = (str(e).splitlines() or [""])[0][:200]
        print(f"FAIL {name}: {type(e).__name__}: {msg}", flush=True)
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", help="case names (default: all nine)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = [c[0] for c in CASES]
    unknown = sorted(set(args.cases) - set(names))
    if unknown:
        ap.error(f"unknown cases {unknown}; the cases are {names}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}; TF32 off", flush=True)
    else:
        print(f"device: {dev}", flush=True)
    results = [run_case(*case, dev) for case in CASES if not args.cases or case[0] in args.cases]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
