"""Build, load and count the port's Hopper kernels.

Every kernel has a plain C launcher (`<name>_launch`, returning
cudaGetLastError()) in a CUDA C++ source in makani_tpu_torch/csrc/ for sm_90a,
loaded with ctypes; one source may hold several kernels (gridmm.cu holds
gridmm and grid_dot, probes.cu the seven probes and probe_dot_chain, the
dot probes' bit reference, gelu.cu the bf16 GELU and its gradient,
instance_norm.cu the norm's forward and backward).
`build()` compiles the sources with nvcc at first use into build/kernels/
at the root of the checkout, one nvcc per source, all started together; a
library there that is newer than every kernel source, header and this
module is loaded as it is, so a process started by one that built (a CLI's
subprocess) compiles nothing. `launches` counts kernel launches per
wrapper: `launch` adds one where it launches a kernel, and
callers reset and read the counts around a run. `launches_by_passes` counts
the launches of the kernels that take a bf16 pass count by (kernel, passes),
so a run can show at which accuracy point its kernels ran. A call with
nothing to compute (`no_work`) launches nothing and counts nothing.
`eager_calls` counts, by layer, the calls on the card that took a layer's
eager path instead of its kernel (InstanceNorm2d on spatial ranks or at
"bf16" statistics), so launches / (launches + eager calls) is the share of
a layer's calls that the kernel took.

Every wrapper launches through `launch`, the one launch path: the launcher,
the device test, the current stream's raw handle (`stream`), the error
check and the count. Its host time is what a caller waits for when a
kernel runs for a microsecond or two (the probes at their script's shapes,
tools/launch_path.py), so it builds no torch object a call: no stream
object, no device context on the current device.
"""

import collections
import ctypes
import math
import os
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
PROBES = ("probe_copy", "probe_dot_plain", "probe_dot_transposed", "probe_grid_blocks",
          "probe_stacked_output", "probe_multi_output", "probe_bf16_split")
# kernel -> its source
_SOURCES = {"legmm": "legmm.cu", "dhconv_mm": "dhconv_mm.cu", "dhconv_dw": "dhconv_dw.cu",
            "fused_adam": "fused_adam.cu", "dhconv_complex": "dhconv_complex.cu",
            "gridmm": "gridmm.cu", "grid_dot": "gridmm.cu",
            "gelu_bf16": "gelu.cu", "gelu_bf16_grad": "gelu.cu",
            "instance_norm_fwd": "instance_norm.cu", "instance_norm_bwd": "instance_norm.cu",
            **{name: "probes.cu" for name in (*PROBES, "probe_dot_chain")}}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {name: 0 for name in _SOURCES}
launches_by_passes = collections.Counter()
eager_calls = collections.Counter()

_libs = {}


def reset_launches():
    for k in launches:
        launches[k] = 0
    launches_by_passes.clear()
    eager_calls.clear()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def _current(out):
    """True for a built library newer than every kernel source and header
    and than this module (its nvcc flags)."""
    if not out.exists():
        return False
    inputs = [p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh")] + [Path(__file__)]
    return out.stat().st_mtime >= max(p.stat().st_mtime for p in inputs)


def build():
    """Compile every kernel source that is not loaded yet and has no current
    library (`_current`), one nvcc each, all started together, each into a
    temporary file renamed into place; load the libraries and declare their
    kernels' C signatures. Returns the compiler's resource report (-Xptxas
    -v) per source compiled."""
    todo = sorted({src for name, src in _SOURCES.items() if name not in _libs})
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in todo:
        out = BUILD_DIR / f"lib{Path(src).stem}.so"
        if _current(out):
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / src)]
        procs[src] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    for src, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        reports[Path(src).stem] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for src in todo:
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{Path(src).stem}.so"))
        for name in (n for n, s in _SOURCES.items() if s == src):
            _libs[name] = _declare(name, lib)
    return reports


def _declare(name, lib):
    vp, ci, cu, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = {
        "legmm": [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp],
        # x, w, scratch, out, b, l, c, o, m, wdim, conj_w, m3, passes, stream
        "dhconv_mm": [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp],
        "dhconv_dw": [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp],
        # the leaves' descriptor table (device), leaves, work units, blocks,
        # the global norm (device), the eleven float scalars (lr .. decay,
        # max_norm, wd), moment kind, mode, stream
        "fused_adam": [vp, ci, cu, ci, vp, cf, cf, cf, cf, cf, cf, cf, cf, cf, cf, cf,
                       ci, ci, vp],
        # x, w, scratch, out, b, c, o, l, m, w's strides (c, o, l), conj_w, passes, stream
        "dhconv_complex": [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp],
        # x, t, scratch, out, r, k, n, x_bf16, out_bf16, passes, x_kmajor, out_t,
        # round_out, stream
        "gridmm": [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp],
        # x, th, tl, scratch, out, r, k, n, x_bf16, out_bf16, stream
        "grid_dot": [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp],
        # x, y, n, stream
        "gelu_bf16": [vp, vp, ci, vp],
        # x, g, dx, n, stream
        "gelu_bf16_grad": [vp, vp, vp, ci, vp],
        # x, w, b, y, mean, rstd, planes, channels, n, eps, is_bf16, stream
        "instance_norm_fwd": [vp, vp, vp, vp, vp, vp, ci, ci, ci, cf, ci, vp],
        # x, g, w, mean, rstd, dx, dw, db, planes, channels, n, is_bf16, stream
        "instance_norm_bwd": [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp],
        # x, out, n, stream
        "probe_copy": [vp, vp, ci, vp],
        # a, b, out, o, c, m, stream
        "probe_dot_plain": [vp, vp, vp, ci, ci, ci, vp],
        "probe_dot_transposed": [vp, vp, vp, ci, ci, ci, vp],
        "probe_bf16_split": [vp, vp, vp, ci, ci, ci, vp],
        # a, b, out, o, c, m, a's strides along o and c, stream
        "probe_dot_chain": [vp, vp, vp, ci, ci, ci, ci, ci, vp],
        # x, w, out, b, l, c, o, m, stream
        "probe_grid_blocks": [vp, vp, vp, ci, ci, ci, ci, ci, vp],
        "probe_stacked_output": [vp, vp, vp, ci, ci, ci, ci, ci, vp],
        # x, w, out1, out2, b, l, c, o, m, stream
        "probe_multi_output": [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp],
    }[name]
    fn.restype = ci
    return fn


def load_built():
    """Load the libraries that `build()` left in BUILD_DIR, compiling
    nothing: for processes that a process which built the kernels starts (the
    ranks of one card), so no two of them write the same library."""
    for src in sorted(set(_SOURCES.values())):
        out = BUILD_DIR / f"lib{Path(src).stem}.so"
        if not out.exists():
            raise FileNotFoundError(f"{out} is not built: call kernels.build() first")
        lib = ctypes.CDLL(str(out))
        for name in (n for n, s in _SOURCES.items() if s == src):
            _libs[name] = _declare(name, lib)


def launcher(name):
    """The C launcher of kernel `name`, built on first use."""
    if name not in _libs:
        build()
    return _libs[name]


def raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def stream(index):
    """The raw handle of the current CUDA stream of device `index`, which
    every launch takes: torch.cuda.current_stream(index).cuda_stream without
    building a torch.cuda.Stream. It follows torch.cuda.stream(s). A CPU
    build of torch lacks it, so it is looked up at each call, never at
    import."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name, index, *args, passes=None):
    """Launches kernel `name` on CUDA device `index`: its C launcher gets
    `args`, then the current stream of that device. The device context is
    entered only when `index` is not the current device (entering
    torch.cuda.device sets the device twice a call), which
    torch._C._cuda_getDevice() gives without torch.cuda.current_device()'s
    lazy-init check: a launch has a CUDA tensor in hand. Raises on the
    launcher's CUDA error, else counts one launch (by `passes` too, where
    the kernel takes a pass count)."""
    fn = _libs.get(name) or launcher(name)
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream(index))
    if rc:
        raise_on(rc, name)
    launches[name] += 1
    if passes is not None:
        launches_by_passes[name, passes] += 1


def no_work(shape, depth, device, dtype=torch.float32):
    """The output of a kernel call that has nothing to compute, made without
    a launch: an empty tensor of `shape` when it has no element, zeros when
    only the contraction length `depth` is 0 (an empty sum); None when the
    kernel has work. Every wrapper asks before it calls its launcher, so no
    launcher is reached with an empty grid."""
    if math.prod(shape) == 0:
        return torch.empty(shape, device=device, dtype=dtype)
    if depth == 0:
        return torch.zeros(shape, device=device, dtype=dtype)
    return None


def dispatch(x):
    """True to launch the kernel, False to run the plain twin (CPU tensors)."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")
