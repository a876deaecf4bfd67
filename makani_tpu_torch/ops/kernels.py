"""Build, load and count the port's Hopper kernels.

Every kernel has a plain C launcher (`<name>_launch`, returning
cudaGetLastError()) in a CUDA C++ source in makani_tpu_torch/csrc/ for sm_90a,
loaded with ctypes; one source may hold several kernels (gridmm.cu holds
gridmm and grid_dot, probes.cu the seven probes). `build()` compiles the
sources with nvcc at first use into build/kernels/ at the root of the
checkout, one nvcc per source, all started together. `launches` counts kernel
launches per wrapper: each wrapper adds one where it launches its kernel, and
callers reset and read the counts around a run.
"""

import ctypes
import os
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
PROBES = ("probe_copy", "probe_dot_plain", "probe_dot_transposed", "probe_grid_blocks",
          "probe_stacked_output", "probe_multi_output", "probe_bf16_split")
# kernel -> its source
_SOURCES = {"legmm": "legmm.cu", "dhconv_mm": "dhconv_mm.cu", "dhconv_dw": "dhconv_dw.cu",
            "fused_adam": "fused_adam.cu", "dhconv_complex": "dhconv_complex.cu",
            "gridmm": "gridmm.cu", "grid_dot": "gridmm.cu",
            **{name: "probes.cu" for name in PROBES}}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {name: 0 for name in _SOURCES}

_libs = {}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build():
    """Compile every kernel source that is not loaded yet, one nvcc each, all
    started together; load the libraries and declare their kernels' C
    signatures. Returns the compiler's resource report (-Xptxas -v) per
    source."""
    todo = sorted({src for name, src in _SOURCES.items() if name not in _libs})
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in todo:
        out = BUILD_DIR / f"lib{Path(src).stem}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(out), str(_CSRC / src)]
        procs[src] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    for src, (out, proc) in procs.items():
        log, _ = proc.communicate()
        reports[Path(src).stem] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for src, (out, _) in procs.items():
        lib = ctypes.CDLL(str(out))
        for name in (n for n, s in _SOURCES.items() if s == src):
            _libs[name] = _declare(name, lib)
    return reports


def _declare(name, lib):
    vp, ci, cu, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = {
        "legmm": [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp],
        "dhconv_mm": [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp],
        "dhconv_dw": [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp],
        # p, g, mu, nu, n, sizes[3], index strides[4], the nine float scalars,
        # two salts, moment kind, stream
        "fused_adam": [vp, vp, vp, vp, cu, cu, cu, cu, cu, cu, cu, cu,
                       cf, cf, cf, cf, cf, cf, cf, cf, cf, cu, cu, ci, vp],
        # x, w, out, b, c, o, l, m, passes, stream
        "dhconv_complex": [vp, vp, vp, ci, ci, ci, ci, ci, ci, vp],
        # x, t, out, r, k, n, x_bf16, out_bf16, passes, stream
        "gridmm": [vp, vp, vp, ci, ci, ci, ci, ci, ci, vp],
        # x, th, tl, out, r, k, n, x_bf16, out_bf16, stream
        "grid_dot": [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp],
        # x, out, n, stream
        "probe_copy": [vp, vp, ci, vp],
        # a, b, out, o, c, m, stream
        "probe_dot_plain": [vp, vp, vp, ci, ci, ci, vp],
        "probe_dot_transposed": [vp, vp, vp, ci, ci, ci, vp],
        "probe_bf16_split": [vp, vp, vp, ci, ci, ci, vp],
        # x, w, out, b, l, c, o, m, stream
        "probe_grid_blocks": [vp, vp, vp, ci, ci, ci, ci, ci, vp],
        "probe_stacked_output": [vp, vp, vp, ci, ci, ci, ci, ci, vp],
        # x, w, out1, out2, b, l, c, o, m, stream
        "probe_multi_output": [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp],
    }[name]
    fn.restype = ci
    return fn


def launcher(name):
    """The C launcher of kernel `name`, built on first use."""
    if name not in _libs:
        build()
    return _libs[name]


def raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def dispatch(x):
    """True to launch the kernel, False to run the plain twin (CPU tensors)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")
