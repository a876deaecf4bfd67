"""Build, load and count the port's Hopper kernels.

Every kernel is a CUDA C++ source in makani_tpu_torch/csrc/ for sm_90a with a
plain C launcher (`<name>_launch`, returning cudaGetLastError()), loaded with
ctypes. `build()` compiles them with nvcc at first use into build/kernels/ at
the root of the checkout, one nvcc per source, all started together.
`launches` counts kernel launches per wrapper: each wrapper adds one where it
launches its kernel, and callers reset and read the counts around a run.
"""

import ctypes
import os
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = {"legmm": "legmm.cu", "dhconv_mm": "dhconv_mm.cu", "dhconv_dw": "dhconv_dw.cu",
            "fused_adam": "fused_adam.cu", "dhconv_complex": "dhconv_complex.cu"}
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
    started together; load the libraries and declare their C signatures.
    Returns the compiler's resource report (-Xptxas -v) per kernel."""
    todo = [name for name in _SOURCES if name not in _libs]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = BUILD_DIR / f"lib{name}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(out),
               str(_CSRC / _SOURCES[name])]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for name, (out, _) in procs.items():
        _libs[name] = _declare(name, ctypes.CDLL(str(out)))
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
