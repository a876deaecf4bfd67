"""Multi-pass bf16 matmuls of the SFNO's coefficient stage, as Hopper kernels.

Counterpart of makani_tpu/ops/pallas_mm.py. Two kernels carry the serving
path, each written in CUDA C++ for sm_90a (makani_tpu_torch/csrc/) and bound
through a plain C interface loaded with ctypes:

  legmm      per-m Legendre contraction of every SHT and inverse SHT
             (replaces pallas_mm.legmm / _legmm_kernel)
  dhconv_mm  per-l complex channel mixing of the dhconv filter
             (replaces pallas_mm.dhconv_mm / _dhconv_mm_kernel)

`passes` selects the accuracy point of the bf16 operand split
(hi = bf16(a), lo = bf16(a - hi)), products accumulated in float32:
  1 = both operands bf16
  2 = first operand bf16, second operand split
  3 = ah*bh + (ah*bl + al*bh), about 16 bits per operand

Each wrapper runs its kernel on a CUDA tensor or raises; on a CPU tensor it
runs the plain PyTorch twin (`legmm_plain`, `dhconv_mm_plain`), which repeats
the kernel's arithmetic. `launches` counts kernel launches per wrapper.
The kernels are compiled with nvcc at first use into build/kernels/ at the
root of the checkout (one nvcc per source, started together).
"""

import ctypes
import os
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = {"legmm": "legmm.cu", "dhconv_mm": "dhconv_mm.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches per wrapper; callers reset and read these around a run
launches = {"legmm": 0, "dhconv_mm": 0}

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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "legmm":
        fn = lib.legmm_launch
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    else:
        fn = lib.dhconv_mm_launch
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def _launcher(name):
    if name not in _libs:
        build()
    return _libs[name]


def _check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _dispatch(x):
    """True to launch the kernel, False to run the plain twin (CPU tensors)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


# --------------------------------------------------------------------------
# plain twins: the kernels' arithmetic in PyTorch
# --------------------------------------------------------------------------

def _split(a):
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def _mp_matmul(a, b, passes):
    """Multi-pass matmul of float32 a and b: bf16 parts, float32 products
    (exact for bf16 x bf16) and float32 sums, in the order of the kernels."""
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return torch.matmul(ah, bh)
    if passes == 2:
        return torch.matmul(ah, bh) + torch.matmul(ah, bl)
    return torch.matmul(ah, bh) + (torch.matmul(ah, bl) + torch.matmul(al, bh))


def _legmm_shapes(z, p, contract):
    if contract not in ("k", "l"):
        raise ValueError(f"contract must be 'k' or 'l', got {contract!r}")
    M2, C, D = z.shape
    mmax, L, K = p.shape
    if M2 != 2 * mmax:
        raise ValueError(f"z has {M2} rows, expected 2*mmax = {2 * mmax}")
    if D != (K if contract == "k" else L):
        raise ValueError(f"z {tuple(z.shape)} does not contract with p {tuple(p.shape)}")
    return M2, mmax, C, L, K


def legmm_plain(z, p, passes=3, contract="k"):
    """Plain twin of `legmm`."""
    M2, mmax, C, L, K = _legmm_shapes(z, p, contract)
    zs = z.reshape(2, mmax, C, z.shape[-1])
    table = p.transpose(-1, -2) if contract == "k" else p
    out = _mp_matmul(zs, table, passes)
    return out.reshape(M2, C, out.shape[-1])


def legmm(z, p, passes=3, contract="k"):
    """Per-m Legendre contraction; the table is indexed m % mmax, so the re and
    im rows of the stacked activation share one (mmax, L, K) table.

    contract="k": analysis  (2*mmax, C, K) x (mmax, L, K) -> (2*mmax, C, L)
    contract="l": synthesis (2*mmax, C, L) x (mmax, L, K) -> (2*mmax, C, K)
    """
    M2, mmax, C, L, K = _legmm_shapes(z, p, contract)
    if not _dispatch(z):
        return legmm_plain(z, p, passes, contract)
    _check_cuda(z, p)
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if M2 > 65535:
        raise ValueError(f"2*mmax = {M2} exceeds the kernel's grid limit")
    out = torch.empty((M2, C, L if contract == "k" else K), device=z.device,
                      dtype=torch.float32)
    launch = _launcher("legmm")
    with torch.cuda.device(z.device):
        rc = launch(z.data_ptr(), p.data_ptr(), out.data_ptr(), M2, mmax, C, L, K,
                    int(contract == "k"), passes, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "legmm")
    launches["legmm"] += 1
    return out


def _dhconv_shapes(x, w, wdim):
    if wdim not in (0, 1):
        raise ValueError(f"wdim must be 0 or 1, got {wdim}")
    if x.ndim != 5 or w.ndim != 4 or x.shape[0] != 2 or w.shape[0] != 2:
        raise ValueError(f"expected x (2,B,L,Ci,M) and w (2,L,C,O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    _, B, L, Ci, M = x.shape
    _, Lw, C, O = w.shape
    if Lw != L or Ci != (C if wdim == 0 else O):
        raise ValueError(f"x {tuple(x.shape)} does not contract with w {tuple(w.shape)}")
    return B, L, C, O, M


def dhconv_mm_plain(x, w, passes=3, m3=True, wdim=0, conj_w=False):
    """Plain twin of `dhconv_mm`."""
    _dhconv_shapes(x, w, wdim)
    wr, wi = w[0], (-w[1] if conj_w else w[1])
    xr, xi = x[0], x[1]

    def mp(a, b):
        # (L, C, O) weight as the first operand: contract C (wdim 0) or O (wdim 1)
        a = a.transpose(-1, -2) if wdim == 0 else a
        return _mp_matmul(a, b, passes)

    rr = mp(wr, xr)
    ii = mp(wi, xi)
    if m3:
        cross = mp(wr + wi, xr + xi)
        return torch.stack([rr - ii, cross - rr - ii])
    return torch.stack([rr - ii, mp(wr, xi) + mp(wi, xr)])


def dhconv_mm(x, w, passes=3, m3=True, wdim=0, conj_w=False):
    """x (2, B, L, Cin, M) [stacked re/im], w (2, L, C, O) -> (2, B, L, Cout, M).

    wdim=0 contracts w's C dim (forward: Cin=C, Cout=O);
    wdim=1 contracts w's O dim (backward dx: Cin=O, Cout=C).
    conj_w negates w's imaginary plane in the kernel (cotangent rules).
    m3 selects the 3-multiplication complex product, else 4.
    """
    B, L, C, O, M = _dhconv_shapes(x, w, wdim)
    if not _dispatch(x):
        return dhconv_mm_plain(x, w, passes, m3, wdim, conj_w)
    _check_cuda(x, w)
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if B * L > 65535:
        raise ValueError(f"B*L = {B * L} exceeds the kernel's grid limit")
    co = O if wdim == 0 else C
    out = torch.empty((2, B, L, co, M), device=x.device, dtype=torch.float32)
    launch = _launcher("dhconv_mm")
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, L, C, O, M, wdim,
                    int(conj_w), int(m3), passes, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "dhconv_mm")
    launches["dhconv_mm"] += 1
    return out
