"""The grid-side DFT matmul at the flagship's shapes on the card, with the
2-pass grid dot kernel: the counterpart of scripts/bench_gridmm.py.

    python3 -m makani_tpu_torch.tools.bench_gridmm [--reps N] [--device cpu]

The longitude DFT and its inverse are plain matmuls, rows = batch x channel x
latitude. Under AMP the analysis input is bf16, so 3 passes waste one (the
activation's lo part is zero). `grid_dot` is the kernel the script wrote for
that case (csrc/gridmm.cu, entry point grid_dot_launch): the table arrives
split outside the kernel into bf16 hi and lo parts (`split_table`), and the
kernel sums x.th + x.tl for a bf16 x and (xh.th + xh.tl) + xl.th for a
float32 x, in the script's order, rounding once to the output type.

The script's variants become PyTorch yardsticks: HIGH the 3-pass twin
(spectral_mm.gridmm_plain) and a float32 matmul (TF32 off), HIGHEST the
float32 matmul, DEFAULT bf16 operands with float32 sums; the 2-dot forms stay
two matmuls and an add. optimization_barrier has no eager counterpart, so
the script's two x-split variants are one line. Times are CUDA-event medians
over --reps runs after one warm-up (PyTorch runs eagerly; the script's
loop-carried operand only kept XLA from hoisting its product). Every
accuracy line against float64 stays; the kernel's lines must be inside the
3-pass bound 5e-5 or the tool returns 1. On the CPU (--device cpu, as the
tests run it) the wrappers run their twins and nothing is timed.

grid_dot_plain is the kernel's plain twin; grid_dot runs the kernel on CUDA
tensors and the twin on CPU tensors, counts its launches in
kernels.launches["grid_dot"], and carries no gradient.
"""

import argparse
import sys

import numpy as np
import torch

from makani_tpu_torch.ops import spectral_mm
from makani_tpu_torch.ops.kernels import dispatch, launch, no_work
from makani_tpu_torch.tools.bench_spectral_mm import bf16_mm_f32, maxrel, report, timeit
from makani_tpu_torch.utils.device import resolve_device

P3_TOL = 5e-5


def split_table(t):
    """A float32 table's bf16 parts: th = bf16(t), tl = bf16(t - th)."""
    th = t.to(torch.bfloat16)
    return th, (t - th.float()).to(torch.bfloat16)


def _grid_dot_checks(x, th, tl, out_dtype):
    if x.ndim != 2 or th.ndim != 2 or x.shape[1] != th.shape[0] or th.shape != tl.shape:
        raise ValueError(f"expected x (R, K) and th, tl (K, N), got {tuple(x.shape)}, "
                         f"{tuple(th.shape)} and {tuple(tl.shape)}")
    if (x.dtype not in (torch.float32, torch.bfloat16) or th.dtype != torch.bfloat16
            or tl.dtype != torch.bfloat16 or out_dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"grid_dot takes x float32 or bfloat16, th and tl bfloat16, out_dtype "
                        f"float32 or bfloat16, got {x.dtype}, {th.dtype}, {tl.dtype}, {out_dtype}")


def grid_dot_plain(x, th, tl, out_dtype=torch.float32):
    """Plain twin of `grid_dot`: bf16 x: x.th + x.tl; float32 x:
    (xh.th + xh.tl) + xl.th; float32 sums, rounded once to `out_dtype`."""
    spectral_mm.no_grad_through("grid_dot_plain", None, x, th, tl)
    _grid_dot_checks(x, th, tl, out_dtype)
    thf, tlf = th.float(), tl.float()
    if x.dtype == torch.bfloat16:
        xf = x.float()
        return (torch.matmul(xf, thf) + torch.matmul(xf, tlf)).to(out_dtype)
    xh, xl = spectral_mm.split_bf16(x)
    return ((torch.matmul(xh, thf) + torch.matmul(xh, tlf)) + torch.matmul(xl, thf)).to(out_dtype)


def grid_dot(x, th, tl, out_dtype=torch.float32):
    """x (R, K) float32 or bfloat16 against the pre-split table th, tl (K, N)
    bfloat16 -> (R, N) out_dtype (grid_dot_pallas of scripts/bench_gridmm.py).
    Rows are tiled by the kernel (no `tr`, no padding of x); the table is
    copied once a call into scratch in the kernel's layout."""
    spectral_mm.no_grad_through("grid_dot", None, x, th, tl)
    _grid_dot_checks(x, th, tl, out_dtype)
    if not dispatch(x):
        return grid_dot_plain(x, th, tl, out_dtype)
    if th.device != x.device or tl.device != x.device:
        raise ValueError("tensors on different devices")
    if not (x.is_contiguous() and th.is_contiguous() and tl.is_contiguous()):
        raise ValueError("kernel takes contiguous tensors")
    (R, K), N = x.shape, th.shape[1]
    out = no_work((R, N), K, x.device, out_dtype)
    if out is not None:
        return out
    out = torch.empty((R, N), device=x.device, dtype=out_dtype)
    scratch = spectral_mm.grid_table_scratch(K, N, 2, x.device)
    launch("grid_dot", x.device.index, x.data_ptr(), th.data_ptr(), tl.data_ptr(),
           scratch.data_ptr(), out.data_ptr(), R, K, N, int(x.dtype == torch.bfloat16),
           int(out_dtype == torch.bfloat16), passes=2 if x.dtype == torch.bfloat16 else 3)
    return out


def run(device="cuda", reps=20, R=320 * 721, K=1440, N=482, rows=2048, legendre=(320, 240, 241)):
    """The script's main at its shapes, or at the ones given (the tests pass
    small ones; N even, the table being the cosine and sine halves). Returns 0
    when the kernel's accuracy lines pass."""
    if N % 2:
        raise ValueError(f"N = {N} must be even")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}; TF32 off", flush=True)
    else:
        print(f"device: {dev}", flush=True)
    rng = np.random.RandomState(0)
    bf16 = torch.bfloat16

    def tensor(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    xb = tensor(R, K).to(bf16)
    C, S = tensor(K, N // 2), tensor(K, N // 2)
    T = torch.cat([C, S], dim=1)
    th, tl = split_table(T)
    xb32 = xb.float()

    print(f"== analysis {R}x{K} @ {K}x{N} (bf16 activation)", flush=True)
    timeit("torch f32 2-dot x@C + x@S (HIGH)", lambda: torch.mm(xb32, C) + torch.mm(xb32, S),
           dev, reps)
    timeit("torch f32 stacked (HIGH)", lambda: torch.mm(xb32, T), dev, reps)
    timeit("3-pass twin stacked (HIGH)", lambda: spectral_mm.gridmm_plain(xb, T, 3), dev, reps)
    timeit("grid_dot 2-pass", lambda: grid_dot(xb, th, tl), dev, reps)

    xs = xb[:rows]
    ref = xs.double() @ T.double()
    ok = True
    report("maxrel torch f32", maxrel(torch.mm(xs.float(), T), ref))
    ok &= report("maxrel grid_dot 2p", maxrel(grid_dot(xs, th, tl), ref), P3_TOL)

    print(f"== synthesis {R}x{N} @ {N}x{K} (f32 activation, bf16 out)", flush=True)
    zf = tensor(R, N)
    Ts = tensor(N, K)
    ths, tls = split_table(Ts)
    h = N // 2
    timeit("torch f32 2-dot f32 out (HIGH)",
           lambda: torch.mm(zf[:, :h], Ts[:h]) - torch.mm(zf[:, h:], Ts[h:]), dev, reps)
    timeit("torch f32 stacked bf16 out (HIGH)", lambda: torch.mm(zf, Ts).to(bf16), dev, reps)
    timeit("3-pass twin stacked bf16 out (HIGH)",
           lambda: spectral_mm.gridmm_plain(zf, Ts, 3, bf16), dev, reps)
    timeit("grid_dot 3-pass bf16 out", lambda: grid_dot(zf, ths, tls, bf16), dev, reps)

    ref2 = zf[:rows].double() @ Ts.double()
    ok &= report("maxrel grid_dot 3p", maxrel(grid_dot(zf[:rows], ths, tls), ref2), P3_TOL)

    # what the float32-activation product costs in each form
    zfb = zf.to(bf16)
    zfb32 = zfb.float()
    timeit("torch f32 stacked bf16 out (HIGHEST)", lambda: torch.mm(zf, Ts).to(bf16), dev, reps)
    timeit("torch bf16, f32 sums (DEFAULT)", lambda: bf16_mm_f32(zfb, Ts.to(bf16)).to(bf16), dev,
           reps)
    timeit("torch z->bf16 stacked f32 (HIGH)", lambda: torch.mm(zfb32, Ts).to(bf16), dev, reps)
    timeit("3-pass twin z->bf16 (HIGH)", lambda: spectral_mm.gridmm_plain(zfb, Ts, 3, bf16), dev,
           reps)
    timeit("torch z->bf16 hi/lo 2-dot",
           lambda: (bf16_mm_f32(zfb, ths) + bf16_mm_f32(zfb, tls)).to(bf16), dev, reps)
    timeit("torch concat-bf16 stacked f32 (HIGH)", lambda: torch.mm(
        torch.cat([zf[:, :h].to(bf16), zf[:, h:].to(bf16)], dim=1).float(), Ts).to(bf16),
        dev, reps)
    report("maxrel bf16-rounded act f32", maxrel(torch.mm(zfb32[:rows], Ts), ref2))

    def xsplit(z):
        zh, zl = spectral_mm.split_bf16(z)
        return (torch.mm(zh, Ts) + torch.mm(zl, Ts)).to(bf16)

    timeit("torch x-split 2-dot f32 (HIGH)", lambda: xsplit(zf), dev, reps)
    report("maxrel x-split (through bf16 out)", maxrel(xsplit(zf[:rows]), ref2))

    c, k, m = legendre
    print(f"== Legendre shape (m-batched) [{m}m] x [{c}c,{k}k] @ [{k}k,{k}l]", flush=True)
    xc = tensor(c, k, m)
    P = tensor(m, k, k)
    xcb32 = xc.to(bf16).float()
    xcb, Pb = xc.to(bf16), P.to(bf16)
    timeit("legendre f32 (HIGH)", lambda: torch.einsum("ckm,mlk->clm", xc, P), dev, reps)
    timeit("legendre f32 bf16-act (HIGH)", lambda: torch.einsum("ckm,mlk->clm", xcb32, P), dev,
           reps)
    timeit("legendre bf16 (DEFAULT)", lambda: torch.einsum("ckm,mlk->clm", xcb, Pb), dev, reps)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device, args.reps)


if __name__ == "__main__":
    sys.exit(main())
