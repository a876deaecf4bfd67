"""Kernel bench of ops/spectral_mm.py on the card: the counterpart of
scripts/bench_pallas_mm.py.

    python3 -m makani_tpu_torch.tools.bench_spectral_mm [family] [--reps N] [--device cpu]

family: dhconv, legendre, legendre2, grid or all (default all). Each family
times the port's multi-pass kernels at the script's shapes (the flagship's
inner grid, embed 320) beside PyTorch calls of the same product, and checks
the kernels against float64 (5e-5 at 3 passes, and at 2 passes on a bf16
activation; 5e-2 at 1 pass: tests/test_pallas_mm.py:27,56):

  dhconv     dhconv_mm (1 and 3 passes, the forward; dx), dhconv_dw, against
             the 3M product as float32 and bf16 einsums
  legendre   legmm, analysis and synthesis, 1 and 3 passes, against a float32
             bmm over the table repeated for the re and im rows
  legendre2  legmm on the paired layout z (mmax, 2C, K): M2 = mmax, row g
             meets table g (2 and 3 passes), against float32 bmm and einsum
  grid       gridmm, the longitude DFT: bf16 x at 2 and 3 passes, a float32 x
             at 3 passes with a bf16 output, against bf16 and float32 matmuls
             and the 3-pass twin, at the full-grid and inner-grid shapes

The script's XLA precisions map to PyTorch calls: HIGH to a float32 matmul
(TF32 off) and, for the grid, the 3-pass twin; DEFAULT to bf16 operands with
float32 sums. pallas_mm.gridmm's row tile `tr` has no counterpart (the
kernel tiles the rows itself), so the script's tr variants are one line.
The script's loop-carried operand only kept XLA from hoisting the product
out of its timing loop: PyTorch runs eagerly, and times are CUDA-event
medians over --reps runs after one warm-up. On the CPU (--device cpu, as
the tests run it) the wrappers run their twins and nothing is timed.
Returns 0 when every accuracy line is inside its bound, else 1.
"""

import argparse
import statistics
import sys

import numpy as np
import torch

from makani_tpu_torch.ops import spectral_mm
from makani_tpu_torch.utils.device import resolve_device

FAMILIES = ("dhconv", "legendre", "legendre2", "grid")
F64_TOL = {1: 5e-2, 2: 5e-5, 3: 5e-5}
# the script's grid shapes: (R, K, N) at the full and the inner grid, embed 320
GRID_SHAPES = ((320 * 721, 1440, 482, "full-res"), (320 * 240, 480, 482, "inner"))


def timeit(name, fn, dev, reps):
    """Median milliseconds of `fn` over `reps` runs after one warm-up, CUDA
    events around each run. On the CPU `fn` runs once and is not timed."""
    fn()
    if dev.type != "cuda":
        print(f"{name:44s} not measured (cpu)", flush=True)
        return None
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    print(f"{name:44s} {ms:8.3f} ms", flush=True)
    return ms


def maxrel(got, ref):
    """Largest error relative to the reference's largest magnitude."""
    return float((got.to(ref.dtype) - ref).abs().max() / ref.abs().max())


def report(name, err, tol=None):
    """Prints an accuracy line; False when `err` is outside `tol`."""
    ok = tol is None or err < tol
    bound = "" if tol is None else (f" (bound {tol:g})" if ok else f" OVER BOUND {tol:g}")
    print(f"{name}: {err:.3e}{bound}", flush=True)
    return ok


def bf16_mm_f32(a, b):
    """bf16 operands, products summed in float32, float32 out: one cuBLAS call
    on the card; the CPU has no such kernel and upcasts (same products)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _tensor(dev, a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def bench_dhconv(dev, reps, B=1, L=240, C=320, O=320, M=241):
    rng = np.random.RandomState(0)
    xs = _tensor(dev, rng.randn(2, B, L, C, M) * 0.1)
    ws = _tensor(dev, rng.randn(2, L, C, O) * 0.05)
    gs = _tensor(dev, rng.randn(2, B, L, O, M) * 0.1)
    print(f"== dhconv B{B} L{L} C{C} O{O} M{M} (stacked-real layout)", flush=True)

    def product_3m(x, w):
        eq = "blcm,lco->blom"
        rr = torch.einsum(eq, x[0], w[0])
        ii = torch.einsum(eq, x[1], w[1])
        cross = torch.einsum(eq, x[0] + x[1], w[0] + w[1])
        return torch.stack([rr - ii, cross - rr - ii])

    xb, wb = xs.bfloat16(), ws.bfloat16()
    timeit("torch float32 3M fwd (HIGH)", lambda: product_3m(xs, ws), dev, reps)
    timeit("torch bf16 3M fwd (DEFAULT)", lambda: product_3m(xb, wb), dev, reps)
    for p in (1, 3):
        timeit(f"dhconv_mm p{p} fwd", lambda p=p: spectral_mm.dhconv_mm(xs, ws, p), dev, reps)
    timeit("dhconv_mm p3 dx", lambda: spectral_mm.dhconv_mm(gs, ws, 3, wdim=1, conj_w=True),
           dev, reps)
    timeit("dhconv_dw p3", lambda: spectral_mm.dhconv_dw(xs, gs, 3), dev, reps)
    eq = "blcm,blom->lco"
    timeit("torch float32 dw (HIGH)", lambda: torch.stack([
        torch.einsum(eq, xs[0], gs[0]) + torch.einsum(eq, xs[1], gs[1]),
        torch.einsum(eq, xs[0], gs[1]) - torch.einsum(eq, xs[1], gs[0])]), dev, reps)

    ref = torch.einsum("blcm,lco->blom", torch.complex(xs[0].double(), xs[1].double()),
                       torch.complex(ws[0].double(), ws[1].double()))
    ok = True
    for p in (1, 3):
        got = spectral_mm.dhconv_mm(xs, ws, p).double()
        err = max(float((got[0] - ref.real).abs().max()),
                  float((got[1] - ref.imag).abs().max())) / float(ref.abs().max())
        ok &= report(f"dhconv_mm p{p} fwd maxrel", err, F64_TOL[p])
    return ok


def bench_legendre(dev, reps, mmax=241, C=320, K=240, L=240):
    rng = np.random.RandomState(0)
    z = _tensor(dev, rng.randn(2 * mmax, C, K))
    p = _tensor(dev, rng.randn(mmax, L, K) * 0.1)
    zl = _tensor(dev, rng.randn(2 * mmax, C, L))
    print(f"== legendre mmax{mmax} C{C} K{K} L{L}", flush=True)
    # the table repeated for the re and im rows, prepared outside the timing
    tables = torch.cat([p, p]).transpose(-1, -2)
    timeit("torch float32 analysis (bmm, HIGH)", lambda: torch.bmm(z, tables), dev, reps)
    for ps in (1, 3):
        timeit(f"legmm p{ps} analysis", lambda ps=ps: spectral_mm.legmm(z, p, ps, "k"), dev, reps)
        timeit(f"legmm p{ps} synthesis", lambda ps=ps: spectral_mm.legmm(zl, p, ps, "l"), dev,
               reps)
    ref = torch.bmm(z.double(), tables.double())
    return report("legmm p3 analysis maxrel", maxrel(spectral_mm.legmm(z, p, 3, "k"), ref),
                  F64_TOL[3])


def bench_legendre2(dev, reps, mmax=241, C=320, K=240, L=240):
    """The paired layout: re and im of each mode side by side, z (mmax, 2C, K)
    against p (mmax, L, K). legmm's m % mmax table index is then the identity:
    a plain batched product with half the blocks of the stacked layout."""
    rng = np.random.RandomState(0)
    zp = _tensor(dev, rng.randn(mmax, 2 * C, K))
    p = _tensor(dev, rng.randn(mmax, L, K) * 0.1)
    print(f"== legendre2 paired mmax{mmax} 2C{2 * C} K{K} L{L}", flush=True)
    pt = p.transpose(-1, -2)
    timeit("torch float32 paired mck,mlk->mcl (bmm)", lambda: torch.bmm(zp, pt), dev, reps)
    timeit("torch float32 paired mck,mlk->clm (einsum)",
           lambda: torch.einsum("mck,mlk->clm", zp, p), dev, reps)
    for ps in (2, 3):
        timeit(f"legmm p{ps} paired", lambda ps=ps: spectral_mm.legmm(zp, p, ps, "k"), dev, reps)
    timeit("legmm p3 paired + movedim copy",
           lambda: spectral_mm.legmm(zp, p, 3, "k").movedim(0, -1).contiguous(), dev, reps)
    ref = torch.bmm(zp.double(), pt.double())
    return report("legmm p3 paired maxrel", maxrel(spectral_mm.legmm(zp, p, 3, "k"), ref),
                  F64_TOL[3])


def bench_grid(dev, reps, shapes=GRID_SHAPES, rows=2048):
    rng = np.random.RandomState(0)
    ok = True
    for R, K, N, tag in shapes:
        xb = _tensor(dev, rng.randn(R, K)).bfloat16()
        xf = _tensor(dev, rng.randn(R, N))
        T = _tensor(dev, rng.randn(K, N))
        Ts = _tensor(dev, rng.randn(N, K))

        print(f"== grid {tag} analysis {R}x{K}@{K}x{N} bf16-act", flush=True)
        xb32, Tb = xb.float(), T.bfloat16()
        timeit("torch bf16, float32 out (DEFAULT)", lambda: bf16_mm_f32(xb, Tb), dev, reps)
        timeit("torch float32 (HIGH)", lambda: torch.mm(xb32, T), dev, reps)
        timeit("gridmm_plain p3, the twin (HIGH)", lambda: spectral_mm.gridmm_plain(xb, T, 3),
               dev, reps)
        for ps in (2, 3):
            timeit(f"gridmm p{ps}", lambda ps=ps: spectral_mm.gridmm(xb, T, ps), dev, reps)

        print(f"== grid {tag} synthesis {R}x{N}@{N}x{K} f32-act bf16-out", flush=True)
        xfb, Tsb = xf.bfloat16(), Ts.bfloat16()
        timeit("torch bf16 -> bf16 (DEFAULT)", lambda: torch.mm(xfb, Tsb), dev, reps)
        timeit("torch float32 -> bf16 (HIGH)", lambda: torch.mm(xf, Ts).bfloat16(), dev, reps)
        timeit("gridmm p3 bf16 out", lambda: spectral_mm.gridmm(xf, Ts, 3, torch.bfloat16), dev,
               reps)

        ref = xf[:rows].double() @ Ts.double()
        ok &= report("gridmm p3 maxrel", maxrel(spectral_mm.gridmm(xf[:rows], Ts, 3), ref),
                     F64_TOL[3])
        ref = xb[:rows].double() @ T.double()
        ok &= report("gridmm p2 bf16-act maxrel",
                     maxrel(spectral_mm.gridmm(xb[:rows], T, 2), ref), F64_TOL[2])
    return ok


def run(family="all", device="cuda", reps=20, **shapes):
    """Runs one family, or all; `shapes` go to the families by keyword (the
    tests pass small ones). Returns 0 when every accuracy line passes."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}; TF32 off", flush=True)
    else:
        print(f"device: {dev}", flush=True)
    ok = True
    for name in FAMILIES if family == "all" else (family,):
        fn = globals()[f"bench_{name}"]
        ok &= fn(dev, reps, **shapes.get(name, {}))
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", nargs="?", default="all", choices=(*FAMILIES, "all"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.family, args.device, args.reps)


if __name__ == "__main__":
    sys.exit(main())
