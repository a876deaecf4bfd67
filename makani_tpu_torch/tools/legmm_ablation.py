"""Where the time of the legmm kernel goes on the card: the kernel rebuilt
with parts of its depth step switched off, timed at the flagship's Legendre
shapes.

    python3 -m makani_tpu_torch.tools.legmm_ablation [--reps N]

Variants, each a text edit of csrc/legmm.cu and csrc/cp_async_ring.cuh built
with nvcc into build/kernels/ablation/:

  kernel     the kernel as it is
  no_mma     no mma instructions (the copies, the split and ldmatrix stay)
  no_split   no split (the copies stay; the mma read stale split tiles)
  no_copy    no copies (the split reads stale staged tiles; the mma stay)
  copy_only  the copies alone
  mma_only   ldmatrix and the mma alone

A variant with a part switched off computes nothing meaningful: only
"kernel" is checked, against the plain twin (TWIN_TOL). Beside them, through
the wrapper and the real kernel, "per-g table" is the stacked analysis with
the table repeated, p (2 mmax, L, K), so that every row group g meets a
table of its own: the blocks of the re and the im rows then stage and split
their table tiles apart, as before one A operand per m.

Shapes (flagship SFNO, embed 384, mmax 241): the full-grid analysis
z (482, 384, 721) and synthesis z (482, 384, 240) against p (241, 240, 721);
the same at K = 720, whose rows start on 16 bytes; the inner-grid analysis
(K = 240). Passes 1 and 3. CUDA-event medians over --reps runs after one
warm-up. Exits 1 without a card or when "kernel" misses its twin.
"""

import argparse
import statistics
import sys

import torch

from makani_tpu_torch.ops import kernels, spectral_mm
from makani_tpu_torch.tools import _ablation

TWIN_TOL = 1e-5
# variant -> edits (file, text, replacement), each text present once
_NO_MMA = [("cp_async_ring.cuh", '  asm volatile(\n      "mma.sync',
            '  if (false) asm volatile(\n      "mma.sync')]
_NO_SPLIT = [("legmm.cu", "  split_stage(0, 0, 0);\n", "\n"),
             ("legmm.cu", "if (k + 1 < nk) split_stage(", "if (false) split_stage(")]
_NO_COPY = [("legmm.cu", "    if (s < nk) load(s, s);\n", "\n"),
            ("legmm.cu", "if (k + STAGES < nk) load(", "if (false) load(")]
VARIANTS = {"kernel": [], "no_mma": _NO_MMA, "no_split": _NO_SPLIT, "no_copy": _NO_COPY,
            "copy_only": _NO_MMA + _NO_SPLIT, "mma_only": _NO_COPY + _NO_SPLIT}
SOURCES = ("legmm.cu", "cp_async_ring.cuh")
# (label, K, contract) at mmax 241, C 384, L 240
SHAPES = (("full analysis", 721, "k"), ("full synthesis", 721, "l"),
          ("analysis, K = 720", 720, "k"), ("synthesis, K = 720", 720, "l"),
          ("inner analysis", 240, "k"))


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(reps=20):
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    launchers = {v: ls["legmm"] for v, ls in
                 _ablation.build_variants("ablation", SOURCES, VARIANTS, ["legmm"])[0].items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    mmax, C, L = 241, 384, 240
    ok = True
    for label, K, contract in SHAPES:
        D, N = (K, L) if contract == "k" else (L, K)
        z = torch.randn((2 * mmax, C, D), device=dev, generator=gen)
        p = torch.randn((mmax, L, K), device=dev, generator=gen)
        out = torch.empty((2 * mmax, C, N), device=dev)
        stream = kernels.stream(z.device.index)
        for passes in (1, 3):
            cells = []
            for variant, launch in launchers.items():
                def call(launch=launch):
                    rc = launch(z.data_ptr(), p.data_ptr(), out.data_ptr(), 2 * mmax, mmax, C, L,
                                K, int(contract == "k"), passes, stream)
                    kernels.raise_on(rc, f"legmm {variant}")
                ms = cuda_ms(call, reps)
                if variant == "kernel":
                    want = spectral_mm.legmm_plain(z, p, passes, contract)
                    err = float((out - want).abs().max() / want.abs().max())
                    ok &= err < TWIN_TOL
                    cells.append(f"kernel {ms:.3f} (vs twin {err:.1e})")
                else:
                    cells.append(f"{variant} {ms:.3f}")
            if contract == "k":
                pp = torch.cat([p, p])
                cells.append("per-g table {:.3f}".format(
                    cuda_ms(lambda: spectral_mm.legmm(z, pp, passes, contract), reps)))
                del pp
            print(f"{label} p{passes} ms: " + ", ".join(cells), flush=True)
        del z, p, out
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("legmm_ablation: CUDA is not available", file=sys.stderr)
        return 1
    return run(args.reps)


if __name__ == "__main__":
    sys.exit(main())
