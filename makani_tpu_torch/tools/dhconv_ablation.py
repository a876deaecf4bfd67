"""Where the time of the dhconv kernels goes on the card: csrc/dhconv_mm.cu
(family mm) or csrc/dhconv_dw.cu (family dw) rebuilt with parts of its work
switched off, timed at the flagship's spectral-filter shapes.

    python3 -m makani_tpu_torch.tools.dhconv_ablation [mm|dw] [--reps N]

Variants, each a text edit of the kernel's sources built with nvcc into
build/kernels/ablation_dhconv/ (mm: dhconv_gemm.cuh, split_gemm.cuh) or
build/kernels/ablation_dw/ (dw: dhconv_dw.cu, split_gemm.cuh):

  mm  kernel     the kernel as it is: the weight prep, then the GEMM
      prep_only  the weight prep alone
      gemm_only  the GEMM alone (it reads the scratch the last prep left)
      no_mma     the prep and the GEMM without its wgmma instructions
      no_split   the GEMM's A fragments not read or split (constants)
      no_xcopy   the GEMM's x rows not copied (the split reads stale tiles)
      no_wcopy   the GEMM's weight tiles not copied (wgmma reads stale tiles)
  dw  kernel     the kernel as it is
      no_mma     without its wgmma instructions
      no_xsplit  x's A fragments not read or split (constants)
      no_gsplit  the staged g tiles not split (wgmma reads stale planes)
      no_xcopy   x's rows not copied (the consumers read stale tiles)
      no_gcopy   g's rows not copied (the split reads stale tiles)
      no_store   dw not stored
      copies_only  the copies and the barriers alone (no wgmma, split or store)

A variant with a part switched off computes nothing meaningful: only
"kernel" is checked, against the plain twin (TWIN_TOL). Shapes (flagship
SFNO, batch 1, embed 384, lmax 240, mmax 241): x (2, 1, 240, 384, 241), w
(2, 240, 384, 384), g (2, 1, 240, 384, 241); mm: the forward at passes 3 and
1 and dx (wdim 1, conj_w) at passes 3, 3M; dw: passes 3 and 1, 3M.
CUDA-event medians over --reps runs after one warm-up. Exits 1 without a
card or when "kernel" misses its twin.
"""

import argparse
import sys

import torch

from makani_tpu_torch.ops import kernels, spectral_mm
from makani_tpu_torch.tools import _ablation
from makani_tpu_torch.tools.legmm_ablation import TWIN_TOL, cuda_ms

_NO_PREP = [("dhconv_gemm.cuh", "  prep_weight<NPL, PARTS><<<",
             "  if (false) prep_weight<NPL, PARTS><<<")]
_NO_GEMM = [("dhconv_gemm.cuh", "  return launch_gemm<CPLX, M3, PASSES>(p, (unsigned)blocks, s);",
             "  return 0;")]
_NO_MMA = [("split_gemm.cuh", '  asm volatile(\n      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %53',
            '  if (false) asm volatile(\n      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %53')]
_NO_SPLIT = [("dhconv_gemm.cuh", "re[d][r] = xs[c * S::XPITCH + sh[0][d % 2] + m];",
              "re[d][r] = 1.f;"),
             ("dhconv_gemm.cuh", "im[d][r] = xs[(BK + c) * S::XPITCH + sh[1][d % 2] + m];",
              "im[d][r] = 2.f;")]
_NO_XCOPY = [("dhconv_gemm.cuh", "      if (bytes != 0) bulk_copy(", "      if (false) bulk_copy("),
             ("dhconv_gemm.cuh", "mbar_expect_tx(full + slot, bytes + ",
              "mbar_expect_tx(full + slot, 0 * bytes + ")]
_NO_WCOPY = [("dhconv_gemm.cuh", "(r == 0 ? S::T_BYTES : 0)", "0"),
             ("dhconv_gemm.cuh", "      if (r == 0)\n        bulk_copy(",
              "      if (false)\n        bulk_copy(")]
_DW_NO_XSPLIT = [("dhconv_dw.cu", """  v[0] = ld_pair(ra + 2 * t, ea);
  v[1] = ld_pair(rb + 2 * t, eb);
  v[2] = ld_pair(ra + 2 * t + 8, ea);
  v[3] = ld_pair(rb + 2 * t + 8, eb);""", "  v[0] = v[1] = v[2] = v[3] = make_float2(1.f, 2.f);")]
_DW_NO_GSPLIT = [("dhconv_dw.cu", "        split_step<NPL, PARTS>(",
                  "        if (false) split_step<NPL, PARTS>(")]
_DW_NO_XCOPY = [("dhconv_dw.cu", "            copy_chunk(dst + row * PITCH, x0",
                 "            if (false) copy_chunk(dst + row * PITCH, x0")]
_DW_NO_GCOPY = [("dhconv_dw.cu", "            copy_chunk(dst + row * PITCH, g0",
                 "            if (false) copy_chunk(dst + row * PITCH, g0")]
_DW_NO_STORE = [("dhconv_dw.cu", "        if (c >= p.C || n >= p.O) continue;",
                 "        if (true) continue;")]
VARIANTS = {"kernel": [], "prep_only": _NO_GEMM, "gemm_only": _NO_PREP, "no_mma": _NO_MMA,
            "no_split": _NO_SPLIT, "no_xcopy": _NO_XCOPY, "no_wcopy": _NO_WCOPY}
SOURCES = ("dhconv_mm.cu", "dhconv_gemm.cuh", "split_gemm.cuh", "cp_async_ring.cuh")
DW_VARIANTS = {"kernel": [], "no_mma": _NO_MMA, "no_xsplit": _DW_NO_XSPLIT,
               "no_gsplit": _DW_NO_GSPLIT, "no_xcopy": _DW_NO_XCOPY, "no_gcopy": _DW_NO_GCOPY,
               "no_store": _DW_NO_STORE,
               "copies_only": _NO_MMA + _DW_NO_XSPLIT + _DW_NO_GSPLIT + _DW_NO_STORE}
DW_SOURCES = ("dhconv_dw.cu", "split_gemm.cuh", "cp_async_ring.cuh")
# family: (kernel, sources (the first is compiled), variants)
FAMILIES = {"mm": ("dhconv_mm", SOURCES, VARIANTS), "dw": ("dhconv_dw", DW_SOURCES, DW_VARIANTS)}
# mm: (label, passes, wdim, conj_w); dw: (label, passes)
MM_CASES = (("forward", 3, 0, False), ("forward", 1, 0, False), ("dx", 3, 1, True))
DW_CASES = (("dw", 3), ("dw", 1))


def _line(label, launchers, call, check, reps):
    """One line of times, the kernel's checked against its twin."""
    cells, ok = [], True
    for variant, launch in launchers.items():
        ms = cuda_ms(lambda launch=launch, variant=variant: call(launch, variant), reps)
        if variant == "kernel":
            err = check()
            ok = err < TWIN_TOL
            cells.append(f"kernel {ms:.3f} (vs twin {err:.1e})")
        else:
            cells.append(f"{variant} {ms:.3f}")
    print(f"{label} ms: " + ", ".join(cells), flush=True)
    return ok


def run(family="mm", reps=20):
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    name, sources, variants = FAMILIES[family]
    subdir = "ablation_dhconv" if family == "mm" else "ablation_dw"
    launchers = {v: ls[name] for v, ls in
                 _ablation.build_variants(subdir, sources, variants, [name])[0].items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    B, L, C, M = 1, 240, 384, 241
    x = torch.randn((2, B, L, C, M), device=dev, generator=gen)
    stream = kernels.stream(x.device.index)
    ok = True
    if family == "mm":
        w = torch.randn((2, L, C, C), device=dev, generator=gen)
        out = torch.empty_like(x)
        scratch = spectral_mm.dhconv_weight_scratch(L, C, C, 3, 2, dev)
        for label, passes, wdim, conj_w in MM_CASES:
            def call(launch, variant):
                rc = launch(x.data_ptr(), w.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, L,
                            C, C, M, wdim, int(conj_w), 1, passes, stream)
                kernels.raise_on(rc, f"dhconv_mm {variant}")

            def check():
                want = spectral_mm.dhconv_mm_plain(x, w, passes, True, wdim, conj_w)
                return float((out - want).abs().max() / want.abs().max())
            ok &= _line(f"{label} p{passes}", launchers, call, check, reps)
        return 0 if ok else 1
    g = torch.randn((2, B, L, C, M), device=dev, generator=gen)
    out = torch.empty((2, L, C, C), device=dev)
    for label, passes in DW_CASES:
        def call(launch, variant):
            rc = launch(x.data_ptr(), g.data_ptr(), out.data_ptr(), B, L, C, C, M, 1, passes,
                        stream)
            kernels.raise_on(rc, f"dhconv_dw {variant}")

        def check():
            want = spectral_mm.dhconv_dw_plain(x, g, passes, True)
            return float((out - want).abs().max() / want.abs().max())
        ok &= _line(f"{label} p{passes}", launchers, call, check, reps)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", nargs="?", choices=sorted(FAMILIES), default="mm")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dhconv_ablation: CUDA is not available", file=sys.stderr)
        return 1
    return run(args.family, args.reps)


if __name__ == "__main__":
    sys.exit(main())
