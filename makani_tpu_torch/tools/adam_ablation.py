"""Where fused_adam's device time goes on the card: csrc/fused_adam.cu
rebuilt with parts switched off, each timed over the flagship's 87 leaves
(572.5 M elements, bf16 moments under stochastic rounding).

    python3 -m makani_tpu_torch.tools.adam_ablation [--blocks-per-sm N ...] [--reps N]

Variants, each a text edit of csrc/fused_adam.cu built with nvcc into
build/kernels/ablation_adam/, all nvcc started together; ptxas's largest
register count and spill stores over the kernel's instantiations are
printed for each:

  kernel     the kernel as it is
  cached     plain loads and stores in place of the streaming ones
  no_index   the dither keyed by the element's offset in its leaf (no
             division, no stride): other bits
  memory     no arithmetic and no dither: p + g and the moments stored back
             (other bits): what the access pattern alone takes
  regs64     launch bounds for 4 blocks an SM (up to 64 registers a thread,
             spilling in 3 instantiations) in place of 2 (up to 128)
  regs85     launch bounds for 3 blocks an SM (up to 85 registers)

Each of ROUNDS rounds times every variant at every --blocks-per-sm, in turns
(the order reversed every other round), as device time an update
(bench_fused_adam.device_ms: CUDA events around an update enqueued behind a
spin kernel), the median of --reps updates. "kernel" and "cached" must give
the twin's bits after one update. Exits 1 without a card or when a check
fails.
"""

import argparse
import statistics
import sys

import torch

from makani_tpu_torch.ops import fused_adam, kernels
from makani_tpu_torch.tools import _ablation, bench_fused_adam

SOURCES = ("fused_adam.cu",)
ROUNDS = 2
# ref_index's last line: the element's flat index in the reference's layout
_INDEX = "  return d.base + q1 * d.j0 + c1 * d.j1 + c2 * d.j2 + c3 * d.j3;"
VARIANTS = {
    "kernel": [],
    "cached": [("fused_adam.cu", "  return __ldcs(a);", "  return *a;"),
               ("fused_adam.cu", "  __stcs(a, v);", "  *a = v;")],
    "no_index": [("fused_adam.cu", _INDEX, "  c3 = 0;\n  return i;")],
    "memory": [("fused_adam.cu", "  const float m = __fmaf_rn(gf, k.a1, __fmul_rn(k.b1, mu0));",
                "  out = pf + gf, m_store = mu0, v = nu0;\n  if (k.lr != -1.f) return;\n"
                "  const float m = __fmaf_rn(gf, k.a1, __fmul_rn(k.b1, mu0));"),
               ("fused_adam.cu",
                "      return ((__float_as_uint(v) + dither_u16(idx, salt)) & 0xFFFF0000u) >> 16;",
                "      return __float_as_uint(v) >> 16;"),
               ("fused_adam.cu", _INDEX, "  c3 = 0;\n  return i;")],
    "regs64": [("fused_adam.cu", "__launch_bounds__(kThreads, 2)",
                "__launch_bounds__(kThreads, 4)")],
    "regs85": [("fused_adam.cu", "__launch_bounds__(kThreads, 2)",
                "__launch_bounds__(kThreads, 3)")],
}


def run(blocks_per_sm, reps):
    from makani_tpu_torch.utils.optimizers import AdamState
    launchers, logs = _ablation.build_variants("ablation_adam", SOURCES, VARIANTS, ["fused_adam"])
    for variant, log in logs.items():
        usage = _ablation.ptxas_usage(log, "fused_adam_kernel")
        print(f"[ptxas] {variant}: up to {max(r for _, r, _ in usage)} registers, "
              f"{max(s for _, _, s in usage)} bytes of spill stores in "
              f"{sum(1 for _, _, s in usage if s)} of {len(usage)} instantiations", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(340)
    shapes = bench_fused_adam.leaf_shapes(bench_fused_adam.ROOT / "config" / "sfnonet.yaml",
                                          "flagship_synth_drive_bare", dev)
    params = {k: torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    grads = {k: 1e-2 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}

    def state():
        return AdamState(0, {k: torch.zeros(s, device=dev, dtype=torch.bfloat16)
                             for k, s in shapes.items()},
                         {k: torch.zeros(s, device=dev, dtype=torch.bfloat16)
                          for k, s in shapes.items()})

    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, stochastic_rounding=True, seed=340)
    built, bps0 = kernels.launcher("fused_adam"), fused_adam.BLOCKS_PER_SM
    ok = True
    # the bits of one update from the same start, against the twin
    twin_p, twin_s = {k: v.clone() for k, v in params.items()}, state()
    fused_adam.fused_adam_apply_plain(twin_p, grads, twin_s, 1e-3, **kw)
    for variant in ("kernel", "cached"):
        kernels._libs["fused_adam"] = launchers[variant]["fused_adam"]
        p, s = {k: v.clone() for k, v in params.items()}, state()
        fused_adam.fused_adam_apply(p, grads, s, 1e-3, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(p[k], twin_p[k]) and torch.equal(s.mu[k], twin_s.mu[k])
                   and torch.equal(s.nu[k], twin_s.nu[k]) for k in shapes)
        print(f"[bits] {variant}: {'the twin' if same else 'NOT the twin'}'s after one update",
              flush=True)
        ok &= same
        del p, s
    del twin_p, twin_s
    torch.cuda.empty_cache()
    s = state()
    times = {}
    order = list(VARIANTS)
    for r in range(ROUNDS):
        for variant in order if r % 2 == 0 else order[::-1]:
            kernels._libs["fused_adam"] = launchers[variant]["fused_adam"]
            for bps in blocks_per_sm:
                fused_adam.BLOCKS_PER_SM = bps
                times.setdefault((variant, bps), []).append(bench_fused_adam.device_ms(
                    lambda: fused_adam.fused_adam_apply(params, grads, s, 1e-3, **kw), reps))
    kernels._libs["fused_adam"], fused_adam.BLOCKS_PER_SM = built, bps0
    bound = bench_fused_adam.HBM_BPS
    n = sum(p.numel() for p in params.values())
    print(f"[adam ablation] {bench_fused_adam.card()}; {len(shapes)} leaves, {n} elements, "
          f"bound {n * 20 / bound * 1e3:.3f} ms; device ms an update (median of {reps}), "
          f"each round:")
    for (variant, bps), ts in times.items():
        print(f"  {variant} at {bps} blocks an SM: {statistics.median(ts):.3f} "
              f"({', '.join(f'{t:.3f}' for t in ts)})", flush=True)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks-per-sm", type=int, nargs="*", default=[fused_adam.BLOCKS_PER_SM])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("adam_ablation: CUDA is not available", file=sys.stderr)
        return 1
    return run(args.blocks_per_sm, args.reps)


if __name__ == "__main__":
    sys.exit(main())
