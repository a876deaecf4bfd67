"""Where the device time of the gridded probes (probe_grid_blocks,
probe_stacked_output, probe_multi_output), of the dot probes
(probe_dot_plain, probe_dot_transposed) or of probe_bf16_split goes on the
card, and how they compare with another tree's: csrc/probes.cu rebuilt with
parts of a kernel switched off or its tile changed, timed at
scripts/pallas_isolate.py's shapes (B = 2, L = 4, C = O = 16, M = 128).

    python3 -m makani_tpu_torch.tools.probe_ablation [gridded|dot|transposed|split]
        [--parent DIR]

Variants, each a text edit of csrc/probes.cu built with nvcc into
build/kernels/ablation_<family>/ (the gridded family: ablation_probes/),
all nvcc started together; ptxas's registers and spill stores are printed
for each instantiation of the family's kernel (gridded_kernel: <false>,
grid_blocks, mangled ILb0E; <true>, stacked_output and multi_output,
ILb1E). The gridded family (VARIANTS):

  kernel       the kernel as it is
  no_store     r and -r not stored (a test on the sums that never holds
               keeps the products)
  no_products  no products (0 x stored; the staging and the reads of x stay)
  no_loads     x and w not read from device memory (constants staged)
  empty        the grid launched with an empty body
  tm64         64 columns of m and 4 groups along o a block (O tiles of 8)
  og4          4 groups along o: O tiles of 8, twice the blocks
  ot1          1 output along o a thread, 16 groups (512 threads a block)
  ot4          4 outputs along o a thread, 4 groups (128 threads a block)
  ck32         32 rows of c staged at once

The dot families, `dot` (probe_dot_plain, a (16, 16) . b (16, 128)) and
`transposed` (probe_dot_transposed, a (16, 16) contracted on dim 0), edit
the one body both launch, probe_dot_kernel (DOT_VARIANTS): the kernel as it
is (an 8 x 32 tile of the output a block, its operands staged in shared
memory 16 rows of c at a time), the same threads with their operands loaded
into registers instead ("registers"), scalar loads in place of 16-byte ones,
the transposed a tile kept in a's layout ("a_rows": read one value of c at a
time), no loads (constants), no products, an empty body (the grid's launch
floor), and two other tiles. The `split` family (probe_bf16_split,
SPLIT_VARIANTS): the kernel as it is (mma.sync m16n8k16 on register
fragments, NW n8 tiles a warp, WB warps a block), no loads (constants), no
split (lo parts zero), no products (the fragments folded into one
accumulator instead of three mma.sync), an empty body, and five other
tilings.

With --parent DIR, DIR/makani_tpu_torch/csrc/probes.cu (another checkout,
e.g. the parent commit unpacked with `git archive`) is built as "parent".

Each of ROUNDS rounds times every variant, in turns (the order reversed
every other round), as device time a call: the summed kernel durations of
torch.profiler over DEVICE_REPS calls after a warm-up
(kernel_isolate.device_ms). The variants that compute must give the same
bits as the reference ("parent" if given, else "kernel") at the script's
shapes and at a ragged one (gridded: B 3, L 2, C 70, O 33, M 130; the dot
families and split: C 70, O 33, M 130), and "kernel" must agree with the
plain twins (TWIN_TOL). Exits 1 without a card or when a check fails.
"""

import argparse
import collections
import statistics
import sys
from pathlib import Path

import torch

from makani_tpu_torch.ops import kernels
from makani_tpu_torch.tools import _ablation, kernel_isolate

SOURCES = ("probes.cu",)
PROBES = ("probe_grid_blocks", "probe_stacked_output", "probe_multi_output")
ROUNDS = 3
_STORES = "      out[i] = acc[j];\n      if constexpr (NEG) neg[i] = -acc[j];"
_TILE = {k: f"constexpr int {k} = {v};" for k, v in (("TM", 32), ("OT", 2), ("OG", 8), ("CK", 16))}


def _tile(**sizes):
    """The edits that set gridded's tile constants to `sizes`."""
    return [("probes.cu", _TILE[k], f"constexpr int {k} = {v};") for k, v in sizes.items()]


# variant -> edits (file, text, replacement), each text present once
VARIANTS = {
    "kernel": [],
    "no_store": [("probes.cu", _STORES, "      if (acc[j] == -1.2345e-30f) out[i] = acc[j];")],
    "no_products": [("probes.cu", "acc[j] = fmaf(ws[c][oi + j], xc, acc[j]);",
                     "acc[j] = 0.f * xc;")],
    "no_loads": [("probes.cu", "xv[i] = c < C && m0 + m < M ? xb[(long long)c * M + m] : 0.f;",
                  "xv[i] = c < C && m0 + m < M ? 1.f : 0.f;"),
                 ("probes.cu",
                  "wv[i] = e < CK * OB && c < C && o0 + o < O ? wl[(long long)c * O + o] : 0.f;",
                  "wv[i] = e < CK * OB && c < C && o0 + o < O ? 2.f : 0.f;")],
    "empty": [("probes.cu", "  using namespace gridded;\n  __shared__",
               "  return;\n  using namespace gridded;\n  __shared__")],
    "tm64": _tile(TM=64, OG=4),
    "og4": _tile(OG=4),
    "ot1": _tile(OT=1, OG=16),
    "ot4": _tile(OT=4, OG=4),
    "ck32": _tile(CK=32),
}
# the variants that compute r
COMPUTING = ("kernel", "tm64", "og4", "ot1", "ot4", "ck32", "parent")

_DOT_TILE = {k: f"constexpr int {k} = {v};" for k, v in (("PM", 32), ("PO", 8))}
# probe_dot_kernel's loop over staged chunks, and its output's indices
_DOT_BODY = """  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += PK) {
    if (c0 > 0) __syncthreads();  // every read of the last chunk is done
    float4 av{}, bv{};
    if (t < PO * PK / 4)
      av = TRANS ? load_quad(a, C, O, c0 + t / AQ, o0 + 4 * (t % AQ), va)
                 : load_quad(a, O, C, o0 + t / AQ, c0 + 4 * (t % AQ), va);
    if (t < PK * BQ) bv = load_quad(b, C, M, c0 + t / BQ, m0 + 4 * (t % BQ), vb);
    if (t < PO * PK / 4) {
      if constexpr (TRANS) {  // row c = t / AQ, rows o .. o + 3 of the tile
        float* col = &as[4 * (t % AQ) * PK + t / AQ];
        col[0] = av.x;
        col[PK] = av.y;
        col[2 * PK] = av.z;
        col[3 * PK] = av.w;
      } else {
        *reinterpret_cast<float4*>(&as[4 * t]) = av;
      }
    }
    if (t < PK * BQ) *reinterpret_cast<float4*>(&bs[4 * t]) = bv;
    __syncthreads();
    const int cn = min(PK, C - c0);
#pragma unroll 4
    for (int c = 0; c < cn; ++c) acc = fmaf(as[oi * PK + c], bs[c * PM + mi], acc);
  }
  const int o = o0 + oi, m = m0 + mi;
"""
# the same threads with their operands loaded into registers instead, PK
# values of c at a time, every load of a chunk issued before its products:
# no shared memory, no barrier; the same fused multiply-adds in order of c
_DOT_REGISTERS = """  const int o = o0 + oi, m = m0 + mi;
  float acc = 0.f;
  if (o < O && m < M) {
    for (int c0 = 0; c0 < C; c0 += PK) {
      float ar[PK], br[PK];
#pragma unroll
      for (int j = 0; j < PK; ++j) {
        const long long ia = TRANS ? (long long)(c0 + j) * O + o : (long long)o * C + c0 + j;
        ar[j] = c0 + j < C ? a[ia] : 0.f;
        br[j] = c0 + j < C ? b[(long long)(c0 + j) * M + m] : 0.f;
      }
      const int cn = min(PK, C - c0);
#pragma unroll
      for (int j = 0; j < PK; ++j)
        if (j < cn) acc = fmaf(ar[j], br[j], acc);
    }
  }
"""


def _dot_tile(**sizes):
    return [("probes.cu", _DOT_TILE[k], f"constexpr int {k} = {v};") for k, v in sizes.items()]


# probe_dot_kernel's variants, both dot probes': edits of probes.cu, each
# text present once
DOT_VARIANTS = {
    "kernel": [],
    "registers": [("probes.cu", _DOT_BODY, _DOT_REGISTERS)],
    "scalar": [("probes.cu", "const bool va = (TRANS ? o : c) % 4 == 0 &&",
                "const bool va = false &&"),
               ("probes.cu", "const bool vb = m % 4 == 0 &&", "const bool vb = false &&")],
    "no_loads": [("probes.cu",
                  """      av = TRANS ? load_quad(a, C, O, c0 + t / AQ, o0 + 4 * (t % AQ), va)
                 : load_quad(a, O, C, o0 + t / AQ, c0 + 4 * (t % AQ), va);""",
                  "      av = make_float4(1.f, 1.f, 1.f, 1.f);"),
                 ("probes.cu",
                  "bv = load_quad(b, C, M, c0 + t / BQ, m0 + 4 * (t % BQ), vb);",
                  "bv = make_float4(2.f, 2.f, 2.f, 2.f);")],
    "no_products": [("probes.cu", "acc = fmaf(as[oi * PK + c], bs[c * PM + mi], acc);",
                     "acc = 0.f * bs[c * PM + mi];")],
    # the transposed a tile kept in a's layout, rows along o, read a value of
    # c at a time
    "a_rows": [("probes.cu", """      if constexpr (TRANS) {  // row c = t / AQ, rows o .. o + 3 of the tile
        float* col = &as[4 * (t % AQ) * PK + t / AQ];
        col[0] = av.x;
        col[PK] = av.y;
        col[2 * PK] = av.z;
        col[3 * PK] = av.w;
      } else {
        *reinterpret_cast<float4*>(&as[4 * t]) = av;
      }""", "      *reinterpret_cast<float4*>(&as[4 * t]) = av;"),
               ("probes.cu", "acc = fmaf(as[oi * PK + c], bs[c * PM + mi], acc);",
                "acc = fmaf(as[TRANS ? c * PO + oi : oi * PK + c], bs[c * PM + mi], acc);")],
    "empty": [("probes.cu", "  using namespace plain;\n  __shared__",
               "  return;\n  using namespace plain;\n  __shared__")],
    "po16": _dot_tile(PM=16, PO=16),
    "pm64": _dot_tile(PM=64, PO=4),
}
# the dot variants that compute a . b
DOT_COMPUTING = ("kernel", "registers", "scalar", "a_rows", "po16", "pm64", "parent")

_SPLIT_TILE = {k: f"constexpr int {k} = {v};" for k, v in (("NW", 1), ("WB", 4))}
_SPLIT_MMAS = """      mma_bf16_16816(hh[j], ah, bh[0], bh[1]);
      mma_bf16_16816(hl[j], ah, bl[0], bl[1]);
      mma_bf16_16816(lh[j], al, bh[0], bh[1]);"""
# the fragments folded into one accumulator, so the loads and the split stay
_SPLIT_FOLD = """      hh[j][0] += __uint_as_float((ah[0] ^ ah[1] ^ ah[2] ^ ah[3] ^ al[0] ^ al[1] ^ al[2] ^
                                   al[3] ^ bh[0] ^ bh[1] ^ bl[0] ^ bl[1]) & 0x007fffffu);"""


def _split_tile(**sizes):
    return [("probes.cu", _SPLIT_TILE[k], f"constexpr int {k} = {v};") for k, v in sizes.items()]


# probe_bf16_split's variants: edits of probes.cu, each text present once
SPLIT_VARIANTS = {
    "kernel": [],
    "no_loads": [("probes.cu", "av[e] = k < C && o < O ? a[(long long)k * O + o] : 0.f;",
                  "av[e] = k < C && o < O ? 1.f : 0.f;"),
                 ("probes.cu", "bv[j][e] = k < C && n < M ? b[(long long)k * M + n] : 0.f;",
                  "bv[j][e] = k < C && n < M ? 2.f : 0.f;")],
    "no_split": [("probes.cu", "  lo = pack_bf16(x - h.x, y - h.y);", "  lo = 0u;")],
    "no_products": [("probes.cu", _SPLIT_MMAS, _SPLIT_FOLD)],
    "empty": [("probes.cu", "  using namespace split;\n  const int g",
               "  return;\n  using namespace split;\n  const int g")],
    "wb1": _split_tile(WB=1),
    "wb2": _split_tile(WB=2),
    "wb8": _split_tile(WB=8),
    "wb16": _split_tile(WB=16),
    "nw2": _split_tile(NW=2, WB=2),
}
SPLIT_COMPUTING = ("kernel", "wb1", "wb2", "wb8", "wb16", "nw2", "parent")

# a dot family: its variants, those that compute, the probe, the kernels
# whose ptxas report is printed (this tree's and the parent's names), the
# shapes its bits are checked at (the script's, a ragged one) and the twin
DotFamily = collections.namedtuple("DotFamily",
                                   "variants computing probe kernels shapes twin")
_DOT_SHAPES = (((kernel_isolate.O, kernel_isolate.C), (kernel_isolate.C, kernel_isolate.M)),
               ((33, 70), (70, 130)))
_TRANSPOSED_SHAPES = (((kernel_isolate.C, kernel_isolate.O), (kernel_isolate.C, kernel_isolate.M)),
                      ((70, 33), (70, 130)))
_DOT_KERNELS = ("probe_dot_kernel", "probe_dot_plain_kernel", "probe_dot_transposed_kernel")
DOT_FAMILIES = {
    "dot": DotFamily(DOT_VARIANTS, DOT_COMPUTING, "probe_dot_plain", _DOT_KERNELS, _DOT_SHAPES,
                     kernel_isolate.dot_plain_plain),
    "transposed": DotFamily(DOT_VARIANTS, DOT_COMPUTING, "probe_dot_transposed", _DOT_KERNELS,
                            _TRANSPOSED_SHAPES, kernel_isolate.dot_transposed_plain),
    "split": DotFamily(SPLIT_VARIANTS, SPLIT_COMPUTING, "probe_bf16_split",
                       ("probe_bf16_split_kernel",), _TRANSPOSED_SHAPES,
                       kernel_isolate.bf16_split_plain),
}
SCRIPT = ((kernel_isolate.B, kernel_isolate.L, kernel_isolate.C, kernel_isolate.M),
          (kernel_isolate.L, kernel_isolate.C, kernel_isolate.O))
RAGGED = ((3, 2, 70, 130), (2, 70, 33))


def build_variants(parent=None):
    """Builds every variant (and with `parent`, a checkout, its probes.cu),
    all nvcc started together; prints ptxas's report for each instantiation
    of gridded_kernel; returns {variant: {probe: launcher}}."""
    csrc = None if parent is None else Path(parent).resolve() / "makani_tpu_torch" / "csrc"
    launchers, logs = _ablation.build_variants("ablation_probes", SOURCES, VARIANTS, PROBES, csrc)
    for variant, log in logs.items():
        for entry, regs, spill in _ablation.ptxas_usage(log, "gridded_kernel"):
            print(f"[ptxas {variant}] {entry}: {regs} registers, {spill} bytes spill stores",
                  flush=True)
    return launchers


def _call(launch, name, x, w, outs):
    b, l, c, m = x.shape
    rc = launch(x.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in outs), b, l, c, w.shape[2],
                m, kernels.stream(x.device.index))
    kernels.raise_on(rc, name)


def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def _outputs(x, w):
    """Each probe's outputs, a tuple."""
    b, l, _, m = x.shape
    o = w.shape[2]
    return {"probe_grid_blocks": (torch.empty((b, l, o, m), device=x.device),),
            "probe_stacked_output": (torch.empty((2, b, l, o, m), device=x.device),),
            "probe_multi_output": tuple(torch.empty((b, l, o, m), device=x.device)
                                        for _ in range(2))}


def check_bits(launchers, dev):
    """True when every computing variant gives the reference's bits and
    "kernel" agrees with the twins; prints one line a shape."""
    ref = "parent" if "parent" in launchers else "kernel"
    twins = {"probe_grid_blocks": kernel_isolate.grid_blocks_plain,
             "probe_stacked_output": kernel_isolate.stacked_output_plain,
             "probe_multi_output": kernel_isolate.multi_output_plain}
    ok = True
    for shapes in (SCRIPT, RAGGED):
        x, w = kernel_isolate.case_inputs(shapes, 3, dev)
        got = {}
        for variant in (v for v in COMPUTING if v in launchers):
            outs = _outputs(x, w)
            for name, out in outs.items():
                for t in out:
                    t.fill_(float("nan"))
                _call(launchers[variant][name], f"{name} {variant}", x, w, out)
            got[variant] = outs
        torch.cuda.synchronize()
        same = {v: all(torch.equal(t.view(torch.int32), r.view(torch.int32))
                       for n, out in outs.items() for t, r in zip(out, got[ref][n], strict=True))
                for v, outs in got.items()}
        err = max(kernel_isolate.rel_err(t, r) for n, twin in twins.items()
                  for t, r in zip(got["kernel"][n], _as_tuple(twin(x, w)), strict=True))
        ok &= all(same.values()) and err < kernel_isolate.TWIN_TOL
        print(f"bits x{tuple(x.shape)} w{tuple(w.shape)}: "
              + ", ".join(f"{v} {'=' if s else '!='} {ref}" for v, s in same.items())
              + f"; kernel vs twin {err:.1e}", flush=True)
    return ok


def run(parent=None):
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    launchers = build_variants(parent)
    ok = check_bits(launchers, dev)
    x, w = kernel_isolate.case_inputs(SCRIPT, 0, dev)
    (xc,) = kernel_isolate.case_inputs(kernel_isolate.CASES[0][1], 0, dev)
    outs = _outputs(x, w)
    order = list(launchers)
    us = {(v, p): [] for v in order for p in PROBES}
    floor = []
    reps = kernel_isolate.DEVICE_REPS
    for r in range(ROUNDS):
        for variant in order if r % 2 == 0 else order[::-1]:
            for name in PROBES:
                launch, out = launchers[variant][name], outs[name]
                us[variant, name].append(1e3 * kernel_isolate.device_ms(
                    lambda: _call(launch, name, x, w, out), reps))
        floor.append(1e3 * kernel_isolate.device_ms(lambda: kernel_isolate.probe_copy(xc), reps))
    print(f"device us a call, {ROUNDS} rounds of {reps} calls, median (all); x{tuple(x.shape)} "
          f"w{tuple(w.shape)}; probe_copy at its script shape (the launch floor) "
          f"{statistics.median(floor):.3f} ({', '.join(f'{t:.3f}' for t in floor)})", flush=True)
    for variant in order:
        cells = [f"{name[6:]} {statistics.median(us[variant, name]):.3f} "
                 f"({', '.join(f'{t:.3f}' for t in us[variant, name])})" for name in PROBES]
        print(f"  {variant}: " + "; ".join(cells), flush=True)
    return 0 if ok else 1


def run_dot(family, parent=None):
    """A dot family (DOT_FAMILIES): bits of every computing variant against
    the reference ("parent" if given, else "kernel") at the script's shape
    and a ragged one, "kernel" against the twin, then device time a call in
    ROUNDS rounds of every variant in turns ("empty": the launch floor of
    this grid)."""
    fam = DOT_FAMILIES[family]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    csrc = None if parent is None else Path(parent).resolve() / "makani_tpu_torch" / "csrc"
    built, logs = _ablation.build_variants(f"ablation_{family}", SOURCES, fam.variants,
                                           (fam.probe,), csrc)
    launchers = {v: ls[fam.probe] for v, ls in built.items()}
    for variant, log in logs.items():
        for kernel in fam.kernels:
            for entry, regs, spill in _ablation.ptxas_usage(log, kernel):
                print(f"[ptxas {variant}] {entry}: {regs} registers, {spill} bytes spill stores",
                      flush=True)

    def call(variant, a, b, out):
        o, c, m = kernel_isolate._dot_shapes(a, b, family != "dot")
        rc = launchers[variant](a.data_ptr(), b.data_ptr(), out.data_ptr(), o, c, m,
                                kernels.stream(a.device.index))
        kernels.raise_on(rc, f"{fam.probe} {variant}")

    ref = "parent" if "parent" in launchers else "kernel"
    ok = True
    for shapes in fam.shapes:
        a, b = kernel_isolate.case_inputs(shapes, 3, dev)
        want = fam.twin(a, b)
        got = {}
        for variant in (v for v in fam.computing if v in launchers):
            got[variant] = torch.full(want.shape, float("nan"), device=dev)
            call(variant, a, b, got[variant])
        torch.cuda.synchronize()
        same = {v: torch.equal(t.view(torch.int32), got[ref].view(torch.int32))
                for v, t in got.items()}
        err = kernel_isolate.rel_err(got["kernel"], want)
        ok &= all(same.values()) and err < kernel_isolate.TWIN_TOL
        print(f"bits a{tuple(a.shape)} b{tuple(b.shape)}: "
              + ", ".join(f"{v} {'=' if s else '!='} {ref}" for v, s in same.items())
              + f"; kernel vs twin {err:.1e}", flush=True)
    a, b = kernel_isolate.case_inputs(fam.shapes[0], 0, dev)
    out = torch.empty(fam.twin(a, b).shape, device=dev)
    order = list(launchers)
    us = {v: [] for v in order}
    reps = kernel_isolate.DEVICE_REPS
    for r in range(ROUNDS):
        for variant in order if r % 2 == 0 else order[::-1]:
            us[variant].append(1e3 * kernel_isolate.device_ms(
                lambda: call(variant, a, b, out), reps))
    print(f"device us a call, {ROUNDS} rounds of {reps} calls, median (all); {fam.probe} "
          f"a{tuple(a.shape)} b{tuple(b.shape)}", flush=True)
    for variant in order:
        print(f"  {variant}: {statistics.median(us[variant]):.3f} "
              f"({', '.join(f'{t:.3f}' for t in us[variant])})", flush=True)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", nargs="?", default="gridded", choices=("gridded", *DOT_FAMILIES))
    ap.add_argument("--parent", type=Path, help="a checkout whose probes.cu is built as 'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_ablation: CUDA is not available", file=sys.stderr)
        return 1
    if args.family == "gridded":
        return run(args.parent)
    return run_dot(args.family, args.parent)


if __name__ == "__main__":
    sys.exit(main())
