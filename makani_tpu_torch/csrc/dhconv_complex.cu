// Complex per-l channel mixing of the SFNO's dhconv filter on complex64
// layouts, multi-pass bf16, always in the 3M form.
//
// Replaces the TPU kernel makani_tpu/ops/pallas_kernels.py
// contract_dhconv_pallas / _dhconv_pallas_raw / _dhconv_kernel (:34-150):
//   out[b, o, l, m] = sum_i w[i, o, l] * x[b, i, l, m]      (complex)
// with the three real products of _dhconv_kernel,
//   rr = wr.xr,  ii = wi.xi,  cross = (wr + wi).(xr + xi),
//   re = rr - ii,  im = (cross - rr) - ii,
// the sums wr + wi and xr + xi formed in float32 before the split, and each
// real product a.b formed from bf16 parts, the weight the first operand:
// passes 3 wh.xh + wh.xl + wl.xh, passes 1 wh.xh, summed in float32.
//
// Layouts: x (B, C, L, M) and out (B, O, L, M) are read and written as the
// complex64 tensors they are, interleaved (re, im) pairs: for each (b, l) the
// slice x[b, :, l, :] is C rows of M pairs, contiguous along m, rows L*M
// pairs apart. The weight is read in place through its strides and its
// conjugate bit: the (C, O, L) tensor of the forward, or the lazily
// conjugated transpose w.conj().transpose(0, 1) of the backward's dx. So
// the TPU path's real/imag copies and four transposes
// (pallas_kernels.py:127-136) are gone, no weight is permuted or resolved,
// and the ragged M (241 at the flagship) is zero-filled on load and masked
// on store instead of padded.
//
// The computation is dhconv_gemm.cuh's (its header has the design and what
// bounds it), the mainloop of dhconv_mm.cu with x staged as rows of pairs:
// at the flagship (batch 1, passes 3) x 177.7 MB + w 283.1 MB + out 177.7
// MB = 638.5 MB once each, 0.19 ms at 3.35 TB/s, against 1.54e11 bf16
// operations, 0.16 ms at 989 TFLOP/s: bound by bytes.

#include "dhconv_gemm.cuh"

using namespace makani::dhconv;

// x (b, c, l, m) complex64, contiguous (pairs on 8 bytes); w (c, o, l)
// complex64 with element (i, o, l) at w[i * sc + o * so + l * sl] (strides in
// pairs), conjugated when conj_w; out (b, o, l, m) complex64, contiguous.
// passes is 1 or 3. scratch, 16-byte aligned, for the prepared weight: l *
// ceil(o / 96) * 2 ceil(c / 32) * 3 * parts * 1536 bf16, parts 2 at 3
// passes, else 1. Returns cudaGetLastError() after the launches.
extern "C" int dhconv_complex_launch(const void* x, const void* w, void* scratch, void* out,
                                     int b, int c, int o, int l, int m, int sc, int so, int sl,
                                     int conj_w, int passes, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  auto* wp = static_cast<makani::bf16*>(scratch);
  float* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  // in floats: re at 2 * (pair offset), im one float after it
  const long long sk = 2LL * sc, sn = 2LL * so, sl2 = 2LL * sl;
  if (passes == 3)
    return run<true, true, 3>(xp, wf, 1, sk, sn, sl2, conj_w, wp, op, b, l, c, o, m, s);
  if (passes == 1)
    return run<true, true, 1>(xp, wf, 1, sk, sn, sl2, conj_w, wp, op, b, l, c, o, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
