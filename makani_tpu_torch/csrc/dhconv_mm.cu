// Per-l complex channel mixing of the SFNO's dhconv filter on stacked real
// planes, multi-pass bf16, and its dx.
//
// Replaces the TPU kernel makani_tpu/ops/pallas_mm.py dhconv_mm /
// _dhconv_mm_kernel (:152-210). On stacked real planes (plane 0 = re,
// plane 1 = im), for every (b, l):
//   wdim 0 (forward): out[b, l] (O, M) = w[l]^T (O, C) . x[b, l] (C, M)
//   wdim 1 (dx):      out[b, l] (C, M) = w[l]   (C, O) . x[b, l] (O, M)
// with x (2, B, L, Ci, M), w (2, L, C, O), out (2, B, L, Co, M), complex
// products in the 3M form (rr, ii, cross = (wr+wi)(xr+xi)) or the 4M form,
// and conj_w negating wi. The weight is the first operand of every product,
// as in the TPU kernel, so passes 2 splits the activation and rounds the
// weight.
//
// The computation is dhconv_gemm.cuh's (its header has the design and what
// bounds it): the weight is prepared once a call into scratch in wgmma's B
// layout, read through the strides of wdim 0 or 1 with conj_w as the sign of
// wi, so dx copies nothing; x, stacked planes, is the register A operand.
// At the flagship (batch 1, passes 3, 3M) the work needs 638.5 MB of HBM
// traffic (0.19 ms at 3.35 TB/s) against 1.54e11 bf16 operations (0.16 ms):
// bound by bytes.

#include "dhconv_gemm.cuh"

namespace {

using namespace makani::dhconv;

template <bool M3>
int run_passes(const float* x, const float* w, long long im_off, long long sk, long long sn,
               long long sl, int conj_w, makani::bf16* wp, float* out, int b, int l, int ci,
               int co, int m, int passes, cudaStream_t s) {
  switch (passes) {
    case 1:
      return run<false, M3, 1>(x, w, im_off, sk, sn, sl, conj_w, wp, out, b, l, ci, co, m, s);
    case 2:
      return run<false, M3, 2>(x, w, im_off, sk, sn, sl, conj_w, wp, out, b, l, ci, co, m, s);
    case 3:
      return run<false, M3, 3>(x, w, im_off, sk, sn, sl, conj_w, wp, out, b, l, ci, co, m, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (2, b, l, ci, m), w (2, l, c, o) -> out (2, b, l, co, m); ci = c and co = o
// for wdim 0, ci = o and co = c for wdim 1; every tensor contiguous. scratch,
// 16-byte aligned, for the prepared weight: l * ceil(co / 96) * 2 ceil(ci /
// 32) * planes * parts * 1536 bf16, planes 3 (m3) or 2, parts 2 at 3 passes,
// else 1. Returns cudaGetLastError() after the launches.
extern "C" int dhconv_mm_launch(const void* x, const void* w, void* scratch, void* out, int b,
                                int l, int c, int o, int m, int wdim, int conj_w, int m3,
                                int passes, void* stream) {
  const int ci = wdim == 0 ? c : o;
  const int co = wdim == 0 ? o : c;
  // weight element (k, n) of slice l: w[l, k, n] (wdim 0) or w[l, n, k]
  const long long sk = wdim == 0 ? o : 1;
  const long long sn = wdim == 0 ? 1 : o;
  const long long sl = (long long)c * o, im_off = (long long)l * c * o;
  const float* xp = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  auto* wp = static_cast<makani::bf16*>(scratch);
  float* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m3)
    return run_passes<true>(xp, wf, im_off, sk, sn, sl, conj_w, wp, op, b, l, ci, co, m, passes,
                            s);
  return run_passes<false>(xp, wf, im_off, sk, sn, sl, conj_w, wp, op, b, l, ci, co, m, passes,
                           s);
}
