// Shared pieces of the multi-pass bf16 WMMA kernels (dhconv_dw.cu, probes.cu);
// legmm.cu's pipeline is in cp_async_ring.cuh, the wgmma consumer of
// gridmm.cu and the dhconv kernels in split_gemm.cuh.
//
// A float32 operand a is split into two bfloat16 values,
//   hi = bf16_rn(a),  lo = bf16_rn(a - float(hi)),
// and a product a*b is formed from the bf16 parts on the tensor cores:
//   passes 1: ah*bh
//   passes 2: ah*bh + ah*bl          (second operand split, first rounded)
//   passes 3: ah*bh + (ah*bl + al*bh)
// Each bf16 x bf16 product is exact in float32 and is accumulated in float32,
// as in _mp_dot (makani_tpu/ops/pallas_mm.py:40-55). The leading term and the
// two correction terms keep separate accumulators and are added once at the
// end, in the order of _mp_dot.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace makani {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void split_store(float v, bf16* hi, bf16* lo, int idx) {
  const bf16 h = __float2bfloat16_rn(v);
  hi[idx] = h;
  lo[idx] = __float2bfloat16_rn(v - __bfloat162float(h));
}

// One thread's share of a TR x TC tile of a logical matrix whose element
// (r, c) lies at src[r * rs + c * cs], held in registers between the global
// load and the split into shared memory. NT == 1 holds one plane (re);
// NT == 2 and 3 hold a complex pair (re, sign * im), and for NT == 3 the
// store adds tile 2 = re + sign * im (the 3M cross operand, summed in
// float32 before the split as in the TPU kernel).
template <int TR, int TC, int NT, int THREADS>
struct TileRegs {
  static_assert((TR * TC) % THREADS == 0, "tile must split evenly over the threads");
  static constexpr int N = TR * TC / THREADS;
  static constexpr int P = NT >= 2 ? 2 : 1;
  float v[P][N];

  // Element j of this thread: consecutive threads walk the dimension of unit
  // stride, so global reads coalesce.
  __device__ __forceinline__ static void coords(int j, bool c_fast, int& r, int& c) {
    const int i = threadIdx.x + j * THREADS;
    if (c_fast) {
      r = i / TC;
      c = i % TC;
    } else {
      r = i % TR;
      c = i / TR;
    }
  }

  // Issues every global load of the tile before any is used, so they are in
  // flight together. Elements outside [0, rmax) x [0, cmax) are zero, so a
  // ragged edge adds nothing to the product.
  __device__ __forceinline__ void load(const float* __restrict__ re, const float* __restrict__ im,
                                       long long rs, long long cs, int r0, int c0, int rmax,
                                       int cmax, float sign) {
    const bool c_fast = (cs == 1);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int r, c;
      coords(j, c_fast, r, c);
      const bool in = (r0 + r < rmax) && (c0 + c < cmax);
      const long long off = (long long)(r0 + r) * rs + (long long)(c0 + c) * cs;
      v[0][j] = in ? __ldg(re + off) : 0.f;
      if constexpr (NT >= 2) v[1][j] = in ? sign * __ldg(im + off) : 0.f;
    }
  }

  // Splits into hi and lo parts and stores row-major shared tiles of pitch
  // LD, tile t of the NT at offset t * TR * LD.
  template <int LD>
  __device__ __forceinline__ void store(bool c_fast, bf16* hi, bf16* lo) const {
    constexpr int TILE = TR * LD;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int r, c;
      coords(j, c_fast, r, c);
      const int s = r * LD + c;
      split_store(v[0][j], hi, lo, s);
      if constexpr (NT >= 2) split_store(v[1][j], hi + TILE, lo + TILE, s);
      if constexpr (NT == 3) split_store(v[0][j] + v[1][j], hi + 2 * TILE, lo + 2 * TILE, s);
    }
  }
};

// acc += ah*bh; cor += ah*bl (passes >= 2) + al*bh (passes == 3)
__device__ __forceinline__ void mp_mma(FragC& acc, FragC& cor, const FragA& ah, const FragA& al,
                                       const FragB& bh, const FragB& bl, int passes) {
  wmma::mma_sync(acc, ah, bh, acc);
  if (passes >= 2) wmma::mma_sync(cor, ah, bl, cor);
  if (passes == 3) wmma::mma_sync(cor, al, bh, cor);
}

// acc <- acc + cor, elementwise (fragments of one type share their layout)
__device__ __forceinline__ void fold(FragC& acc, const FragC& cor) {
  for (int t = 0; t < acc.num_elements; ++t) acc.x[t] += cor.x[t];
}

}  // namespace makani
