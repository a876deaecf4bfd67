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
//   passes 3: (ah.bh + ah.bl) + al.bh    (three accumulators, added once)
//   passes 1: ah.bh
// Every bf16 x bf16 product is exact in float32 and summed in float32.
//
// Layouts: x (B, C, L, M) and out (B, O, L, M) are read and written as the
// complex64 tensors they are, interleaved (re, im) pairs: for each (b, l) the
// slice x[b, :, l, :] is C rows of M pairs, contiguous along m, rows L*M
// pairs apart. The wrapper permutes the weight once per call to (L, C, O)
// complex64. So the TPU path's real/imag copies and four transposes
// (pallas_kernels.py:127-136) are gone, and the ragged M (241 at the
// flagship) is zero-filled on load and masked on store instead of padded.
//
// What bounds it on an H100 (flagship SFNO, batch 1, passes 3): it moves
// x 177.7 MB + w 283.1 MB + out 177.7 MB = 638.5 MB once each, 0.19 ms at
// 3.35 TB/s, against 3 passes x 3 products x 2*240*384*384*241 = 1.54e11
// bf16 operations, 0.16 ms at 989 TFLOP/s: bound by bytes.
//
// Design, simple first: one block per (32-column m tile, 64-row o tile,
// b*L + l); eight warps each own a 16 x 16 output tile, so the nine float32
// accumulator fragments of passes 3 fit in registers. The block walks
// the input channels in steps of 32: every global load of the step is issued
// before any is used, the re, im and re + im operand tiles are split into
// shared bf16 hi/lo tiles (the weight tile stored column-major, so the loads
// along o store without bank conflicts) and the passes of the three products
// run on WMMA 16x16x16. The weight tile is re-read from L2 by every m tile
// and batch row. No TMA, wgmma or pipelining.

#include "split_mma.cuh"

namespace {

using namespace makani;

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

constexpr int TM = 64;        // output channels per block
constexpr int TN = 32;        // m columns per block
constexpr int TK = 32;        // input channels per stage
constexpr int LDA = TM + 8;   // bf16 pitch of the column-major weight tiles (144 B)
constexpr int LDB = TN + 8;   // bf16 pitch of the activation tiles (80 B)
constexpr int LDC = TN + 4;   // f32 pitch of the output staging tiles
constexpr int THREADS = 256;

constexpr int A_TILE = TK * LDA;  // one weight operand tile, [k][o]
constexpr int B_TILE = TK * LDB;  // one activation operand tile, [k][m]
constexpr int IN_BYTES = 2 * 3 * (A_TILE + B_TILE) * (int)sizeof(bf16);
constexpr int OUT_BYTES = 2 * TM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;

template <bool P3>
__device__ __forceinline__ void put(float v, bf16* hi, bf16* lo, int s) {
  const bf16 h = __float2bfloat16_rn(v);
  hi[s] = h;
  if constexpr (P3) lo[s] = __float2bfloat16_rn(v - __bfloat162float(h));
}

// One thread's share of a TR x TC tile of complex64 pairs whose element
// (r, c) lies at src[r * rs + c * cs] (in pairs), held in registers between
// the global load and the split. Consecutive threads walk r (R_FAST) or c,
// the dimension of unit stride, so the 8-byte loads coalesce. Elements
// outside [0, rmax) x [0, cmax) are zero and add nothing to the product.
template <int TR, int TC, bool R_FAST>
struct CplxTile {
  static_assert((TR * TC) % THREADS == 0, "tile must split evenly over the threads");
  static constexpr int N = TR * TC / THREADS;
  float2 v[N];

  __device__ __forceinline__ static void coords(int j, int& r, int& c) {
    const int i = threadIdx.x + j * THREADS;
    r = R_FAST ? i % TR : i / TC;
    c = R_FAST ? i / TR : i % TC;
  }

  __device__ __forceinline__ void load(const float2* __restrict__ src, long long rs, long long cs,
                                       int r0, int c0, int rmax, int cmax) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int r, c;
      coords(j, r, c);
      const bool in = (r0 + r < rmax) && (c0 + c < cmax);
      v[j] = in ? __ldg(src + (long long)(r0 + r) * rs + (long long)(c0 + c) * cs)
                : make_float2(0.f, 0.f);
    }
  }

  // Splits re, im and re + im into the hi/lo tiles t = 0, 1, 2 (TILE apart);
  // element (r, c) at r * LD + c, or c * LD + r when COL_MAJOR.
  template <int LD, int TILE, bool COL_MAJOR, bool P3>
  __device__ __forceinline__ void store(bf16* hi, bf16* lo) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int r, c;
      coords(j, r, c);
      const int s = COL_MAJOR ? c * LD + r : r * LD + c;
      put<P3>(v[j].x, hi, lo, s);
      put<P3>(v[j].y, hi + TILE, lo + TILE, s);
      put<P3>(v[j].x + v[j].y, hi + 2 * TILE, lo + 2 * TILE, s);
    }
  }
};

// x (B, C, L, M), w (L, C, O), out (B, O, L, M), all complex64 pairs.
template <bool P3>
__global__ void __launch_bounds__(THREADS)
dhconv_complex_kernel(const float2* __restrict__ x, const float2* __restrict__ w,
                      float2* __restrict__ out, int C, int O, int L, int M) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = a_hi + 3 * A_TILE;
  bf16* b_hi = a_lo + 3 * A_TILE;
  bf16* b_lo = b_hi + 3 * B_TILE;
  float* stage = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * TM;
  const int b = blockIdx.z / L;
  const int l = blockIdx.z % L;
  const long long LM = (long long)L * M;
  const float2* xs = x + (long long)b * C * LM + (long long)l * M;    // (i, m) at i*LM + m
  const float2* ws = w + (long long)l * C * O;                        // (o, i) at i*O + o
  float2* os = out + (long long)b * O * LM + (long long)l * M;        // (o, m) at o*LM + m

  const int warp = threadIdx.x / 32;
  const int wrow = (warp / 2) * 16;
  const int wcol = (warp % 2) * 16;

  // hh, and for passes 3 hl and lh, of the products rr, ii, cross (q)
  FragC hh[3], hl[3], lh[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    wmma::fill_fragment(hh[q], 0.f);
    if constexpr (P3) {
      wmma::fill_fragment(hl[q], 0.f);
      wmma::fill_fragment(lh[q], 0.f);
    }
  }

  CplxTile<TM, TK, true> ra;    // weight: rows o, columns i
  CplxTile<TK, TN, false> rb;   // activation: rows i, columns m
  for (int k0 = 0; k0 < C; k0 += TK) {
    ra.load(ws, 1, O, r0, k0, O, C);
    rb.load(xs, LM, 1, k0, n0, C, M);
    ra.store<LDA, A_TILE, true, P3>(a_hi, a_lo);
    rb.store<LDB, B_TILE, false, P3>(b_hi, b_lo);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        FragAc ah, al;
        FragB bh, bl;
        wmma::load_matrix_sync(ah, a_hi + q * A_TILE + kk * LDA + wrow, LDA);
        wmma::load_matrix_sync(bh, b_hi + q * B_TILE + kk * LDB + wcol, LDB);
        wmma::mma_sync(hh[q], ah, bh, hh[q]);
        if constexpr (P3) {
          wmma::load_matrix_sync(al, a_lo + q * A_TILE + kk * LDA + wrow, LDA);
          wmma::load_matrix_sync(bl, b_lo + q * B_TILE + kk * LDB + wcol, LDB);
          wmma::mma_sync(hl[q], ah, bl, hl[q]);
          wmma::mma_sync(lh[q], al, bh, lh[q]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: (hh + hl) + lh per product, then the 3M combination; re and im
  // overwrite hh[0] and hh[1] (fragments of one type share their layout)
  for (int t = 0; t < hh[0].num_elements; ++t) {
    float p[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      p[q] = hh[q].x[t];
      if constexpr (P3) p[q] = (p[q] + hl[q].x[t]) + lh[q].x[t];
    }
    hh[0].x[t] = p[0] - p[1];
    hh[1].x[t] = (p[2] - p[0]) - p[1];
  }
  wmma::store_matrix_sync(stage + wrow * LDC + wcol, hh[0], LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(stage + TM * LDC + wrow * LDC + wcol, hh[1], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    if (r0 + r < O && n0 + c < M)
      os[(long long)(r0 + r) * LM + n0 + c] =
          make_float2(stage[r * LDC + c], stage[TM * LDC + r * LDC + c]);
  }
}

}  // namespace

// x (b, c, l, m), w (l, c, o), out (b, o, l, m): complex64, contiguous.
// passes is 1 or 3. Returns cudaGetLastError().
extern "C" int dhconv_complex_launch(const void* x, const void* w, void* out, int b, int c, int o,
                                     int l, int m, int passes, void* stream) {
  if (passes != 1 && passes != 3) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((m + TN - 1) / TN, (o + TM - 1) / TM, b * l);
  auto s = static_cast<cudaStream_t>(stream);
  const float2* xp = static_cast<const float2*>(x);
  const float2* wp = static_cast<const float2*>(w);
  float2* op = static_cast<float2*>(out);
  if (passes == 3)
    dhconv_complex_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, op, c, o, l, m);
  else
    dhconv_complex_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, op, c, o, l, m);
  return static_cast<int>(cudaGetLastError());
}
