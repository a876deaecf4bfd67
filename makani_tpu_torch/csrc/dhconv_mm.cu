// Per-l complex channel mixing of the SFNO's dhconv filter, multi-pass bf16.
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
// weight (split_mma.cuh).
//
// What bounds it on an H100 (flagship SFNO, batch 1, passes 3, 3M): it moves
// 638 MB (x, w and out, f32, once each) and does 3 x 51.2 GFLOP of bf16
// products at M = 241: 0.19 ms of HBM traffic at 3.35 TB/s against 0.16 ms
// of tensor work at 989 TFLOP/s, so it is bound by bytes.
//
// Design, simple first: one block per (32-column m tile, 64-row output
// channel tile, b*L + l); four warps each own 16 rows x 32 columns. The block
// walks the input channels in steps of 32, loading the re and im planes of
// the weight and activation tiles once (all loads of a step in flight
// together), forming the 3M sums in float32, splitting every operand into
// shared bf16 hi/lo tiles and issuing the passes of every complex product.
// M is not padded: the ragged m edge (M = 241) is zero-filled on load and
// masked on store. The weight tile is re-read from L2 by every m tile and
// batch row. No TMA, wgmma or pipelining.

#include "split_mma.cuh"

namespace {

using namespace makani;

constexpr int TM = 64;        // output channels per block
constexpr int TN = 32;        // m columns per block
constexpr int TK = 32;        // input channels per stage
constexpr int LDA = TK + 8;   // bf16 pitch of the weight tiles (80 B)
constexpr int LDB = TN + 8;   // bf16 pitch of the activation tiles (80 B)
constexpr int LDC = TN + 4;   // f32 pitch of the output staging tiles
constexpr int THREADS = 128;

constexpr int A_TILE = TM * LDA;
constexpr int B_TILE = TK * LDB;

template <bool M3>
struct Layout {
  static constexpr int NT = M3 ? 3 : 2;  // operand tiles per side (re, im[, re+im])
  static constexpr int NP = M3 ? 3 : 4;  // real products per complex product
  static constexpr int IN_BYTES = 2 * NT * (A_TILE + B_TILE) * (int)sizeof(bf16);
  static constexpr int OUT_BYTES = 2 * TM * LDC * (int)sizeof(float);
  static constexpr int SMEM_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
  // operand tiles of product q: 3M rr = A0.B0, ii = A1.B1, cross = A2.B2;
  //                             4M rr = A0.B0, ii = A1.B1, ri = A0.B1, ir = A1.B0
  __host__ __device__ static constexpr int pa(int q) { return q < 2 ? q : (M3 ? 2 : q - 2); }
  __host__ __device__ static constexpr int pb(int q) { return q < 2 ? q : (M3 ? 2 : 3 - q); }
};

// Weight element (r, k) lies at w_plane + l*C*O + r*a_rs + k*a_cs.
template <bool M3>
__global__ void __launch_bounds__(THREADS)
dhconv_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
              int B, int L, int Ci, int Co, int M, long long w_l_stride, long long a_rs,
              long long a_cs, float wi_sign, int passes) {
  using Lay = Layout<M3>;
  constexpr int NT = Lay::NT;
  constexpr int NP = Lay::NP;
  __shared__ __align__(128) unsigned char smem[Lay::SMEM_BYTES];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = a_hi + NT * A_TILE;
  bf16* b_hi = a_lo + NT * A_TILE;
  bf16* b_lo = b_hi + NT * B_TILE;
  float* stage = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * TM;
  const int bl = blockIdx.z;  // b * L + l
  const int l = bl % L;
  const long long x_plane = (long long)B * L * Ci * M;
  const long long o_plane = (long long)B * L * Co * M;
  const long long w_plane = (long long)L * w_l_stride;
  const float* xr = x + (long long)bl * Ci * M;
  const float* wr = w + (long long)l * w_l_stride;
  float* o = out + (long long)bl * Co * M;

  const int wrow = (threadIdx.x / 32) * 16;

  FragC acc[NP][2], cor[NP][2];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[q][j], 0.f);
      wmma::fill_fragment(cor[q][j], 0.f);
    }

  TileRegs<TM, TK, NT, THREADS> ra;
  TileRegs<TK, TN, NT, THREADS> rb;
  const bool a_cfast = (a_cs == 1);
  for (int k0 = 0; k0 < Ci; k0 += TK) {
    // every load of both tiles in flight together, then split and store
    ra.load(wr, wr + w_plane, a_rs, a_cs, r0, k0, Co, Ci, wi_sign);
    rb.load(xr, xr + x_plane, M, 1, k0, n0, Ci, M, 1.f);
    ra.store<LDA>(a_cfast, a_hi, a_lo);
    rb.store<LDB>(true, b_hi, b_lo);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      FragA ah[NT], al[NT];
      FragB bh[NT][2], bv[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        wmma::load_matrix_sync(ah[t], a_hi + t * A_TILE + wrow * LDA + kk, LDA);
        if (passes == 3) wmma::load_matrix_sync(al[t], a_lo + t * A_TILE + wrow * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(bh[t][j], b_hi + t * B_TILE + kk * LDB + 16 * j, LDB);
          if (passes >= 2)
            wmma::load_matrix_sync(bv[t][j], b_lo + t * B_TILE + kk * LDB + 16 * j, LDB);
        }
      }
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mp_mma(acc[q][j], cor[q][j], ah[Lay::pa(q)], al[Lay::pa(q)], bh[Lay::pb(q)][j],
                 bv[Lay::pb(q)][j], passes);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < NP; ++q) fold(acc[q][j], cor[q][j]);
    FragC& re = cor[0][j];  // reuse as output registers
    FragC& im = cor[1][j];
    for (int t = 0; t < re.num_elements; ++t) {
      const float rr = acc[0][j].x[t], ii = acc[1][j].x[t];
      re.x[t] = rr - ii;
      if constexpr (M3)
        im.x[t] = (acc[2][j].x[t] - rr) - ii;
      else
        im.x[t] = acc[2][j].x[t] + acc[NP - 1][j].x[t];
    }
    wmma::store_matrix_sync(stage + wrow * LDC + 16 * j, re, LDC, wmma::mem_row_major);
    wmma::store_matrix_sync(stage + TM * LDC + wrow * LDC + 16 * j, im, LDC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    if (r0 + r < Co && n0 + c < M) {
      const long long off = (long long)(r0 + r) * M + n0 + c;
      o[off] = stage[r * LDC + c];
      o[o_plane + off] = stage[TM * LDC + r * LDC + c];
    }
  }
}

}  // namespace

// x (2, b, l, ci, m), w (2, l, c, o) -> out (2, b, l, co, m); ci = c and co = o
// for wdim 0, ci = o and co = c for wdim 1. Returns cudaGetLastError().
extern "C" int dhconv_mm_launch(const void* x, const void* w, void* out, int b, int l, int c,
                                int o, int m, int wdim, int conj_w, int m3, int passes,
                                void* stream) {
  const int ci = wdim == 0 ? c : o;
  const int co = wdim == 0 ? o : c;
  const long long a_rs = wdim == 0 ? 1 : o;
  const long long a_cs = wdim == 0 ? o : 1;
  const float sign = conj_w ? -1.f : 1.f;
  dim3 grid((m + TN - 1) / TN, (co + TM - 1) / TM, b * l);
  auto s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (m3)
    dhconv_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, op, b, l, ci, co, m, (long long)c * o,
                                                 a_rs, a_cs, sign, passes);
  else
    dhconv_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, op, b, l, ci, co, m, (long long)c * o,
                                                  a_rs, a_cs, sign, passes);
  return static_cast<int>(cudaGetLastError());
}
