// Legendre contraction of the spherical harmonic transform, multi-pass bf16.
//
// Replaces the TPU kernel makani_tpu/ops/pallas_mm.py legmm / _legmm_kernel
// (:104-143). For g in [0, 2*mmax) (re rows, then im rows) and m = g % mmax:
//   contract "k" (analysis):  out[g] (C, L) = z[g] (C, K) . p[m]^T
//   contract "l" (synthesis): out[g] (C, K) = z[g] (C, L) . p[m]
// with p (mmax, L, K) one table shared by both directions and by the re and
// im rows. Operands are split into bf16 hi/lo parts (split_mma.cuh) and the
// passes accumulate in float32 on the tensor cores (WMMA 16x16x16).
//
// What bounds it on an H100 (flagship SFNO, batch 1, passes 3): the full-grid
// analysis or synthesis moves 878 MB (z, table and output, f32, once each) and
// does 3 x 64.1 GFLOP of bf16 products: 0.26 ms of HBM traffic at 3.35 TB/s
// against 0.19 ms of tensor work at 989 TFLOP/s, so it is bound by bytes.
// The inner grid (K = 240): 411 MB and 3 x 21.3 GFLOP, bound by bytes.
//
// Design, simple first: one block per (64-column tile, 64-row tile, g); four
// warps each own a 32x32 sub-tile. The block walks the contraction depth in
// steps of 32: f32 tiles come from global memory into registers (the next
// step's loads in flight while the tensor cores work on the current step),
// are split into shared bf16 hi/lo tiles, and each fragment pair takes 1-3
// mma. Ragged edges (K = 721, L = 240, M2 = 482) are zero-filled on load and
// masked on store. The z row tile is re-read from L2 once per column tile.
// No TMA, wgmma or multi-stage shared-memory pipeline yet.

#include "split_mma.cuh"

namespace {

using namespace makani;

constexpr int TM = 64;        // output rows (channels x batch) per block
constexpr int TN = 64;        // output columns (l or k) per block
constexpr int TK = 32;        // contraction depth per stage
constexpr int LDA = TK + 8;   // bf16 pitch of the A tiles (80 B)
constexpr int LDB = TN + 8;   // bf16 pitch of the B tiles (144 B)
constexpr int LDC = TN + 4;   // f32 pitch of the output staging tile
constexpr int THREADS = 128;

constexpr int A_TILE = TM * LDA;
constexpr int B_TILE = TK * LDB;
constexpr int IN_BYTES = 2 * (A_TILE + B_TILE) * (int)sizeof(bf16);
constexpr int OUT_BYTES = TM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;

// z: (M2, C, D) with D the contracted extent; p: (mmax, L, K); out: (M2, C, N).
// Element (d, n) of the table operand lies at p[m] + d * b_rs + n * b_cs.
__global__ void __launch_bounds__(THREADS)
legmm_kernel(const float* __restrict__ z, const float* __restrict__ p, float* __restrict__ out,
             int mmax, int C, int D, int N, long long table_stride, long long b_rs,
             long long b_cs, int passes) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = a_hi + A_TILE;
  bf16* b_hi = a_lo + A_TILE;
  bf16* b_lo = b_hi + B_TILE;
  float* stage = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * TM;
  const int g = blockIdx.z;
  const float* A = z + (long long)g * C * D;
  const float* B = p + (long long)(g % mmax) * table_stride;
  float* O = out + (long long)g * C * N;

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 32;

  FragC acc[2][2], cor[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      wmma::fill_fragment(cor[i][j], 0.f);
    }

  // the next depth step's tiles are loaded into registers while the tensor
  // cores work on the current one from shared memory
  TileRegs<TM, TK, 1, THREADS> ra;
  TileRegs<TK, TN, 1, THREADS> rb;
  const bool b_cfast = (b_cs == 1);
  ra.load(A, nullptr, D, 1, r0, 0, C, D, 1.f);
  rb.load(B, nullptr, b_rs, b_cs, 0, n0, D, N, 1.f);
  for (int k0 = 0; k0 < D; k0 += TK) {
    ra.store<LDA>(true, a_hi, a_lo);
    rb.store<LDB>(b_cfast, b_hi, b_lo);
    __syncthreads();
    if (k0 + TK < D) {
      ra.load(A, nullptr, D, 1, r0, k0 + TK, C, D, 1.f);
      rb.load(B, nullptr, b_rs, b_cs, k0 + TK, n0, D, N, 1.f);
    }
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      FragA ah[2], al[2];
      FragB bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ah[i], a_hi + (wr + 16 * i) * LDA + kk, LDA);
        if (passes == 3) wmma::load_matrix_sync(al[i], a_lo + (wr + 16 * i) * LDA + kk, LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bh[j], b_hi + kk * LDB + wc + 16 * j, LDB);
        if (passes >= 2) wmma::load_matrix_sync(bl[j], b_lo + kk * LDB + wc + 16 * j, LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mp_mma(acc[i][j], cor[i][j], ah[i], al[i], bh[j], bl[j], passes);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      fold(acc[i][j], cor[i][j]);
      wmma::store_matrix_sync(stage + (wr + 16 * i) * LDC + wc + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    if (r0 + r < C && n0 + c < N) O[(long long)(r0 + r) * N + n0 + c] = stage[r * LDC + c];
  }
}

}  // namespace

// z (m2, c, K) for contract_k != 0, else (m2, c, L); p (mmax, L, K);
// out (m2, c, L) or (m2, c, K). Returns cudaGetLastError() after the launch.
extern "C" int legmm_launch(const void* z, const void* p, void* out, int m2, int mmax, int c,
                            int l, int k, int contract_k, int passes, void* stream) {
  const int D = contract_k ? k : l;
  const int N = contract_k ? l : k;
  const long long b_rs = contract_k ? 1 : k;
  const long long b_cs = contract_k ? k : 1;
  dim3 grid((N + TN - 1) / TN, (c + TM - 1) / TM, m2);
  legmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(p), static_cast<float*>(out), mmax,
      c, D, N, (long long)l * k, b_rs, b_cs, passes);
  return static_cast<int>(cudaGetLastError());
}
