// Weight gradient of the SFNO's dhconv filter, multi-pass bf16.
//
// Replaces the TPU kernel makani_tpu/ops/pallas_mm.py dhconv_dw /
// _dhconv_dw_kernel (:269-335). On stacked real planes (plane 0 = re,
// plane 1 = im), for every l:
//   dw[l] (C, O) = sum over b, m of conj(x[b, l]) (C, M) . g[b, l]^T (M, O)
//   re = xr.gr^T + xi.gi^T,  im = xr.gi^T - xi.gr^T
// with x (2, B, L, C, M), g (2, B, L, O, M), dw (2, L, C, O). The 3M form
// uses cross = (xr - xi).(gr + gi)^T, re = rr + ii, im = (cross - rr) + ii,
// in the TPU kernel's order (:278-289); the 4M form im = ri - ir. x is the
// first operand of every product, as in the TPU kernel, so passes 2 rounds
// x and splits g (split_mma.cuh).
//
// What bounds it on an H100 (flagship SFNO, batch 1, passes 3, 3M): it moves
// 638 MB (x and g 178 MB each, dw 283 MB, f32, once each) and does
// 3 x 51.2 GFLOP of bf16 products: 0.19 ms of HBM traffic at 3.35 TB/s
// against 0.16 ms of tensor work at 989 TFLOP/s, so it is bound by bytes.
//
// Design, simple first: the TPU kernel keeps the output block resident over a
// sequential b sweep. Here one block owns a (l, 64-row C tile, 32-column O
// tile) of dw and loops over b and m itself, so no reduction crosses blocks
// and no atomics are needed. Four warps each own 16 rows x 32 columns. x is
// loaded with its imaginary plane negated, so the operand tiles are xr, -xi
// and xr - xi (the 3M cross operand, summed in float32 before the split) and
// gr, gi, gr + gi; the products are rr, -ii and cross (3M) or rr, -ii,
// xr.gi^T and -xi.gr^T (4M). M is not padded: the ragged m edge (M = 241) is
// zero-filled on load. Each step loads, splits and stores the tiles of both
// operands (all loads of a step in flight together) and issues the passes of
// every product on WMMA 16x16x16. No TMA, wgmma or pipelining.

#include "split_mma.cuh"

namespace {

using namespace makani;

constexpr int TM = 64;        // dw rows (C) per block
constexpr int TN = 32;        // dw columns (O) per block
constexpr int TK = 32;        // m per stage
constexpr int LDA = TK + 8;   // bf16 pitch of the x tiles (80 B)
constexpr int LDB = TN + 8;   // bf16 pitch of the g^T tiles (80 B)
constexpr int LDC = TN + 4;   // f32 pitch of the output staging tiles
constexpr int THREADS = 128;

constexpr int A_TILE = TM * LDA;
constexpr int B_TILE = TK * LDB;

template <bool M3>
struct Layout {
  static constexpr int NT = M3 ? 3 : 2;  // operand tiles per side (re, -im[, re-im])
  static constexpr int NP = M3 ? 3 : 4;  // real products per complex product
  static constexpr int IN_BYTES = 2 * NT * (A_TILE + B_TILE) * (int)sizeof(bf16);
  static constexpr int OUT_BYTES = 2 * TM * LDC * (int)sizeof(float);
  static constexpr int SMEM_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
  // operand tiles of product q: 3M rr = A0.B0, -ii = A1.B1, cross = A2.B2;
  //                             4M rr = A0.B0, -ii = A1.B1, ri = A0.B1, -ir = A1.B0
  __host__ __device__ static constexpr int pa(int q) { return q < 2 ? q : (M3 ? 2 : q - 2); }
  __host__ __device__ static constexpr int pb(int q) { return q < 2 ? q : (M3 ? 2 : 3 - q); }
};

template <bool M3>
__global__ void __launch_bounds__(THREADS)
dhconv_dw_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dw,
                 int B, int L, int C, int O, int M, int passes) {
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
  const int l = blockIdx.z;
  const long long x_plane = (long long)B * L * C * M;
  const long long g_plane = (long long)B * L * O * M;
  const long long w_plane = (long long)L * C * O;

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
  // x[b, l] is (C, M) with m of unit stride; g[b, l]^T is (M, O) with m of
  // unit stride, i.e. the B tile is read down its columns
  const bool b_cfast = (M == 1);
  for (int b = 0; b < B; ++b) {
    const float* xr = x + ((long long)b * L + l) * C * M;
    const float* gr = g + ((long long)b * L + l) * O * M;
    for (int k0 = 0; k0 < M; k0 += TK) {
      ra.load(xr, xr + x_plane, M, 1, r0, k0, C, M, -1.f);
      rb.load(gr, gr + g_plane, 1, M, k0, n0, M, O, 1.f);
      ra.store<LDA>(true, a_hi, a_lo);
      rb.store<LDB>(b_cfast, b_hi, b_lo);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        FragA ah[NT], al[NT];
        FragB bh[NT][2], bv[NT][2];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          wmma::load_matrix_sync(ah[t], a_hi + t * A_TILE + wrow * LDA + kk, LDA);
          if (passes == 3)
            wmma::load_matrix_sync(al[t], a_lo + t * A_TILE + wrow * LDA + kk, LDA);
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
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < NP; ++q) fold(acc[q][j], cor[q][j]);
    FragC& re = cor[0][j];  // reuse as output registers
    FragC& im = cor[1][j];
    for (int t = 0; t < re.num_elements; ++t) {
      const float rr = acc[0][j].x[t], nii = acc[1][j].x[t];  // nii = -ii
      re.x[t] = rr - nii;
      if constexpr (M3)
        im.x[t] = (acc[2][j].x[t] - rr) - nii;
      else
        im.x[t] = acc[2][j].x[t] + acc[NP - 1][j].x[t];
    }
    wmma::store_matrix_sync(stage + wrow * LDC + 16 * j, re, LDC, wmma::mem_row_major);
    wmma::store_matrix_sync(stage + TM * LDC + wrow * LDC + 16 * j, im, LDC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  float* o = dw + (long long)l * C * O;
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    if (r0 + r < C && n0 + c < O) {
      const long long off = (long long)(r0 + r) * O + n0 + c;
      o[off] = stage[r * LDC + c];
      o[w_plane + off] = stage[TM * LDC + r * LDC + c];
    }
  }
}

}  // namespace

// x (2, b, l, c, m), g (2, b, l, o, m) -> dw (2, l, c, o).
// Returns cudaGetLastError().
extern "C" int dhconv_dw_launch(const void* x, const void* g, void* dw, int b, int l, int c,
                                int o, int m, int m3, int passes, void* stream) {
  dim3 grid((o + TN - 1) / TN, (c + TM - 1) / TM, l);
  auto s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* wp = static_cast<float*>(dw);
  if (m3)
    dhconv_dw_kernel<true><<<grid, THREADS, 0, s>>>(xp, gp, wp, b, l, c, o, m, passes);
  else
    dhconv_dw_kernel<false><<<grid, THREADS, 0, s>>>(xp, gp, wp, b, l, c, o, m, passes);
  return static_cast<int>(cudaGetLastError());
}
