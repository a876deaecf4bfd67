// Grid-side multi-pass bf16 matmul: the longitude DFT and its inverse.
//
// Replaces two TPU kernels that compute out (R, N) = x (R, K) . t (K, N) with
// the table resident, x float32 or bfloat16 and the output float32 or
// bfloat16, rounded once from the float32 sum:
//   gridmm   makani_tpu/ops/pallas_mm.py gridmm / _gridmm_kernel (:62-96).
//            t float32, split here into bf16 hi/lo (split_mma.cuh);
//            passes 1: hh,  2: hh + hl,  3: hh + (hl + lh)  (_mp_dot's order)
//   grid_dot scripts/bench_gridmm.py grid_dot_pallas / _grid_dot_kernel
//            (:33-74). t arrives pre-split as bf16 th and tl; a bf16 x gives
//            hh + hl, a float32 x (hh + hl) + lh (the script's left-to-right
//            order, not _mp_dot's)
// with hh = xh.th, hl = xh.tl and lh = xl.th summed over K on WMMA 16x16x16
// in two float32 accumulators that are added once at the end: gridmm keeps hh
// in one and the corrections hl and lh in the other (legmm.cu's scheme,
// split_mma.cuh's mp_mma), grid_dot keeps hh and hl in one and lh in the
// other, so each ends in its own association. A bf16 x splits with xl = 0:
// its lh term is zero and is not formed, so gridmm at 3 passes runs the
// 2-pass build on a bf16 x (the same value).
//
// What bounds it on an H100, at the flagship longitude DFT (block 0 of the
// SFNO: R = 384*721 = 276,864 rows, K = 1440, N = 2*241 = 482, float32 x,
// 3 passes): 2.131 GB moved once (x 1.595 GB, table 2.8 MB, out 0.534 GB),
// 0.636 ms at 3.35 TB/s, against 3 x 2RKN = 1.153e12 bf16 operations,
// 1.166 ms at 989 TFLOP/s: bound by operations. A bf16 x at 2 passes moves
// 1.33 GB (0.40 ms) for 7.7e11 operations (0.78 ms): bound by operations too.
//
// Design, simple first (legmm.cu's tiling): one block per 64 x 64 output
// tile, the tiles of one row band adjacent in launch order, so the band of x
// comes from device memory once and from L2 for the band's other column
// tiles; the 2.8 MB table stays in L2. Eight warps each own a 16 x 32
// sub-tile (with four warps of 32 x 32, as in legmm.cu, the staged tiles and
// two accumulator sets spilled registers). The block walks K in steps of 32 with the next step's global
// loads in flight while the tensor cores work on the current step from
// shared memory. Ragged R, K and N (K = 1440, N = 482 and 1440 are not
// multiples of 64) are zero-filled on load and masked on store: nothing is
// padded or copied. The element types of x and of the output and the pass
// count are template parameters, so each build holds only the accumulators
// and splits it uses; the staged tiles stay in their source type in
// registers. No TMA, wgmma or multi-stage pipeline yet.

#include <type_traits>

#include "split_mma.cuh"

namespace {

using namespace makani;

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int TK = 32;        // contraction depth per stage
constexpr int LDA = TK + 8;   // bf16 pitch of the x tiles (80 B)
constexpr int LDB = TN + 8;   // bf16 pitch of the table tiles (144 B)
constexpr int LDC = TN + 4;   // f32 pitch of the output staging tile
constexpr int THREADS = 256;

constexpr int A_TILE = TM * LDA;
constexpr int B_TILE = TK * LDB;
constexpr int IN_BYTES = 2 * (A_TILE + B_TILE) * (int)sizeof(bf16);
constexpr int OUT_BYTES = TM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// One thread's share of a TR x TC tile of a row-major matrix of T with pitch
// ld, held in registers between the global load and the split into shared
// memory. Consecutive threads walk the columns, so the reads coalesce;
// elements outside [0, rmax) x [0, cmax) are zero and add nothing.
template <typename T, int TR, int TC>
struct Tile {
  static_assert((TR * TC) % THREADS == 0, "tile must split evenly over the threads");
  static constexpr int N = TR * TC / THREADS;
  T v[N];

  __device__ __forceinline__ void load(const T* __restrict__ src, long long ld, long long r0,
                                       int c0, long long rmax, int cmax) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / TC, c = i % TC;
      const bool in = (r0 + r < rmax) && (c0 + c < cmax);
      v[j] = in ? src[(r0 + r) * ld + c0 + c] : T(0.f);
    }
  }

  // hi[r * LD + c] = bf16(v) and, with LO, lo[r * LD + c] = bf16(v - hi)
  template <int LD, bool LO>
  __device__ __forceinline__ void store(bf16* hi, bf16* lo) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int s = (i / TC) * LD + i % TC;
      if constexpr (LO)
        split_store(to_f32(v[j]), hi, lo, s);
      else
        hi[s] = to_bf16(v[j]);
    }
  }
};

// x (R, K) of XT; the table (K, N) as float32 t (PRESPLIT false) or as bf16
// th, tl (PRESPLIT true); out (R, N) of OT.
template <typename XT, typename OT, int PASSES, bool PRESPLIT>
__global__ void __launch_bounds__(THREADS)
gridmm_kernel(const XT* __restrict__ x, const float* __restrict__ t, const bf16* __restrict__ th,
              const bf16* __restrict__ tl, OT* __restrict__ out, int R, int K, int N) {
  constexpr bool X_LO = PASSES == 3;  // x split into hi and lo
  constexpr bool T_LO = PASSES >= 2;  // the table's lo part
  // the second accumulator: gridmm's corrections hl + lh, grid_dot's lh
  constexpr bool COR = PRESPLIT ? X_LO : T_LO;
  static_assert(!(X_LO && std::is_same<XT, bf16>::value), "a bf16 x has no lo part");
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = a_hi + A_TILE;
  bf16* b_hi = a_lo + A_TILE;
  bf16* b_lo = b_hi + B_TILE;
  float* stage = reinterpret_cast<float*>(smem);

  const int ncol = (N + TN - 1) / TN;
  const int n0 = (blockIdx.x % ncol) * TN;
  const long long r0 = (long long)(blockIdx.x / ncol) * TM;

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 16;
  const int wc = (warp % 2) * 32;

  FragC acc[2], cor[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(acc[j], 0.f);
    if constexpr (COR) wmma::fill_fragment(cor[j], 0.f);
  }

  using TT = std::conditional_t<PRESPLIT, bf16, float>;
  Tile<XT, TM, TK> ra;   // x
  Tile<TT, TK, TN> rb;   // t, or th
  Tile<TT, TK, TN> rl;   // tl (PRESPLIT)
  ra.load(x, K, r0, 0, R, K);
  if constexpr (PRESPLIT) {
    rb.load(th, N, 0, n0, K, N);
    if constexpr (T_LO) rl.load(tl, N, 0, n0, K, N);
  } else {
    rb.load(t, N, 0, n0, K, N);
  }
  for (int k0 = 0; k0 < K; k0 += TK) {
    ra.template store<LDA, X_LO>(a_hi, a_lo);
    if constexpr (PRESPLIT) {
      rb.template store<LDB, false>(b_hi, nullptr);
      if constexpr (T_LO) rl.template store<LDB, false>(b_lo, nullptr);
    } else {
      rb.template store<LDB, T_LO>(b_hi, b_lo);
    }
    __syncthreads();
    if (k0 + TK < K) {
      ra.load(x, K, r0, k0 + TK, R, K);
      if constexpr (PRESPLIT) {
        rb.load(th, N, k0 + TK, n0, K, N);
        if constexpr (T_LO) rl.load(tl, N, k0 + TK, n0, K, N);
      } else {
        rb.load(t, N, k0 + TK, n0, K, N);
      }
    }
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      FragA ah, al;
      FragB bh[2], bl[2];
      wmma::load_matrix_sync(ah, a_hi + wr * LDA + kk, LDA);
      if constexpr (X_LO) wmma::load_matrix_sync(al, a_lo + wr * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bh[j], b_hi + kk * LDB + wc + 16 * j, LDB);
        if constexpr (T_LO) wmma::load_matrix_sync(bl[j], b_lo + kk * LDB + wc + 16 * j, LDB);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (PRESPLIT) {
          // acc += hh + hl, cor += lh
          wmma::mma_sync(acc[j], ah, bh[j], acc[j]);
          wmma::mma_sync(acc[j], ah, bl[j], acc[j]);
          if constexpr (X_LO) wmma::mma_sync(cor[j], al, bh[j], cor[j]);
        } else {
          // acc += hh, cor += hl + lh
          mp_mma(acc[j], cor[j], ah, al, bh[j], bl[j], PASSES);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (COR) fold(acc[j], cor[j]);
    wmma::store_matrix_sync(stage + wr * LDC + wc + 16 * j, acc[j], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    if (r0 + r < R && n0 + c < N) put(out + (r0 + r) * N + n0 + c, stage[r * LDC + c]);
  }
}

template <typename XT, typename OT, int PASSES, bool PRESPLIT>
int launch(const void* x, const void* t, const void* th, const void* tl, void* out, int r, int k,
           int n, cudaStream_t s) {
  const long long tiles = (long long)((r + TM - 1) / TM) * ((n + TN - 1) / TN);
  if (tiles < 1 || tiles > 2147483647LL || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  gridmm_kernel<XT, OT, PASSES, PRESPLIT><<<(unsigned)tiles, THREADS, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const float*>(t), static_cast<const bf16*>(th),
      static_cast<const bf16*>(tl), static_cast<OT*>(out), r, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT>
int gridmm_passes(const void* x, const void* t, void* out, int r, int k, int n, int passes,
                  cudaStream_t s) {
  switch (passes) {
    case 1:
      return launch<XT, OT, 1, false>(x, t, nullptr, nullptr, out, r, k, n, s);
    case 2:
      return launch<XT, OT, 2, false>(x, t, nullptr, nullptr, out, r, k, n, s);
    case 3:
      // a bf16 x has lo = 0: the 2-pass build gives the 3-pass value
      if constexpr (std::is_same<XT, bf16>::value)
        return launch<XT, OT, 2, false>(x, t, nullptr, nullptr, out, r, k, n, s);
      else
        return launch<XT, OT, 3, false>(x, t, nullptr, nullptr, out, r, k, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (r, k) float32 (x_bf16 == 0) or bfloat16, t (k, n) float32, out (r, n)
// float32 (out_bf16 == 0) or bfloat16; passes 1, 2 or 3. Contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int gridmm_launch(const void* x, const void* t, void* out, int r, int k, int n,
                             int x_bf16, int out_bf16, int passes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return out_bf16 ? gridmm_passes<bf16, bf16>(x, t, out, r, k, n, passes, s)
                    : gridmm_passes<bf16, float>(x, t, out, r, k, n, passes, s);
  return out_bf16 ? gridmm_passes<float, bf16>(x, t, out, r, k, n, passes, s)
                  : gridmm_passes<float, float>(x, t, out, r, k, n, passes, s);
}

// x (r, k) float32 or bfloat16, th and tl (k, n) bfloat16 (the table's hi and
// lo parts), out (r, n) float32 or bfloat16. Contiguous.
extern "C" int grid_dot_launch(const void* x, const void* th, const void* tl, void* out, int r,
                               int k, int n, int x_bf16, int out_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return out_bf16 ? launch<bf16, bf16, 2, true>(x, nullptr, th, tl, out, r, k, n, s)
                    : launch<bf16, float, 2, true>(x, nullptr, th, tl, out, r, k, n, s);
  return out_bf16 ? launch<float, bf16, 3, true>(x, nullptr, th, tl, out, r, k, n, s)
                  : launch<float, float, 3, true>(x, nullptr, th, tl, out, r, k, n, s);
}
