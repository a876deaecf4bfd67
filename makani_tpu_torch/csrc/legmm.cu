// Legendre contraction of the spherical harmonic transform, multi-pass bf16.
//
// Replaces the TPU kernel makani_tpu/ops/pallas_mm.py legmm / _legmm_kernel
// (:104-143). For g in [0, M2) and m = g % mmax:
//   contract "k" (analysis):  out[g] (C, L) = z[g] (C, K) . p[m]^T
//   contract "l" (synthesis): out[g] (C, K) = z[g] (C, L) . p[m]
// with p (mmax, L, K) one table shared by both directions and by every row
// g = m (mod mmax). Operands are split into bf16 hi/lo parts,
//   hi = bf16_rn(a), lo = bf16_rn(a - float(hi)),
// and the products run on the tensor cores in float32 (_mp_dot,
// pallas_mm.py:40-55): passes 1 ah*bh; 2 ah*bh + ah*bl (the table split,
// z rounded); 3 ah*bh + ah*bl + al*bh.
//
// What bounds it on an H100 (flagship SFNO, batch 1, passes 3): the full-grid
// analysis or synthesis moves 878 MB (z, table and output, f32, once each) and
// does 3 x 64.1 GFLOP of bf16 products: 0.262 ms of HBM traffic at 3.35 TB/s
// against 0.195 ms of tensor work at 989 TFLOP/s, so it is bound by bytes.
// The inner grid (K = 240): 411 MB and 3 x 21.3 GFLOP, bound by bytes.
//
// Design. One block per (128-column tile, 128-row tile, m); eight warps, each
// owning 64 x 32 of the output. The rows of every g = m (mod mmax) are
// stacked into one A operand per table m (z[m], z[m + mmax], ...: 2C = 768
// rows in the SHT's stacked re/im layout, C rows in the paired layout), so a
// block stages and splits its table tile once for the re and the im rows.
// The grid's slowest dimension is m: the blocks of one m run side by side and
// share their z and table tiles through L2. Against the first kernel (one
// 64 x 64 block per g, a register prefetch of one 32-deep step, WMMA):
//   - one stage: the float32 tiles now arrive through a ring of 3 or 4
//     16-deep cp.async stages in shared memory (commit/wait groups; as many
//     as fit beside the split buffers), so two or three steps of loads are
//     in flight while the tensor cores work;
//   - the split redone per block: each staged tile is split into bf16 hi/lo
//     tiles once, by all threads, into one of two split buffers; the split of
//     step k + 1 overlaps the mma of step k with one barrier per step;
//   - the table split again for the re and the im rows: one A operand per m;
//   - passes a runtime argument: PASSES is a template parameter, so 1 pass
//     splits no lo tile and keeps no lo fragment, 2 splits only the table;
//   - WMMA from unswizzled pitches with two accumulator sets: ldmatrix from
//     pitches that leave its eight row reads on distinct banks, mma.sync
//     m16n8k16, and one accumulator. The correction terms are folded in as
//     they are formed (hh, then hl, then lh at every 16-deep step) instead of
//     summed apart and added at the end: the kernel and its twin differ only
//     in the order of float32 sums.
// The full-grid rows (pitch 721 floats) are not 16-byte aligned: they are
// copied 16 bytes at a time all the same, each row moved in shared memory by
// its misalignment and read back in place by the split (cp_async_ring.cuh,
// StagedTile with SHIFT; A_SHIFT and B_SHIFT choose it per operand, so the
// aligned inner grid keeps the plain layout). Ragged edges are zero-filled
// by the copy and masked on the store; the output goes through shared memory
// so that each warp writes whole rows. Shared memory is at most 113 KB a
// block and registers at most 128 a thread, so two blocks share an SM.

#include "cp_async_ring.cuh"

namespace {

using namespace makani;

constexpr int BM = 128;     // output rows (stacked g, c) per block
constexpr int BN = 128;     // output columns (l or k) per block
constexpr int BK = 16;      // contraction depth per stage
constexpr int THREADS = 256;
constexpr int WM = 64, WN = 32;  // warp tile: 4 x 4 mma tiles of 16 x 8
// blocks an SM holds at 128 registers a thread, and the shared memory each
// may take (228 KB an SM, 1 KB of it reserved for each block)
constexpr int BLOCKS_PER_SM = 2048 / THREADS / 4;
constexpr int SMEM_LIMIT = 233472 / BLOCKS_PER_SM - 1024;
constexpr int LDO = BN + 8;      // float32 pitch of the output staging tile

// Shared memory of one block: the float32 ring, two split buffers, and the
// global row index of each of the block's BM output rows. B_KMAJOR (the
// analysis) stages the table tile as [n][k], else as [k][n]. The ring has 4
// stages where they fit in SMEM_LIMIT beside the split buffers, else 3.
template <int PASSES, bool A_SHIFT, bool B_SHIFT, bool B_KMAJOR>
struct Layout {
  using TileA = StagedTile<BM, BK, A_SHIFT, THREADS>;
  using TileB = StagedTile<B_KMAJOR ? BN : BK, B_KMAJOR ? BK : BN, B_SHIFT, THREADS>;
  static constexpr int A_F32 = BM * TileA::PITCH;
  static constexpr int STAGE_F32 = A_F32 + (B_KMAJOR ? BN : BK) * TileB::PITCH;
  static constexpr int LDA = BK + 8;
  static constexpr int LDB = B_KMAJOR ? BK + 8 : BN + 8;
  static constexpr int A_BF = BM * LDA;
  static constexpr int B_BF = B_KMAJOR ? BN * LDB : BK * LDB;
  static constexpr int A_PARTS = PASSES == 3 ? 2 : 1;
  static constexpr int B_PARTS = PASSES >= 2 ? 2 : 1;
  static constexpr int SPLIT_BF = A_PARTS * A_BF + B_PARTS * B_BF;
  static constexpr int SPLIT_BYTES = 2 * SPLIT_BF * 2;
  static constexpr int STAGES = 4 * STAGE_F32 * 4 + SPLIT_BYTES + BM * 4 <= SMEM_LIMIT ? 4 : 3;
  static constexpr int RING_BYTES = STAGES * STAGE_F32 * 4;
  static constexpr int PIPE_BYTES = RING_BYTES + SPLIT_BYTES;
  static constexpr int OUT_BYTES = BM * LDO * 4;
  static constexpr int ROWS_AT = PIPE_BYTES > OUT_BYTES ? PIPE_BYTES : OUT_BYTES;
  static constexpr int BYTES = ROWS_AT + BM * 4;
  static_assert(BYTES <= SMEM_LIMIT, "BLOCKS_PER_SM blocks must fit on an SM");
  static_assert((STAGE_F32 * 4) % 16 == 0 && (A_F32 * 4) % 16 == 0, "staged tiles 16-byte aligned");
  static_assert((A_BF * 2) % 16 == 0 && (B_BF * 2) % 16 == 0, "split tiles 16-byte aligned");
};

// z: (M2, C, D) with D the contracted extent; p: (mmax, L, K), pitch K;
// out: (M2, C, N). A_SHIFT / B_SHIFT: z / p rows that need not start on 16
// bytes.
template <int PASSES, bool A_SHIFT, bool B_SHIFT, bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
legmm_kernel(const float* __restrict__ z, const float* __restrict__ p, float* __restrict__ out,
             int m2, int mmax, int C, int D, int N, int K, long long table_stride) {
  using S = Layout<PASSES, A_SHIFT, B_SHIFT, B_KMAJOR>;
  using TA = typename S::TileA;
  using TB = typename S::TileB;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  bf16* split = reinterpret_cast<bf16*>(smem + S::RING_BYTES);
  int* rows = reinterpret_cast<int*>(smem + S::ROWS_AT);

  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int m = blockIdx.z;
  const int nrows = ((m2 - 1 - m) / mmax + 1) * C;  // rows of every g = m (mod mmax)
  if (r0 >= nrows) return;
  // stacked row r is row c = r % C of g = m + (r / C) * mmax: global row g * C + c
  if (threadIdx.x < BM) {
    const int r = r0 + threadIdx.x;
    rows[threadIdx.x] = r < nrows ? (m + (r / C) * mmax) * C + r % C : -1;
  }
  __syncthreads();
  const float* B = p + (long long)m * table_stride;
  const int nk = (D + BK - 1) / BK;

  constexpr int STAGES = S::STAGES;

  // This thread's rows i of the staged tiles of depth step k0: stacked row
  // TA::row(i) of z; the table's row n0 + TB::row(i) (analysis: a column of
  // B, along k) or k0 + TB::row(i) (synthesis). The rows of z and of the
  // analysis table are fixed, their addresses at k0 = 0 held from the start.
  const float* a_base[TA::RPT];
#pragma unroll
  for (int i = 0; i < TA::RPT; ++i) {
    const int R = rows[TA::row(i)];
    a_base[i] = R < 0 ? nullptr : z + (long long)R * D;
  }
  const float* b_base[TB::RPT];
#pragma unroll
  for (int i = 0; i < TB::RPT; ++i) {
    const int n = n0 + TB::row(i);
    b_base[i] = B_KMAJOR && n < N ? B + (long long)n * K : nullptr;
  }
  auto a_at = [&](int k0) {
    return [=](int i) { return TA::locate(a_base[i] ? a_base[i] + k0 : nullptr, D - k0); };
  };
  auto b_at = [&](int k0) {
    return [=](int i) {
      if constexpr (B_KMAJOR) return TB::locate(b_base[i] ? b_base[i] + k0 : nullptr, D - k0);
      const int kb = k0 + TB::row(i);
      return TB::locate(kb < D ? B + (long long)kb * K + n0 : nullptr, N - n0);
    };
  };
  auto load = [&](int k, int slot) {
    float* a = ring + slot * S::STAGE_F32;
    TA::copy(a, a_at(k * BK), z);
    TB::copy(a + S::A_F32, b_at(k * BK), p);
  };
  auto split_stage = [&](int k, int slot, int buf) {
    const float* a = ring + slot * S::STAGE_F32;
    bf16* ah = split + buf * S::SPLIT_BF;
    bf16* bh = ah + S::A_PARTS * S::A_BF;
    TA::template split<S::LDA, PASSES == 3>(a, a_at(k * BK), ah, ah + S::A_BF);
    TB::template split<S::LDB, PASSES >= 2>(a + S::A_F32, b_at(k * BK), bh, bh + S::B_BF);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / (BN / WN)) * WM;
  const int wc = (warp % (BN / WN)) * WN;
  // ldmatrix addresses of this lane: A rows (lane % 16), k half (lane / 16);
  // B as [n][k]: n (lane % 8) + 8 (lane / 16), k half (lane / 8) % 2;
  // B as [k][n] (transposed load): k (lane % 8) + 8 ((lane / 8) % 2), n 8 (lane / 16)
  const int a_off = (wr + lane % 16) * S::LDA + (lane / 16) * 8;
  const int b_off = B_KMAJOR ? (wc + lane % 8 + (lane / 16) * 8) * S::LDB + ((lane / 8) % 2) * 8
                             : (lane % 8 + ((lane / 8) % 2) * 8) * S::LDB + wc + (lane / 16) * 8;

  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  // B fragments of the warp's four n8 tiles from one split B tile
  auto load_b = [&](uint32_t (&b)[WN / 8][2], const bf16* tile) {
#pragma unroll
    for (int jp = 0; jp < WN / 16; ++jp) {
      uint32_t r[4];
      ldmatrix_x4<!B_KMAJOR>(r, tile + b_off + (B_KMAJOR ? jp * 16 * S::LDB : jp * 16));
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
  };
  auto load_a = [&](uint32_t (&a)[WM / 16][4], const bf16* tile) {
#pragma unroll
    for (int i = 0; i < WM / 16; ++i) ldmatrix_x4<false>(a[i], tile + a_off + i * 16 * S::LDA);
  };
  auto mma_all = [&](const uint32_t (&a)[WM / 16][4], const uint32_t (&b)[WN / 8][2]) {
#pragma unroll
    for (int i = 0; i < WM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
  };

  // ring: stage s in slot s % STAGES, one commit group per stage (empty past
  // the end, so the wait counts stay uniform)
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  split_stage(0, 0, 0);

  for (int k = 0; k < nk; ++k) {
    // stage k + 1 has landed, split k is visible, and every warp is done with
    // the mma of k - 1 (its split buffer is free) and with splitting slot k
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (k + STAGES < nk) load(k + STAGES, k % STAGES);
    cp_async_commit();
    if (k + 1 < nk) split_stage(k + 1, (k + 1) % STAGES, (k + 1) % 2);

    const bf16* ah = split + (k % 2) * S::SPLIT_BF;
    const bf16* bh = ah + S::A_PARTS * S::A_BF;
    uint32_t a[WM / 16][4], b[WN / 8][2];
    load_a(a, ah);
    load_b(b, bh);
    mma_all(a, b);                    // hh
    if constexpr (PASSES >= 2) {
      uint32_t bl[WN / 8][2];
      load_b(bl, bh + S::B_BF);
      mma_all(a, bl);                 // hl
    }
    if constexpr (PASSES == 3) {
      load_a(a, ah + S::A_BF);
      mma_all(a, b);                  // lh
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // accumulators -> shared staging tile -> whole output rows
  float* stage = reinterpret_cast<float*>(smem);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      float* s = stage + (wr + i * 16 + g) * LDO + wc + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(s) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(s + 8 * LDO) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int R = rows[r];
    if (R < 0) break;  // the rows past the last are all at the tile's end
    float* o = out + (long long)R * N + n0;
#pragma unroll
    for (int c = lane; c < BN; c += 32)
      if (n0 + c < N) o[c] = stage[r * LDO + c];
  }
}

struct Args {
  const float* z;
  const float* p;
  float* out;
  int m2, mmax, c, d, n, k;
  long long table_stride;
};

template <int PASSES, bool A_SHIFT, bool B_SHIFT, bool B_KMAJOR>
int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  auto kernel = legmm_kernel<PASSES, A_SHIFT, B_SHIFT, B_KMAJOR>;
  constexpr int bytes = Layout<PASSES, A_SHIFT, B_SHIFT, B_KMAJOR>::BYTES;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, bytes, stream>>>(a.z, a.p, a.out, a.m2, a.mmax, a.c, a.d, a.n, a.k,
                                           a.table_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int PASSES, bool A_SHIFT, bool B_SHIFT>
int launch_dir(const Args& a, bool kmajor, dim3 grid, cudaStream_t s) {
  return kmajor ? launch<PASSES, A_SHIFT, B_SHIFT, true>(a, grid, s)
                : launch<PASSES, A_SHIFT, B_SHIFT, false>(a, grid, s);
}

template <int PASSES>
int launch_passes(const Args& a, bool a_shift, bool b_shift, bool kmajor, dim3 grid,
                  cudaStream_t s) {
  if (a_shift)
    return b_shift ? launch_dir<PASSES, true, true>(a, kmajor, grid, s)
                   : launch_dir<PASSES, true, false>(a, kmajor, grid, s);
  return b_shift ? launch_dir<PASSES, false, true>(a, kmajor, grid, s)
                 : launch_dir<PASSES, false, false>(a, kmajor, grid, s);
}

// rows of `pitch` floats from ptr all start on 16 bytes
bool aligned(const void* ptr, long long pitch) {
  return pitch % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// z (m2, c, K) for contract_k != 0, else (m2, c, L); p (mmax, L, K);
// out (m2, c, L) or (m2, c, K). Returns cudaGetLastError() after the launch
// (or the error of setting the kernel's shared-memory size).
extern "C" int legmm_launch(const void* z, const void* p, void* out, int m2, int mmax, int c,
                            int l, int k, int contract_k, int passes, void* stream) {
  const int D = contract_k ? k : l;
  const int N = contract_k ? l : k;
  const long long rows_per_m = (long long)((m2 + mmax - 1) / mmax) * c;
  const long long row_tiles = (rows_per_m + BM - 1) / BM;
  const int ms = m2 < mmax ? m2 : mmax;
  if (row_tiles > 65535 || ms > 65535 || (long long)m2 * c >= (1LL << 31) || passes < 1 ||
      passes > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(z), static_cast<const float*>(p), static_cast<float*>(out),
               m2, mmax, c, D, N, k, (long long)l * k};
  const dim3 grid((N + BN - 1) / BN, (unsigned)row_tiles, ms);
  // z rows have pitch D, table rows pitch K (and the table stride L * K is
  // then a multiple of 4 floats too)
  const bool a_shift = !aligned(z, D), b_shift = !aligned(p, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (passes) {
    case 1: return launch_passes<1>(a, a_shift, b_shift, contract_k != 0, grid, s);
    case 2: return launch_passes<2>(a, a_shift, b_shift, contract_k != 0, grid, s);
    default: return launch_passes<3>(a, a_shift, b_shift, contract_k != 0, grid, s);
  }
}
