// The mainloop of the dhconv kernels (dhconv_mm.cu, dhconv_complex.cu): the
// SFNO's per-l complex channel mixing,
//   out[b, l] (Co, M) = w[l]^T (Co, Ci) . x[b, l] (Ci, M)      (complex)
// for stacked real planes (x (2, B, L, Ci, M), out (2, B, L, Co, M)) or
// interleaved complex64 (x (B, Ci, L, M), out (B, Co, L, M)), with the
// weight read through any strides.
//
// The complex product is three real products in the 3M form (rr = wr.xr,
// ii = wi.xi, cross = (wr + wi).(xr + xi); re = rr - ii, im = (cross - rr)
// - ii, the sums formed in float32 before the split) or four in the 4M form
// (re = rr - ii, im = wr.xi + wi.xr). Each real product a.b is formed from
// bf16 parts with the weight the first operand (split_gemm.cuh):
//   passes 1: wh.xh   2: + wh.xl   3: + wl.xh
// one float32 accumulator a product (the 4M form's wr.xi and wi.xr share
// one), each 16-deep step adding its terms in that order.
//
// Design, in the launcher's order (run()):
//   1. The weight is prepared once a call (prep_weight) into scratch in the
//      layout wgmma reads B in (split_gemm.cuh's core matrices): the planes
//      wr, wi and wr + wi (3M; wr and wi for 4M), conj_w folded in as the
//      sign of wi, each split into bf16 hi (and, at 3 passes, lo), one slab
//      of 96 output channels x 16 input channels per (l, column block, 16-deep
//      step, plane, part), zero past Ci and Co. The weight is read through
//      its strides, so the dx transpose and the complex (C, O, L) layout
//      cost no copy. A stage's weight tile is one contiguous, aligned run:
//      one bulk copy, counted by the slot's mbarrier.
//   2. The GEMM of each (b, l) runs with m as its rows: D (M, Co) = x^T
//      (M, Ci) . w (Ci, Co), so the prepared weight is wgmma's B operand and
//      x its register A operand. A block covers 128 m x 96 output channels of
//      one (b, l): two consumer warpgroups of 64 m, each with three m64n96
//      float32 accumulators (144 registers a thread), for 4 column blocks at
//      Co = 384, and a producer warpgroup that only copies. setmaxnreg gives
//      the consumers 232 registers a thread and the producer 40. Blocks of
//      one l (all b, all m) run side by side, so the prepared weight is read
//      from device memory about once.
//   3. x comes through a ring of 32-deep stages (3 or 4) beside the weight
//      tiles: a stage is 32 input channels x 128 m of the re and im planes,
//      or 32 rows of 128 (re, im) pairs, each row brought by one bulk copy
//      (one producer thread a row) counted by the slot's full mbarrier; the
//      consumers release a slot through its empty mbarrier, so the producer
//      runs up to a ring ahead and the two consumer warpgroups run apart,
//      with no block barrier a stage. A row that does not start on 16 bytes
//      (M = 241: 964-byte rows, pairs on 8 bytes) is copied from the 16 bytes
//      that hold its first element and lands moved by its misalignment,
//      chosen from its address (the shift of cp_async_ring.cuh's
//      StagedTile). Ragged M and Co are masked on the store, a ragged Ci
//      meets zero weight rows: nothing is padded in device memory. Tried on
//      the H100 and slower: 16-byte cp.async of x by all threads and bulk
//      copies issued by the consumers, each with a block barrier a stage;
//      one producer warp issuing every copy.
//   4. A is x transposed: a lane's rows are m and its depths channels, the
//      staged tile's slow axis, so each lane reads its 8 elements of a
//      16-deep step one by one (pitches 132 and 260 floats keep the four
//      depth pairs of a warp in different banks), forms xr + xi in float32
//      and splits the planes in registers. Each warpgroup issues the step's
//      products (3, 6 or 9 wgmma m64n96k16) as one group and waits for it
//      before it splits the next step; the other warpgroup's group keeps the
//      tensor cores busy meanwhile.
//   5. The epilogue forms re and im and stages them through shared memory,
//      so the stores run along m, the contiguous axis of both layouts.
//
// What bounds it on an H100 (flagship SFNO, batch 1, passes 3, 3M): it
// needs x 177.7 MB + w 283.1 MB + out 177.7 MB = 638.5 MB, 0.19 ms at 3.35
// TB/s, against 3 x 3 x 2*240*384*384*241 = 1.54e11 bf16 operations, 0.16
// ms at 989 TFLOP/s: bound by bytes. The prepared weight costs more: the
// prep reads 283 MB and writes 425 MB (12 bytes a complex element at passes
// 3), which the main kernel reads again: about 1.49 GB, 0.44 ms at 3.35
// TB/s. That design was taken over the alternative (the weight as the
// register A operand, x split once per staged tile into shared memory as
// B: 638 MB) because one mainloop then serves both layouts, the dx
// transpose and the conjugate bit, and the complex (C, O, L) weight, whose
// elements lie L pairs apart, is read once by a kernel that can order its
// reads by its strides.
#pragma once

#include "split_gemm.cuh"

namespace makani {
namespace dhconv {

constexpr int BM = 128;        // m rows a block: two warpgroups of 64
constexpr int BN = 96;         // output channels a block
constexpr int BK = 32;         // input channels a stage: two 16-deep steps
constexpr int THREADS = 256;        // two consumer warpgroups
constexpr int BLOCK = THREADS + 128;  // and a producer warpgroup, one warp of it copying
constexpr int SLAB = BN * 16;  // bf16 of one (plane, part) of a 16-deep weight step
constexpr int SMEM_MAX = 232448;
constexpr int PL = 4, PK = 16, PN = 32;  // a prep block's tile: l, input and output channels

// Slab (l, nb, step, plane, part) of the prepared weight lies at
// ((((l * nblk + nb) * steps + step) * NPL + plane) * PARTS + part) * SLAB,
// element (n, k) of it at core matrix (n / 8, k / 8); steps = 2 ceil(Ci / 32).
//
// Weight element (k, n) of slice l: re at w[k * sk + n * sn + l * sl] and im
// wi_sign times the float im_off after it (floats). A block brings a tile of
// PL l x PK k x PN n into shared memory, the threads walking the dimension
// `fast` (0 n, 1 k, 2 l) of the smallest stride so the reads coalesce, then
// writes each (l, n, 8 k) of each plane and part as one 16-byte store:
// 64 threads an l write 1 KB runs.
template <int NPL, int PARTS>
__global__ void __launch_bounds__(256)
prep_weight(const float* __restrict__ w, long long im_off, long long sk, long long sn,
            long long sl, float wi_sign, bf16* __restrict__ wp, int K, int N, int L, int nblk,
            int steps, int fast) {
  constexpr int LSTR = PK * (PN + 1) + 1;  // odd in float2: the l walk misses no bank
  __shared__ float2 tile[PL * LSTR];
  const int l0 = blockIdx.x * PL, k0 = blockIdx.z * 16, n0 = blockIdx.y * PN;
#pragma unroll
  for (int j = 0; j < PL * PK * PN / 256; ++j) {
    const int i = threadIdx.x + 256 * j;
    int li, ki, ni;
    if (fast == 0) {
      ni = i % PN, ki = (i / PN) % PK, li = i / (PN * PK);
    } else if (fast == 1) {
      ki = i % PK, ni = (i / PK) % PN, li = i / (PN * PK);
    } else {
      li = i % PL, ni = (i / PL) % PN, ki = i / (PL * PN);
    }
    const int l = l0 + li, k = k0 + ki, n = n0 + ni;
    float2 v = make_float2(0.f, 0.f);
    if (l < L && k < K && n < N) {
      const long long o = k * sk + n * sn + l * sl;
      v = make_float2(w[o], wi_sign * w[o + im_off]);
    }
    tile[li * LSTR + ki * (PN + 1) + ni] = v;
  }
  __syncthreads();
  // thread: l (li), n (ng * 8 + nlo), depth half h; consecutive threads
  // write consecutive 16-byte runs
  const int nlo = threadIdx.x % 8, h = (threadIdx.x / 8) % 2, ng = (threadIdx.x / 16) % 4;
  const int li = threadIdx.x / 64;
  if (l0 + li >= L) return;
  const int ni = ng * 8 + nlo;
  float v[NPL][8];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float2 e = tile[li * LSTR + (h * 8 + kk) * (PN + 1) + ni];
    v[0][kk] = e.x;
    v[1][kk] = e.y;
    if constexpr (NPL == 3) v[2][kk] = e.x + e.y;  // the 3M cross operand, in float32
  }
  const int nb = n0 / BN, nl = n0 % BN + ni;
  bf16* o = wp + (((long long)(l0 + li) * nblk + nb) * steps + blockIdx.z) * NPL * PARTS * SLAB +
            (nl / 8) * 128 + h * 64 + (nl % 8) * 8;
#pragma unroll
  for (int q = 0; q < NPL; ++q) {
    uint4 hi, lo;
    uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = v[q][2 * i], b = v[q][2 * i + 1];
      hp[i] = pack_bf16(a, b);
      if constexpr (PARTS == 2) {
        const float2 f = unpack_bf16(hp[i]);
        lp[i] = pack_bf16(a - f.x, b - f.y);
      }
    }
    *reinterpret_cast<uint4*>(o + q * PARTS * SLAB) = hi;
    if constexpr (PARTS == 2) *reinterpret_cast<uint4*>(o + (q * PARTS + 1) * SLAB) = lo;
  }
}

// The staged x tile of a stage and the output staging of the epilogue.
// Stacked: 64 rows (32 channels of re, then of im) x 128 m floats, pitch
// 132. Complex: 32 channel rows x 128 (re, im) pairs, pitch 260 floats. A
// pitch holds a row moved by its shift and rounded up to 16 bytes.
// Output: re and im tiles of 96 x 128 floats, pitch 132 (stacked), or one
// tile of 96 x 128 pairs, pitch 130 pairs (complex).
template <bool CPLX, bool M3, int PASSES>
struct Layout {
  static constexpr int NPL = M3 ? 3 : 2;            // weight planes: wr, wi (, wr + wi)
  static constexpr int PARTS = PASSES == 3 ? 2 : 1;  // the weight's hi (and lo)
  static constexpr int XROWS = CPLX ? BK : 2 * BK;
  static constexpr int XCOLS = CPLX ? 2 * BM : BM;
  static constexpr int XPITCH = XCOLS + 4;
  static constexpr int OPITCH = CPLX ? BM + 2 : BM + 4;  // in pairs (complex) or floats
  static constexpr int OUT_BYTES = 2 * BN * OPITCH * 4;
  static constexpr int X_BYTES = XROWS * XPITCH * 4;
  static constexpr int T_BYTES = 2 * NPL * PARTS * SLAB * 2;
  static constexpr int STAGE_BYTES = X_BYTES + T_BYTES;
  static constexpr int FIT = (SMEM_MAX - 16 * 4) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BARS = STAGES * STAGE_BYTES;  // two mbarriers a slot, after the ring
  static constexpr int BYTES = BARS + 16 * STAGES;
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(OUT_BYTES <= BARS, "the output staging reuses the ring");
  static_assert((XPITCH * 4) % 16 == 0 && T_BYTES % 16 == 0, "16-byte bulk copies");
};

struct Params {
  const float* x;   // stacked (2, B, L, Ci, M) or complex (B, Ci, L, M) pairs
  const bf16* wp;   // the prepared weight
  float* out;       // stacked (2, B, L, Co, M) or complex (B, Co, L, M) pairs
  int B, L, Ci, Co, M, mblk, nblk, steps;
};

// this lane's A fragment of one plane from v[d][r]: depth slots d = 2t,
// 2t + 1, 2t + 8, 2t + 9 and rows r = g, g + 8 (split_gemm.cuh); hi =
// bf16_rn(v) and, with LO, lo = bf16_rn(v - hi)
template <bool LO>
__device__ __forceinline__ void split_frag(const float (&v)[4][2], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = v[(i / 2) * 2][i % 2], b = v[(i / 2) * 2 + 1][i % 2];
    hi[i] = pack_bf16(a, b);
    if constexpr (LO) {
      const float2 h = unpack_bf16(hi[i]);
      lo[i] = pack_bf16(a - h.x, b - h.y);
    }
  }
}

// Block ((l * B + b) * mblk + mb) * nblk + nb covers m from mb * BM and
// output channels from nb * BN of (b, l).
template <bool CPLX, bool M3, int PASSES>
__global__ void __launch_bounds__(BLOCK, 1) dhconv_gemm(Params p) {
  using S = Layout<CPLX, M3, PASSES>;
  constexpr int STAGES = S::STAGES, NPL = S::NPL, PARTS = S::PARTS;
  constexpr bool A_LO = PASSES >= 2;
  extern __shared__ __align__(128) unsigned char smem[];
  // full: a slot's x rows and weight tile landed (one arrival a copying
  // producer thread); empty: the consumers are done with the slot (one
  // arrival a consumer thread)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, S::XROWS);
      mbar_init(empty + s, THREADS);
    }
    fence_mbar_init();
  }
  // Rows past Ci are never copied: with a ragged Ci the x tiles start as
  // zeros, so those rows hold zeros or an earlier stage's x, finite values
  // that meet the weight's zero rows.
  if (p.Ci % BK != 0) {
    for (int i = threadIdx.x; i < STAGES * S::X_BYTES / 16; i += BLOCK)
      *reinterpret_cast<uint4*>(smem + (i / (S::X_BYTES / 16)) * S::STAGE_BYTES +
                                (i % (S::X_BYTES / 16)) * 16) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();  // the zeros before the bulk copies into the same bytes
  }
  __syncthreads();

  const int nb = blockIdx.x % p.nblk;
  const int mb = (blockIdx.x / p.nblk) % p.mblk;
  const int lb = blockIdx.x / (p.nblk * p.mblk);
  const int l = lb / p.B, b = lb % p.B;
  const int m0 = mb * BM, n0 = nb * BN;
  const int nk = p.steps / 2;
  const unsigned char* wblk = reinterpret_cast<const unsigned char*>(
      p.wp + ((long long)l * p.nblk + nb) * p.steps * NPL * PARTS * SLAB);

  // x at channel 0 and m0 of (b, l) (the re plane), the floats from one
  // channel to the next and from the re plane to the im plane (stacked)
  const long long cstride = CPLX ? 2LL * p.L * p.M : p.M;
  const long long pstride = CPLX ? 1 : (long long)p.B * p.L * p.Ci * p.M;
  const float* x0 = CPLX ? p.x + 2 * (((long long)b * p.Ci * p.L + l) * p.M + m0)
                         : p.x + ((long long)(b * p.L + l) * p.Ci * p.M + m0);
  const int ncols = min(CPLX ? 2 * (p.M - m0) : p.M - m0, S::XCOLS);
  // staged row r of stage k is channel k * BK + r (complex), or channel
  // k * BK + r % BK of plane r / BK (stacked); its shift s is its first
  // element's offset in floats from 16 bytes
  auto channel = [&](int k, int r) { return k * BK + (CPLX ? r : r % BK); };
  auto first = [&](int k, int r) {
    return x0 + (CPLX ? 0 : (r / BK) * pstride) + (long long)channel(k, r) * cstride;
  };
  auto shift = [](const float* f) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(f) / 4) & 3);
  };
  // The producer warp stages k into its slot once the consumers are done
  // with the slot's last stage: lane r copies rows r, r + 32 by one bulk
  // copy each, from the 16 bytes that hold a row's first element to those
  // that hold its last, so the row lands moved by its shift; lane 0 also
  // copies the weight tile (one contiguous run). The slot's full mbarrier
  // counts every byte.
  // Registers go where the accumulators are: the producer warpgroup keeps
  // 40 a thread, the consumers take 232 (128 x 40 + 256 x 232 <= 65,536).
  if (threadIdx.x >= THREADS) {
    setmaxnreg_dec<40>();
    const int r = threadIdx.x - THREADS;  // this thread's staged row
    for (int k = 0; r < S::XROWS && k < nk; ++k) {
      const int slot = k % STAGES;
      if (k >= STAGES) mbar_wait(empty + slot, (k / STAGES - 1) & 1);
      unsigned char* st = smem + slot * S::STAGE_BYTES;
      const float* f = first(k, r);
      const int s = shift(f);
      const uint32_t bytes = channel(k, r) < p.Ci ? ((s + ncols) * 4 + 15) & ~15u : 0;
      mbar_expect_tx(full + slot, bytes + (r == 0 ? S::T_BYTES : 0));
      if (bytes != 0) bulk_copy(st + r * S::XPITCH * 4, f - s, bytes, full + slot);
      if (r == 0)
        bulk_copy(st + S::X_BYTES, wblk + (long long)k * S::T_BYTES, S::T_BYTES, full + slot);
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ma = (warp / 4) * 64 + (warp % 4) * 16 + g;  // this lane's rows ma and ma + 8
  // the shifts of this lane's staged rows, by channel parity (and plane):
  // a stage is 32 channels deep, so they hold at every stage and depth slot
  int sh[2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int q = 0; q < 2; ++q) sh[q][e] = shift(first(0, (CPLX ? 0 : q * BK) + 2 * t + e));

  float acc[3][48];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[q][i] = 0.f;

  // ring: stage k in slot k % STAGES; the warpgroups run apart, held only
  // by the slots' barriers
  for (int k = 0; k < nk; ++k) {
    mbar_wait(full + k % STAGES, (k / STAGES) & 1);  // stage k's x rows and weight tile

    const unsigned char* st = smem + (k % STAGES) * S::STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(st);
    const bf16* tb = reinterpret_cast<const bf16*>(st + S::X_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // this lane's re and im at depth slots d (channel 16h + 2t + d % 2 +
      // 8 (d / 2)) and rows ma, ma + 8
      float re[4][2], im[4][2];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int c = 16 * h + 2 * t + d % 2 + 8 * (d / 2);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = ma + 8 * r;
          if constexpr (CPLX) {
            const float2 v =
                *reinterpret_cast<const float2*>(xs + c * S::XPITCH + sh[0][d % 2] + 2 * m);
            re[d][r] = v.x;
            im[d][r] = v.y;
          } else {
            re[d][r] = xs[c * S::XPITCH + sh[0][d % 2] + m];
            im[d][r] = xs[(BK + c) * S::XPITCH + sh[1][d % 2] + m];
          }
        }
      }
      // A planes: xr, xi and, for 3M, xr + xi (summed in float32)
      uint32_t ah[3][4], al[3][4];
      split_frag<A_LO>(re, ah[0], al[0]);
      split_frag<A_LO>(im, ah[1], al[1]);
      if constexpr (M3) {
        float sum[4][2];
#pragma unroll
        for (int d = 0; d < 4; ++d)
#pragma unroll
          for (int r = 0; r < 2; ++r) sum[d][r] = re[d][r] + im[d][r];
        split_frag<A_LO>(sum, ah[2], al[2]);
      }
      // products (A plane, B plane) -> accumulator: 3M rr (0, 0), ii (1, 1),
      // cross (2, 2); 4M rr (0, 0), ii (1, 1), wr.xi (1, 0) and wi.xr (0, 1)
      // into the third accumulator. One wgmma group a step, waited for
      // before the next step's split: an instruction that writes a wgmma's A
      // or accumulator registers while its group is in flight makes ptxas
      // serialise the wgmma.
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < (M3 ? 3 : 4); ++q) {
        const int pa = q < 2 ? q : (M3 ? 2 : 3 - q);
        const int pb = q < 2 ? q : (M3 ? 2 : q - 2);
        float(&d)[48] = acc[q < 2 ? q : 2];
        const bf16* bh = tb + (h * NPL + pb) * PARTS * SLAB;
        wgmma_m64n96k16(d, ah[pa], wgmma_desc(bh, 128, 256));                 // wh.xh
        if constexpr (A_LO) wgmma_m64n96k16(d, al[pa], wgmma_desc(bh, 128, 256));  // wh.xl
        if constexpr (PARTS == 2)
          wgmma_m64n96k16(d, ah[pa], wgmma_desc(bh + SLAB, 128, 256));            // wl.xh
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    mbar_arrive(empty + k % STAGES);  // this thread is done with the slot
  }
  named_barrier_sync(1, THREADS);  // the consumers are done with the ring: it takes the output

  // re and im of the accumulators' elements: d[4j + e] is row ma + 8 (e / 2),
  // output channel 8j + 2t + e % 2
  float* so = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, m = ma + 8 * (e / 2), n = 8 * j + 2 * t + e % 2;
      const float rr = acc[0][i], ii = acc[1][i];
      const float vr = rr - ii;
      const float vi = M3 ? (acc[2][i] - rr) - ii : acc[2][i];
      if constexpr (CPLX) {
        reinterpret_cast<float2*>(so)[n * S::OPITCH + m] = make_float2(vr, vi);
      } else {
        so[n * S::OPITCH + m] = vr;
        so[(BN + n) * S::OPITCH + m] = vi;
      }
    }
  named_barrier_sync(1, THREADS);
  // whole runs along m: (n, m) of the block's tile at n * BM + m
  for (int i = threadIdx.x; i < BN * BM; i += THREADS) {
    const int n = i / BM, m = i % BM;
    if (n0 + n >= p.Co || m0 + m >= p.M) continue;
    if constexpr (CPLX) {
      float2* o = reinterpret_cast<float2*>(p.out);
      o[(((long long)b * p.Co + n0 + n) * p.L + l) * p.M + m0 + m] =
          reinterpret_cast<const float2*>(so)[n * S::OPITCH + m];
    } else {
      const long long off = ((long long)(b * p.L + l) * p.Co + n0 + n) * p.M + m0 + m;
      p.out[off] = so[n * S::OPITCH + m];
      p.out[(long long)p.B * p.L * p.Co * p.M + off] = so[(BN + n) * S::OPITCH + m];
    }
  }
}

template <bool CPLX, bool M3, int PASSES>
int launch_gemm(const Params& p, unsigned blocks, cudaStream_t s) {
  auto kernel = dhconv_gemm<CPLX, M3, PASSES>;
  constexpr int bytes = Layout<CPLX, M3, PASSES>::BYTES;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, BLOCK, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Prepares the weight into wp, then runs the GEMM. The weight: element (k,
// n) of slice l at w[k * sk + n * sn + l * sl] (re) and im_off floats after
// it (im), k the contracted channel (Ci of them), n the output channel (Co).
// Refuses (before launching anything) a shape whose grids or indices do not
// fit.
template <bool CPLX, bool M3, int PASSES>
int run(const float* x, const float* w, long long im_off, long long sk, long long sn,
        long long sl, int conj_w, bf16* wp, float* out, int B, int L, int Ci, int Co, int M,
        cudaStream_t s) {
  constexpr int NPL = Layout<CPLX, M3, PASSES>::NPL, PARTS = Layout<CPLX, M3, PASSES>::PARTS;
  if (B < 1 || L < 1 || Ci < 1 || Co < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long mblk = (M + BM - 1) / BM, nblk = (Co + BN - 1) / BN;
  const long long steps = 2 * ((Ci + BK - 1) / BK);
  const long long blocks = (long long)B * L * mblk * nblk;
  if (blocks > 2147483647LL || nblk * (BN / PN) > 65535 || steps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long as[3] = {sn < 0 ? -sn : sn, sk < 0 ? -sk : sk, sl < 0 ? -sl : sl};
  const int fast = as[0] <= as[1] && as[0] <= as[2] ? 0 : (as[1] <= as[2] ? 1 : 2);
  const dim3 pgrid((L + PL - 1) / PL, (unsigned)(nblk * (BN / PN)), (unsigned)steps);
  prep_weight<NPL, PARTS><<<pgrid, 256, 0, s>>>(w, im_off, sk, sn, sl, conj_w ? -1.f : 1.f, wp,
                                                Ci, Co, L, (int)nblk, (int)steps, fast);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Params p{x, wp, out, B, L, Ci, Co, M, (int)mblk, (int)nblk, (int)steps};
  return launch_gemm<CPLX, M3, PASSES>(p, (unsigned)blocks, s);
}

}  // namespace dhconv
}  // namespace makani
