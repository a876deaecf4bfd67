// Weight gradient of the SFNO's dhconv filter, multi-pass bf16.
//
// Replaces the TPU kernel makani_tpu/ops/pallas_mm.py dhconv_dw /
// _dhconv_dw_kernel (:269-335, pallas_call :322). On stacked real planes
// (plane 0 = re, plane 1 = im), for every l:
//   dw[l] (C, O) = sum over b, m of conj(x[b, l]) (C, M) . g[b, l]^T (M, O)
// with x (2, B, L, C, M), g (2, B, L, O, M), dw (2, L, C, O). The 3M form
// takes rr = xr.gr^T, ii = xi.gi^T, cross = (xr - xi).(gr + gi)^T (both sums
// in float32 before the split), re = rr + ii, im = (cross - rr) + ii, in the
// TPU kernel's order (:278-289); the 4M form im = xr.gi^T - xi.gr^T, both in
// one accumulator. x is the first operand of every product (split_gemm.cuh):
//   passes 1: xh.gh   2: + xh.gl   3: + xl.gh
// one float32 accumulator a product, each 16-deep step adding its terms in
// that order; the sum over b runs inside the accumulator (depth b-major,
// then m), so the result is deterministic and needs no atomics.
//
// What bounds it on an H100 (flagship SFNO, batch 1, C = O = 384, L = 240,
// M = 241, passes 3, 3M): it moves 638 MB (x and g 178 MB each, dw 283 MB,
// float32, once each), 0.191 ms at 3.35 TB/s, against 9 bf16 products of
// 2 x 240 x 384 x 384 x 256 (M padded to 16), 0.165 ms at 989 TFLOP/s: both
// limits bind, so copies, split, products and stores have to overlap. dw is
// 44% of the bytes and nothing reuses it.
//
// Design:
//   1. Persistent blocks, one an SM, walk the tiles (l, 128 rows of C, 96
//      columns of O) with l slowest, so the blocks of one l share x[l] and
//      g[l] in L2 (L2 -> SM traffic: x once a column block, g once a row
//      block). The depth of a tile, B x M, comes through a 2-slot ring of
//      32-deep stages of staged rows, and g's planes through a ring of 2-4
//      slots of 16-deep steps; both rings run on across tiles, so the next
//      tile's first stage is copied while the current tile's last one is
//      multiplied and stored.
//   2. Copies: 16-byte cp.async, nine threads a staged row of x or g (the
//      row's 32 floats and the 16 bytes its shift pushes out), issued by the
//      consumers while their own wgmma group runs and by a producer warp; each
//      copying thread arrives on the slot's rfull once its copies have landed.
//      The rows are 964 bytes at M = 241, mostly not on 16 bytes, and no TMA
//      tensor map can describe them: each is copied from the 16 bytes that
//      hold its first element and lands moved by its misalignment
//      (cp_async_ring.cuh's shift). The copies' rate grows with the warps
//      that issue them, hence the consumers' share.
//   3. Three producer warps split each staged g tile once, one thread a
//      column, into bf16 planes gr, gi (and gr + gi for 3M), hi and (at
//      passes 2 and 3) lo, in the K-major core-matrix layout wgmma reads B in
//      (split_gemm.cuh), one 16-deep step ahead of the consumers; a proxy
//      fence, then the plane slot's sfull. No device-memory scratch.
//   4. x is wgmma's register A operand (rows C, depth m: m is x's contiguous
//      axis, so a lane reads depth pairs). Each consumer lane reads its rows'
//      re and im, forms xr - xi in float32 (3M; 4M negates xi's bf16 parts)
//      and splits them in registers. One wgmma group (m64n96k16) a 16-deep
//      step, waited for before the next step's split: ptxas serialises a
//      register-A wgmma whose registers are written while it is in flight.
//   5. The epilogue forms re and im, stages them in the warp's own rows of
//      shared memory, 8 rows at a time, and stores whole 384-byte row runs,
//      16 bytes a lane (stores straight from the accumulators write 32 bytes
//      of 8 rows an instruction, and were slower).
// What holds it back (tools/dhconv_ablation.py dw): the copies, which alone
// take about two thirds of the kernel's time; the products, the splits and
// the stores each add a tenth to a fifth. Tried on the H100 and slower: one
// bulk copy a staged row (448 copies of at most 144 bytes a stage: the copy
// engine's rate for small copies); the producer warpgroup copying and
// splitting, with 2 or 3 slots of staged rows; one copying warp; all
// threads copying at the top of a stage; a fourth warpgroup copying in place
// of the consumers.
// Edges: nothing is padded in device memory. Depth past M in a stage (M =
// 241: the last 16-deep step holds one m) is zeroed in both operands' splits,
// never read as stale shared memory (a stale pattern can be Inf or NaN, and
// 0 x NaN is NaN). Rows past C are not copied: their stale A rows reach only
// their own output rows, which the store masks; columns past O split as
// zeros and are masked too.

#include "split_gemm.cuh"

namespace {

using namespace makani;

constexpr int BM = 128;                   // dw rows (C) a tile: two consumer warpgroups of 64
constexpr int BN = 96;                    // dw columns (O) a tile
constexpr int BK = 32;                    // depth (m) a stage: two 16-deep steps
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int SPLITTERS = BN;             // three producer warps, one thread a column of g
constexpr int BLOCK = CONSUMERS + 128;    // and a producer warpgroup: a copying warp, three splitting
constexpr int COPIERS = CONSUMERS + 32;   // the threads that copy: nine to a staged row
constexpr int RAW = 2;                    // slots of staged rows: one stage copied ahead
constexpr int PITCH = BK + 4;             // floats a staged row: 32 and its shift
constexpr int SLAB = BN * 16;             // bf16 of one (plane, part) of a 16-deep step of g
constexpr int OPITCH = BN + 8;            // floats a row of a warp's output staging
constexpr int SMEM_MAX = 232448;

// Shared memory: RAW slots of staged rows (x: re rows 0-127, im rows
// 128-255; then g: re rows 0-95, im rows 96-191), then STEPS slots of g's
// planes for one 16-deep step each (slab (plane, part) at (plane * PARTS +
// part) * SLAB, element (n, k) of it at core matrix (n / 8, k / 8)), then
// each consumer warp's output staging (8 rows of re, 8 of im), then the
// mbarriers: full and empty a raw slot, full and empty a plane slot.
template <bool M3, int PASSES>
struct Layout {
  static constexpr int NPL = M3 ? 3 : 2;              // g planes: gr, gi (, gr + gi)
  static constexpr int PARTS = PASSES >= 2 ? 2 : 1;   // g's hi (and lo)
  static constexpr int X_BYTES = 2 * BM * PITCH * 4;
  static constexpr int RAW_BYTES = X_BYTES + 2 * BN * PITCH * 4;
  static constexpr int STEP_BYTES = NPL * PARTS * SLAB * 2;
  static constexpr int OUT_BYTES = CONSUMERS / 32 * 16 * OPITCH * 4;
  static constexpr int FIT =
      (SMEM_MAX - RAW * RAW_BYTES - OUT_BYTES - (2 * RAW + 8) * 8) / STEP_BYTES;
  static constexpr int STEPS = FIT < 4 ? FIT : 4;
  static constexpr int PLANES = RAW * RAW_BYTES;
  static constexpr int OUT = PLANES + STEPS * STEP_BYTES;
  static constexpr int BARS = OUT + OUT_BYTES;
  static constexpr int BYTES = BARS + (2 * RAW + 2 * STEPS) * 8;
  static_assert(STEPS >= 2, "the planes need two slots");
  static_assert(X_BYTES % 128 == 0 && RAW_BYTES % 128 == 0 && STEP_BYTES % 128 == 0 &&
                    OUT_BYTES % 128 == 0,
                "16-byte copies, aligned wgmma tiles");
};

struct Params {
  const float* x;  // (2, B, L, C, M)
  const float* g;  // (2, B, L, O, M)
  float* dw;       // (2, L, C, O)
  int B, L, C, O, M;
  int nrb, ncb, spb, tiles;  // row and column blocks, stages a b, tiles
};

// tile t: l = t / (nrb ncb), rows from ((t / ncb) % nrb) BM, columns from
// (t % ncb) BN
struct Tile {
  int l, r0, n0;
};
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  return {t / (p.nrb * p.ncb), ((t / p.ncb) % p.nrb) * BM, (t % p.ncb) * BN};
}

// Stage `it` of this block: stage it % nstage (b-major, then 32 m each) of
// its (it / nstage)-th tile; kv of its depths are valid
struct Stage {
  Tile tl;
  int b, m0, kv;
};
__device__ __forceinline__ Stage stage_of(const Params& p, int it, int nstage) {
  const int s = it % nstage, m0 = (s % p.spb) * BK;
  return {tile_of(p, blockIdx.x + (it / nstage) * gridDim.x), s / p.spb, m0, min(BK, p.M - m0)};
}

// the first element of row `row` of plane q of (b, l) at depth m0, in x (rows
// C) or g (rows O)
__device__ __forceinline__ const float* row_at(const float* a, long long plane, int rows,
                                               const Params& p, int q, int b, int l, int row,
                                               int m0) {
  return a + q * plane + (((long long)b * p.L + l) * rows + row) * p.M + m0;
}

// a row's misalignment in floats from 16 bytes
__device__ __forceinline__ int shift_of(const float* f) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(f) / 4) & 3);
}

// arrives on bar once every cp.async this thread issued before has landed
// (the arrival is counted in bar's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Chunk k (of 9) of a staged row: kv floats from `first`, copied from the 16
// bytes that hold it, so the row lands moved by its shift; the ninth chunk
// brings the shifted row's last floats; chunks past the row's end are zeros.
__device__ __forceinline__ void copy_chunk(float* dst, const float* first, int kv, int k) {
  const int sh = shift_of(first);
  const float* c0 = first - sh;
  const int n = min(4, max(0, sh + kv - 4 * k));
  cp_async16(dst + 4 * k, n > 0 ? c0 + 4 * k : c0, 4 * n);
}

// depths 8q .. 8q + 7 of a staged row that lands moved by sh (0-3), zero from
// depth kv on: three aligned 16-byte reads and a select
__device__ __forceinline__ void gather8(const float* row, int sh, int q, int kv, float (&v)[8]) {
  const float4* c4 = reinterpret_cast<const float4*>(row) + 2 * q;
  const float4 a = c4[0], b = c4[1], c = c4[2];
  const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float lo = sh & 1 ? w[e + 1] : w[e];
    const float hi = sh & 1 ? w[e + 3] : w[e + 2];
    v[e] = 8 * q + e < kv ? (sh & 2 ? hi : lo) : 0.f;
  }
}

// 8 values to 8 bf16 hi (and lo = bf16_rn(v - hi)) in one 16-byte store each
template <bool LO>
__device__ __forceinline__ void split8(const float (&v)[8], bf16* hi, bf16* lo) {
  uint4 h, l;
  uint32_t* hp = reinterpret_cast<uint32_t*>(&h);
  uint32_t* lp = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hp[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
    if constexpr (LO) {
      const float2 f = unpack_bf16(hp[i]);
      lp[i] = pack_bf16(v[2 * i] - f.x, v[2 * i + 1] - f.y);
    }
  }
  *reinterpret_cast<uint4*>(hi) = h;
  if constexpr (LO) *reinterpret_cast<uint4*>(lo) = l;
}

// The splitting thread of column j, 16-deep step h of a stage: its staged re
// and im rows (shifts sr, si), depth valid below kv (0: a column past O, all
// zeros), into the step's planes tb.
template <int NPL, int PARTS>
__device__ __forceinline__ void split_step(const float* gre, int sr, const float* gim, int si,
                                           int kv, int h, bf16* tb, int j) {
  const int at = (j / 8) * 128 + (j % 8) * 8;  // column j's 8 depths in a core matrix
#pragma unroll 1
  for (int q = 2 * h; q < 2 * h + 2; ++q) {
    float r[8], i[8];
    gather8(gre, sr, q, kv, r);
    gather8(gim, si, q, kv, i);
    bf16* o = tb + at + (q % 2) * 64;
    split8<PARTS == 2>(r, o, o + SLAB);
    split8<PARTS == 2>(i, o + PARTS * SLAB, o + (PARTS + 1) * SLAB);
    if constexpr (NPL == 3) {
      float s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = r[e] + i[e];  // the 3M cross operand, in float32
      split8<PARTS == 2>(s, o + 2 * PARTS * SLAB, o + (2 * PARTS + 1) * SLAB);
    }
  }
}

// This lane's re or im values of one 16-deep step: v[i] at (row ra for i
// even, rb for i odd; depths 2t, 2t + 1 for i < 2, 2t + 8, 2t + 9 after), the
// rows already at the step's first depth plus their shifts; zero from depth
// kv (counted from the step's first depth) on.
__device__ __forceinline__ void x_vals(const float* ra, bool ea, const float* rb, bool eb, int t,
                                       int kv, float2 (&v)[4]) {
  v[0] = ld_pair(ra + 2 * t, ea);
  v[1] = ld_pair(rb + 2 * t, eb);
  v[2] = ld_pair(ra + 2 * t + 8, ea);
  v[3] = ld_pair(rb + 2 * t + 8, eb);
  if (kv < 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 2 * t + 8 * (i / 2);
      if (d >= kv) v[i].x = 0.f;
      if (d + 1 >= kv) v[i].y = 0.f;
    }
  }
}

// A fragment of v: hi = bf16_rn(v) and, with LO, lo = bf16_rn(v - hi)
template <bool LO>
__device__ __forceinline__ void split_frag(const float2 (&v)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack_bf16(v[i].x, v[i].y);
    if constexpr (LO) {
      const float2 h = unpack_bf16(hi[i]);
      lo[i] = pack_bf16(v[i].x - h.x, v[i].y - h.y);
    }
  }
}

template <bool M3, int PASSES>
__global__ void __launch_bounds__(BLOCK, 1) dhconv_dw_kernel(Params p) {
  using S = Layout<M3, PASSES>;
  constexpr int NPL = S::NPL, PARTS = S::PARTS, STEPS = S::STEPS;
  constexpr bool X_LO = PASSES == 3;
  extern __shared__ __align__(128) unsigned char smem[];
  // rfull: a raw slot's rows landed (one arrival a copying thread, once its
  // copies have); rempty: the consumers have read its x and the splitters
  // its g; sfull: a plane slot is written (one arrival a splitting thread);
  // sempty: the consumers' wgmma are done with it
  uint64_t* rfull = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* rempty = rfull + RAW;
  uint64_t* sfull = rempty + RAW;
  uint64_t* sempty = sfull + STEPS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RAW; ++i) {
      mbar_init(rfull + i, COPIERS);
      mbar_init(rempty + i, CONSUMERS + SPLITTERS);
    }
    for (int i = 0; i < STEPS; ++i) {
      mbar_init(sfull + i, SPLITTERS);
      mbar_init(sempty + i, CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const long long xplane = (long long)p.B * p.L * p.C * p.M;
  const long long gplane = (long long)p.B * p.L * p.O * p.M;
  const int nstage = p.B * p.spb;  // stages a tile
  // every role walks this block's stages in the same order: stage it in raw
  // slot it % RAW; its 16-deep steps (one where kv <= 16), counted u over
  // the block, in plane slot u % STEPS
  const int total = (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nstage;

  // Copies, by the consumers and the producer's first warp (COPIERS
  // threads): the rate of 16-byte cp.async grows with the warps that issue
  // them. Thread i brings chunk i % 9 of staged rows i / 9 + 32 n (x: re
  // rows 0-127, im 128-255; then g: re rows 256-351, im 352-447): a warp
  // instruction touches two cache lines a row. It then arrives on the
  // slot's rfull once its copies have landed.
  auto copy = [&](int it) {
    const Stage st = stage_of(p, it, nstage);
    float* dst = reinterpret_cast<float*>(smem + (it % RAW) * S::RAW_BYTES);
    {
      const int k = threadIdx.x % 9;
      const float* x0 = row_at(p.x, xplane, p.C, p, 0, st.b, st.tl.l, st.tl.r0, st.m0);
      const float* g0 = row_at(p.g, gplane, p.O, p, 0, st.b, st.tl.l, st.tl.n0, st.m0);
#pragma unroll 1
      for (int row = threadIdx.x / 9; row < 2 * (BM + BN); row += COPIERS / 9) {
        if (row < 2 * BM) {
          const int c = row % BM;
          if (st.tl.r0 + c < p.C)
            copy_chunk(dst + row * PITCH, x0 + row / BM * xplane + (long long)c * p.M, st.kv, k);
        } else {
          const int o = (row - 2 * BM) % BN;
          if (st.tl.n0 + o < p.O)
            copy_chunk(dst + row * PITCH, g0 + (row - 2 * BM) / BN * gplane + (long long)o * p.M,
                       st.kv, k);
        }
      }
    }
    cp_async_arrive(rfull + it % RAW);
  };
  // In stage it, the copying threads copy stage it + RAW - 1 into the slot of
  // stage it - 1, once every reader is done with that.
  auto copy_ahead = [&](int it) {
    const int next = it + RAW - 1;
    if (next >= total) return;
    if (next >= RAW) mbar_wait(rempty + next % RAW, (next / RAW - 1) & 1);
    copy(next);
  };
  if (threadIdx.x < COPIERS)
    for (int it = 0; it < RAW - 1 && it < total; ++it) copy(it);

  // Registers go where the accumulators are: 128 x 56 + 256 x 224 = 64,512,
  // all the launch holds (168 a thread); asking for more than it holds
  // makes setmaxnreg.inc wait for ever.
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<56>();
    const int pt = threadIdx.x - CONSUMERS;
    if (pt < 32) {  // the first warp only copies
      for (int it = 0; it < total; ++it) copy_ahead(it);
      return;
    }
    int u = 0;
    for (int it = 0; it < total; ++it) {
      // The other three warps split stage it, thread j = pt - 32 column j,
      // each 16-deep step into its plane slot once the consumers are done
      // with the slot's last step: while the consumers multiply the step
      // before.
      const Stage st = stage_of(p, it, nstage);
      const int j = pt - 32, o = st.tl.n0 + j;
      const int sr = shift_of(row_at(p.g, gplane, p.O, p, 0, st.b, st.tl.l, o, st.m0));
      const int si = shift_of(row_at(p.g, gplane, p.O, p, 1, st.b, st.tl.l, o, st.m0));
      mbar_wait(rfull + it % RAW, (it / RAW) & 1);
      const float* gre =
          reinterpret_cast<const float*>(smem + (it % RAW) * S::RAW_BYTES + S::X_BYTES) +
          j * PITCH;
      for (int h = 0; h < 2 && 16 * h < st.kv; ++h, ++u) {
        if (u >= STEPS) mbar_wait(sempty + u % STEPS, (u / STEPS - 1) & 1);
        split_step<NPL, PARTS>(
            gre, sr, gre + BN * PITCH, si, o < p.O ? st.kv : 0, h,
            reinterpret_cast<bf16*>(smem + S::PLANES + (u % STEPS) * S::STEP_BYTES), j);
        fence_proxy_async();  // the planes before wgmma reads them (async proxy)
        mbar_arrive(sfull + u % STEPS);
      }
      mbar_arrive(rempty + it % RAW);
    }
    return;
  }

  setmaxnreg_inc<224>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ma = (warp / 4) * 64 + (warp % 4) * 16 + g;  // this lane's rows ma and ma + 8
  float acc[3][48];
  int u = 0;
  for (int it = 0; it < total; ++it) {
    const Stage st = stage_of(p, it, nstage);
    if (it % nstage == 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int i = 0; i < 48; ++i) acc[q][i] = 0.f;
    }
    // the shifts of this lane's staged rows: re and im of rows ma, ma + 8
    int sh[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        sh[q][r] = shift_of(
            row_at(p.x, xplane, p.C, p, q, st.b, st.tl.l, st.tl.r0 + ma + 8 * r, st.m0));
    mbar_wait(rfull + it % RAW, (it / RAW) & 1);
    const float* xs = reinterpret_cast<const float*>(smem + (it % RAW) * S::RAW_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (16 * h >= st.kv) break;
      float2 xr[4], xi[4];
      x_vals(xs + ma * PITCH + sh[0][0] + 16 * h, sh[0][0] % 2 == 0,
             xs + (ma + 8) * PITCH + sh[0][1] + 16 * h, sh[0][1] % 2 == 0, t, st.kv - 16 * h, xr);
      x_vals(xs + (BM + ma) * PITCH + sh[1][0] + 16 * h, sh[1][0] % 2 == 0,
             xs + (BM + ma + 8) * PITCH + sh[1][1] + 16 * h, sh[1][1] % 2 == 0, t,
             st.kv - 16 * h, xi);
      if (h == 1 || st.kv <= 16) mbar_arrive(rempty + it % RAW);  // this thread read its x
      // A planes: xr, xi and, for 3M, xr - xi (in float32); for 4M, -xi
      uint32_t ah[3][4], al[3][4];
      split_frag<X_LO>(xr, ah[0], al[0]);
      split_frag<X_LO>(xi, ah[1], al[1]);
      if constexpr (M3) {
        float2 d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = make_float2(xr[i].x - xi[i].x, xr[i].y - xi[i].y);
        split_frag<X_LO>(d, ah[2], al[2]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[2][i] = ah[1][i] ^ 0x80008000u;
          al[2][i] = al[1][i] ^ 0x80008000u;
        }
      }
      mbar_wait(sfull + u % STEPS, (u / STEPS) & 1);  // this step's g planes
      const bf16* tb = reinterpret_cast<const bf16*>(smem + S::PLANES + (u % STEPS) * S::STEP_BYTES);
      // products (A plane, g plane) -> accumulator: 3M rr (0, 0), ii (1, 1),
      // cross (2, 2); 4M rr (0, 0), ii (1, 1), xr.gi (0, 1) and -xi.gr
      // (2, 0) into the third. One wgmma group a step, waited for before the
      // next step's split: ptxas serialises a register-A wgmma whose
      // registers are written while it is in flight.
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < (M3 ? 3 : 4); ++q) {
        const int pa = q < 2 ? q : (M3 ? 2 : (q == 2 ? 0 : 2));
        const int pb = q < 2 ? q : (M3 ? 2 : (q == 2 ? 1 : 0));
        float(&d)[48] = acc[q < 2 ? q : 2];
        const bf16* gh = tb + pb * PARTS * SLAB;
        wgmma_m64n96k16(d, ah[pa], wgmma_desc(gh, 128, 256));                             // xh.gh
        if constexpr (PARTS == 2) wgmma_m64n96k16(d, ah[pa], wgmma_desc(gh + SLAB, 128, 256));  // xh.gl
        if constexpr (X_LO) wgmma_m64n96k16(d, al[pa], wgmma_desc(gh, 128, 256));         // xl.gh
      }
      wgmma_commit();
      if (h == 0) copy_ahead(it);  // issued while the tensor cores work
      wgmma_wait<0>();
      mbar_arrive(sempty + u % STEPS);  // this thread's wgmma are done with the planes
      ++u;
    }
    if (it % nstage != nstage - 1) continue;

    // The tile's last stage: re and im of the accumulators' elements (d[4j +
    // e] is row ma + 8 (e / 2), column 8j + 2t + e % 2) go through the
    // warp's staging, 8 rows at a time, and leave as whole row runs of 16
    // bytes a lane, masked past C and O.
    float* wb = reinterpret_cast<float*>(smem + S::OUT) + warp * 16 * OPITCH;
    const int rw = st.tl.r0 + ma - g;  // the warp's first row
    const long long wplane = (long long)p.L * p.C * p.O;
    const bool quads = p.O % 4 == 0;  // then a row's runs start on 16 bytes
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int jj = 0; jj < 12; ++jj) {
        float re[2], im[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * half + e;
          const float rr = acc[0][i], ii = acc[1][i];
          re[e] = rr + ii;
          im[e] = M3 ? (acc[2][i] - rr) + ii : acc[2][i];
        }
        *reinterpret_cast<float2*>(wb + g * OPITCH + 8 * jj + 2 * t) = make_float2(re[0], re[1]);
        *reinterpret_cast<float2*>(wb + (8 + g) * OPITCH + 8 * jj + 2 * t) =
            make_float2(im[0], im[1]);
      }
      __syncwarp();
#pragma unroll 4
      for (int i = lane; i < 16 * BN / 4; i += 32) {
        const int row = i / (BN / 4), c4 = i % (BN / 4);  // row: plane row / 8, dw row row % 8
        const int c = rw + 8 * half + row % 8, n = st.tl.n0 + 4 * c4;
        if (c >= p.C || n >= p.O) continue;
        const float4 v = *reinterpret_cast<const float4*>(wb + row * OPITCH + 4 * c4);
        float* o = p.dw + row / 8 * wplane + ((long long)st.tl.l * p.C + c) * p.O + n;
        if (quads) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          o[0] = v.x;
          if (n + 1 < p.O) o[1] = v.y;
          if (n + 2 < p.O) o[2] = v.z;
          if (n + 3 < p.O) o[3] = v.w;
        }
      }
      __syncwarp();
    }
  }
}

template <bool M3, int PASSES>
int launch(const Params& p, cudaStream_t s) {
  auto kernel = dhconv_dw_kernel<M3, PASSES>;
  constexpr int bytes = Layout<M3, PASSES>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<p.tiles < sms ? p.tiles : sms, BLOCK, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool M3>
int launch_passes(const Params& p, int passes, cudaStream_t s) {
  switch (passes) {
    case 1:
      return launch<M3, 1>(p, s);
    case 2:
      return launch<M3, 2>(p, s);
    default:
      return launch<M3, 3>(p, s);
  }
}

}  // namespace

// x (2, b, l, c, m), g (2, b, l, o, m) -> dw (2, l, c, o), every tensor
// contiguous (x's and g's rows need not start on 16 bytes); m3 the 3M form,
// passes 1, 2 or 3. Refuses (before launching) a shape whose tile count or
// stage count does not fit an int. Returns cudaGetLastError().
extern "C" int dhconv_dw_launch(const void* x, const void* g, void* dw, int b, int l, int c,
                                int o, int m, int m3, int passes, void* stream) {
  if (b < 1 || l < 1 || c < 1 || o < 1 || m < 1 || passes < 1 || passes > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrb = (c + BM - 1) / BM, ncb = (o + BN - 1) / BN, spb = (m + BK - 1) / BK;
  const long long tiles = (long long)l * nrb * ncb;
  if (tiles > 2147483647LL || b * spb > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dw),
                 b, l, c, o, m, (int)nrb, (int)ncb, (int)spb, (int)tiles};
  auto s = static_cast<cudaStream_t>(stream);
  return m3 ? launch_passes<true>(p, passes, s) : launch_passes<false>(p, passes, s);
}
