// Grid-side multi-pass bf16 matmul: the longitude DFT and its inverse.
//
// Replaces two TPU kernels that compute out (R, N) = x (R, K) . t (K, N) with
// the table resident, x float32 or bfloat16 and the output float32 or
// bfloat16, rounded once from the float32 sum:
//   gridmm   makani_tpu/ops/pallas_mm.py gridmm / _gridmm_kernel (:62-96).
//            t float32, split here into bf16 hi/lo;
//            passes 1: hh,  2: hh + hl,  3: hh + hl + lh
//   grid_dot scripts/bench_gridmm.py grid_dot_pallas / _grid_dot_kernel
//            (:33-74). t arrives split as bf16 th and tl; a bf16 x gives
//            hh + hl, a float32 x hh + hl + lh
// with hh = xh.th, hl = xh.tl and lh = xl.th, xh = bf16_rn(x) and xl =
// bf16_rn(x - xh). One float32 accumulator takes hh, then hl, then lh at
// every 16-deep step (legmm.cu's order): the kernel and either twin
// (_mp_dot's hh + (hl + lh), the script's (hh + hl) + lh) differ only in the
// order of float32 sums. A bf16 x has xl = 0: its lh is not formed, so a
// bf16 x at 3 passes runs the 2-pass build (the same value).
//
// What bounds it on an H100, at the flagship longitude DFT (block 0 of the
// SFNO: R = 384*721 = 276,864 rows, K = 1440, N = 2*241 = 482, float32 x,
// 3 passes): 2.131 GB moved once (x 1.595 GB, table 2.8 MB, out 0.534 GB),
// 0.636 ms at 3.35 TB/s, against 3 x 2RKN = 1.153e12 bf16 operations,
// 1.166 ms at 989 TFLOP/s: bound by operations. A bf16 x at 2 passes moves
// 1.33 GB (0.40 ms) for 7.7e11 operations (0.78 ms): bound by operations too.
//
// Layouts (the SHT's grid stage, ops/sht.py): x is read row-major (R, K),
// or K-major when it is the transpose of a contiguous (K, R) float32 tensor
// (XK: the m-leading coefficients of the inverse DFT and the cotangent of
// the DFT), and the output is stored row-major (R, N) or transposed (N, R)
// (out_t: the m-leading DFT output and the inverse DFT's dx), so the
// stage's layouts cost no transpose copy. A float32 output may be rounded
// to bf16 values (round_out: the cotangent of an x that makani_tpu casts to
// bf16, kept in float32 storage).
//
// Design, in the launcher's order:
//   1. The table is prepared once a call (prep_table): its bf16 hi (and lo)
//      parts are written to scratch in the layout the consumer reads
//      (split_gemm.cuh's core matrices), one slab of BN columns x 16 depths
//      per (column block, 16-deep step, part), zero past K and N. A block's
//      table tile of one stage is then one contiguous, aligned run whatever
//      K and N are (N = 482 rows are 1928 or 964 bytes: not aligned), copied
//      by one bulk copy (the async proxy wgmma reads through) whose bytes an
//      mbarrier of the slot counts.
//   2. x goes through a ring of 32-deep stages (4 at a float32 x and 3
//      passes, up to 6 where they fit) of 16-byte cp.async by all threads
//      (StagedTile, cp_async_ring.cuh), rows that do not start on 16 bytes
//      (K = 482, or a slice at an odd row) landing moved by their
//      misalignment, chosen from each row's address. Ragged R and K are
//      zero-filled by the copies, ragged N masked on the store: nothing is
//      padded in device memory. One barrier a stage. A K-major x is staged
//      as 32 depth rows of the block's 128 rows (pitch 132 floats, 4 banks
//      apart a depth: the fragments' column reads are conflict-free), each
//      depth row moved by its own misalignment where R is not a multiple of
//      4.
//   3. A block covers 128 rows and 256 columns (N = 482 in 2 column blocks,
//      1440 in 6), two warpgroups of 64 rows. Each warp reads its 16 rows of
//      the staged x tile once a 16-deep step and splits them in registers
//      into the A fragments: each x tile is split once per block and the
//      split writes nothing to shared memory. A K-major tile is read one
//      element at a time (two depths make a fragment's pair).
//   4. The consumer: wgmma.mma_async m64n256k16, A from those registers, B
//      the prepared table from shared memory through a descriptor; 128
//      float32 accumulators a thread. A warpgroup waits for its stage's
//      group before it splits the next; the other warpgroup's group runs
//      meanwhile.
// The output is stored from the accumulators: four lanes write 32 whole
// bytes of a row (float2, or bf16x2 rounded once from the float32 sum);
// transposed, eight lanes write 32 bytes of an output row (N, R) a column.
// PASSES, the x type, the output type and x's layout are template
// parameters, so each build forms only the products and splits it uses; the
// output's layout and rounding are arguments (uniform branches in the
// store). Tried on the H100 and
// slower: a producer warp issuing all the copies, the consumers held by
// mbarriers alone (one warp's cp.async of 128 rows a stage does not keep the
// ring full); clusters of 2 or 4 row bands sharing each table tile by
// multicast (a cluster barrier a stage); the table by cp.async with a proxy
// fence a stage; one persistent block an SM walking its tiles through one
// ring, the next tile's copies in flight during the stores.

#include <type_traits>

#include "split_gemm.cuh"

namespace {

using namespace makani;

constexpr int BM = 128;         // output rows per block: two warpgroups of 64
constexpr int BN = 256;         // output columns per block
constexpr int BK = 32;          // depth of a stage: two 16-deep steps
constexpr int THREADS = 256;    // two warpgroups
constexpr int XPITCH = BK + 8;  // pitch of a staged x row: room for the shift, no bank conflicts
constexpr int XKPITCH = BM + 4;  // pitch of a staged depth row of a K-major x: 4 banks apart
constexpr int SLAB = BN * 16;   // bf16 of one part of a 16-deep table step
constexpr int SMEM_MAX = 232448;

// XK: x K-major, staged as BK depth rows of BM rows (float32 only)
template <typename XT, int PASSES, bool XK = false>
struct Layout {
  static constexpr int PARTS = PASSES >= 2 ? 2 : 1;  // the table's hi (and lo)
  using TileX = std::conditional_t<XK, StagedTile<BK, BM, true, THREADS, XT, XKPITCH>,
                                   StagedTile<BM, BK, true, THREADS, XT, XPITCH>>;
  static constexpr int X_BYTES = (XK ? BK * XKPITCH : BM * XPITCH) * (int)sizeof(XT);
  static constexpr int T_BYTES = 2 * PARTS * SLAB * 2;
  static constexpr int STAGE_BYTES = X_BYTES + T_BYTES;
  static constexpr int FIT = (SMEM_MAX - 8 * 6) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int BARS = STAGES * STAGE_BYTES;  // an mbarrier a slot, after the ring
  static constexpr int BYTES = BARS + 8 * STAGES;
  static_assert(STAGES >= 4, "the ring needs four stages");
  static_assert(X_BYTES % 16 == 0 && T_BYTES % 16 == 0, "16-byte copies");
};

// The table's scratch: slab (nb, step, part) at ((nb * steps + step) *
// parts + part) * SLAB, element (n, k) of it at core matrix (n / 8, k / 8)
// (split_gemm.cuh); steps = 2 ceil(K / BK). From t float32 (split) or from th
// and tl bf16; zero past K and N.
__global__ void prep_table(const float* __restrict__ t, const bf16* __restrict__ th,
                           const bf16* __restrict__ tl, bf16* __restrict__ tp, int K, int N,
                           int steps, int parts, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int e = static_cast<int>(i % SLAB);
  const long long blk = i / SLAB;  // nb * steps + step
  const int step = static_cast<int>(blk % steps);
  const int nb = static_cast<int>(blk / steps);
  const int n = nb * BN + (e / 128) * 8 + (e % 64) / 8;
  const int k = step * 16 + ((e / 64) % 2) * 8 + e % 8;
  bf16 hi = __float2bfloat16_rn(0.f), lo = hi;
  if (n < N && k < K) {
    const long long s = (long long)k * N + n;
    if (t != nullptr) {
      const float v = t[s];
      hi = __float2bfloat16_rn(v);
      lo = __float2bfloat16_rn(v - __bfloat162float(hi));
    } else {
      hi = th[s];
      lo = tl[s];
    }
  }
  bf16* o = tp + blk * parts * SLAB + e;
  o[0] = hi;
  if (parts == 2) o[SLAB] = lo;
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put1(float* p, float a) { *p = a; }
__device__ __forceinline__ void put1(bf16* p, float a) { *p = __float2bfloat16_rn(a); }

__device__ __forceinline__ float round_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// This lane's A fragment of one 16-deep step from a K-major staged tile:
// d0, d1, d8, d9 the depth rows 2t, 2t + 1, 2t + 8, 2t + 9 of the step, each
// at its shift; ra, rb the lane's rows g and g + 8 (split_gemm.cuh's a_frag
// order).
template <bool LO>
__device__ __forceinline__ void a_frag_kmajor(const float* d0, const float* d1, const float* d8,
                                              const float* d9, int ra, int rb, uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  const float2 v[4] = {make_float2(d0[ra], d1[ra]), make_float2(d0[rb], d1[rb]),
                       make_float2(d8[ra], d9[ra]), make_float2(d8[rb], d9[rb])};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack_bf16(v[i].x, v[i].y);
    if constexpr (LO) {
      const float2 h = unpack_bf16(hi[i]);
      lo[i] = pack_bf16(v[i].x - h.x, v[i].y - h.y);
    }
  }
}

// x (R, K) of XT (XK: stored (K, R)), the prepared table tp, out (R, N) of
// OT (out_t: stored (N, R); round_out: a float32 output rounded to bf16
// values); block b covers rows (b / ncol) * BM and columns (b % ncol) * BN,
// so the column blocks of one row band run side by side and read the band
// from device memory once.
template <typename XT, typename OT, int PASSES, bool XK>
__global__ void __launch_bounds__(THREADS, 1)
gridmm_kernel(const XT* __restrict__ x, const bf16* __restrict__ tp, OT* __restrict__ out, int R,
              int K, int N, int ncol, int out_t, int round_out) {
  using S = Layout<XT, PASSES, XK>;
  using TX = typename S::TileX;
  constexpr bool X_LO = PASSES == 3;
  static_assert(!(X_LO && std::is_same<XT, bf16>::value), "a bf16 x has no lo part");
  static_assert(!XK || std::is_same<XT, float>::value, "a K-major x is float32");
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);  // a slot's table tile landed
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int nb = blockIdx.x % ncol;
  const long long r0 = (long long)(blockIdx.x / ncol) * BM;
  const int nk = (K + BK - 1) / BK;
  const unsigned char* tblk =
      reinterpret_cast<const unsigned char*>(tp + (long long)nb * 2 * nk * S::PARTS * SLAB);

  // the x rows this thread copies, their addresses at depth 0 (row-major x)
  const XT* xrow[XK ? 1 : TX::RPT];
  if constexpr (!XK) {
#pragma unroll
    for (int i = 0; i < TX::RPT; ++i) {
      const long long r = r0 + TX::row(i);
      xrow[i] = r < R ? x + r * K : nullptr;
    }
  }
  // stage k into slot: this thread's chunks of the x rows (cp.async; for a
  // K-major x, of the stage's depth rows from column r0) and, by thread 0,
  // the table tile (one contiguous run: one bulk copy, counted by the slot's
  // mbarrier)
  auto load = [&](int k, int slot) {
    unsigned char* st = smem + slot * S::STAGE_BYTES;
    const int k0 = k * BK;
    if constexpr (XK) {
      TX::copy(reinterpret_cast<XT*>(st), [&](int i) {
        const int d = k0 + TX::row(i);
        return TX::locate(d < K ? x + (long long)d * R + r0 : nullptr,
                          static_cast<int>(R - r0));
      }, tp);
    } else {
      TX::copy(reinterpret_cast<XT*>(st), [&](int i) {
        return TX::locate(xrow[i] ? xrow[i] + k0 : nullptr, K - k0);
      }, tp);
    }
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + slot, S::T_BYTES);
      bulk_copy(st + S::X_BYTES, tblk + (long long)k * S::T_BYTES, S::T_BYTES, full + slot);
    }
  };

  // this lane's rows g and g + 8 of its warp's 16, and their shifts in the
  // staged tile (fixed over the depth: a stage is 64 or 128 bytes deep)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16;  // warpgroup, warp within it
  const int ra = wrow + g, rb = ra + 8;
  auto shift = [&](int r) {
    return r0 + r < R ? TX::locate(x + (r0 + r) * K, 1).s : 0;
  };
  const int sa = XK ? 0 : shift(ra), sb = XK ? 0 : shift(rb);
  const bool ea = sa % 2 == 0, eb = sb % 2 == 0;
  // K-major: the shift of depth row d is (x's element address + d R + r0) % 4
  const unsigned sx =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(x) / sizeof(XT) + r0) & 3u;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // ring: stage s in slot s % STAGES, STAGES - 1 stages in flight, one
  // commit group a stage (empty past the end, so the wait counts stay
  // uniform)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  for (int k = 0; k < nk; ++k) {
    // every thread's x copies of stage k have landed, and both warpgroups
    // are done with stage k - 1 (its slot is free)
    __syncthreads();
    if (k + STAGES - 1 < nk) load(k + STAGES - 1, (k + STAGES - 1) % STAGES);
    cp_async_commit();

    const unsigned char* st = smem + (k % STAGES) * S::STAGE_BYTES;
    const XT* xs = reinterpret_cast<const XT*>(st);
    const bf16* tb = reinterpret_cast<const bf16*>(st + S::X_BYTES);
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (XK) {
        auto depth = [&](int d) {  // depth row d of the stage, at its shift
          // (a row past K was zero-filled unshifted: the copy had no source)
          const unsigned dg = static_cast<unsigned>(k * BK + d);
          const unsigned sh =
              dg < static_cast<unsigned>(K) ? (sx + dg * static_cast<unsigned>(R)) & 3u : 0u;
          return xs + d * XKPITCH + sh;
        };
        const int d = 16 * h + 2 * t;
        a_frag_kmajor<X_LO>(depth(d), depth(d + 1), depth(d + 8), depth(d + 9), ra, rb, ah[h],
                            al[h]);
      } else {
        a_frag<X_LO>(xs + ra * XPITCH + sa + 16 * h, ea, xs + rb * XPITCH + sb + 16 * h, eb, t,
                     ah[h], al[h]);
      }
    }
    mbar_wait(full + k % STAGES, (k / STAGES) & 1);  // the table tile of stage k
    // One wgmma group a stage, waited for before the next stage's split: an
    // instruction that writes a wgmma's A or accumulator registers while a
    // group is in flight makes ptxas serialize the wgmma (C7513, C7515).
    // The other warpgroup's group keeps the tensor cores busy meanwhile.
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* hi = tb + h * S::PARTS * SLAB;
      wgmma_m64n256k16(acc, ah[h], wgmma_desc(hi, 128, 256));  // hh
      if constexpr (PASSES >= 2) wgmma_m64n256k16(acc, ah[h], wgmma_desc(hi + SLAB, 128, 256));  // hl
      if constexpr (X_LO) wgmma_m64n256k16(acc, al[h], wgmma_desc(hi, 128, 256));  // lh
    }
    wgmma_commit();
    wgmma_wait<0>();
    cp_async_wait<STAGES - 2>();  // this thread's x copies of stage k + 1
  }

  // d[4j + e]: row g + 8 (e / 2), column 8j + 2t + e % 2 of the warp's tile
  const int n0 = nb * BN + 2 * t;
  const bool pairs = N % 2 == 0;  // then a pair's columns are in or out together
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = r0 + (half ? rb : ra);
    if (r >= R) continue;
    OT* o = out + (out_t ? r : r * N);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = n0 + 8 * j;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (round_out) v0 = round_bf16(v0), v1 = round_bf16(v1);
      if (out_t) {  // element (r, c) at c R + r
        if (c < N) put1(o + (long long)c * R, v0);
        if (c + 1 < N) put1(o + (long long)(c + 1) * R, v1);
      } else if (pairs) {
        if (c < N) put2(o + c, v0, v1);
      } else {
        if (c < N) put1(o + c, v0);
        if (c + 1 < N) put1(o + c + 1, v1);
      }
    }
  }
}

// the output's layout and rounding, passed to the kernel
struct Store {
  int out_t, round_out;
};

template <typename XT, typename OT, int PASSES, bool XK>
int launch(const void* x, const bf16* tp, void* out, int r, int k, int n, Store st,
           cudaStream_t s) {
  auto kernel = gridmm_kernel<XT, OT, PASSES, XK>;
  constexpr int bytes = Layout<XT, PASSES, XK>::BYTES;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ncol = (n + BN - 1) / BN;
  const unsigned blocks = (unsigned)(((long long)r + BM - 1) / BM * ncol);
  kernel<<<blocks, THREADS, bytes, s>>>(static_cast<const XT*>(x), tp, static_cast<OT*>(out), r,
                                        k, n, ncol, st.out_t, st.round_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT, bool XK = false>
int launch_passes(const void* x, const bf16* tp, void* out, int r, int k, int n, int passes,
                  Store st, cudaStream_t s) {
  switch (passes) {
    case 1:
      return launch<XT, OT, 1, XK>(x, tp, out, r, k, n, st, s);
    case 2:
      return launch<XT, OT, 2, XK>(x, tp, out, r, k, n, st, s);
    default:
      // a bf16 x has lo = 0: the 2-pass build gives the 3-pass value
      if constexpr (std::is_same<XT, bf16>::value)
        return launch<XT, OT, 2, XK>(x, tp, out, r, k, n, st, s);
      else
        return launch<XT, OT, 3, XK>(x, tp, out, r, k, n, st, s);
  }
}

// Prepares the table into tp, then runs the main kernel. Refuses (before
// launching anything) a shape whose grid or indices do not fit, and a
// K-major bf16 x or a rounded bf16 output.
int run(const void* x, const float* t, const bf16* th, const bf16* tl, bf16* tp, void* out, int r,
        int k, int n, int x_bf16, int out_bf16, int passes, int x_kmajor, Store st,
        cudaStream_t s) {
  const long long ncol = ((long long)n + BN - 1) / BN;
  const long long blocks = ((long long)r + BM - 1) / BM * ncol;
  const int steps = 2 * ((k + BK - 1) / BK);
  if (r < 1 || k < 1 || n < 1 || blocks > 2147483647LL || passes < 1 || passes > 3 ||
      (x_kmajor && x_bf16) || (st.round_out && out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = passes >= 2 ? 2 : 1;
  const long long total = ncol * steps * SLAB;
  prep_table<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(t, th, tl, tp, k, n, steps, parts,
                                                             total);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (x_kmajor)
    return out_bf16 ? launch_passes<float, bf16, true>(x, tp, out, r, k, n, passes, st, s)
                    : launch_passes<float, float, true>(x, tp, out, r, k, n, passes, st, s);
  if (x_bf16)
    return out_bf16 ? launch_passes<bf16, bf16>(x, tp, out, r, k, n, passes, st, s)
                    : launch_passes<bf16, float>(x, tp, out, r, k, n, passes, st, s);
  return out_bf16 ? launch_passes<float, bf16>(x, tp, out, r, k, n, passes, st, s)
                  : launch_passes<float, float>(x, tp, out, r, k, n, passes, st, s);
}

}  // namespace

// x (r, k) float32 (x_bf16 == 0) or bfloat16, stored (k, r) when x_kmajor
// (float32 only), t (k, n) float32, out (r, n) float32 (out_bf16 == 0) or
// bfloat16, stored (n, r) when out_t, a float32 output rounded to bf16
// values when round_out; passes 1, 2 or 3; scratch, 16-byte aligned, for
// the prepared table: ceil(n / 256) * 2 ceil(k / 32) * parts * 4096 bf16,
// parts 2 at 2 or 3 passes, else 1.
// x's rows need not start on 16 bytes; every tensor is contiguous in its
// layout. Returns cudaGetLastError() after the launches.
extern "C" int gridmm_launch(const void* x, const void* t, void* scratch, void* out, int r, int k,
                             int n, int x_bf16, int out_bf16, int passes, int x_kmajor, int out_t,
                             int round_out, void* stream) {
  return run(x, static_cast<const float*>(t), nullptr, nullptr, static_cast<bf16*>(scratch), out,
             r, k, n, x_bf16, out_bf16, passes, x_kmajor, Store{out_t, round_out},
             static_cast<cudaStream_t>(stream));
}

// x (r, k) float32 or bfloat16, th and tl (k, n) bfloat16 (the table's hi and
// lo parts), out (r, n) float32 or bfloat16, scratch as for gridmm at 2 or 3
// passes. A bf16 x takes 2 passes, a float32 x 3.
extern "C" int grid_dot_launch(const void* x, const void* th, const void* tl, void* scratch,
                               void* out, int r, int k, int n, int x_bf16, int out_bf16,
                               void* stream) {
  return run(x, nullptr, static_cast<const bf16*>(th), static_cast<const bf16*>(tl),
             static_cast<bf16*>(scratch), out, r, k, n, x_bf16, out_bf16, x_bf16 ? 2 : 3, 0,
             Store{0, 0}, static_cast<cudaStream_t>(stream));
}
