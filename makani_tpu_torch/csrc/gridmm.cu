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
//      padded in device memory. One barrier a stage.
//   3. A block covers 128 rows and 256 columns (N = 482 in 2 column blocks,
//      1440 in 6), two warpgroups of 64 rows. Each warp reads its 16 rows of
//      the staged x tile once a 16-deep step and splits them in registers
//      into the A fragments: each x tile is split once per block and the
//      split writes nothing to shared memory.
//   4. The consumer: wgmma.mma_async m64n256k16, A from those registers, B
//      the prepared table from shared memory through a descriptor; 128
//      float32 accumulators a thread. A warpgroup waits for its stage's
//      group before it splits the next; the other warpgroup's group runs
//      meanwhile.
// The output is stored from the accumulators: four lanes write 32 whole
// bytes of a row (float2, or bf16x2 rounded once from the float32 sum).
// PASSES, the x type and the output type are template parameters, so each
// build forms only the products and splits it uses. Tried on the H100 and
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
constexpr int SLAB = BN * 16;   // bf16 of one part of a 16-deep table step
constexpr int SMEM_MAX = 232448;

template <typename XT, int PASSES>
struct Layout {
  static constexpr int PARTS = PASSES >= 2 ? 2 : 1;  // the table's hi (and lo)
  using TileX = StagedTile<BM, BK, true, THREADS, XT, XPITCH>;
  static constexpr int X_BYTES = BM * XPITCH * (int)sizeof(XT);
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

// x (R, K) of XT, the prepared table tp, out (R, N) of OT; block b covers
// rows (b / ncol) * BM and columns (b % ncol) * BN, so the column blocks of
// one row band run side by side and read the band from device memory once.
template <typename XT, typename OT, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
gridmm_kernel(const XT* __restrict__ x, const bf16* __restrict__ tp, OT* __restrict__ out, int R,
              int K, int N, int ncol) {
  using S = Layout<XT, PASSES>;
  using TX = typename S::TileX;
  constexpr bool X_LO = PASSES == 3;
  static_assert(!(X_LO && std::is_same<XT, bf16>::value), "a bf16 x has no lo part");
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

  // the x rows this thread copies, their addresses at depth 0
  const XT* xrow[TX::RPT];
#pragma unroll
  for (int i = 0; i < TX::RPT; ++i) {
    const long long r = r0 + TX::row(i);
    xrow[i] = r < R ? x + r * K : nullptr;
  }
  // stage k into slot: this thread's chunks of the x rows (cp.async) and, by
  // thread 0, the table tile (one contiguous run: one bulk copy, counted by
  // the slot's mbarrier)
  auto load = [&](int k, int slot) {
    unsigned char* st = smem + slot * S::STAGE_BYTES;
    const int k0 = k * BK;
    TX::copy(reinterpret_cast<XT*>(st), [&](int i) {
      return TX::locate(xrow[i] ? xrow[i] + k0 : nullptr, K - k0);
    }, tp);
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
  const int sa = shift(ra), sb = shift(rb);
  const bool ea = sa % 2 == 0, eb = sb % 2 == 0;

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
    for (int h = 0; h < 2; ++h)
      a_frag<X_LO>(xs + ra * XPITCH + sa + 16 * h, ea, xs + rb * XPITCH + sb + 16 * h, eb, t,
                   ah[h], al[h]);
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
    OT* o = out + r * N;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = n0 + 8 * j;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (pairs) {
        if (c < N) put2(o + c, v0, v1);
      } else {
        if (c < N) put1(o + c, v0);
        if (c + 1 < N) put1(o + c + 1, v1);
      }
    }
  }
}

template <typename XT, typename OT, int PASSES>
int launch(const void* x, const bf16* tp, void* out, int r, int k, int n, cudaStream_t s) {
  auto kernel = gridmm_kernel<XT, OT, PASSES>;
  constexpr int bytes = Layout<XT, PASSES>::BYTES;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ncol = (n + BN - 1) / BN;
  const unsigned blocks = (unsigned)(((long long)r + BM - 1) / BM * ncol);
  kernel<<<blocks, THREADS, bytes, s>>>(static_cast<const XT*>(x), tp, static_cast<OT*>(out), r,
                                        k, n, ncol);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT>
int launch_passes(const void* x, const bf16* tp, void* out, int r, int k, int n, int passes,
                  cudaStream_t s) {
  switch (passes) {
    case 1:
      return launch<XT, OT, 1>(x, tp, out, r, k, n, s);
    case 2:
      return launch<XT, OT, 2>(x, tp, out, r, k, n, s);
    default:
      // a bf16 x has lo = 0: the 2-pass build gives the 3-pass value
      if constexpr (std::is_same<XT, bf16>::value)
        return launch<XT, OT, 2>(x, tp, out, r, k, n, s);
      else
        return launch<XT, OT, 3>(x, tp, out, r, k, n, s);
  }
}

// Prepares the table into tp, then runs the main kernel. Refuses (before
// launching anything) a shape whose grid or indices do not fit.
int run(const void* x, const float* t, const bf16* th, const bf16* tl, bf16* tp, void* out, int r,
        int k, int n, int x_bf16, int out_bf16, int passes, cudaStream_t s) {
  const long long ncol = ((long long)n + BN - 1) / BN;
  const long long blocks = ((long long)r + BM - 1) / BM * ncol;
  const int steps = 2 * ((k + BK - 1) / BK);
  if (r < 1 || k < 1 || n < 1 || blocks > 2147483647LL || passes < 1 || passes > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = passes >= 2 ? 2 : 1;
  const long long total = ncol * steps * SLAB;
  prep_table<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(t, th, tl, tp, k, n, steps, parts,
                                                             total);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (x_bf16)
    return out_bf16 ? launch_passes<bf16, bf16>(x, tp, out, r, k, n, passes, s)
                    : launch_passes<bf16, float>(x, tp, out, r, k, n, passes, s);
  return out_bf16 ? launch_passes<float, bf16>(x, tp, out, r, k, n, passes, s)
                  : launch_passes<float, float>(x, tp, out, r, k, n, passes, s);
}

}  // namespace

// x (r, k) float32 (x_bf16 == 0) or bfloat16, t (k, n) float32, out (r, n)
// float32 (out_bf16 == 0) or bfloat16; passes 1, 2 or 3; scratch, 16-byte
// aligned, for the prepared table: ceil(n / 256) * 2 ceil(k / 32) * parts *
// 4096 bf16, parts 2 at 2 or 3 passes, else 1.
// x's rows need not start on 16 bytes; every tensor is contiguous. Returns
// cudaGetLastError() after the launches.
extern "C" int gridmm_launch(const void* x, const void* t, void* scratch, void* out, int r, int k,
                             int n, int x_bf16, int out_bf16, int passes, void* stream) {
  return run(x, static_cast<const float*>(t), nullptr, nullptr, static_cast<bf16*>(scratch), out,
             r, k, n, x_bf16, out_bf16, passes, static_cast<cudaStream_t>(stream));
}

// x (r, k) float32 or bfloat16, th and tl (k, n) bfloat16 (the table's hi and
// lo parts), out (r, n) float32 or bfloat16, scratch as for gridmm at 2 or 3
// passes. A bf16 x takes 2 passes, a float32 x 3.
extern "C" int grid_dot_launch(const void* x, const void* th, const void* tl, void* scratch,
                               void* out, int r, int k, int n, int x_bf16, int out_bf16,
                               void* stream) {
  return run(x, nullptr, static_cast<const bf16*>(th), static_cast<const bf16*>(tl),
             static_cast<bf16*>(scratch), out, r, k, n, x_bf16, out_bf16, x_bf16 ? 2 : 3,
             static_cast<cudaStream_t>(stream));
}
