// The consumer side of the multi-pass bf16 matmul kernels (gridmm.cu,
// dhconv_gemm.cuh, dhconv_dw.cu; probes.cu's mma.sync probe): A fragments read from a staged float32 or bf16 tile and
// split into bf16 hi/lo in registers, so the split writes nothing back to
// shared memory, and Hopper's warpgroup product wgmma.mma_async m64n256k16
// (gridmm) or m64n96k16 (dhconv), bf16 in, float32 accumulate, with A from
// those registers and B, a prepared bf16 tile, from shared memory through a
// matrix descriptor; and the mbarrier and bulk copy that bring such a tile.
//
// B layout ("core matrices", no swizzle): a 16-deep B tile of BN columns is
// BN / 8 x 2 core matrices of 8 columns x 8 depths, each 128 contiguous bytes
// holding its 8 columns one after another, each column's 8 depths contiguous
// (K-major). Core matrix (j, h) (columns 8j.., depths 8h..) sits at
// (2j + h) x 128 bytes: the two depth halves 128 bytes apart (the
// descriptor's leading byte offset), neighbouring column groups 256 bytes
// apart (its stride byte offset). ldmatrix reads the same layout for
// mma.sync: lane l of an x4 load at (pair of column groups) + 16 l bytes.
//
// A fragment (wgmma's register A, as mma.sync m16n8k16's): warp w of the
// warpgroup holds rows 16w .. 16w + 15; lane l (g = l / 4, t = l % 4) holds
// rows g and g + 8 at depths 2t, 2t + 1 and 2t + 8, 2t + 9: a[0] (g, 2t),
// a[1] (g + 8, 2t), a[2] (g, 2t + 8), a[3] (g + 8, 2t + 8), two bf16 each,
// the lower depth in the low half. The accumulator of m64nN: d[4j + e] is
// row 16w + g + 8 (e / 2), column 8j + 2t + e % 2.
//
// The passes: a float32 operand a is split into two bfloat16 values,
//   hi = bf16_rn(a),  lo = bf16_rn(a - float(hi)),
// and a product a*b is formed from the bf16 parts on the tensor cores:
//   passes 1: ah*bh
//   passes 2: ah*bh + ah*bl          (second operand split, first rounded)
//   passes 3: ah*bh + (ah*bl + al*bh)
// Each bf16 x bf16 product is exact in float32 and is accumulated in float32,
// as in _mp_dot (makani_tpu/ops/pallas_mm.py:40-55).
#pragma once

#include "cp_async_ring.cuh"

namespace makani {

// (lo, hi) bf16 halves of one 32-bit register, rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two floats of a packed bf16 pair
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Two consecutive elements of a staged row, at an even offset from the
// row's shifted start when `even` (one 8- or 4-byte read), else one by one.
__device__ __forceinline__ float2 ld_pair(const float* p, bool even) {
  return even ? *reinterpret_cast<const float2*>(p) : make_float2(p[0], p[1]);
}
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool even) {
  if (even) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + 1);
  return lo | (hi << 16);
}

// This lane's A fragment of one 16-deep step from two staged rows: ra at
// row g and rb at row g + 8, each already at the step's first depth plus its
// shift (ea, eb: the shift is even). hi = bf16_rn(a) and, with LO, lo =
// bf16_rn(a - float(hi)). A bf16 row is its own hi part and has no lo.
template <bool LO>
__device__ __forceinline__ void a_frag(const float* ra, bool ea, const float* rb, bool eb, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 v[4] = {ld_pair(ra + 2 * t, ea), ld_pair(rb + 2 * t, eb),
                       ld_pair(ra + 2 * t + 8, ea), ld_pair(rb + 2 * t + 8, eb)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack_bf16(v[i].x, v[i].y);
    if constexpr (LO) {
      const float2 h = unpack_bf16(hi[i]);
      lo[i] = pack_bf16(v[i].x - h.x, v[i].y - h.y);
    }
  }
}
template <bool LO>
__device__ __forceinline__ void a_frag(const bf16* ra, bool ea, const bf16* rb, bool eb, int t,
                                       uint32_t (&hi)[4], uint32_t (&)[4]) {
  static_assert(!LO, "a bf16 row has no lo part");
  hi[0] = ld_pair(ra + 2 * t, ea);
  hi[1] = ld_pair(rb + 2 * t, eb);
  hi[2] = ld_pair(ra + 2 * t + 8, ea);
  hi[3] = ld_pair(rb + 2 * t + 8, eb);
}

// wgmma matrix descriptor of a K-major B tile without swizzle at shared
// address p: leading byte offset lbo (between the two depth halves), stride
// byte offset sbo (between column groups of 8)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// orders this thread's register writes (A fragments, zeroed accumulators)
// before the warpgroup's next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// mbarriers: a phase completes when its expected arrivals have arrived and
// the bytes it expects (expect_tx) have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// makes initialised mbarriers visible to the other threads and the async proxy
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` more of copies in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// a warpgroup's registers a thread, lowered or raised to N (all its warps
// execute it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// one arrival on bar's current phase
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// waits until `count` threads of the block have reached named barrier `id`
// (1-15; __syncthreads is barrier 0)
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (bulk copies, wgmma) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the bulk copy engine (the async proxy, as wgmma reads), counted
// by bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

#define MAKANI_D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256, this thread's 128) += a (64 x 16, registers) . b (16 x 256,
// the descriptor's tile), bf16 in, float32 accumulate; asynchronous until
// wgmma_wait
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : MAKANI_D8(0), MAKANI_D8(8), MAKANI_D8(16), MAKANI_D8(24), MAKANI_D8(32), MAKANI_D8(40),
        MAKANI_D8(48), MAKANI_D8(56), MAKANI_D8(64), MAKANI_D8(72), MAKANI_D8(80), MAKANI_D8(88),
        MAKANI_D8(96), MAKANI_D8(104), MAKANI_D8(112), MAKANI_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 96, this thread's 48) += a (64 x 16, registers) . b (16 x 96, the
// descriptor's tile), bf16 in, float32 accumulate; asynchronous until
// wgmma_wait
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : MAKANI_D8(0), MAKANI_D8(8), MAKANI_D8(16), MAKANI_D8(24), MAKANI_D8(32), MAKANI_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MAKANI_D8

}  // namespace makani
