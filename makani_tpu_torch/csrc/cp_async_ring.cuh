// The staging pipeline of the multi-pass bf16 matmul kernels (legmm.cu,
// gridmm.cu): float32 or bf16 source tiles arrive in a shared-memory ring
// through cp.async; legmm's threads split each arrived tile once into bf16
// hi/lo tiles, and the tensor cores read the split tiles with ldmatrix into
// mma.sync m16n8k16 (bf16 in, float32 accumulate). gridmm splits in
// registers instead (split_gemm.cuh). Nothing here knows a kernel's
// indexing: the kernel locates the rows of each tile.
//
// Global rows whose pitch is not a multiple of 16 bytes (721 floats in the
// SFNO's full grid) cannot be copied 16 bytes at a time into aligned rows
// of shared memory, nor described to TMA (its strides are multiples of 16
// bytes), and 4-byte copies issue four times the copy instructions. So such
// rows are copied in 16-byte chunks too and land in shared memory moved by
// their misalignment; the split reads them back in place (StagedTile with
// SHIFT). Elements outside the matrix are zero-filled by the copy: nothing
// is padded in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace makani {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, the first `bytes` (0-16) from src and the rest
// zero; src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// hi[0..3] = bf16_rn(v) and, where lo is given, lo[0..3] = bf16_rn(v - hi):
// two 8-byte shared writes each
__device__ __forceinline__ void split_store4(float4 v, bf16* hi, bf16* lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  uint2 h;
  h.x = *reinterpret_cast<const uint32_t*>(&h01);
  h.y = *reinterpret_cast<const uint32_t*>(&h23);
  *reinterpret_cast<uint2*>(hi) = h;
  if (lo != nullptr) {
    const __nv_bfloat162 l01 =
        __floats2bfloat162_rn(v.x - __low2float(h01), v.y - __high2float(h01));
    const __nv_bfloat162 l23 =
        __floats2bfloat162_rn(v.z - __low2float(h23), v.w - __high2float(h23));
    uint2 l;
    l.x = *reinterpret_cast<const uint32_t*>(&l01);
    l.y = *reinterpret_cast<const uint32_t*>(&l23);
    *reinterpret_cast<uint2*>(lo) = l;
  }
}

// The staged copy of a TR x TC tile of T (float32 by default, or bf16) of
// rows that are contiguous in device memory, and, for float32, its split.
// Each row is held by TC / EPC consecutive threads, one 16-byte chunk (EPC =
// four float32 or eight bf16 columns) each, so a warp's copy covers
// whole stretches of a few rows and lands in contiguous shared memory. A
// thread holds RPT rows, row(i) for i < RPT; the caller locates them once a
// step (row_at(i): a Row, the address of chunk 0, the shift and the valid
// columns), so the copies and the split need no further indexing.
//
// SHIFT: rows need not start on 16 bytes (a pitch of 721 floats). A 16-byte
// copy needs 16-byte aligned source and destination, so each row lands in
// shared memory at pitch TC + EPC (or the PITCH_ given), moved right by its
// misalignment s = (address of its first column) / sizeof(T) % EPC: chunk j
// holds columns -s + EPC j .. -s + EPC (j + 1) - 1, and a last chunk brings
// the row's last s columns. The s columns before the first are read but
// never used; they lie in the 16 aligned bytes that hold the first column,
// inside the tensor's allocation. Without SHIFT every row starts on 16
// bytes (pitch TC). Either way columns past a row's valid extent are
// zero-filled by the copy (src-size below 16), so nothing past a row's end
// is read.
template <int TR, int TC, bool SHIFT, int THREADS, typename T = float,
          int PITCH_ = SHIFT ? TC + 16 / (int)sizeof(T) : TC>
struct StagedTile {
  static constexpr int EPC = 16 / (int)sizeof(T);  // columns a 16-byte chunk
  static constexpr int PITCH = PITCH_;
  static constexpr int TPR = TC / EPC;             // threads a row
  static constexpr int RPT = TR * TPR / THREADS;   // rows a thread
  static_assert(TC % EPC == 0 && THREADS % TPR == 0 && (TR * TPR) % THREADS == 0,
                "tile must split over the threads");
  static_assert(PITCH >= (SHIFT ? TC + EPC : TC) && (PITCH * (int)sizeof(T)) % 16 == 0,
                "rows must hold their chunks and start on 16 bytes");

  // row i of this thread's rows
  __device__ __forceinline__ static int row(int i) {
    return threadIdx.x / TPR + i * (THREADS / TPR);
  }

  // the address of chunk 0 (null: a row of zeros), the shift s and the
  // valid columns counted from chunk 0
  struct Row {
    const T* chunk0;
    int s, lim;
  };

  // A row whose first column is at `first` (null: zeros), with `ncols`
  // valid columns from there.
  __device__ __forceinline__ static Row locate(const T* first, int ncols) {
    if (first == nullptr || ncols <= 0) return {nullptr, 0, 0};
    const int s = SHIFT ? static_cast<int>((reinterpret_cast<uintptr_t>(first) / sizeof(T)) &
                                           (EPC - 1))
                        : 0;
    return {first - s, s, ncols + s};
  }

  // `any`: a 16-byte aligned address, the source of a copy that reads nothing
  __device__ __forceinline__ static void copy_chunk(T* dst, const Row& w, int j, const void* any) {
    const int n = min(EPC, max(0, w.lim - EPC * j));
    cp_async16(dst + EPC * j, n > 0 ? w.chunk0 + EPC * j : any, n * (int)sizeof(T));
  }

  // Issues this thread's copies into the tile at dst: chunk q of each of its
  // rows, and with SHIFT the last chunk of a misaligned row by q == 0.
  template <class RowAt>
  __device__ __forceinline__ static void copy(T* dst, RowAt row_at, const void* any) {
    const int q = threadIdx.x % TPR;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const Row w = row_at(i);
      copy_chunk(dst + row(i) * PITCH, w, q, any);
      if (SHIFT && q == 0 && w.s != 0) copy_chunk(dst + row(i) * PITCH, w, TPR, any);
    }
  }

  // Splits this thread's four columns of each of its rows of the staged tile
  // at src into bf16 tiles of pitch LD: hi = bf16_rn(a) and, with LO,
  // lo = bf16_rn(a - float(hi)). row_at(i) gives each row's shift.
  template <int LD, bool LO, class RowAt>
  __device__ __forceinline__ static void split(const float* src, RowAt row_at, bf16* hi,
                                               bf16* lo) {
    const int c = (threadIdx.x % TPR) * 4;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float* q = src + row(i) * PITCH + c;
      float4 v;
      const int sh = SHIFT ? row_at(i).s : 0;
      if (sh == 0) {
        v = *reinterpret_cast<const float4*>(q);
      } else {  // four single reads from the shifted row
        v = make_float4(q[sh], q[sh + 1], q[sh + 2], q[sh + 3]);
      }
      const int o = row(i) * LD + c;
      split_store4(v, hi + o, LO ? lo + o : nullptr);
    }
  }
};

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. TRANS delivers each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace makani
