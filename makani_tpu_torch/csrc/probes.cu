// The probe battery: seven small kernels, each isolating one construct of the
// dhconv kernel, written for sm_90a.
//
// Replaces the TPU kernels of scripts/pallas_isolate.py (C = O = 16, M = 128,
// B = 2, L = 4, all float32 there):
//   probe_copy            case_copy (:37-42)            out = 2 x on (8, 128)
//   probe_dot_plain       case_dot_plain (:45-55)       (O, C) . (C, M)
//   probe_dot_transposed  case_dot_transposed (:58-68)  dim 0 of both: a (C, O), b (C, M)
//   probe_grid_blocks     case_grid_blocks (:71-88)     out[b, l] = w[l]^T x[b, l]
//   probe_stacked_output  case_stacked_output (:91-109) the same as (2, B, L, O, M): r, -r
//   probe_multi_output    case_multi_output (:112-131)  two outputs r and -r
//   probe_bf16_split      case_bf16_split (:134-150)    the 3-pass hi/lo split dot
// On the TPU they located which Pallas construct a runtime refused. Here each
// shows that its construct builds, launches and computes what its plain twin
// (makani_tpu_torch/tools/kernel_isolate.py) computes.
//
// What bounds them on an H100: at the script's shapes a probe moves at most
// 197 KB (stacked_output: x 64 KB, w 4 KB, out 128 KB) and does at most
// 0.5 MFLOP, well under a microsecond of either; a call costs its launch.
//
// Design: the float32 dot probes give one thread to each output element,
// which sums over the contraction with fused multiply-adds in order of c; the
// gridded probes give one block to each (b, l), as the Pallas grid (B, L, 1)
// does. probe_bf16_split goes through split_mma.cuh: one warp per 16 x 16
// output tile splits both operands into bf16 hi/lo in shared memory (zero
// beyond the edges) and keeps hh, hl and lh in three WMMA accumulators,
// added once as (hh + hl) + lh, the probe's left-to-right order.

#include "split_mma.cuh"

namespace {

using namespace makani;

constexpr int THREADS = 256;

// sum over c of a[o * so + c * sc] * b[c * M + m], fused multiply-adds in
// order of c
__device__ __forceinline__ float dot_om(const float* __restrict__ a, int so, int sc,
                                        const float* __restrict__ b, int C, int M, int o, int m) {
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = fmaf(a[o * so + c * sc], b[c * M + m], acc);
  return acc;
}

__global__ void probe_copy_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.f;
}

// a (O, C), b (C, M) -> out (O, M)
__global__ void probe_dot_plain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                       float* __restrict__ out, int O, int C, int M) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < O * M) out[i] = dot_om(a, C, 1, b, C, M, i / M, i % M);
}

// a (C, O), b (C, M) -> out (O, M), contracting dim 0 of both
__global__ void probe_dot_transposed_kernel(const float* __restrict__ a,
                                            const float* __restrict__ b, float* __restrict__ out,
                                            int O, int C, int M) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < O * M) out[i] = dot_om(a, 1, O, b, C, M, i / M, i % M);
}

// x (B, L, C, M), w (L, C, O): element i = o * M + m of r[b, l] = w[l]^T x[b, l],
// for the block's (b, l) = (blockIdx.x, blockIdx.y)
__device__ __forceinline__ float blocks_r(const float* __restrict__ x,
                                          const float* __restrict__ w, int L, int C, int O, int M,
                                          int i) {
  const int b = blockIdx.x, l = blockIdx.y;
  return dot_om(w + (long long)l * C * O, 1, O, x + ((long long)b * L + l) * C * M, C, M, i / M,
                i % M);
}

__global__ void probe_grid_blocks_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                         float* __restrict__ out, int L, int C, int O, int M) {
  float* ob = out + ((long long)blockIdx.x * L + blockIdx.y) * O * M;
  for (int i = threadIdx.x; i < O * M; i += THREADS) ob[i] = blocks_r(x, w, L, C, O, M, i);
}

// out (2, B, L, O, M): plane 0 r, plane 1 -r
__global__ void probe_stacked_output_kernel(const float* __restrict__ x,
                                            const float* __restrict__ w, float* __restrict__ out,
                                            int B, int L, int C, int O, int M) {
  const long long plane = (long long)B * L * O * M;
  float* ob = out + ((long long)blockIdx.x * L + blockIdx.y) * O * M;
  for (int i = threadIdx.x; i < O * M; i += THREADS) {
    const float r = blocks_r(x, w, L, C, O, M, i);
    ob[i] = r;
    ob[plane + i] = -r;
  }
}

// out1 = r, out2 = -r, each (B, L, O, M)
__global__ void probe_multi_output_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                          float* __restrict__ out1, float* __restrict__ out2, int L,
                                          int C, int O, int M) {
  const long long off = ((long long)blockIdx.x * L + blockIdx.y) * O * M;
  for (int i = threadIdx.x; i < O * M; i += THREADS) {
    const float r = blocks_r(x, w, L, C, O, M, i);
    out1[off + i] = r;
    out2[off + i] = -r;
  }
}

// a (C, O), b (C, M) -> out (O, M) = a^T b in 3 bf16 passes; one warp per
// 16 x 16 output tile (o0, m0) = (16 blockIdx.y, 16 blockIdx.x)
__global__ void __launch_bounds__(32)
probe_bf16_split_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ out, int C, int O, int M) {
  __shared__ __align__(32) bf16 ah[256], al[256], bh[256], bl[256];
  __shared__ __align__(32) float stage[256];
  const int o0 = blockIdx.y * 16, m0 = blockIdx.x * 16;
  FragC hh, hl, lh;
  wmma::fill_fragment(hh, 0.f);
  wmma::fill_fragment(hl, 0.f);
  wmma::fill_fragment(lh, 0.f);
  for (int c0 = 0; c0 < C; c0 += 16) {
    for (int i = threadIdx.x; i < 256; i += 32) {
      const int r = i / 16, q = i % 16;
      // the A tile [o][c] = a[c][o]; the B tile [c][m]
      const bool in_a = o0 + r < O && c0 + q < C;
      const bool in_b = c0 + r < C && m0 + q < M;
      split_store(in_a ? a[(c0 + q) * O + o0 + r] : 0.f, ah, al, i);
      split_store(in_b ? b[(c0 + r) * M + m0 + q] : 0.f, bh, bl, i);
    }
    __syncwarp();
    FragA fah, fal;
    FragB fbh, fbl;
    wmma::load_matrix_sync(fah, ah, 16);
    wmma::load_matrix_sync(fal, al, 16);
    wmma::load_matrix_sync(fbh, bh, 16);
    wmma::load_matrix_sync(fbl, bl, 16);
    wmma::mma_sync(hh, fah, fbh, hh);
    wmma::mma_sync(hl, fah, fbl, hl);
    wmma::mma_sync(lh, fal, fbh, lh);
    __syncwarp();
  }
  for (int e = 0; e < hh.num_elements; ++e) hh.x[e] = (hh.x[e] + hl.x[e]) + lh.x[e];
  wmma::store_matrix_sync(stage, hh, 16, wmma::mem_row_major);
  __syncwarp();
  for (int i = threadIdx.x; i < 256; i += 32) {
    const int r = i / 16, q = i % 16;
    if (o0 + r < O && m0 + q < M) out[(o0 + r) * M + m0 + q] = stage[i];
  }
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Every tensor float32 and contiguous; each launcher returns
// cudaGetLastError() after its launch.

extern "C" int probe_copy_launch(const void* x, void* out, int n, void* stream) {
  probe_copy_kernel<<<blocks(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return done();
}

extern "C" int probe_dot_plain_launch(const void* a, const void* b, void* out, int o, int c,
                                      int m, void* stream) {
  probe_dot_plain_kernel<<<blocks(o * m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), o, c,
      m);
  return done();
}

extern "C" int probe_dot_transposed_launch(const void* a, const void* b, void* out, int o, int c,
                                           int m, void* stream) {
  probe_dot_transposed_kernel<<<blocks(o * m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), o, c,
      m);
  return done();
}

extern "C" int probe_grid_blocks_launch(const void* x, const void* w, void* out, int b, int l,
                                        int c, int o, int m, void* stream) {
  probe_grid_blocks_kernel<<<dim3(b, l), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), l, c,
      o, m);
  return done();
}

extern "C" int probe_stacked_output_launch(const void* x, const void* w, void* out, int b, int l,
                                           int c, int o, int m, void* stream) {
  probe_stacked_output_kernel<<<dim3(b, l), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), b, l,
      c, o, m);
  return done();
}

extern "C" int probe_multi_output_launch(const void* x, const void* w, void* out1, void* out2,
                                         int b, int l, int c, int o, int m, void* stream) {
  probe_multi_output_kernel<<<dim3(b, l), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out1),
      static_cast<float*>(out2), l, c, o, m);
  return done();
}

// a (c, o), b (c, m), out (o, m)
extern "C" int probe_bf16_split_launch(const void* a, const void* b, void* out, int o, int c,
                                       int m, void* stream) {
  probe_bf16_split_kernel<<<dim3((m + 15) / 16, (o + 15) / 16), 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), c, o,
      m);
  return done();
}
