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
// 0.5 MFLOP, well under a microsecond of either; a call costs its launch and
// a memory latency or two.
//
// Design: the float32 dot probes give one thread to each output element,
// which sums over the contraction with fused multiply-adds in order of c.
// probe_dot_plain stages its operands in shared memory first
// (probe_dot_plain_kernel below), so a thread waits on one round of loads,
// not on each of its c; its sums stay dot_om's, bit for bit.
// probe_grid_blocks, probe_stacked_output and probe_multi_output share one
// body, gridded_kernel (below): the (b, l) work spread over many blocks, the
// operands staged in shared memory once a block, r and -r stored from the
// same registers (stacked_output: -r in plane 1 of its output;
// multi_output: in its second output). probe_bf16_split goes through
// split_mma.cuh: one warp per
// 16 x 16 output tile splits both operands into bf16 hi/lo in shared memory
// (zero beyond the edges) and keeps hh, hl and lh in three WMMA accumulators,
// added once as (hh + hl) + lh, the probe's left-to-right order.

#include <climits>
#include <cstdint>

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

// a (O, C), b (C, M) -> out (O, M). One block a PO x PM tile of out, one
// element a thread: lanes along m (coalesced stores, conflict-free reads of
// b's staged rows), warps along o (a staged a value read is a broadcast).
// A block stages its rows of a (PO x PK) and its columns of b (PK x PM) in
// shared memory, PK rows of c at a time, every load of a chunk issued before
// one barrier: 16-byte loads of four floats where the rows allow them (va,
// vb: a row's length a multiple of 4 floats from a 16-byte base), four
// scalar loads otherwise; zeros past O, C and M. Each output is then
// dot_om's chain: fused multiply-adds in order of c from 0.
namespace plain {
constexpr int PM = 32;  // columns of m a block
constexpr int PO = 8;   // rows of o a block
constexpr int PK = 16;  // rows of c staged at once
constexpr int PT = PM * PO;  // threads a block
static_assert(PO * PK / 4 <= PT && PK * PM / 4 <= PT, "a quad of each tile a thread at most");
}  // namespace plain

// four floats of row `row` from column `col` on: one 16-byte load (vec),
// else scalars; zeros past `rows` and `cols`
__device__ __forceinline__ float4 load_quad(const float* __restrict__ p, int rows, int cols,
                                            int row, int col, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* r = p + (long long)row * cols;
  if (vec) {
    if (col < cols) v = *reinterpret_cast<const float4*>(r + col);
  } else {
    if (col < cols) v.x = r[col];
    if (col + 1 < cols) v.y = r[col + 1];
    if (col + 2 < cols) v.z = r[col + 2];
    if (col + 3 < cols) v.w = r[col + 3];
  }
  return v;
}

__global__ void __launch_bounds__(plain::PT)
probe_dot_plain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int O, int C, int M, int mtiles, bool va,
                       bool vb) {
  using namespace plain;
  __shared__ __align__(16) float as[PO][PK];
  __shared__ __align__(16) float bs[PK][PM];
  constexpr int AQ = PK / 4, BQ = PM / 4;  // quads a row of each tile
  const int t = threadIdx.x;
  const int m0 = (blockIdx.x % mtiles) * PM, o0 = (blockIdx.x / mtiles) * PO;
  const int mi = t % PM, oi = t / PM;
  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += PK) {
    if (c0 > 0) __syncthreads();  // every read of the last chunk is done
    float4 av{}, bv{};
    if (t < PO * AQ) av = load_quad(a, O, C, o0 + t / AQ, c0 + 4 * (t % AQ), va);
    if (t < PK * BQ) bv = load_quad(b, C, M, c0 + t / BQ, m0 + 4 * (t % BQ), vb);
    if (t < PO * AQ) *reinterpret_cast<float4*>(&as[t / AQ][4 * (t % AQ)]) = av;
    if (t < PK * BQ) *reinterpret_cast<float4*>(&bs[t / BQ][4 * (t % BQ)]) = bv;
    __syncthreads();
    const int cn = min(PK, C - c0);
#pragma unroll 4
    for (int c = 0; c < cn; ++c) acc = fmaf(as[oi][c], bs[c][mi], acc);
  }
  const int o = o0 + oi, m = m0 + mi;
  if (o < O && m < M) out[(long long)o * M + m] = acc;
}

// a (C, O), b (C, M) -> out (O, M), contracting dim 0 of both
__global__ void probe_dot_transposed_kernel(const float* __restrict__ a,
                                            const float* __restrict__ b, float* __restrict__ out,
                                            int O, int C, int M) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < O * M) out[i] = dot_om(a, 1, O, b, C, M, i / M, i % M);
}

// The gridded product r[b, l] = w[l]^T x[b, l], x (B, L, C, M), w (L, C, O),
// r (B, L, O, M). One block a (b, l, O tile, M tile), the grid flattened
// (M tiles fastest). A block stages its window of x (CK x TM) and its
// columns of w[l] (CK x OB) in shared memory, CK rows of c at a time, all of
// a chunk's loads issued before one barrier; zeros stand past C, O and M, so
// nothing a kernel left in shared memory is read. Lanes run along m: x loads
// and the stores are coalesced scalar accesses at any M and any alignment.
// Warps run along o, so a w read is a broadcast, and each thread keeps OT
// outputs, o = o0 + OT * (thread / TM) + j, so one x value read serves OT
// products. Each output is summed with fused multiply-adds in order of c,
// dot_om's order.
namespace gridded {
// the tile measured fastest at the script's shapes (tools/probe_ablation.py)
constexpr int TM = 32;       // columns of m a block
constexpr int OT = 2;        // outputs along o a thread
constexpr int OG = 8;        // thread groups along o
constexpr int CK = 16;       // rows of c staged at once
constexpr int NT = TM * OG;  // threads a block
constexpr int OB = OT * OG;  // columns of o a block
constexpr int XL = CK * TM / NT;         // x loads a thread a chunk
constexpr int WL = (CK * OB + NT - 1) / NT;  // w loads a thread a chunk
static_assert(CK * TM % NT == 0, "x chunk not a whole number of loads a thread");
}  // namespace gridded

// NEG: also store -r at neg (stacked_output: plane 1 of its output;
// multi_output: its second output)
template <bool NEG>
__global__ void __launch_bounds__(gridded::NT)
gridded_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
               float* __restrict__ neg, int L, int C, int O, int M, int mtiles, int otiles) {
  using namespace gridded;
  __shared__ float xs[CK][TM];
  __shared__ __align__(16) float ws[CK][OB];
  const int t = threadIdx.x;
  const int m0 = (blockIdx.x % mtiles) * TM;
  const int o0 = (blockIdx.x / mtiles % otiles) * OB;
  const long long bl = blockIdx.x / mtiles / otiles;
  const float* xb = x + bl * C * M + m0;
  const float* wl = w + (bl % L) * C * O + o0;
  const int mi = t % TM, oi = t / TM * OT;
  float acc[OT] = {};
  for (int c0 = 0; c0 < C; c0 += CK) {
    if (c0 > 0) __syncthreads();  // every read of the last chunk is done
    float xv[XL], wv[WL];
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = t + i * NT, c = c0 + e / TM, m = e % TM;
      xv[i] = c < C && m0 + m < M ? xb[(long long)c * M + m] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int e = t + i * NT, c = c0 + e / OB, o = e % OB;
      wv[i] = e < CK * OB && c < C && o0 + o < O ? wl[(long long)c * O + o] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < XL; ++i) xs[(t + i * NT) / TM][(t + i * NT) % TM] = xv[i];
#pragma unroll
    for (int i = 0; i < WL; ++i)
      if (t + i * NT < CK * OB) ws[(t + i * NT) / OB][(t + i * NT) % OB] = wv[i];
    __syncthreads();
    const int cn = min(CK, C - c0);
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      const float xc = xs[c][mi];
#pragma unroll
      for (int j = 0; j < OT; ++j) acc[j] = fmaf(ws[c][oi + j], xc, acc[j]);
    }
  }
  const int m = m0 + mi;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int o = o0 + oi + j;
    if (o < O) {
      const long long i = (bl * O + o) * M + m;
      out[i] = acc[j];
      if constexpr (NEG) neg[i] = -acc[j];
    }
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

template <bool NEG>
int launch_gridded(const void* x, const void* w, void* out, void* neg, int b, int l, int c, int o,
                   int m, void* stream) {
  using namespace gridded;
  const int mtiles = (m + TM - 1) / TM, otiles = (o + OB - 1) / OB;
  const long long n = (long long)b * l * mtiles * otiles;
  if (n == 0) return done();  // nothing to compute: an empty grid is no launch
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  gridded_kernel<NEG><<<static_cast<unsigned>(n), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<float*>(neg), l, c, o, m, mtiles, otiles);
  return done();
}

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
  using namespace plain;
  const int mtiles = (m + PM - 1) / PM;
  const long long n = (long long)mtiles * ((o + PO - 1) / PO);
  if (n == 0) return done();  // nothing to compute: an empty grid is no launch
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool va = c % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  const bool vb = m % 4 == 0 && reinterpret_cast<std::uintptr_t>(b) % 16 == 0;
  probe_dot_plain_kernel<<<static_cast<unsigned>(n), PT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), o, c,
      m, mtiles, va, vb);
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
  return launch_gridded<false>(x, w, out, nullptr, b, l, c, o, m, stream);
}

// out (2, B, L, O, M): plane 0 r, plane 1 -r
extern "C" int probe_stacked_output_launch(const void* x, const void* w, void* out, int b, int l,
                                           int c, int o, int m, void* stream) {
  float* r = static_cast<float*>(out);
  return launch_gridded<true>(x, w, r, r + (long long)b * l * o * m, b, l, c, o, m, stream);
}

// out1 = r, out2 = -r, each (B, L, O, M)
extern "C" int probe_multi_output_launch(const void* x, const void* w, void* out1, void* out2,
                                         int b, int l, int c, int o, int m, void* stream) {
  return launch_gridded<true>(x, w, out1, out2, b, l, c, o, m, stream);
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
