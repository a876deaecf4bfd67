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
// probe_dot_plain and probe_dot_transposed launch one body, probe_dot_kernel
// (below), a's layout its template argument: a block stages its operands in
// shared memory first, so a thread waits on one round of loads, not on each
// of its c; the sums stay dot_om's, bit for bit with probe_dot_chain, the
// one-thread-an-output chain kept as their reference. probe_grid_blocks,
// probe_stacked_output and probe_multi_output share one body, gridded_kernel
// (below): the (b, l) work spread over many blocks, the operands staged in
// shared memory once a block, r and -r stored from the same registers
// (stacked_output: -r in plane 1 of its output; multi_output: in its second
// output). probe_bf16_split runs mma.sync on register fragments
// (split_gemm.cuh's layout): each lane loads its own elements of the A and B
// fragments, splits them into bf16 hi/lo in registers, keeps hh, hl and lh in
// three accumulators, adds them once as (hh + hl) + lh, the probe's
// left-to-right order, and stores its accumulator pairs straight to the
// output: no shared memory, no barrier.

#include <climits>
#include <cstdint>

#include "split_gemm.cuh"

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

// a (O, C), or (TRANS) a (C, O) contracted on dim 0, and b (C, M) -> out
// (O, M). One block a PO x PM tile of out, one element a thread: lanes along
// m (coalesced stores, conflict-free reads of b's staged rows), warps along o
// (a staged a value read is a broadcast). A block stages its PO rows of o of
// a (PO x PK) and its PM columns of b (PK x PM) in shared memory, PK rows of
// c at a time, every load of a chunk issued before one barrier. Global loads
// take four floats along a row of each operand, which for a (C, O) (TRANS)
// runs along o: 16-byte loads where the rows allow them (va, vb: a row's
// length a multiple of 4 floats from a 16-byte base), four scalar loads
// otherwise; zeros past O, C and M. TRANS stores such a quad down a column
// of the a tile, so both layouts read it alike, four values of c in one
// shared load. Each output is then dot_om's chain: fused multiply-adds in
// order of c from 0.
namespace plain {
constexpr int PM = 32;  // columns of m a block
constexpr int PO = 8;   // rows of o a block
constexpr int PK = 16;  // rows of c staged at once
constexpr int PT = PM * PO;  // threads a block
static_assert(PO * PK / 4 <= PT && PK * PM / 4 <= PT, "a quad of each tile a thread at most");
static_assert(PO % 4 == 0 && PK % 4 == 0, "whole quads a row of either a tile");
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

template <bool TRANS>
__global__ void __launch_bounds__(plain::PT)
probe_dot_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                 int O, int C, int M, int mtiles, bool va, bool vb) {
  using namespace plain;
  __shared__ __align__(16) float as[PO * PK];
  __shared__ __align__(16) float bs[PK * PM];
  constexpr int AQ = (TRANS ? PO : PK) / 4, BQ = PM / 4;  // quads a row of each tile
  const int t = threadIdx.x;
  const int m0 = (blockIdx.x % mtiles) * PM, o0 = (blockIdx.x / mtiles) * PO;
  const int mi = t % PM, oi = t / PM;
  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += PK) {
    if (c0 > 0) __syncthreads();  // every read of the last chunk is done
    float4 av{}, bv{};
    if (t < PO * PK / 4)
      av = TRANS ? load_quad(a, C, O, c0 + t / AQ, o0 + 4 * (t % AQ), va)
                 : load_quad(a, O, C, o0 + t / AQ, c0 + 4 * (t % AQ), va);
    if (t < PK * BQ) bv = load_quad(b, C, M, c0 + t / BQ, m0 + 4 * (t % BQ), vb);
    if (t < PO * PK / 4) {
      if constexpr (TRANS) {  // row c = t / AQ, rows o .. o + 3 of the tile
        float* col = &as[4 * (t % AQ) * PK + t / AQ];
        col[0] = av.x;
        col[PK] = av.y;
        col[2 * PK] = av.z;
        col[3 * PK] = av.w;
      } else {
        *reinterpret_cast<float4*>(&as[4 * t]) = av;
      }
    }
    if (t < PK * BQ) *reinterpret_cast<float4*>(&bs[4 * t]) = bv;
    __syncthreads();
    const int cn = min(PK, C - c0);
#pragma unroll 4
    for (int c = 0; c < cn; ++c) acc = fmaf(as[oi * PK + c], bs[c * PM + mi], acc);
  }
  const int o = o0 + oi, m = m0 + mi;
  if (o < O && m < M) out[(long long)o * M + m] = acc;
}

// The bit reference of both dot probes: each output dot_om's chain, one
// thread an output, a's element (o, c) at a[o * so + c * sc]
__global__ void probe_dot_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                       float* __restrict__ out, int O, int C, int M, int so,
                                       int sc) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < O * M) out[i] = dot_om(a, so, sc, b, C, M, i / M, i % M);
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

// a (C, O), b (C, M) -> out (O, M) = a^T b in 3 bf16 passes on mma.sync
// m16n8k16 (the tile mma.sync takes: wgmma's 64 rows would leave three
// quarters of a warpgroup idle at O = 16). A block a 16-row O tile and BM
// columns of m, WB warps along m, NW n8 tiles a warp. For each 16-deep chunk
// of c a lane loads its own elements of the A fragment (A[o][k] = a[c0 + k]
// [o]) and of its B fragments (B[k][n] = b[c0 + k][n]), every load issued
// before any is split, zeros past O, C and M; splits them into bf16 hi/lo
// pairs in registers and runs hh += ah bh, hl += ah bl, lh += al bh. The
// chunks and their order are those of a WMMA 16 x 16 x 16 product, which
// lowers to the same m16n8k16 instructions: its bits.
namespace split {
// the tile measured fastest at the script's shapes (tools/probe_ablation.py split)
constexpr int NW = 1;  // n8 tiles of m a warp
constexpr int WB = 4;  // warps a block, along m
constexpr int BM = 8 * NW * WB;  // columns of m a block
}  // namespace split

// The bf16 hi and lo parts of the pair (x, y), x in the low half as the
// fragments want the lower k: hi = bf16_rn(v), lo = bf16_rn(v - float(hi))
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x - h.x, y - h.y);
}

// vo: float2 stores (M even, out 8-byte aligned)
__global__ void __launch_bounds__(32 * split::WB)
probe_bf16_split_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ out, int C, int O, int M, int mtiles, bool vo) {
  using namespace split;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;  // the fragments' group and lane in it
  const int o0 = blockIdx.x / mtiles * 16;
  const int n0 = blockIdx.x % mtiles * BM + threadIdx.x / 32 * 8 * NW;
  float hh[NW][4] = {}, hl[NW][4] = {}, lh[NW][4] = {};
  for (int c0 = 0; c0 < C; c0 += 16) {
    // A's element e: row g + 8 (e / 2 % 2), column 2 t + e % 2 + 8 (e / 4);
    // B's: row 2 t + e % 2 + 8 (e / 2), column g
    float av[8], bv[NW][4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = c0 + 2 * t + e % 2 + 8 * (e / 4), o = o0 + g + 8 * (e / 2 % 2);
      av[e] = k < C && o < O ? a[(long long)k * O + o] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = c0 + 2 * t + e % 2 + 8 * (e / 2), n = n0 + 8 * j + g;
        bv[j][e] = k < C && n < M ? b[(long long)k * M + n] : 0.f;
      }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_pair(av[2 * r], av[2 * r + 1], ah[r], al[r]);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t bh[2], bl[2];
      split_pair(bv[j][0], bv[j][1], bh[0], bl[0]);
      split_pair(bv[j][2], bv[j][3], bh[1], bl[1]);
      mma_bf16_16816(hh[j], ah, bh[0], bh[1]);
      mma_bf16_16816(hl[j], ah, bl[0], bl[1]);
      mma_bf16_16816(lh[j], al, bh[0], bh[1]);
    }
  }
  // accumulator element e at row g + 8 (e / 2), column 2 t + e % 2
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int n = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + g + 8 * h;
      const float x = (hh[j][2 * h] + hl[j][2 * h]) + lh[j][2 * h];
      const float y = (hh[j][2 * h + 1] + hl[j][2 * h + 1]) + lh[j][2 * h + 1];
      if (o >= O || n >= M) continue;
      float* p = out + (long long)o * M + n;
      if (vo && n + 1 < M) {
        *reinterpret_cast<float2*>(p) = make_float2(x, y);
      } else {
        p[0] = x;
        if (n + 1 < M) p[1] = y;
      }
    }
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

// a (o, c), or (TRANS) a (c, o)
template <bool TRANS>
int launch_dot(const void* a, const void* b, void* out, int o, int c, int m, void* stream) {
  using namespace plain;
  const int mtiles = (m + PM - 1) / PM;
  const long long n = (long long)mtiles * ((o + PO - 1) / PO);
  if (n == 0) return done();  // nothing to compute: an empty grid is no launch
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool va = (TRANS ? o : c) % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  const bool vb = m % 4 == 0 && reinterpret_cast<std::uintptr_t>(b) % 16 == 0;
  probe_dot_kernel<TRANS><<<static_cast<unsigned>(n), PT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), o, c,
      m, mtiles, va, vb);
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
  return launch_dot<false>(a, b, out, o, c, m, stream);
}

extern "C" int probe_dot_transposed_launch(const void* a, const void* b, void* out, int o, int c,
                                           int m, void* stream) {
  return launch_dot<true>(a, b, out, o, c, m, stream);
}

// The dot probes' bit reference, never a probe's path: a's element (o, c) at
// a[o * so + c * sc], so (c, 1) for a (o, c) and (1, o) for a (c, o)
extern "C" int probe_dot_chain_launch(const void* a, const void* b, void* out, int o, int c,
                                      int m, int so, int sc, void* stream) {
  probe_dot_chain_kernel<<<blocks(o * m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), o, c,
      m, so, sc);
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
  using namespace split;
  const int mtiles = (m + BM - 1) / BM;
  const long long n = (long long)mtiles * ((o + 15) / 16);
  if (n == 0) return done();  // nothing to compute: an empty grid is no launch
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vo = m % 2 == 0 && reinterpret_cast<std::uintptr_t>(out) % 8 == 0;
  probe_bf16_split_kernel<<<static_cast<unsigned>(n), 32 * WB, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), c, o,
      m, mtiles, vo);
  return done();
}
