// InstanceNorm2d at "f32" statistics, forward and backward, one launch each.
//
// It replaces no TPU kernel: makani_tpu's InstanceNorm2d
// (makani_tpu/models/common/layers.py) is jnp code that XLA fuses, and the
// port's eager chain of float32 operations (models/common/layers.py) ran at
// about 25 times its bound on the card. The semantics are that chain's: per
// (b, c) plane over (H, W), the float32 mean and the centred variance
// mean((x - mean)^2), then y = ((x - mean) * rsqrt(var + eps)) * w + b in
// float32, each step rounded as the eager operations round it (no fused
// multiply-add), and one rounding to x's type. The statistic is never
// E[x^2] - E[x]^2: each 16-byte pack gives its count, mean and centred sum
// of squares, and packs, threads, warps and blocks combine theirs by Chan's
// formula in a fixed order, so a run's bits repeat.
//
// The backward, from the saved x and the float32 mean and rstd, with
// x^ = (x - mean) rstd and g^ = g w:
//   dx = rstd (g^ - mean(g^) - x^ mean(g^ x^)), rounded once to x's type;
//   sum g x^ and sum g over each plane, the affine's gradients before the
//   sum over the batch, which the wrapper takes in a fixed order
//   (ops/instance_norm.py). No float atomics.
//
// What bounds it on an H100: bytes. A plane's reductions come before its
// normalization, so a plane is read twice; the design keeps the second read
// on chip where it fits. A plane is split over a thread block cluster of G
// blocks (1, 2, 4 or 8: the fewest whose share fits kChunkBytes of shared
// memory, x forward, x and g backward). Each block stages its share in
// shared memory as it reduces it, the cluster's blocks exchange their
// partials through distributed shared memory, and the second pass reads
// shared memory: 4 bytes an element forward and 6 backward at bf16. A plane
// too large for 8 shares (the flagship's 721 x 1440) streams over 8 blocks
// that read their shares again from device memory, last read first, so the
// part still in L2 comes back first: at most 6 bytes an element forward and
// 10 backward. Loads and stores are 16 bytes a thread, on the packs that lie
// on 16 bytes of the whole tensor; a share's ragged ends (and a tensor off
// 16 bytes) go element by element. The block count adapts to H x W and the
// dtype alone.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;              // 16-byte loads a thread keeps in flight
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kChunkBytes = 72 * 1024;  // a block's staged share: three blocks an SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
union Pack {
  uint4 v;
  T e[16 / sizeof(T)];
};

// count, mean and centred sum of squares of a set of elements
struct Moments {
  float n, mean, m2;
};

// Chan's combination of two sets' moments
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  if (b.n == 0.f) return a;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float d = b.mean - a.mean;
  return {n, a.mean + d * wb, a.m2 + b.m2 + d * d * a.n * wb};
}

template <typename T>
__device__ __forceinline__ Moments pack_moments(const Pack<T>& p) {
  constexpr int N = 16 / sizeof(T);
  float f[N];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    f[k] = to_f(p.e[k]);
    s += f[k];
  }
  const float m = s * (1.0f / N);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float d = f[k] - m;
    q = fmaf(d, d, q);
  }
  return {static_cast<float>(N), m, q};
}

struct MergeMoments {
  __device__ Moments operator()(const Moments& a, const Moments& b) const { return merge(a, b); }
};
struct AddSums {
  __device__ float2 operator()(float2 a, float2 b) const {
    return make_float2(a.x + b.x, a.y + b.y);
  }
};

__device__ __forceinline__ Moments shfl_down(const Moments& m, int o) {
  return {__shfl_down_sync(0xffffffffu, m.n, o), __shfl_down_sync(0xffffffffu, m.mean, o),
          __shfl_down_sync(0xffffffffu, m.m2, o)};
}
__device__ __forceinline__ float2 shfl_down(float2 v, int o) {
  return make_float2(__shfl_down_sync(0xffffffffu, v.x, o), __shfl_down_sync(0xffffffffu, v.y, o));
}

// the block's partials combined in a fixed order; the result in thread 0
template <typename S, typename Op>
__device__ S block_reduce(S v, S* warp_part, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, shfl_down(v, o));
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_part[lane] : S{};
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) v = op(v, shfl_down(v, o));
  }
  return v;
}

// the cluster's block totals (thread 0's `v` of each block) combined in the
// order of the blocks' ranks; the plane's total in every thread of every block
template <typename S, typename Op>
__device__ S cluster_reduce(S v, S* slot, Op op) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  S t = *cluster.map_shared_rank(slot, 0);
  for (unsigned r = 1; r < cluster.num_blocks(); ++r) t = op(t, *cluster.map_shared_rank(slot, r));
  cluster.sync();  // no block leaves while another reads its slot
  return t;
}

// A block's share of its plane, in elements of the whole tensor: [lo, hi),
// its whole packs [p0, p1) (in packs), its ragged head [lo, h1) and tail
// [t0, hi), and `origin`, the staged copy's first element (lo down to a pack).
struct Share {
  int64_t lo, hi, p0, p1, h1, t0, origin;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

template <int N>
__device__ Share share_of(int64_t plane, int rank, int n, int chunk, bool vec) {
  Share s;
  const int64_t base = plane * n;
  const int64_t a = lmin(n, static_cast<int64_t>(rank) * chunk);
  const int64_t b = lmin(n, a + chunk);
  s.lo = base + a;
  s.hi = base + b;
  s.origin = s.lo / N * N;
  if (vec) {
    s.p0 = (s.lo + N - 1) / N;
    s.p1 = s.hi / N;
    if (s.p1 < s.p0) s.p1 = s.p0;
    s.h1 = lmin(s.hi, s.p0 * N);
    s.t0 = lmax(s.h1, s.p1 * N);
  } else {
    s.p0 = s.p1 = 0;
    s.h1 = s.t0 = s.hi;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
instance_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ rstd_out, int channels,
                         int n, int chunk, float eps, bool vec, bool staged) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem);
  __shared__ Moments warp_part[kWarps];
  __shared__ Moments slot;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / cluster.num_blocks();
  const Share s = share_of<N>(plane, rank, n, chunk, vec);

  // first pass: the moments, the share staged where it fits
  Moments acc{0.f, 0.f, 0.f};
  auto scalar = [&](int64_t e) {
    const T v = x[e];
    if (staged) sx[e - s.origin] = v;
    acc = merge(acc, Moments{1.f, to_f(v), 0.f});
  };
  for (int64_t e = s.lo + threadIdx.x; e < s.h1; e += kThreads) scalar(e);
  for (int64_t e = s.t0 + threadIdx.x; e < s.hi; e += kThreads) scalar(e);
  for (int64_t p = s.p0 + threadIdx.x; p < s.p1; p += kThreads * kUnroll) {
    Pack<T> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * kThreads;
      if (q < s.p1) r[u].v = *reinterpret_cast<const uint4*>(x + q * N);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * kThreads;
      if (q < s.p1) {
        if (staged) *reinterpret_cast<uint4*>(sx + (q * N - s.origin)) = r[u].v;
        acc = merge(acc, pack_moments(r[u]));
      }
    }
  }
  const Moments m = cluster_reduce(block_reduce(acc, warp_part, MergeMoments{}), &slot,
                                   MergeMoments{});
  const float mean = m.mean;
  // var = M2 * (1 / n) and var + eps rounded apart, as the eager mean and add
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(m.m2, 1.0f / static_cast<float>(n)), eps));
  if (rank == 0 && threadIdx.x == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }

  // second pass: normalize, last pack first
  const int c = static_cast<int>(plane % channels);
  const bool affine = w != nullptr;
  const float wc = affine ? w[c] : 1.f, bc = affine ? b[c] : 0.f;
  auto norm = [&](float v) {
    float r = __fmul_rn(__fsub_rn(v, mean), rstd);
    if (affine) r = __fadd_rn(__fmul_rn(r, wc), bc);
    return from_f<T>(r);
  };
  for (int64_t e = s.lo + threadIdx.x; e < s.h1; e += kThreads)
    y[e] = norm(to_f(staged ? sx[e - s.origin] : x[e]));
  for (int64_t e = s.t0 + threadIdx.x; e < s.hi; e += kThreads)
    y[e] = norm(to_f(staged ? sx[e - s.origin] : x[e]));
  const int64_t packs = s.p1 - s.p0;
  for (int64_t k = threadIdx.x; k < packs; k += kThreads * kUnroll) {
    Pack<T> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ku = k + u * kThreads, q = s.p1 - 1 - ku;
      if (ku < packs)
        r[u].v = staged ? *reinterpret_cast<const uint4*>(sx + (q * N - s.origin))
                        : *reinterpret_cast<const uint4*>(x + q * N);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ku = k + u * kThreads, q = s.p1 - 1 - ku;
      if (ku < packs) {
        Pack<T> o;
#pragma unroll
        for (int j = 0; j < N; ++j) o.e[j] = norm(to_f(r[u].e[j]));
        *reinterpret_cast<uint4*>(y + q * N) = o.v;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
instance_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ w, const float* __restrict__ mean_in,
                         const float* __restrict__ rstd_in, T* __restrict__ dx,
                         float* __restrict__ dw, float* __restrict__ db, int channels, int n,
                         int chunk, bool vec, bool staged) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem);
  T* sg = sx + (chunk + N);
  __shared__ float2 warp_part[kWarps];
  __shared__ float2 slot;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / cluster.num_blocks();
  const Share s = share_of<N>(plane, rank, n, chunk, vec);
  const float mean = mean_in[plane], rstd = rstd_in[plane];
  auto xhat = [&](float v) { return __fmul_rn(__fsub_rn(v, mean), rstd); };

  // first pass: sum g and sum g x^, the shares staged where they fit
  float2 acc = make_float2(0.f, 0.f);
  auto scalar = [&](int64_t e) {
    const T xv = x[e], gv = g[e];
    if (staged) {
      sx[e - s.origin] = xv;
      sg[e - s.origin] = gv;
    }
    const float gf = to_f(gv);
    acc.x += gf;
    acc.y = fmaf(gf, xhat(to_f(xv)), acc.y);
  };
  for (int64_t e = s.lo + threadIdx.x; e < s.h1; e += kThreads) scalar(e);
  for (int64_t e = s.t0 + threadIdx.x; e < s.hi; e += kThreads) scalar(e);
  for (int64_t p = s.p0 + threadIdx.x; p < s.p1; p += kThreads * kUnroll) {
    Pack<T> rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * kThreads;
      if (q < s.p1) {
        rx[u].v = *reinterpret_cast<const uint4*>(x + q * N);
        rg[u].v = *reinterpret_cast<const uint4*>(g + q * N);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * kThreads;
      if (q < s.p1) {
        if (staged) {
          *reinterpret_cast<uint4*>(sx + (q * N - s.origin)) = rx[u].v;
          *reinterpret_cast<uint4*>(sg + (q * N - s.origin)) = rg[u].v;
        }
        float sg1 = 0.f, sgx = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float gf = to_f(rg[u].e[j]);
          sg1 += gf;
          sgx = fmaf(gf, xhat(to_f(rx[u].e[j])), sgx);
        }
        acc.x += sg1;
        acc.y += sgx;
      }
    }
  }
  const float2 sums = cluster_reduce(block_reduce(acc, warp_part, AddSums{}), &slot, AddSums{});
  if (rank == 0 && threadIdx.x == 0 && dw != nullptr) {
    dw[plane] = sums.y;
    db[plane] = sums.x;
  }

  // second pass: dx, last pack first
  const int c = static_cast<int>(plane % channels);
  const float wc = w != nullptr ? w[c] : 1.f;
  const float inv_n = 1.0f / static_cast<float>(n);
  const float mg = wc * (sums.x * inv_n), mgx = wc * (sums.y * inv_n);
  auto grad = [&](float xv, float gv) {
    return from_f<T>(rstd * ((gv * wc - mg) - xhat(xv) * mgx));
  };
  for (int64_t e = s.lo + threadIdx.x; e < s.h1; e += kThreads)
    dx[e] = staged ? grad(to_f(sx[e - s.origin]), to_f(sg[e - s.origin]))
                   : grad(to_f(x[e]), to_f(g[e]));
  for (int64_t e = s.t0 + threadIdx.x; e < s.hi; e += kThreads)
    dx[e] = staged ? grad(to_f(sx[e - s.origin]), to_f(sg[e - s.origin]))
                   : grad(to_f(x[e]), to_f(g[e]));
  const int64_t packs = s.p1 - s.p0;
  for (int64_t k = threadIdx.x; k < packs; k += kThreads * kUnroll) {
    Pack<T> rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ku = k + u * kThreads, q = s.p1 - 1 - ku;
      if (ku < packs) {
        if (staged) {
          rx[u].v = *reinterpret_cast<const uint4*>(sx + (q * N - s.origin));
          rg[u].v = *reinterpret_cast<const uint4*>(sg + (q * N - s.origin));
        } else {
          rx[u].v = *reinterpret_cast<const uint4*>(x + q * N);
          rg[u].v = *reinterpret_cast<const uint4*>(g + q * N);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ku = k + u * kThreads, q = s.p1 - 1 - ku;
      if (ku < packs) {
        Pack<T> o;
#pragma unroll
        for (int j = 0; j < N; ++j) o.e[j] = grad(to_f(rx[u].e[j]), to_f(rg[u].e[j]));
        *reinterpret_cast<uint4*>(dx + q * N) = o.v;
      }
    }
  }
}

// blocks a plane (the cluster), a block's share of the plane in elements,
// and the dynamic shared memory a block stages it in (0: streamed)
struct Plan {
  int cluster, chunk, smem;
};

template <typename T>
Plan plan_for(int n, int arrays) {
  constexpr int64_t N = 16 / sizeof(T);
  for (int G = 1; G <= kMaxCluster; G *= 2) {
    const int64_t chunk = ((static_cast<int64_t>(n) + G - 1) / G + N - 1) / N * N;
    const int64_t smem = arrays * (chunk + N) * static_cast<int64_t>(sizeof(T));
    if (smem <= kChunkBytes) return {G, static_cast<int>(chunk), static_cast<int>(smem)};
  }
  const int64_t chunk = ((static_cast<int64_t>(n) + kMaxCluster - 1) / kMaxCluster + N - 1) / N * N;
  return {kMaxCluster, static_cast<int>(chunk), 0};
}

template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int planes, const Plan& plan, cudaStream_t stream,
                    Args... args) {
  if (static_cast<int64_t>(planes) * plan.cluster > INT_MAX) return cudaErrorInvalidValue;
  if (plan.smem > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * plan.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(plan.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(plan.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15u) == 0;
}

bool bad_shape(int planes, int channels, int n) {
  return planes < 1 || channels < 1 || n < 1 || planes % channels != 0;
}

template <typename T>
int fwd(const void* x, const void* w, const void* b, void* y, void* mean, void* rstd,
        int planes, int channels, int n, float eps, cudaStream_t s) {
  const Plan plan = plan_for<T>(n, 1);
  return launch_clusters(instance_norm_fwd_kernel<T>, planes, plan, s,
                         static_cast<const T*>(x), static_cast<const float*>(w),
                         static_cast<const float*>(b), static_cast<T*>(y),
                         static_cast<float*>(mean), static_cast<float*>(rstd), channels, n,
                         plan.chunk, eps, aligned16(x, y, y), plan.smem > 0);
}

template <typename T>
int bwd(const void* x, const void* g, const void* w, const void* mean, const void* rstd,
        void* dx, void* dw, void* db, int planes, int channels, int n, cudaStream_t s) {
  const Plan plan = plan_for<T>(n, 2);
  return launch_clusters(instance_norm_bwd_kernel<T>, planes, plan, s,
                         static_cast<const T*>(x), static_cast<const T*>(g),
                         static_cast<const float*>(w), static_cast<const float*>(mean),
                         static_cast<const float*>(rstd), static_cast<T*>(dx),
                         static_cast<float*>(dw), static_cast<float*>(db), channels, n,
                         plan.chunk, aligned16(x, g, dx), plan.smem > 0);
}

}  // namespace

// x, y: planes = B * C contiguous planes of n = H * W elements, bf16 (is_bf16)
// or float32; w, b: the affine's C float32 values, both null for none; mean,
// rstd: planes float32 each, written. planes, channels, n >= 1 (the wrapper
// launches nothing for an empty tensor).
extern "C" int instance_norm_fwd_launch(const void* x, const void* w, const void* b, void* y,
                                        void* mean, void* rstd, int planes, int channels, int n,
                                        float eps, int is_bf16, void* stream_ptr) {
  if (bad_shape(planes, channels, n) || (w == nullptr) != (b == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16 ? fwd<bf16>(x, w, b, y, mean, rstd, planes, channels, n, eps, s)
                 : fwd<float>(x, w, b, y, mean, rstd, planes, channels, n, eps, s);
}

// x, g, dx: as x above; w: the affine's weight or null; mean, rstd: the
// forward's; dw, db: planes float32 each (sum g x^ and sum g of each plane),
// written, both null where w is
extern "C" int instance_norm_bwd_launch(const void* x, const void* g, const void* w,
                                        const void* mean, const void* rstd, void* dx, void* dw,
                                        void* db, int planes, int channels, int n, int is_bf16,
                                        void* stream_ptr) {
  if (bad_shape(planes, channels, n) || (w == nullptr) != (dw == nullptr) ||
      (dw == nullptr) != (db == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16 ? bwd<bf16>(x, g, w, mean, rstd, dx, dw, db, planes, channels, n, s)
                 : bwd<float>(x, g, w, mean, rstd, dx, dw, db, planes, channels, n, s);
}
