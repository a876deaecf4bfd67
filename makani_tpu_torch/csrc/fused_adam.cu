// Fused Adam(W) update of every parameter leaf of a step in one launch, in
// place, with bf16 moments under counter-hash stochastic rounding (or
// float32, or float16 moments).
//
// Replaces the TPU kernel makani_tpu/ops/pallas_adam.py _adam_kernel /
// _fused_leaf_update / fused_adam_apply (:66-186), which launches once per
// leaf. One pass per element over (p f32, g f32, mu, nu):
//   mu' = (1-b1)*g + b1*mu              one fused multiply-add
//   nu' = (1-b2)*(g*g) + b2*nu          one fused multiply-add
//   (float16 moments: mu' and nu' stored as fma(mu, b1, (1-b1)*g) and
//   fma(nu, b2, (1-b2)*(g*g)), u from the first form of mu': the fused
//   multiply-adds XLA's CPU code makes of the reference's float16 graph)
//   u   = mu' / (bc1 * (sqrt(nu'/bc2) + eps))
//   p'  = p*decay - lr*u                one fused multiply-add, decay = 1 - lr*wd
//   mu, nu stored with stochastic rounding to bf16, to nearest bf16, as f32,
//   or to nearest float16 (subnormals kept: the reference's float16 moments
//   round to nearest whatever optimizer_stochastic_rounding says)
// The arithmetic is the reference's as XLA compiles it (the same update in
// utils/optimizers.scale_by_adam_lowmem + apply, and pallas_adam's kernel):
// (mu'/bc1)/(sqrt(nu'/bc2)+eps) folded into one division, and each
// multiply-add contracted into one fused multiply-add. Every operation here
// is an explicit round-to-nearest intrinsic, so nothing is contracted or
// approximated beyond that, and the plain twin in ops/fused_adam.py matches
// it bit for bit.
//
// Two mode bits extend the update (makani_tpu's optax chain; LAMB and
// gradient clipping):
//   bit 0, clip: g is first scaled by the global gradient norm, read from
//     the device (no host sync): g when norm < max_norm, else
//     (g / norm) * max_norm, two roundings, as optax.clip_by_global_norm;
//   bit 1, direction: p is left alone and dir = u + wd*p (one fused
//     multiply-add, optax.add_decayed_weights) is written to a float32
//     buffer; the caller scales it by LAMB's trust ratio and applies it.
//
// The dither of the stochastic rounding is keyed by the element's flat index
// in the reference's layout of its leaf and a salt per (step, leaf, moment).
// Each leaf's descriptor (LeafDesc) carries its four merged sizes and one
// index stride a dimension (the identity for every leaf but the dhconv
// weight, which the port stores as (2, L, C, O) and the reference as
// (C, O, L, 2)), the flat index of its first element (a rank's shard of a
// leaf split over ranks keeps the whole leaf's indices), and its two salts.
//
// What bounds it on an H100: 20 bytes per element (p read and written, g
// read, two bf16 or float16 moments read and written); the flagship's 572.5 M
// parameters move 11.45 GB, 3.42 ms at 3.35 TB/s. The design spends as few
// instructions and launches per byte as it can:
//   - one launch per update: the wrapper packs one descriptor per non-empty
//     leaf into a table in device memory (one asynchronous copy from
//     page-locked memory), and the kernel walks them all;
//   - a work unit is kUnit consecutive elements of one leaf; `unit0`, the
//     prefix of the leaves' unit counts, maps a unit to its leaf. A grid of
//     two blocks of 256 threads an SM (ops/fused_adam.BLOCKS_PER_SM) strides
//     over the units in order, so each block finds its leaf by moving a
//     cursor forward. The launch bounds leave ptxas up to 128 registers a
//     thread (it takes up to 80): at 64, for four blocks an SM, three
//     instantiations spill and the flagship's update took 10% longer on an
//     H100 (tools/adam_ablation.py);
//   - each thread takes a run of kVec = 8 consecutive elements by 16-byte
//     loads and stores: p and g as two float4 each, a bf16 or float16
//     moment as one 16-byte vector, a float32 moment as two. A leaf's tail
//     shorter than a run, or a leaf whose pointers do not all lie on 16
//     bytes (`vec` 0), goes element by element;
//   - the dither's index is computed once per run, by three multiply-shift
//     divisions whose constants the wrapper computes per leaf; the other
//     seven elements add the innermost index stride (2L for the dhconv
//     weight). A run that crosses the innermost dimension takes the exact
//     per-element formula for each element.
// Nothing is staged in shared memory: every byte is read once and written
// once, and loads and stores are streaming (evict-first), since the 11 GB
// pass cannot reuse the L2 cache.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// elements a thread takes at a time, and a work unit's elements
constexpr uint32_t kVec = 8;
constexpr uint32_t kUnit = kThreads * kVec;

constexpr int kClip = 1;
constexpr int kDirection = 2;

// One non-empty leaf of an update. ops/fused_adam.py's LEAF_DTYPE mirrors it
// field for field. A quotient q = i / d is
//   t = umulhi(i, m), q = (t + ((i - t) >> min(l, 1))) >> max(l - 1, 0)
// with l = ceil(log2 d) and m = floor(2^32 (2^l - d) / d) + 1, exact for
// every 32-bit i (Granlund and Montgomery's unsigned division by an
// invariant integer).
struct LeafDesc {
  uint64_t p, g, mu, nu, dir;   // device addresses; dir 0 outside the direction mode
  uint32_t n;                   // elements (< 2^32)
  uint32_t unit0;               // the leaf's first work unit
  uint32_t s1, m1, l1;          // the second of the four merged sizes, its divider
  uint32_t s2, m2, l2;          // the third
  uint32_t s3, m3, l3;          // the innermost
  uint32_t j0, j1, j2, j3;      // the four dimensions' index strides in the reference's layout
  uint32_t base;                // the flat index of the leaf's first element there
  uint32_t salt_mu, salt_nu;    // the dither's salts of this step's mu and nu
  uint32_t vec;                 // 1 where p, g, mu, nu (and dir) lie on 16 bytes
  uint32_t pad;
};
static_assert(sizeof(LeafDesc) == 120, "LeafDesc must match ops/fused_adam.LEAF_DTYPE");

struct Scalars {
  float lr, bc1, bc2, b1, b2, a1, a2, eps, decay, max_norm, wd;
};

__device__ __forceinline__ uint32_t dither_u16(uint32_t idx, uint32_t salt) {
  uint32_t h = idx * 0x9E3779B1u ^ salt;
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return (h ^ (h >> 16)) & 0xFFFFu;
}

__device__ __forceinline__ uint32_t divide(uint32_t i, uint32_t m, uint32_t l) {
  const uint32_t t = __umulhi(i, m);
  return (t + ((i - t) >> min(l, 1u))) >> (l > 0u ? l - 1u : 0u);
}

// The flat index of the leaf's element i in the reference's layout, and its
// coordinate c3 along the innermost merged dimension.
__device__ __forceinline__ uint32_t ref_index(const LeafDesc& d, uint32_t i, uint32_t& c3) {
  const uint32_t q3 = divide(i, d.m3, d.l3);
  const uint32_t q2 = divide(q3, d.m2, d.l2);
  const uint32_t q1 = divide(q2, d.m1, d.l1);
  c3 = i - q3 * d.s3;
  const uint32_t c2 = q3 - q2 * d.s2;
  const uint32_t c1 = q2 - q1 * d.s1;
  return d.base + q1 * d.j0 + c1 * d.j1 + c2 * d.j2 + c3 * d.j3;
}

// Every byte is read once and written once: streaming (evict-first) loads
// and stores.
template <class T>
__device__ __forceinline__ T load_once(const T* a) {
  return __ldcs(a);
}

template <class T>
__device__ __forceinline__ void store_once(T* a, T v) {
  __stcs(a, v);
}

// moment kinds: 0 float32, 1 bf16 rounded to nearest, 2 bf16 stochastically,
// 3 float16 rounded to nearest
template <int KIND>
struct Moment {
  using T = typename std::conditional<
      KIND == 0, float,
      typename std::conditional<KIND == 3, __half, __nv_bfloat16>::type>::type;

  __device__ static float load(const T* m) {
    if constexpr (KIND == 0)
      return load_once(m);
    else if constexpr (KIND == 3)
      return __half2float(__ushort_as_half(load_once(reinterpret_cast<const unsigned short*>(m))));
    else
      return __uint_as_float(
          static_cast<uint32_t>(load_once(reinterpret_cast<const unsigned short*>(m))) << 16);
  }

  // the 16 bits stored for v (kinds 1-3)
  __device__ static uint32_t bits(float v, uint32_t idx, uint32_t salt) {
    if constexpr (KIND == 1) {
      return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    } else if constexpr (KIND == 3) {
      return __half_as_ushort(__float2half_rn(v));
    } else {
      return ((__float_as_uint(v) + dither_u16(idx, salt)) & 0xFFFF0000u) >> 16;
    }
  }

  __device__ static void store(T* m, float v, uint32_t idx, uint32_t salt) {
    if constexpr (KIND == 0)
      store_once(m, v);
    else
      store_once(reinterpret_cast<unsigned short*>(m), static_cast<unsigned short>(bits(v, idx, salt)));
  }

  // kVec consecutive moments from 16-byte aligned memory
  __device__ static void load8(const T* m, float* out) {
    if constexpr (KIND == 0) {
      const float4 a = load_once(reinterpret_cast<const float4*>(m));
      const float4 b = load_once(reinterpret_cast<const float4*>(m) + 1);
      out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
      out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
    } else {
      const uint4 r = load_once(reinterpret_cast<const uint4*>(m));
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (KIND == 3) {
          out[2 * e] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[e] & 0xFFFFu)));
          out[2 * e + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[e] >> 16)));
        } else {
          out[2 * e] = __uint_as_float(w[e] << 16);
          out[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
        }
      }
    }
  }

  __device__ static void store8(T* m, const float* v, const uint32_t* idx, uint32_t salt) {
    if constexpr (KIND == 0) {
      store_once(reinterpret_cast<float4*>(m), make_float4(v[0], v[1], v[2], v[3]));
      store_once(reinterpret_cast<float4*>(m) + 1, make_float4(v[4], v[5], v[6], v[7]));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = bits(v[2 * e], idx[2 * e], salt) | (bits(v[2 * e + 1], idx[2 * e + 1], salt) << 16);
      store_once(reinterpret_cast<uint4*>(m), make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
};

// One element's update: from its gradient (clipped where the mode clips), p
// and the stored moments, the new p (or direction) and the moments to store.
template <int KIND, int MODE>
__device__ __forceinline__ void update(float gf, float pf, float mu0, float nu0, const Scalars& k,
                                       bool clip, float nrm, float& out, float& m_store,
                                       float& v) {
  if constexpr ((MODE & kClip) != 0) {
    if (clip) gf = __fmul_rn(__fdiv_rn(gf, nrm), k.max_norm);
  }
  const float m = __fmaf_rn(gf, k.a1, __fmul_rn(k.b1, mu0));
  m_store = m;
  if constexpr (KIND == 3) {
    // the reference's float16 graph, as XLA compiles it for the CPU: the
    // stored moments contract the other product, the direction reads m
    m_store = __fmaf_rn(mu0, k.b1, __fmul_rn(k.a1, gf));
    v = __fmaf_rn(nu0, k.b2, __fmul_rn(k.a2, __fmul_rn(gf, gf)));
  } else {
    v = __fmaf_rn(__fmul_rn(gf, gf), k.a2, __fmul_rn(k.b2, nu0));
  }
  const float den = __fmul_rn(k.bc1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), k.eps));
  const float u = __fdiv_rn(m, den);
  if constexpr ((MODE & kDirection) != 0)
    out = __fmaf_rn(k.wd, pf, u);
  else
    out = __fmaf_rn(-u, k.lr, __fmul_rn(pf, k.decay));
}

__device__ __forceinline__ void load8f(const float* src, float* out) {
  const float4 a = load_once(reinterpret_cast<const float4*>(src));
  const float4 b = load_once(reinterpret_cast<const float4*>(src) + 1);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ void store8f(float* dst, const float* v) {
  store_once(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  store_once(reinterpret_cast<float4*>(dst) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

template <int KIND, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
fused_adam_kernel(const LeafDesc* __restrict__ leaves, int n_leaves, uint32_t n_units,
                  const float* __restrict__ norm, Scalars k) {
  using T = typename Moment<KIND>::T;
  float nrm = 0.f;
  bool clip = false;
  if constexpr ((MODE & kClip) != 0) {
    nrm = *norm;
    clip = !(nrm < k.max_norm);
  }
  int leaf = 0;
  for (uint32_t u = blockIdx.x; u < n_units; u += gridDim.x) {
    while (leaf + 1 < n_leaves && leaves[leaf + 1].unit0 <= u) ++leaf;
    const LeafDesc d = leaves[leaf];
    const uint32_t n = d.n;
    const uint32_t i0 = (u - d.unit0) * kUnit + threadIdx.x * kVec;
    if (i0 >= n) continue;
    float* p = reinterpret_cast<float*>(d.p) + i0;
    const float* g = reinterpret_cast<const float*>(d.g) + i0;
    T* mu = reinterpret_cast<T*>(d.mu) + i0;
    T* nu = reinterpret_cast<T*>(d.nu) + i0;
    float* dir = reinterpret_cast<float*>(d.dir) + i0;
    const uint32_t salt_mu = d.salt_mu, salt_nu = d.salt_nu;
    if (d.vec != 0u && n - i0 >= kVec) {
      float pf[kVec], gf[kVec], m0[kVec], v0[kVec], out[kVec], ms[kVec], vs[kVec];
      uint32_t idx[kVec] = {};
      load8f(p, pf);
      load8f(g, gf);
      Moment<KIND>::load8(mu, m0);
      Moment<KIND>::load8(nu, v0);
      if constexpr (KIND == 2) {
        uint32_t c3;
        idx[0] = ref_index(d, i0, c3);
        if (c3 + kVec <= d.s3) {
#pragma unroll
          for (uint32_t e = 1; e < kVec; ++e) idx[e] = idx[0] + e * d.j3;
        } else {
#pragma unroll
          for (uint32_t e = 1; e < kVec; ++e) idx[e] = ref_index(d, i0 + e, c3);
        }
      }
#pragma unroll
      for (uint32_t e = 0; e < kVec; ++e)
        update<KIND, MODE>(gf[e], pf[e], m0[e], v0[e], k, clip, nrm, out[e], ms[e], vs[e]);
      store8f((MODE & kDirection) != 0 ? dir : p, out);
      Moment<KIND>::store8(mu, ms, idx, salt_mu);
      Moment<KIND>::store8(nu, vs, idx, salt_nu);
    } else {
      const uint32_t todo = min(kVec, n - i0);
      for (uint32_t e = 0; e < todo; ++e) {
        float out, ms, vs;
        update<KIND, MODE>(load_once(g + e), load_once(p + e), Moment<KIND>::load(mu + e),
                           Moment<KIND>::load(nu + e), k, clip, nrm, out, ms, vs);
        store_once(((MODE & kDirection) != 0 ? dir : p) + e, out);
        uint32_t c3 = 0, idx = 0;
        if constexpr (KIND == 2) idx = ref_index(d, i0 + e, c3);
        Moment<KIND>::store(mu + e, ms, idx, salt_mu);
        Moment<KIND>::store(nu + e, vs, idx, salt_nu);
      }
    }
  }
}

struct Launch {
  const LeafDesc* leaves;
  int n_leaves;
  uint32_t n_units;
  const float* norm;
  int blocks;
};

template <int KIND, int MODE>
void launch(const Launch& a, const Scalars& k, cudaStream_t s) {
  fused_adam_kernel<KIND, MODE><<<a.blocks, kThreads, 0, s>>>(a.leaves, a.n_leaves, a.n_units,
                                                              a.norm, k);
}

template <int KIND>
void launch_mode(const Launch& a, const Scalars& k, int mode, cudaStream_t s) {
  if (mode == 0)
    launch<KIND, 0>(a, k, s);
  else if (mode == kClip)
    launch<KIND, kClip>(a, k, s);
  else if (mode == kDirection)
    launch<KIND, kDirection>(a, k, s);
  else
    launch<KIND, kClip | kDirection>(a, k, s);
}

}  // namespace

// One update of `n_leaves` leaves, in place. `leaves` is the table of their
// descriptors in device memory, ordered by `unit0`; `n_units` the units of
// all of them (the last leaf's unit0 plus its units), walked by `blocks`
// blocks of 256 threads. kind: 0 float32 moments, 1 bf16 rounded to
// nearest, 2 bf16 stochastically, 3 float16 rounded to nearest. mode: bit 0
// clips g by the float32 global norm at `norm` (device memory) against
// max_norm; bit 1 writes u + wd*p to each leaf's `dir` and leaves p. `norm`
// may be null where its bit is clear. Returns cudaGetLastError().
extern "C" int fused_adam_launch(const void* leaves, int n_leaves, uint32_t n_units, int blocks,
                                 const void* norm, float lr, float bc1, float bc2, float b1,
                                 float b2, float a1, float a2, float eps, float decay,
                                 float max_norm, float wd, int kind, int mode, void* stream) {
  if (n_units == 0u) return static_cast<int>(cudaGetLastError());
  if (mode < 0 || mode > 3 || kind < 0 || kind > 3 || n_leaves <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scalars k{lr, bc1, bc2, b1, b2, a1, a2, eps, decay, max_norm, wd};
  const Launch a{static_cast<const LeafDesc*>(leaves), n_leaves, n_units,
                 static_cast<const float*>(norm), blocks};
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    launch_mode<0>(a, k, mode, s);
  else if (kind == 1)
    launch_mode<1>(a, k, mode, s);
  else if (kind == 2)
    launch_mode<2>(a, k, mode, s);
  else
    launch_mode<3>(a, k, mode, s);
  return static_cast<int>(cudaGetLastError());
}
