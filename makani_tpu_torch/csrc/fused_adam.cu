// Fused Adam(W) update of one parameter leaf, in place, with bf16 moments
// under counter-hash stochastic rounding (or float32, or float16 moments).
//
// Replaces the TPU kernel makani_tpu/ops/pallas_adam.py _adam_kernel /
// _fused_leaf_update / fused_adam_apply (:66-186). One pass per element over
// (p f32, g f32, mu, nu):
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
// in the reference's layout of the leaf: the wrapper passes the leaf's last
// three sizes and one index stride per dimension (the identity for every leaf
// but the dhconv weight, which the port stores as (2, L, C, O) and the
// reference as (C, O, L, 2)), and the flat index of the leaf's first element
// (a rank's shard of a leaf split over ranks keeps the whole leaf's indices).
//
// What bounds it on an H100: 20 bytes per element (p read and written, g
// read, two bf16 or float16 moments read and written); the flagship's 572.5 M
// parameters move 11.45 GB, 3.42 ms at 3.35 TB/s. A few dozen integer and
// float operations per element stay far below the card's rates, so it is
// bound by bytes. One thread per element, consecutive threads on consecutive
// elements; no shared memory. The direction mode moves 4 more bytes per
// element (dir written) and 4 fewer (p not written back).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Scalars {
  float lr, bc1, bc2, b1, b2, a1, a2, eps, decay, max_norm, wd;
  uint32_t salt_mu, salt_nu;
};

constexpr int kClip = 1;
constexpr int kDirection = 2;

__device__ __forceinline__ uint32_t dither_u16(uint32_t idx, uint32_t salt) {
  uint32_t h = idx * 0x9E3779B1u ^ salt;
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return (h ^ (h >> 16)) & 0xFFFFu;
}

// moment kinds: 0 float32, 1 bf16 rounded to nearest, 2 bf16 stochastically,
// 3 float16 rounded to nearest
template <int KIND>
struct Moment {
  using T = typename std::conditional<
      KIND == 0, float,
      typename std::conditional<KIND == 3, __half, __nv_bfloat16>::type>::type;
  __device__ static float load(const T* m, uint32_t i) {
    if constexpr (KIND == 0)
      return m[i];
    else if constexpr (KIND == 3)
      return __half2float(m[i]);
    else
      return __bfloat162float(m[i]);
  }
  __device__ static void store(T* m, uint32_t i, float v, uint32_t idx, uint32_t salt) {
    if constexpr (KIND == 0) {
      m[i] = v;
    } else if constexpr (KIND == 1) {
      m[i] = __float2bfloat16_rn(v);
    } else if constexpr (KIND == 3) {
      m[i] = __float2half_rn(v);
    } else {
      const uint32_t bits = (__float_as_uint(v) + dither_u16(idx, salt)) & 0xFFFF0000u;
      m[i] = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
    }
  }
};

template <int KIND, int MODE>
__global__ void __launch_bounds__(256)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                  typename Moment<KIND>::T* __restrict__ mu,
                  typename Moment<KIND>::T* __restrict__ nu, float* __restrict__ dir,
                  const float* __restrict__ norm, uint32_t n, uint32_t s1, uint32_t s2,
                  uint32_t s3, uint32_t j0, uint32_t j1, uint32_t j2, uint32_t j3,
                  uint32_t base, Scalars k) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float gf = g[i];
  if constexpr ((MODE & kClip) != 0) {
    const float nrm = *norm;
    if (!(nrm < k.max_norm)) gf = __fmul_rn(__fdiv_rn(gf, nrm), k.max_norm);
  }
  const float mu0 = Moment<KIND>::load(mu, i), nu0 = Moment<KIND>::load(nu, i);
  const float m = __fmaf_rn(gf, k.a1, __fmul_rn(k.b1, mu0));
  float m_store = m, v;
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
    dir[i] = __fmaf_rn(k.wd, p[i], u);
  else
    p[i] = __fmaf_rn(-u, k.lr, __fmul_rn(p[i], k.decay));
  uint32_t idx = i;
  if constexpr (KIND == 2) {
    // flat index of the element in the reference's layout
    uint32_t t = i;
    const uint32_t c3 = t % s3;
    t /= s3;
    const uint32_t c2 = t % s2;
    t /= s2;
    const uint32_t c1 = t % s1;
    idx = base + (t / s1) * j0 + c1 * j1 + c2 * j2 + c3 * j3;
  }
  Moment<KIND>::store(mu, i, m_store, idx, k.salt_mu);
  Moment<KIND>::store(nu, i, v, idx, k.salt_nu);
}

struct Leaf {
  void* p;
  const void* g;
  void* mu;
  void* nu;
  void* dir;
  const void* norm;
  uint32_t n, s1, s2, s3, j0, j1, j2, j3, base;
};

template <int KIND, int MODE>
void launch(const Leaf& a, const Scalars& k, cudaStream_t s) {
  using T = typename Moment<KIND>::T;
  const unsigned blocks = (a.n + 255u) / 256u;
  fused_adam_kernel<KIND, MODE><<<blocks, 256, 0, s>>>(
      static_cast<float*>(a.p), static_cast<const float*>(a.g), static_cast<T*>(a.mu),
      static_cast<T*>(a.nu), static_cast<float*>(a.dir), static_cast<const float*>(a.norm),
      a.n, a.s1, a.s2, a.s3, a.j0, a.j1, a.j2, a.j3, a.base, k);
}

template <int KIND>
void launch_mode(const Leaf& a, const Scalars& k, int mode, cudaStream_t s) {
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

// One leaf of n elements (n < 2^32), in place. (s1, s2, s3) are the last
// three sizes of the leaf's shape padded to four dimensions, (j0..j3) the
// index strides of the four dimensions in the reference's layout, `base` the
// flat index of the leaf's first element there (0 but for a shard of a leaf
// split over ranks, whose indices are those of the whole leaf). kind:
// 0 float32 moments, 1 bf16 rounded to nearest, 2 bf16 stochastically,
// 3 float16 rounded to nearest.
// mode: bit 0 clips g by the float32 global norm at `norm` (device memory)
// against max_norm; bit 1 writes u + wd*p to `dir` (n float32) and leaves p.
// `dir` and `norm` may be null where their bit is clear. Returns
// cudaGetLastError().
extern "C" int fused_adam_launch(void* p, const void* g, void* mu, void* nu, void* dir,
                                 const void* norm, uint32_t n, uint32_t s1, uint32_t s2,
                                 uint32_t s3, uint32_t j0, uint32_t j1, uint32_t j2, uint32_t j3,
                                 uint32_t base, float lr, float bc1, float bc2, float b1, float b2, float a1,
                                 float a2, float eps, float decay, float max_norm, float wd,
                                 uint32_t salt_mu, uint32_t salt_nu, int kind, int mode,
                                 void* stream) {
  const Scalars k{lr, bc1, bc2, b1, b2, a1, a2, eps, decay, max_norm, wd, salt_mu, salt_nu};
  const Leaf a{p, g, mu, nu, dir, norm, n, s1, s2, s3, j0, j1, j2, j3, base};
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (mode < 0 || mode > 3 || kind < 0 || kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
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
