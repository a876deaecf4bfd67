// Fused Adam(W) update of one parameter leaf, in place, with bf16 moments
// under counter-hash stochastic rounding.
//
// Replaces the TPU kernel makani_tpu/ops/pallas_adam.py _adam_kernel /
// _fused_leaf_update / fused_adam_apply (:66-186). One pass per element over
// (p f32, g f32, mu, nu):
//   mu' = (1-b1)*g + b1*mu              one fused multiply-add
//   nu' = (1-b2)*(g*g) + b2*nu          one fused multiply-add
//   u   = mu' / (bc1 * (sqrt(nu'/bc2) + eps))
//   p'  = p*decay - lr*u                one fused multiply-add, decay = 1 - lr*wd
//   mu, nu stored with stochastic rounding to bf16, to nearest bf16, or as f32
// The arithmetic is the reference's as XLA compiles it (the same update in
// utils/optimizers.scale_by_adam_lowmem + apply, and pallas_adam's kernel):
// (mu'/bc1)/(sqrt(nu'/bc2)+eps) folded into one division, and each
// multiply-add contracted into one fused multiply-add. Every operation here
// is an explicit round-to-nearest intrinsic, so nothing is contracted or
// approximated beyond that, and the plain twin in ops/fused_adam.py matches
// it bit for bit.
//
// The dither of the stochastic rounding is keyed by the element's flat index
// in the reference's layout of the leaf: the wrapper passes the leaf's last
// three sizes and one index stride per dimension (the identity for every leaf
// but the dhconv weight, which the port stores as (2, L, C, O) and the
// reference as (C, O, L, 2)).
//
// What bounds it on an H100: 20 bytes per element (p read and written, g
// read, two bf16 moments read and written); the flagship's 572.5 M
// parameters move 11.45 GB, 3.42 ms at 3.35 TB/s. A few dozen integer and
// float operations per element stay far below the card's rates, so it is
// bound by bytes. One thread per element, consecutive threads on consecutive
// elements; no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Scalars {
  float lr, bc1, bc2, b1, b2, a1, a2, eps, decay;
  uint32_t salt_mu, salt_nu;
};

__device__ __forceinline__ uint32_t dither_u16(uint32_t idx, uint32_t salt) {
  uint32_t h = idx * 0x9E3779B1u ^ salt;
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return (h ^ (h >> 16)) & 0xFFFFu;
}

// moment kinds: 0 float32, 1 bf16 rounded to nearest, 2 bf16 stochastically
template <int KIND>
struct Moment {
  using T = typename std::conditional<KIND == 0, float, __nv_bfloat16>::type;
  __device__ static float load(const T* m, uint32_t i) {
    if constexpr (KIND == 0)
      return m[i];
    else
      return __bfloat162float(m[i]);
  }
  __device__ static void store(T* m, uint32_t i, float v, uint32_t idx, uint32_t salt) {
    if constexpr (KIND == 0) {
      m[i] = v;
    } else if constexpr (KIND == 1) {
      m[i] = __float2bfloat16_rn(v);
    } else {
      const uint32_t bits = (__float_as_uint(v) + dither_u16(idx, salt)) & 0xFFFF0000u;
      m[i] = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
    }
  }
};

template <int KIND>
__global__ void __launch_bounds__(256)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                  typename Moment<KIND>::T* __restrict__ mu,
                  typename Moment<KIND>::T* __restrict__ nu, uint32_t n, uint32_t s1, uint32_t s2,
                  uint32_t s3, uint32_t j0, uint32_t j1, uint32_t j2, uint32_t j3, Scalars k) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float gf = g[i];
  const float m = __fmaf_rn(gf, k.a1, __fmul_rn(k.b1, Moment<KIND>::load(mu, i)));
  const float v = __fmaf_rn(__fmul_rn(gf, gf), k.a2, __fmul_rn(k.b2, Moment<KIND>::load(nu, i)));
  const float den = __fmul_rn(k.bc1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), k.eps));
  const float u = __fdiv_rn(m, den);
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
    idx = (t / s1) * j0 + c1 * j1 + c2 * j2 + c3 * j3;
  }
  Moment<KIND>::store(mu, i, m, idx, k.salt_mu);
  Moment<KIND>::store(nu, i, v, idx, k.salt_nu);
}

template <int KIND>
void launch(void* p, const void* g, void* mu, void* nu, uint32_t n, uint32_t s1, uint32_t s2,
            uint32_t s3, uint32_t j0, uint32_t j1, uint32_t j2, uint32_t j3, const Scalars& k,
            cudaStream_t s) {
  using T = typename Moment<KIND>::T;
  const unsigned blocks = (n + 255u) / 256u;
  fused_adam_kernel<KIND><<<blocks, 256, 0, s>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<T*>(mu),
      static_cast<T*>(nu), n, s1, s2, s3, j0, j1, j2, j3, k);
}

}  // namespace

// One leaf of n elements (n < 2^32), in place. (s1, s2, s3) are the last
// three sizes of the leaf's shape padded to four dimensions, (j0..j3) the
// index strides of the four dimensions in the reference's layout. kind:
// 0 float32 moments, 1 bf16 rounded to nearest, 2 bf16 stochastically.
// Returns cudaGetLastError().
extern "C" int fused_adam_launch(void* p, const void* g, void* mu, void* nu, uint32_t n,
                                 uint32_t s1, uint32_t s2, uint32_t s3, uint32_t j0, uint32_t j1,
                                 uint32_t j2, uint32_t j3, float lr, float bc1, float bc2,
                                 float b1, float b2, float a1, float a2, float eps, float decay,
                                 uint32_t salt_mu, uint32_t salt_nu, int kind, void* stream) {
  const Scalars k{lr, bc1, bc2, b1, b2, a1, a2, eps, decay, salt_mu, salt_nu};
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (kind == 0)
    launch<0>(p, g, mu, nu, n, s1, s2, s3, j0, j1, j2, j3, k, s);
  else if (kind == 1)
    launch<1>(p, g, mu, nu, n, s1, s2, s3, j0, j1, j2, j3, k, s);
  else
    launch<2>(p, g, mu, nu, n, s1, s2, s3, j0, j1, j2, j3, k, s);
  return static_cast<int>(cudaGetLastError());
}
