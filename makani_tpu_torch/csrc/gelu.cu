// GELU (tanh form) on bf16 activations, forward and gradient, one pass each.
//
// The forward is jax.nn.gelu on a bf16 input as XLA runs it, step by step:
//   y = x * (0.5 * (1 + tanh(s * (x + c * ((x * x) * x)))))
// with s = sqrt(2/pi) and c = 0.044715 rounded to bf16, and every one of the
// nine operations rounded to bf16 (to nearest even). The plain twin in
// ops/gelu.py is that chain of nine eager bf16 operations, each computed in
// float32 and rounded. Here each multiply and add is one bf16x2 instruction
// (the _rn forms, which the compiler does not contract into an fma),
// rounded once: a product or sum of two bf16 values is exact in float32
// (or, past a 16-bit exponent gap, rounds to the larger operand either way),
// so one rounding gives the twin's bits. The exception is a product below
// float32's normal range (under 2^-126), which float32 rounds first; such a
// product of an activation with itself or its gradient moves no result of
// a normal size. tanh is tanhf in float32, the one PyTorch's float tanh
// calls on the card, rounded to bf16.
//
// The gradient is jax.nn.gelu's VJP on bf16 as JAX builds it (its jaxpr),
// from the saved x and the incoming gradient g, again every operation
// rounded to bf16:
//   p = x x,  t = tanh(s (x + c (p x))),  l = 0.5 (1 + t)
//   a = (0.5 (x g)) (1 - t),  r = s (a + a t)
//   dx = (g l + r) + (c r) (3 p)
// The forward's values are recomputed from x rather than saved. The plain
// twin is the same chain of eager bf16 operations.
//
// What bounds it on an H100: bytes. The forward reads 2 and writes 2 bytes an
// element, the gradient reads 4 and writes 2; a dozen bf16x2 instructions a
// pair and one tanhf an element stay below the card's instruction rate. Each
// thread takes 8 consecutive elements as one 16-byte load and store where
// every pointer is 16-byte aligned, else element by element (the same
// arithmetic on a pair holding the element twice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 256;

using bf2 = __nv_bfloat162;

// a pair of bf16 values, each rounded from its float32 tanh
__device__ __forceinline__ bf2 tanh2(bf2 u) {
  const float2 f = __bfloat1622float2(u);
  return __floats2bfloat162_rn(tanhf(f.x), tanhf(f.y));
}

// jax.nn.gelu's constants as bf16 rounds them: sqrt(2/pi) and 0.044715
__device__ __forceinline__ bf2 k_s() { return __float2bfloat162_rn(0.796875f); }
__device__ __forceinline__ bf2 k_c() { return __float2bfloat162_rn(0.044677734375f); }
__device__ __forceinline__ bf2 k(float v) { return __float2bfloat162_rn(v); }

__device__ __forceinline__ bf2 gelu2(bf2 x) {
  const bf2 v = __hadd2_rn(x, __hmul2_rn(__hmul2_rn(__hmul2_rn(x, x), x), k_c()));
  const bf2 t = tanh2(__hmul2_rn(v, k_s()));
  return __hmul2_rn(x, __hmul2_rn(__hadd2_rn(t, k(1.0f)), k(0.5f)));
}

__device__ __forceinline__ bf2 gelu_grad2(bf2 x, bf2 g) {
  const bf2 p = __hmul2_rn(x, x);
  const bf2 t = tanh2(__hmul2_rn(__hadd2_rn(x, __hmul2_rn(__hmul2_rn(p, x), k_c())), k_s()));
  const bf2 l = __hmul2_rn(__hadd2_rn(t, k(1.0f)), k(0.5f));
  const bf2 a = __hmul2_rn(__hmul2_rn(__hmul2_rn(x, g), k(0.5f)), __hsub2_rn(k(1.0f), t));
  const bf2 r = __hmul2_rn(__hadd2_rn(a, __hmul2_rn(a, t)), k_s());
  return __hadd2_rn(__hadd2_rn(__hmul2_rn(g, l), r), __hmul2_rn(__hmul2_rn(r, k_c()), __hmul2_rn(p, k(3.0f))));
}

union Pack {
  uint4 v;
  bf2 e[kVec / 2];
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, int n) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  if (VEC && i0 + kVec <= n) {
    Pack in, out;
    in.v = *reinterpret_cast<const uint4*>(x + i0);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) out.e[k] = gelu2(in.e[k]);
    *reinterpret_cast<uint4*>(y + i0) = out.v;
    return;
  }
  for (int64_t i = i0; i < i0 + kVec && i < n; ++i) y[i] = gelu2(__bfloat162bfloat162(x[i])).x;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gelu_bf16_grad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                      __nv_bfloat16* __restrict__ dx, int n) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  if (VEC && i0 + kVec <= n) {
    Pack xs, gs, out;
    xs.v = *reinterpret_cast<const uint4*>(x + i0);
    gs.v = *reinterpret_cast<const uint4*>(g + i0);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) out.e[k] = gelu_grad2(xs.e[k], gs.e[k]);
    *reinterpret_cast<uint4*>(dx + i0) = out.v;
    return;
  }
  for (int64_t i = i0; i < i0 + kVec && i < n; ++i)
    dx[i] = gelu_grad2(__bfloat162bfloat162(x[i]), __bfloat162bfloat162(g[i])).x;
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15u) == 0;
}

unsigned blocks_for(int n) {
  return static_cast<unsigned>((static_cast<int64_t>(n) + kVec * kThreads - 1) / (kVec * kThreads));
}

}  // namespace

// x, y: n contiguous bf16 elements; n >= 1 (the wrapper launches nothing
// for an empty tensor)
extern "C" int gelu_bf16_launch(const void* x, void* y, int n, void* stream_ptr) {
  if (n < 1) return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (aligned16(x, y, y))
    gelu_bf16_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(xp, yp, n);
  else
    gelu_bf16_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(xp, yp, n);
  return cudaGetLastError();
}

// x, g, dx: n contiguous bf16 elements each; n >= 1
extern "C" int gelu_bf16_grad_launch(const void* x, const void* g, void* dx, int n,
                                     void* stream_ptr) {
  if (n < 1) return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  auto* dp = static_cast<__nv_bfloat16*>(dx);
  if (aligned16(x, g, dx))
    gelu_bf16_grad_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(xp, gp, dp, n);
  else
    gelu_bf16_grad_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(xp, gp, dp, n);
  return cudaGetLastError();
}
