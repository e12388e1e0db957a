// SiLU and tanh-GELU of a bfloat16 tensor, rounded where the JAX package
// rounds:
//   silu(x) = x * (1 / (1 + exp(-x)))
//   gelu(x) = x * (0.5 * (1 + tanh(c2 * (x + c1 * ((x * x) * x)))))
// with c1 = bf16(0.044715) and c2 = bf16(sqrt(2 / pi)), every op rounded
// to bf16 (round to nearest even), as XLA evaluates jax.nn.silu and
// jax.nn.gelu(approximate=True) in bf16.
//
// Not the port of a TPU kernel: the JAX package leaves these activations
// to XLA (femasr_tpu/ops/layers.py ActLayer, femasr_tpu/ops/swin.py Mlp).
// The port's plain version (femasr_torch/kernels/act_bf16.py) runs the
// same sequence as one PyTorch op per step, a pass over the tensor each;
// this kernel does the whole sequence in one pass.
//
// What bounds it on the H100: by bytes, 4 a value (one bf16 read, one
// write): the Swin MLP's GELU over 69,696 x 1024 values moves 285 MB,
// ~0.085 ms at 3.35 TB/s. But each value takes up to nine roundings to
// bf16, and a float -> bf16 conversion issues at a fraction of the f32
// rate, so the conversions bound it: rounded one value at a time, GELU
// took 2.1x F.gelu's time on the card, and rounded in pairs (one
// cvt.rn.bf16x2.f32 for two values) 1.3x. Each thread handles eight
// values per 16-byte load and store; the steps use the _rn intrinsics,
// expf, tanhf and the correctly rounded reciprocal (no fast-math), so no
// step is fused with the next and each one rounds as PyTorch's own bf16
// op rounds on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float silu(float x) {
  const float e = rb(expf(-x));
  const float d = rb(__fadd_rn(1.f, e));
  const float r = rb(__frcp_rn(d));
  return rb(__fmul_rn(x, r));
}

__device__ __forceinline__ float gelu(float x) {
  const float c1 = 0.044677734375f;  // bf16(0.044715)
  const float c2 = 0.796875f;        // bf16(sqrt(2 / pi))
  float v = rb(__fmul_rn(x, x));
  v = rb(__fmul_rn(v, x));
  v = rb(__fmul_rn(c1, v));
  v = rb(__fadd_rn(x, v));
  v = rb(__fmul_rn(c2, v));
  v = rb(tanhf(v));
  v = rb(__fadd_rn(1.f, v));
  v = rb(__fmul_rn(0.5f, v));
  return rb(__fmul_rn(x, v));
}

template <int ACT>
__device__ __forceinline__ __nv_bfloat16 act1(__nv_bfloat16 v) {
  const float x = __bfloat162float(v);
  return __float2bfloat16_rn(ACT == 0 ? silu(x) : gelu(x));
}

// Two values at a time: the same steps, each pair of results rounded by
// one cvt.rn.bf16x2.f32
__device__ __forceinline__ float2 rb2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ __nv_bfloat162 silu2(float2 x) {
  const float2 e = rb2(expf(-x.x), expf(-x.y));
  const float2 d = rb2(__fadd_rn(1.f, e.x), __fadd_rn(1.f, e.y));
  const float2 r = rb2(__frcp_rn(d.x), __frcp_rn(d.y));
  return __floats2bfloat162_rn(__fmul_rn(x.x, r.x), __fmul_rn(x.y, r.y));
}

__device__ __forceinline__ __nv_bfloat162 gelu2(float2 x) {
  const float c1 = 0.044677734375f;  // bf16(0.044715)
  const float c2 = 0.796875f;        // bf16(sqrt(2 / pi))
  float2 v = rb2(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
  v = rb2(__fmul_rn(v.x, x.x), __fmul_rn(v.y, x.y));
  v = rb2(__fmul_rn(c1, v.x), __fmul_rn(c1, v.y));
  v = rb2(__fadd_rn(x.x, v.x), __fadd_rn(x.y, v.y));
  v = rb2(__fmul_rn(c2, v.x), __fmul_rn(c2, v.y));
  v = rb2(tanhf(v.x), tanhf(v.y));
  v = rb2(__fadd_rn(1.f, v.x), __fadd_rn(1.f, v.y));
  v = rb2(__fmul_rn(0.5f, v.x), __fmul_rn(0.5f, v.y));
  return __floats2bfloat162_rn(__fmul_rn(x.x, v.x), __fmul_rn(x.y, v.y));
}

template <int ACT>
__device__ __forceinline__ __nv_bfloat162 act2(__nv_bfloat162 v) {
  const float2 x = __bfloat1622float2(v);
  return ACT == 0 ? silu2(x) : gelu2(x);
}

// VEC: eight values per 16-byte load and store (both pointers 16-byte
// aligned); the n % 8 values past the last full vector go one by one.
template <int ACT, bool VEC>
__global__ void __launch_bounds__(NT) act_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
    long long n) {
  const long long stride = (long long)gridDim.x * NT;
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (VEC) {
    const long long nv = n / 8;
    for (long long j = i; j < nv; j += stride) {
      uint4 u = reinterpret_cast<const uint4*>(x)[j];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = act2<ACT>(h[k]);
      reinterpret_cast<uint4*>(y)[j] = u;
    }
    i += nv * 8;
  }
  for (; i < n; i += stride) y[i] = act1<ACT>(x[i]);
}

template <int ACT>
int launch(const __nv_bfloat16* x, __nv_bfloat16* y, long long n,
           cudaStream_t stream) {
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long items = vec ? (n + 7) / 8 : n;
  // enough blocks to fill the card several times over; the loop strides
  const long long blocks = (items + NT - 1) / NT;
  const int grid = (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1)
                                           : 132 * 16);
  if (vec)
    act_bf16_kernel<ACT, true><<<grid, NT, 0, stream>>>(x, y, n);
  else
    act_bf16_kernel<ACT, false><<<grid, NT, 0, stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n bfloat16 values each; act: 0 silu, 1 gelu (tanh form).
extern "C" int femasr_act_bf16(const void* x, void* y, long long n, int act,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  __nv_bfloat16* yb = (__nv_bfloat16*)y;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (act == 0) return launch<0>(xb, yb, n, s);
  if (act == 1) return launch<1>(xb, yb, n, s);
  return (int)cudaErrorInvalidValue;
}
