// Shared by the w8a8 kernels (matmul_w8a8.cu, matmul_w8a8_q.cu,
// conv3_w8a8.cu): dtype conversions, the fused epilogue activation and a
// 16-byte int8 dot product.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace w8a8 {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// act: 0 none, 1 gelu (tanh form, written as PyTorch's CUDA kernel writes
// it, so the two agree bit for bit), 2 silu, 3 leaky relu 0.2.
__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 1) {
    // sqrt(2) * 2 / sqrt(pi) * 0.5 in double, then rounded to float
    const float k_beta = (float)(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
    const float k_kappa = 0.044715f;
    const float cube = v * v * v;
    const float inner = k_beta * (v + k_kappa * cube);
    return 0.5f * v * (1.f + tanhf(inner));
  }
  if (act == 2) return v / (1.f + expf(-v));
  if (act == 3) return v >= 0.f ? v : 0.2f * v;
  return v;
}

// c + sum of the 16 int8 x int8 products of a and b (int32, exact)
__device__ __forceinline__ int dot16(const int4 a, const int4 b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

// y = acc * (s_x * s_w) + bias (bias may be null), in that association:
// the _rn intrinsics keep nvcc from fusing the two into one FMA.
__device__ __forceinline__ float dequant(int acc, float sx, float sw,
                                         const float* bias, int col) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw));
  return bias ? __fadd_rn(v, bias[col]) : v;
}

}  // namespace w8a8
