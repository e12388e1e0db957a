// Windowed multi-head self-attention: for each window and head,
// softmax(q k^T + relative-position bias [+ shift mask]) v.
//
// Replaces: femasr_tpu/ops/pallas/window_attention.py,
// window_attention_fused / _wattn_kernel. It is the attention core of all
// 24 Swin blocks of the LQ encoder (window 8 -> N = 64 tokens, 8 heads of
// 32, 1089 windows per block for a 512px LR image).
//
// What bounds it on the H100: per (window, head) it reads 3 x 64 x 32
// inputs and writes 64 x 32 outputs (16 KB in bf16) for 2 x 2 x 64 x 64 x
// 32 = 524K FLOP, about 32 FLOP/byte: well below the bf16 ridge, so the
// bound is device memory (~0.04 ms per Swin block at 3.35 TB/s). The
// logits, the bias and mask adds and the softmax never leave the SM.
//
// Design: one block of 256 threads per (window, head). q, k and v for the
// head are staged in shared memory in f32 (rows padded to 33 floats so the
// k reads do not collide on a bank). Four threads own one query row: each
// computes 16 of its 64 logits with q held in registers, adds the bias and
// the mask (indexed by window id mod nW, never tiled in memory), and the
// row max and normalizer are combined across the four lanes with warp
// shuffles. Logits, softmax and the normalizer are f32. The probabilities
// go to shared memory and each thread then produces 8 output features of
// its row. q is pre-scaled by the caller. Token strides are arguments so q,
// k and v may be column slices of one packed qkv tensor.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int N = 64;
constexpr int HD = 32;
constexpr int NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT) wattn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask,
    T* __restrict__ out, int nw, long ldq, long ldk, long ldv, long ldo) {
  __shared__ float sq[N][HD + 1];
  __shared__ float sk[N][HD + 1];
  __shared__ float sv[N][HD];
  __shared__ float sp[N][N + 1];

  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const size_t tok0 = (size_t)win * N;

  for (int i = t; i < N * HD; i += NT) {
    const int n = i / HD;
    const int d = i % HD;
    sq[n][d] = to_f(q[(tok0 + n) * ldq + h * HD + d]);
    sk[n][d] = to_f(k[(tok0 + n) * ldk + h * HD + d]);
    sv[n][d] = to_f(v[(tok0 + n) * ldv + h * HD + d]);
  }
  __syncthreads();

  const int row = t >> 2;
  const int lane4 = t & 3;
  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = sq[row][d];

  const float* brow = bias + ((size_t)h * N + row) * N;
  const float* mrow = mask ? mask + ((size_t)(win % nw) * N + row) * N : nullptr;
  float lg[16];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int j = lane4 + 4 * m;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(qr[d], sk[j][d], s);
    s += brow[j];
    if (mrow) s += mrow[j];
    lg[m] = s;
    mx = fmaxf(mx, s);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    lg[m] = expf(lg[m] - mx);
    sum += lg[m];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
  for (int m = 0; m < 16; ++m) sp[row][lane4 + 4 * m] = lg[m] / sum;
  __syncthreads();

  const int d0 = lane4 * 8;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int j = 0; j < N; ++j) {
    const float pj = sp[row][j];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(pj, sv[j][d0 + e], acc[e]);
  }
  T* op = out + (tok0 + row) * ldo + h * HD + d0;
#pragma unroll
  for (int e = 0; e < 8; ++e) op[e] = from_f<T>(acc[e]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const float* mask, void* out, int nwin, int nh, int nw, long ldq,
           long ldk, long ldv, long ldo, cudaStream_t stream) {
  dim3 grid(nwin, nh);
  wattn_kernel<T><<<grid, NT, 0, stream>>>((const T*)q, (const T*)k,
                                           (const T*)v, bias, mask, (T*)out,
                                           nw, ldq, ldk, ldv, ldo);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out: (nwin, 64, nh*32) with token strides ldq/ldk/ldv/ldo (elements)
// and unit feature stride. bias: (nh, 64, 64) f32. mask: (nw, 64, 64) f32 or
// null; window b uses mask[b % nw]. dtype: 0 = float32, 1 = bfloat16.
extern "C" int femasr_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* mask, void* out, int nwin,
                                       int n, int nh, int hd, int nw, long ldq,
                                       long ldk, long ldv, long ldo, int dtype,
                                       void* stream) {
  if (n != N || hd != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, (const float*)bias, (const float*)mask, out,
                         nwin, nh, nw, ldq, ldk, ldv, ldo, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, (const float*)bias,
                                 (const float*)mask, out, nwin, nh, nw, ldq,
                                 ldk, ldv, ldo, s);
  return (int)cudaErrorInvalidValue;
}
