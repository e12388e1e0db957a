// w8a8 dense with a per-tensor activation scale:
//   y[m, n] = act(acc[m, n] * (s_x * s_w[n]) + bias[n]),
//   acc = sum_k round(x[m, k] / s_x) * w_q[n, k]   (int8 x int8 -> int32)
//
// Replaces: femasr_tpu/ops/pallas/int8_dense.py, matmul_w8a8 / _mm_kernel.
// On the main path of the int8 serving lane it runs the Swin qkv (256->768)
// and proj (256->256) linears of all 24 blocks: 69,696 tokens for a 512px
// LR image.
//
// What bounds it on the H100: qkv moves 69,696 x (256 + 768) bf16 values
// (143 MB, ~0.043 ms at 3.35 TB/s) for 27 GOP, about 190 int8 operations
// per byte, far below the 1979 TOPS / 3.35 TB/s ridge (~590), so an int8
// tensor-core kernel would be bound by device memory. This first version
// multiplies with __dp4a on the CUDA cores (4 int8 MACs per instruction,
// roughly 130 TOPS), so it is bound by those operations; mma.sync / wgmma
// s8 is later work.
//
// Design: one block owns BM = 32 rows and stages them ONCE, quantized, in
// shared memory (the whole K extent, round-half-even of a true IEEE
// division, as jnp.round(x / s_x)), so each activation is read from device
// memory exactly once. It then sweeps the output columns in 128-wide tiles;
// the int8 weights (N, K) (quantized by the wrapper) are staged in 64-byte
// K chunks. Each thread owns a 4 row x 4 column register tile of int32
// sums and reads 16 bytes of each operand per step (LDS.128, row strides
// padded to keep a quarter-warp's loads on distinct banks). The epilogue
// keeps the reference's association, acc * (s_x * s_w[n]) then + bias,
// with _rn intrinsics so nvcc cannot fuse them into one FMA.

#include "w8a8_common.cuh"

namespace {

constexpr int BM = 32;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int WS = BK + 16;  // weight tile row stride in bytes

using namespace w8a8;

template <typename T>
__global__ void __launch_bounds__(NT) mm_w8a8_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ y, int M, int N, int K,
    int Kp, int act) {
  extern __shared__ __align__(16) int8_t smem[];
  const int XS = Kp + 16;
  int8_t* xs = smem;            // [BM][XS]
  int8_t* ws = smem + BM * XS;  // [BN][WS]
  const int m0 = blockIdx.x * BM;
  const int t = threadIdx.x;
  const float s = *sx;

  for (int i = t; i < BM * Kp; i += NT) {
    const int r = i / Kp;
    const int k = i - r * Kp;
    const int m = m0 + r;
    int q = 0;
    if (m < M && k < K) q = __float2int_rn(__fdiv_rn(to_f(x[(size_t)m * K + k]), s));
    xs[r * XS + k] = (int8_t)q;
  }

  const int tx = t & 31;
  const int ty = t >> 5;
  for (int n0 = 0; n0 < N; n0 += BN) {
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < Kp; k0 += BK) {
      for (int i = t; i < BN * BK; i += NT) {
        const int c = i / BK;
        const int k = i - c * BK;
        const int n = n0 + c;
        const int gk = k0 + k;
        ws[c * WS + k] = (n < N && gk < K) ? wq[(size_t)n * K + gk] : (int8_t)0;
      }
      __syncthreads();
      const int kend = min(BK, Kp - k0);
      for (int kk = 0; kk < kend; kk += 16) {
        int4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const int4*>(xs + (ty + 8 * i) * XS + k0 + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const int4*>(ws + (tx + 32 * j) * WS + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot16(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 32 * j;
        if (n >= N) continue;
        y[(size_t)m * N + n] = from_f<T>(act_fn(dequant(acc[i][j], s, sw[n], bias, n), act));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const int8_t* wq, const float* sx, const float* sw,
           const float* bias, void* y, int M, int N, int K, int act,
           cudaStream_t stream) {
  const int Kp = (K + 15) / 16 * 16;
  const size_t smem = (size_t)BM * (Kp + 16) + (size_t)BN * WS;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mm_w8a8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + BM - 1) / BM);
  mm_w8a8_kernel<T><<<grid, NT, smem, stream>>>((const T*)x, wq, sx, sw, bias,
                                                 (T*)y, M, N, K, Kp, act);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). x: (M, K); wq: (N, K) int8;
// sx: one f32 on the device; sw: (N,) f32; bias: (N,) f32 or null;
// y: (M, N). act: 0 none, 1 gelu(tanh), 2 silu, 3 lrelu.
extern "C" int femasr_matmul_w8a8(const void* x, const void* wq, const void* sx,
                                  const void* sw, const void* bias, void* y,
                                  int M, int N, int K, int act, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, (const int8_t*)wq, (const float*)sx, (const float*)sw,
                         (const float*)bias, y, M, N, K, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, (const int8_t*)wq, (const float*)sx,
                                 (const float*)sw, (const float*)bias, y, M, N, K,
                                 act, s);
  return (int)cudaErrorInvalidValue;
}
