// Per-token w8a8 dense, one link of the int8 chain:
//   y[m, n] = act(acc[m, n] * (s_x[m] * s_w[n]) + bias[n]),
//   acc = sum_k x_q[m, k] * w_q[n, k]   (int8 x int8 -> int32)
// emitted either as out_dtype, or (out_int8) re-quantized per row:
//   s_y[m] = max(max_n |y[m, n]| / 127, 1e-12), y_q = round(y / s_y[m]).
//
// Replaces: femasr_tpu/ops/pallas/int8_dense.py, matmul_w8a8_q /
// _mm_q_kernel. On the main path of the int8 serving lane it runs the Swin
// MLP of all 24 blocks: fc1 (256 -> 1024, GELU, int8 out) and fc2
// (1024 -> 256, model-dtype out) over 69,696 tokens of a 512px LR image.
//
// What bounds it on the H100: fc1 moves 69,696 x (256 + 1024) int8 bytes
// plus row scales (90 MB, ~0.027 ms at 3.35 TB/s) for 36.5 GOP, ~400 int8
// operations per byte: below the tensor cores' ridge, so a tensor-core
// kernel would be bound by device memory. This first version multiplies
// with __dp4a on the CUDA cores, so it is bound by those operations.
//
// Design: as csrc/matmul_w8a8.cu (one block stages its rows' whole K extent
// once; 128-column tiles; 4x4 register tiles of int32 sums; 16-byte shared
// loads), with per-row scales in the epilogue. With out_int8 a block owns
// whole rows (BM = 16) and keeps their f32 results for all N <= 1024
// columns in shared memory; after the last column tile one warp per row
// takes the row's max |y|, writes the row scale and the re-quantized codes
// (round-half-even of a true division, as jnp.round(y / s)).

#include "w8a8_common.cuh"

namespace {

constexpr int BN = 128;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int WS = BK + 16;  // weight tile row stride in bytes

using namespace w8a8;

// RI rows per thread: BM = 8 * RI rows per block. OUT_INT8 keeps the
// block's (BM, N) f32 results in shared memory for the per-row requantize.
template <typename T, int RI, bool OUT_INT8>
__global__ void __launch_bounds__(NT) mm_w8a8_q_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const int8_t* __restrict__ wq, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ y,
    int8_t* __restrict__ yq, float* __restrict__ sy, int M, int N, int K,
    int Kp, int act) {
  constexpr int BM = 8 * RI;
  extern __shared__ __align__(16) int8_t smem[];
  const int XS = Kp + 16;
  int8_t* xs = smem;                                      // [BM][XS]
  int8_t* ws = smem + BM * XS;                            // [BN][WS]
  float* yb = reinterpret_cast<float*>(ws + BN * WS);     // [BM][N]
  const int m0 = blockIdx.x * BM;
  const int t = threadIdx.x;

  for (int i = t; i < BM * Kp; i += NT) {
    const int r = i / Kp;
    const int k = i - r * Kp;
    const int m = m0 + r;
    xs[r * XS + k] = (m < M && k < K) ? xq[(size_t)m * K + k] : (int8_t)0;
  }

  const int tx = t & 31;
  const int ty = t >> 5;
  for (int n0 = 0; n0 < N; n0 += BN) {
    int acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
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
        int4 a[RI], b[4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          a[i] = *reinterpret_cast<const int4*>(xs + (ty + 8 * i) * XS + k0 + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const int4*>(ws + (tx + 32 * j) * WS + kk);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot16(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 8 * i;
      const int m = m0 + r;
      if (m >= M) continue;
      const float sxm = sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 32 * j;
        if (n >= N) continue;
        const float v = act_fn(dequant(acc[i][j], sxm, sw[n], bias, n), act);
        if (OUT_INT8) yb[r * N + n] = v;
        else y[(size_t)m * N + n] = from_f<T>(v);
      }
    }
  }

  if (OUT_INT8) {
    __syncthreads();
    const int warp = t >> 5;
    const int lane = t & 31;
    for (int r = warp; r < BM; r += NT / 32) {
      const int m = m0 + r;
      if (m >= M) continue;
      float mx = 0.f;
      for (int c = lane; c < N; c += 32) mx = fmaxf(mx, fabsf(yb[r * N + c]));
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float sc = fmaxf(__fdiv_rn(mx, 127.f), 1e-12f);
      if (lane == 0) sy[m] = sc;
      for (int c = lane; c < N; c += 32)
        yq[(size_t)m * N + c] = (int8_t)__float2int_rn(__fdiv_rn(yb[r * N + c], sc));
    }
  }
}

template <typename T, int RI, bool OUT_INT8>
int launch(const int8_t* xq, const float* sx, const int8_t* wq, const float* sw,
           const float* bias, void* y, int8_t* yq, float* sy, int M, int N,
           int K, int act, cudaStream_t stream) {
  constexpr int BM = 8 * RI;
  const int Kp = (K + 15) / 16 * 16;
  size_t smem = (size_t)BM * (Kp + 16) + (size_t)BN * WS;
  if (OUT_INT8) smem += (size_t)BM * N * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mm_w8a8_q_kernel<T, RI, OUT_INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + BM - 1) / BM);
  mm_w8a8_q_kernel<T, RI, OUT_INT8><<<grid, NT, smem, stream>>>(
      xq, sx, wq, sw, bias, (T*)y, yq, sy, M, N, K, Kp, act);
  return (int)cudaGetLastError();
}

}  // namespace

// xq: (M, K) int8; sx: (M,) f32 row scales; wq: (N, K) int8; sw: (N,) f32;
// bias: (N,) f32 or null. out_int8 = 0: y is (M, N) in dtype (0 float32,
// 1 bfloat16); out_int8 = 1: yq (M, N) int8 and sy (M,) f32 (N <= 1024
// keeps the block's rows in shared memory). act: 0 none, 1 gelu(tanh),
// 2 silu, 3 lrelu.
extern "C" int femasr_matmul_w8a8_q(const void* xq, const void* sx, const void* wq,
                                    const void* sw, const void* bias, void* y,
                                    void* yq, void* sy, int M, int N, int K,
                                    int act, int out_int8, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* x8 = (const int8_t*)xq;
  const int8_t* w8 = (const int8_t*)wq;
  const float* sxf = (const float*)sx;
  const float* swf = (const float*)sw;
  const float* bf = (const float*)bias;
  if (out_int8)
    return launch<float, 2, true>(x8, sxf, w8, swf, bf, nullptr, (int8_t*)yq,
                                  (float*)sy, M, N, K, act, s);
  if (dtype == 0)
    return launch<float, 4, false>(x8, sxf, w8, swf, bf, y, nullptr, nullptr, M,
                                   N, K, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 4, false>(x8, sxf, w8, swf, bf, y, nullptr,
                                           nullptr, M, N, K, act, s);
  return (int)cudaErrorInvalidValue;
}
