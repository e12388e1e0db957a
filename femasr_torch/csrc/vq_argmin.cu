// Codebook nearest-neighbour search: idx[n] = argmin_k ||c_k||^2 - 2 z_n.c_k
// in true f32 (FFMA, no TF32), first minimum wins ties.
//
// Replaces: femasr_tpu/ops/pallas/vq.py, vq_argmin / _vq_argmin_chunk /
// _vq_kernel. On the main path it searches the 1024 x 512 codebook for the
// 69,696 tokens of a 512px LR image.
//
// What bounds it on the H100: it is a (N x C) . (C x K) product with an
// argmin over K folded in: 2*N*K*C = 73 GFLOP for 142 MB of tokens, about
// 500 FLOP/byte. Exact f32 rules out the tensor cores (TF32 would flip
// near-tie indices), so the bound is the CUDA cores' 67 TFLOP/s fp32,
// about 1.1 ms.
//
// Design: a first kernel computes ||c_k||^2 (one thread per code, in index
// order). The search kernel gives each block 64 tokens and sweeps the whole
// codebook inside the block in 64-code tiles, so the (N, K) distance
// matrix never exists anywhere: each thread owns a 4 token x 4 code
// register tile of dot products, accumulated over C in 16-wide chunks
// staged (transposed) in shared memory, then folds it into a running
// (min, idx) per token. Codes are visited in increasing order and only a
// strictly smaller distance replaces the running minimum; the final
// reduction across the 16 threads that share a token breaks equal
// distances towards the lower index. Tokens arrive as f32 (the wrapper
// casts, as vq.py does).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;
constexpr int TK = 64;
constexpr int CC = 16;
constexpr int NT = 256;

__global__ void code_norms(const float* __restrict__ cb, float* __restrict__ c2,
                           int K, int C) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float* row = cb + (size_t)k * C;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s = fmaf(row[c], row[c], s);
  c2[k] = s;
}

__global__ void __launch_bounds__(NT) vq_kernel(
    const float* __restrict__ z, const float* __restrict__ cb,
    const float* __restrict__ c2, int* __restrict__ idx, int N, int K, int C) {
  __shared__ __align__(16) float sz[CC][TN];
  __shared__ __align__(16) float sc[CC][TK];
  __shared__ float red_v[16][TN];
  __shared__ int red_i[16][TN];

  const int t = threadIdx.x;
  const int tx = t & 15;  // code group
  const int ty = t >> 4;  // token group
  const int n0 = blockIdx.x * TN;
  const int lrow = t >> 2;       // loader: tile row
  const int lcol = (t & 3) * 4;  // loader: 4 consecutive features

  float best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += TK) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CC) {
      const int n = n0 + lrow;
      const int kk = k0 + lrow;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + lcol + e;
        sz[lcol + e][lrow] = (n < N && c < C) ? z[(size_t)n * C + c] : 0.f;
        sc[lcol + e][lrow] = (kk < K && c < C) ? cb[(size_t)kk * C + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float4 a = *reinterpret_cast<const float4*>(&sz[cc][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sc[cc][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k >= K) continue;
      const float ck = c2[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = ck - 2.f * acc[i][j];
        if (d < best_v[i]) {
          best_v[i] = d;
          best_i[i] = k;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red_v[tx][ty * 4 + i] = best_v[i];
    red_i[tx][ty * 4 + i] = best_i[i];
  }
  __syncthreads();
  if (t < TN && n0 + t < N) {
    float bv = red_v[0][t];
    int bi = red_i[0][t];
    for (int g = 1; g < 16; ++g) {
      const float v = red_v[g][t];
      const int i = red_i[g][t];
      if (v < bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
      }
    }
    idx[n0 + t] = bi;
  }
}

}  // namespace

// z: (N, C) f32, cb: (K, C) f32, c2: (K,) f32 scratch, idx: (N,) int32.
extern "C" int femasr_vq_argmin(const void* z, const void* cb, void* c2,
                                void* idx, int N, int K, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  code_norms<<<(K + 127) / 128, 128, 0, s>>>((const float*)cb, (float*)c2, K, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  vq_kernel<<<(N + TN - 1) / TN, NT, 0, s>>>((const float*)z, (const float*)cb,
                                             (const float*)c2, (int*)idx, N, K, C);
  return (int)cudaGetLastError();
}
