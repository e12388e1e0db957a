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
// Design: a GEMM-class FFMA kernel with the argmin in its epilogue, so the
// (N, K) distance matrix never exists. code_norms computes ||c_k||^2 (one
// thread per code, in index order). vq_tile_argmin gives each block a
// work item: 128 tokens against one range of the codebook, swept in
// 128-code tiles. Each of its 256 threads owns an 8 token x 8 code
// register tile (tokens ty + 16 i, codes tx + 16 j): one 16-byte shared
// load of 4 channels of a code feeds 32 FFMAs, a token's 4 channels are a
// broadcast within the warp. Channels arrive in chunks of 32 by 16-byte
// cp.async into a three-stage ring (rows padded to 144 bytes, so the 8 code
// rows of a quarter warp fall on distinct banks): the chunk after next
// loads while the current one is multiplied, one barrier per chunk. The
// 64 accumulators, the two 8-float operand rows and the running minima
// take 254 registers, so one block runs per SM (capped at 128 registers
// for two blocks, it spilled and ran slower). After each code tile
// the 8x8 dot products fold into a running (min, idx) per token: codes
// are visited in increasing order and only a strictly smaller distance
// replaces the minimum. A shuffle reduction across the 16 threads that
// share a token then breaks equal distances towards the lower index.
// The codebook is split into `splits` ranges so that the items fill the
// card's block slots in whole waves (the wrapper picks the count: 545
// token tiles alone fill 4.1 waves of 132 blocks, so the fifth is nearly
// empty); with more than one range each item writes a partial (min, idx)
// per token and vq_merge takes the first minimum over the ranges in
// increasing order. Tokens arrive as f32 with C a multiple of 32 (the
// wrapper casts and zero-pads, which changes no distance).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;                  // tokens per item
constexpr int TK = 128;                  // codes per tile
constexpr int CC = 32;                   // channels per chunk
constexpr int LD = CC + 4;               // padded shared row, floats
constexpr int NT = 256;
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = (TN + TK) * LD;
constexpr int SMEM = STAGES * STAGE_FLOATS * 4;  // 110,592 bytes

__global__ void code_norms(const float* __restrict__ cb, float* __restrict__ c2,
                           int K, int C) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float* row = cb + (size_t)k * C;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s = fmaf(row[c], row[c], s);
  c2[k] = s;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// items: blockIdx.x = token tile, blockIdx.y = code range (tiles_per_split
// code tiles from tile blockIdx.y * tiles_per_split).
__global__ void __launch_bounds__(NT, 1) vq_tile_argmin(
    const float* __restrict__ z, const float* __restrict__ cb,
    const float* __restrict__ c2, float* __restrict__ part_v,
    int* __restrict__ part_i, int* __restrict__ idx, int N, int K, int C,
    int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int n0 = blockIdx.x * TN;
  const int kt0 = blockIdx.y * tiles_per_split;
  const int ktiles = min(tiles_per_split, (K + TK - 1) / TK - kt0);
  const int nch = C / CC;
  const int steps = ktiles * nch;

  // step s: code tile kt0 + s / nch, channels (s % nch) * CC.. into ring
  // slot s % STAGES; four 16-byte copies of tokens and four of codes each
  auto load = [&](int s) {
    if (s < steps) {
      float* st = smem + (s % STAGES) * STAGE_FLOATS;
      const int k0 = (kt0 + s / nch) * TK;
      const int c0 = (s % nch) * CC;
#pragma unroll
      for (int e = 0; e < TN * CC / 4 / NT; ++e) {
        const int i = t + e * NT;
        const int row = i / (CC / 4);
        const int ch = (i % (CC / 4)) * 4;
        const int n = n0 + row;
        const int k = k0 + row;
        cp16(st + row * LD + ch, z + (size_t)(n < N ? n : 0) * C + c0 + ch,
             n < N);
        cp16(st + (TN + row) * LD + ch,
             cb + (size_t)(k < K ? k : 0) * C + c0 + ch, k < K);
      }
    }
    commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float best_v[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_v[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    // slot (s + STAGES - 1) % STAGES was last read at step s - 1, which
    // every thread has finished at the barrier above
    load(s + STAGES - 1);
    const float* sz = smem + (s % STAGES) * STAGE_FLOATS;
    const float* sc = sz + TN * LD;
#pragma unroll
    for (int c4 = 0; c4 < CC; c4 += 4) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(sc + (tx + 16 * j) * LD + c4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(sz + (ty + 16 * i) * LD + c4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = fmaf(a.x, b[j].x, acc[i][j]);
          v = fmaf(a.y, b[j].y, v);
          v = fmaf(a.z, b[j].z, v);
          acc[i][j] = fmaf(a.w, b[j].w, v);
        }
      }
    }
    if (s % nch == nch - 1) {
      const int k0 = (kt0 + s / nch) * TK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + tx + 16 * j;
        const float ck = k < K ? __ldg(c2 + k) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = ck - 2.f * acc[i][j];
          if (k < K && d < best_v[i]) {
            best_v[i] = d;
            best_i[i] = k;
          }
          acc[i][j] = 0.f;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the 16 threads of a token are lanes 0-15 or 16-31 of one warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = best_v[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov < v || (ov == v && oi < bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int n = n0 + ty + 16 * i;
    if (tx == 0 && n < N) {
      if (gridDim.y == 1) {
        idx[n] = bi;
      } else {
        part_v[(size_t)blockIdx.y * N + n] = v;
        part_i[(size_t)blockIdx.y * N + n] = bi;
      }
    }
  }
}

// first minimum over the code ranges, visited in increasing order
__global__ void vq_merge(const float* __restrict__ part_v,
                         const int* __restrict__ part_i, int* __restrict__ idx,
                         int N, int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float bv = part_v[n];
  int bi = part_i[n];
  for (int r = 1; r < splits; ++r) {
    const float v = part_v[(size_t)r * N + n];
    if (v < bv) {
      bv = v;
      bi = part_i[(size_t)r * N + n];
    }
  }
  idx[n] = bi;
}

}  // namespace

// Block slots of vq_tile_argmin on the current device (SMs x resident
// blocks per SM), or a negative CUDA error code.
extern "C" int femasr_vq_slots() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vq_tile_argmin,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vq_tile_argmin,
                                                        NT, SMEM);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// z: (N, C) f32, cb: (K, C) f32, C % 32 == 0; c2: (K,) f32 scratch;
// part_v/part_i: (splits, N) f32/int32 scratch (unused when splits == 1);
// idx: (N,) int32. The codebook's ceil(K / 128) tiles are split into
// `splits` ranges of tiles_per_split tiles (the last may be shorter).
extern "C" int femasr_vq_argmin(const void* z, const void* cb, void* c2,
                                void* part_v, void* part_i, void* idx, int N,
                                int K, int C, int splits, int tiles_per_split,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C % CC != 0 || splits < 1 || tiles_per_split < 1 ||
      (splits - 1) * tiles_per_split >= (K + TK - 1) / TK)
    return (int)cudaErrorInvalidValue;
  code_norms<<<(K + 127) / 128, 128, 0, s>>>((const float*)cb, (float*)c2, K, C);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vq_tile_argmin,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TN - 1) / TN, splits);
  vq_tile_argmin<<<grid, NT, SMEM, s>>>(
      (const float*)z, (const float*)cb, (const float*)c2, (float*)part_v,
      (int*)part_i, (int*)idx, N, K, C, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  vq_merge<<<(N + 255) / 256, 256, 0, s>>>((const float*)part_v,
                                           (const int*)part_i, (int*)idx, N,
                                           splits);
  return (int)cudaGetLastError();
}
