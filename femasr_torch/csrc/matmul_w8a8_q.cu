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
// operations per byte: below the tensor cores' ridge (~590), so the
// products are bound by device memory. Its epilogue evaluates 71 M tanh
// GELUs and 71 M correctly rounded quotients on the CUDA cores, which
// takes longer than the bytes (~0.1 ms of instruction issue on 132 SMs).
//
// Tensor cores (mm_w8a8_q_tc; K % 64 == 0 and N % 64 == 0, 16-byte aligned
// x: every shape of the int8 lane): a block computes 64 rows x 256
// columns, 8 warps of 32 x 64 (two m16 x eight n8 tiles of mma.sync
// m16n8k32 s8), sweeping K in 64-byte chunks through a 4-stage cp.async
// ring of the rows' chunk (4 KB, zero past M) and the weights' chunk, one
// contiguous 16 KB slab packed (N tiles, K / 64, 256, 64) by the wrapper
// (zero rows past N; a warp whose 64 columns lie past N skips its MMAs).
// 80 KB of shared memory and <= 128 registers let two blocks share an SM,
// so one block's loads and MMAs overlap the other's epilogue. The epilogue
// keeps the reference's association, acc * (s_x * s_w) then + bias, with
// _rn intrinsics, then the activation, and stages each warp's 32 x 64
// outputs through shared memory so the row-major stores are 16 bytes wide.
//
// The int8-out row max: a row's N <= 1024 columns span N / 256 blocks, one
// thread-block cluster along N (4 blocks for fc1; row tiles on grid.x,
// N tiles on grid.y, so M has grid.x's range). Each thread takes the
// max |y| of its 16 values of a row, the four threads of a quad combine by
// shuffles (the warp's 64 columns), the block's four column warps through
// shared memory (256 columns), and the cluster's blocks read each other's
// block maxima through distributed shared memory (cluster barrier, then
// map_shared_rank); the maximum is exact in any order. Every block then
// quantizes its own registers: s_y = max(max / 127, 1e-12) by a true
// division, y / s_y by the correctly rounded reciprocal of s_y, a
// remainder step and Markstein's step (w8a8_mma.cuh quant), round half to
// even. Nothing round-trips through device memory.
//
// dp4a (mm_w8a8_q_dp4a, every other shape): __dp4a on the CUDA cores, the
// same arithmetic. One block stages its rows' whole K extent once; 128-
// column tiles; 4x4 register tiles of int32 sums; 16-byte shared loads.
// With out_int8 a block owns whole rows (BM = 16) and keeps their f32
// results for all N <= 1024 columns in shared memory; after the last
// column tile one warp per row takes the row's max |y|, writes the row
// scale and the re-quantized codes (round-half-even of a true division).

#include <cooperative_groups.h>

#include "w8a8_common.cuh"
#include "w8a8_mma.cuh"

namespace {

using namespace w8a8;
namespace cg = cooperative_groups;

// -- tensor cores ------------------------------------------------------------

namespace tc {

constexpr int BM = 64;                    // rows per block
constexpr int BN = 256;                   // columns per block
constexpr int NT = 256;                   // 8 warps: 2 along M x 4 along N
constexpr int WM = BM / 2;                // rows per warp
constexpr int WN = BN / 4;                // columns per warp
constexpr int MT = WM / 16;               // m16 tiles per warp
constexpr int NT8 = WN / 8;               // n8 tiles per warp
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * CK;          // a chunk of the block's rows
constexpr int W_BYTES = BN * CK;          // a packed weight slab
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int NV = MT * NT8 * 4;          // outputs per thread

// the ring; each warp's output staging (WM x WN of T) reuses it
template <typename T>
constexpr int smem_bytes() {
  return RING_BYTES > BM * BN * (int)sizeof(T) ? RING_BYTES
                                               : BM * BN * (int)sizeof(T);
}

// cp.async of K chunk k0 / 64 into ring stage st: BM rows of x_q (zero
// past M) and the weight slab
__device__ __forceinline__ void load_chunk(uint32_t st,
                                           const int8_t* __restrict__ xq,
                                           int m0, int M, int K, int k0,
                                           const int8_t* __restrict__ slab,
                                           int tid) {
#pragma unroll
  for (int i = tid; i < BM * ROW_CHUNKS; i += NT) {
    const int r = i / ROW_CHUNKS;
    const int c = i % ROW_CHUNKS;
    const bool ok = m0 + r < M;
    cp_async16_zfill(st + swz(r, c),
                     xq + (size_t)(ok ? m0 + r : m0) * K + k0 + c * 16, ok);
  }
#pragma unroll
  for (int i = tid; i < W_BYTES / 16; i += NT)
    cp_async16(st + A_BYTES + swz(i / ROW_CHUNKS, i % ROW_CHUNKS),
               slab + i * 16);
}

template <int ACT>
__device__ __forceinline__ void act_all(float (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = act_fn(v[i], ACT);
}

// T: float or __nv_bfloat16 (out = y), or int8_t (out = y_q, with the row
// scales s_y; launched as a cluster of the N / BN blocks of a row tile).
template <typename T>
__global__ void __launch_bounds__(NT, 2) mm_w8a8_q_tc(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const int8_t* __restrict__ wp, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ out,
    float* __restrict__ sy, int M, int N, int K, int act) {
  constexpr bool Q = sizeof(T) == 1;
  constexpr int RB = WN * (int)sizeof(T);     // staged row bytes
  constexpr int CH = RB / 16;                 // 16-byte chunks per row
  constexpr int SPAN = CH < 8 ? CH : 8;       // staging swizzle span
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int g = lane >> 2;
  const int q4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN + wn * WN;   // the warp's first column
  const bool active = n0 < N;                 // warp-uniform
  const int nk = K / CK;
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int8_t* wtile = wp + (size_t)blockIdx.y * nk * W_BYTES;

  int acc[MT][NT8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_chunk(s0 + s * STAGE_BYTES, xq, m0, M, K, s * CK,
                 wtile + (size_t)s * W_BYTES, tid);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();  // chunk kc has landed
    __syncthreads();              // ... for every thread; stage kc - 1 is free
    const int nx = kc + STAGES - 1;
    if (nx < nk)
      load_chunk(s0 + (nx % STAGES) * STAGE_BYTES, xq, m0, M, K, nx * CK,
                 wtile + (size_t)nx * W_BYTES, tid);
    cp_async_commit();
    const uint32_t st = s0 + (kc % STAGES) * STAGE_BYTES;
    if (active) mma_k64<MT, NT8>(acc, st, wm * WM, st + A_BYTES, wn * WN, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the staging reuses it

  // v[(m * NT8 + n) * 4 + e]: row wm * WM + 16 m + g + 8 (e >> 1), column
  // n0 + 8 n + 2 q4 + (e & 1)
  float v[NV];
  if (active) {
    float sxr[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + m * 16 + h * 8 + g;
        sxr[m][h] = row < M ? sx[row] : 0.f;
      }
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const int col = n0 + n * 8 + 2 * q4;
      const float sw0 = sw[col], sw1 = sw[col + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[(m * NT8 + n) * 4 + e] =
              dequant(acc[m][n][e], sxr[m][e >> 1], (e & 1) ? sw1 : sw0,
                      bias, col + (e & 1));
    }
    switch (act) {
      case 1: act_all<1>(v); break;
      case 2: act_all<2>(v); break;
      case 3: act_all<3>(v); break;
      default: break;
    }
  }

  unsigned char* so = smem + warp * WM * RB;

  if constexpr (Q) {
    __shared__ float warp_max[4][BM];
    __shared__ float block_max[BM];
    __shared__ float row_scale[BM];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = 0.f;
        if (active)
#pragma unroll
          for (int n = 0; n < NT8; ++n)
            mx = fmaxf(mx, fmaxf(fabsf(v[(m * NT8 + n) * 4 + 2 * h]),
                                 fabsf(v[(m * NT8 + n) * 4 + 2 * h + 1])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (q4 == 0) warp_max[wn][wm * WM + m * 16 + h * 8 + g] = mx;
      }
    __syncthreads();
    if (tid < BM)
      block_max[tid] = fmaxf(fmaxf(warp_max[0][tid], warp_max[1][tid]),
                             fmaxf(warp_max[2][tid], warp_max[3][tid]));
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's maxima are written
    if (tid < BM) {
      float mx = 0.f;
      for (unsigned r = 0; r < cluster.num_blocks(); ++r)
        mx = fmaxf(mx, *cluster.map_shared_rank(&block_max[tid], r));
      const float s = fmaxf(__fdiv_rn(mx, 127.f), 1e-12f);
      row_scale[tid] = s;
      if (blockIdx.y == 0 && m0 + tid < M) sy[m0 + tid] = s;
    }
    cluster.sync();  // no block leaves while another may read its maxima
    if (active) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = m * 16 + h * 8 + g;
          const float s = row_scale[wm * WM + px];
          const float r = __frcp_rn(s);
#pragma unroll
          for (int n = 0; n < NT8; ++n) {
            const int i = (m * NT8 + n) * 4 + 2 * h;
            unsigned char* dst = so + stage_off<RB, SPAN>(px, n * 8 + 2 * q4);
            *reinterpret_cast<uint16_t*>(dst) =
                (uint16_t)(quant(v[i], s, r) | (quant(v[i + 1], s, r) << 8));
          }
        }
    }
  } else if (active) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (m * NT8 + n) * 4 + 2 * h;
          put2(so + stage_off<RB, SPAN>(m * 16 + h * 8 + g,
                                         (n * 8 + 2 * q4) * (int)sizeof(T)),
               from_f<T>(v[i]), from_f<T>(v[i + 1]));
        }
  }
  if (!active) return;
  __syncwarp();
  const int row0 = m0 + wm * WM;
#pragma unroll
  for (int j = 0; j < WM * CH / 32; ++j) {
    const int idx = j * 32 + lane;
    const int px = idx / CH;
    const int c = idx % CH;
    if (row0 + px < M)
      reinterpret_cast<uint4*>(out + (size_t)(row0 + px) * N + n0)[c] =
          *reinterpret_cast<const uint4*>(so + stage_off<RB, SPAN>(px, c * 16));
  }
}

template <typename T>
int launch(const int8_t* xq, const float* sx, const int8_t* wp, const float* sw,
           const float* bias, T* out, float* sy, int M, int N, int K, int act,
           cudaStream_t stream) {
  if (K % CK != 0 || N % WN != 0) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      mm_w8a8_q_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  if (n_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, n_tiles, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (sizeof(T) == 1) {  // a row tile's blocks form a cluster
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = n_tiles;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, mm_w8a8_q_tc<T>, xq, sx, wp, sw, bias, out,
                           sy, M, N, K, act);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tc

// -- dp4a ----------------------------------------------------------------------

namespace dp4a {

constexpr int BN = 128;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int WS = BK + 16;  // weight tile row stride in bytes

// RI rows per thread: BM = 8 * RI rows per block. OUT_INT8 keeps the
// block's (BM, N) f32 results in shared memory for the per-row requantize.
template <typename T, int RI, bool OUT_INT8>
__global__ void __launch_bounds__(NT) mm_w8a8_q_dp4a(
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
    cudaError_t e = cudaFuncSetAttribute(mm_w8a8_q_dp4a<T, RI, OUT_INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + BM - 1) / BM);
  mm_w8a8_q_dp4a<T, RI, OUT_INT8><<<grid, NT, smem, stream>>>(
      xq, sx, wq, sw, bias, (T*)y, yq, sy, M, N, K, Kp, act);
  return (int)cudaGetLastError();
}

}  // namespace dp4a

}  // namespace

// xq: (M, K) int8; sx: (M,) f32 row scales; sw: (N,) f32; bias: (N,) f32
// or null. out_int8 = 0: y is (M, N) in dtype (0 float32, 1 bfloat16);
// out_int8 = 1: yq (M, N) int8 and sy (M,) f32, N <= 1024. act: 0 none,
// 1 gelu(tanh), 2 silu, 3 lrelu. route 0 (dp4a): wq (N, K) int8, any K and
// N. route 1 (tensor cores): K % 64 == 0 and N % 64 == 0, wq packed
// (N tiles of 256, K / 64, 256, 64) int8 with zero rows past N; xq 16-byte
// aligned.
extern "C" int femasr_matmul_w8a8_q(const void* xq, const void* sx, const void* wq,
                                    const void* sw, const void* bias, void* y,
                                    void* yq, void* sy, int M, int N, int K,
                                    int act, int out_int8, int dtype, int route,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* x8 = (const int8_t*)xq;
  const int8_t* w8 = (const int8_t*)wq;
  const float* sxf = (const float*)sx;
  const float* swf = (const float*)sw;
  const float* bf = (const float*)bias;
  if (route == 1) {
    if (out_int8)
      return tc::launch<int8_t>(x8, sxf, w8, swf, bf, (int8_t*)yq, (float*)sy,
                                M, N, K, act, s);
    if (dtype == 0)
      return tc::launch<float>(x8, sxf, w8, swf, bf, (float*)y, nullptr, M, N,
                               K, act, s);
    if (dtype == 1)
      return tc::launch<__nv_bfloat16>(x8, sxf, w8, swf, bf,
                                       (__nv_bfloat16*)y, nullptr, M, N, K,
                                       act, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (out_int8)
    return dp4a::launch<float, 2, true>(x8, sxf, w8, swf, bf, nullptr,
                                        (int8_t*)yq, (float*)sy, M, N, K, act,
                                        s);
  if (dtype == 0)
    return dp4a::launch<float, 4, false>(x8, sxf, w8, swf, bf, y, nullptr,
                                         nullptr, M, N, K, act, s);
  if (dtype == 1)
    return dp4a::launch<__nv_bfloat16, 4, false>(x8, sxf, w8, swf, bf, y,
                                                 nullptr, nullptr, M, N, K,
                                                 act, s);
  return (int)cudaErrorInvalidValue;
}
