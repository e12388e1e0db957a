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
// per byte, below the int8 tensor cores' ridge (1979 TOPS / 3.35 TB/s,
// ~590), so on the tensor cores it is bound by device memory.
//
// Tensor cores (mm_w8a8_tc; K % 64 == 0, N % 64 == 0, K <= 2048 and a
// 16-byte aligned x: the qkv and proj of the int8 lane): a block owns 64
// rows. It reads their whole K extent once, with 16-byte loads of bf16 or
// f32, and quantizes it once into shared memory as int8 (64-byte K chunks
// of the 64 rows, swizzled as w8a8_mma.cuh swz). The quantize is round-
// half-even of the correctly rounded x / s_x, as torch.round(torch.div(x,
// s_x)): the correctly rounded reciprocal of s_x, a remainder step to a
// faithful quotient and Markstein's step to the correctly rounded one
// (w8a8_mma.cuh quant), without the IEEE division's slow-path check. The
// block then sweeps the output columns in tiles of 256: 8 warps of 32 rows
// x 64 columns (two m16 x eight n8 tiles of mma.sync m16n8k32 s8), over
// the packed weight slabs (N tiles, K / 64, 256, 64) of the wrapper, one
// contiguous 16 KB slab per (N tile, K chunk), streamed as one sequence
// through a 2-stage cp.async ring that runs on across the N tiles; the
// first slab is in flight while the rows are quantized. A warp whose 64
// columns lie past N skips its MMAs. At the last K chunk of an N tile each
// warp runs the epilogue: its 16 columns' s_x * s_w and bias are loaded
// first, as float2 pairs, then acc * (s_x * s_w) then + bias with _rn
// intrinsics (the reference's association, no FMA), then the activation
// (a template argument, so the unrolled epilogue holds one activation's
// code), and its 32 x 64 outputs are staged in the warp's own shared area
// so the row-major stores are 16 bytes wide. For K = 256 a block takes 80
// KB of shared memory in bf16 (16 KB of rows, 32 KB of ring, 32 KB of
// staging) and 112 KB in f32, so two blocks share an SM and one block's
// quantize and epilogue overlap the other's MMAs.
// Measured on the H100 at the qkv shape (kernel alone, bf16): the
// activation as a runtime switch inside the unrolled epilogue took twice
// the time; per-element scale and bias loads a quarter more; a 3- or
// 4-stage ring and 128-row blocks of 16 warps were no faster.
//
// dp4a (mm_w8a8_dp4a, every other shape): __dp4a on the CUDA cores, the
// same arithmetic. One block owns 32 rows and stages them once, quantized
// (a true IEEE division), with the whole K extent in shared memory; it
// sweeps the output columns in 128-wide tiles with the int8 weights (N, K)
// staged in 64-byte K chunks; each thread keeps a 4 x 4 register tile of
// int32 sums and reads 16 bytes of each operand per shared load.

#include "w8a8_common.cuh"
#include "w8a8_mma.cuh"

namespace {

using namespace w8a8;

// s_x = max(max|x| / 127, 1e-12), as the plain version's scale_of (a true
// division, then the floor)
template <typename T>
__device__ __forceinline__ float scale_of(T amax) {
  return fmaxf(__fdiv_rn(to_f(amax), 127.f), 1e-12f);
}

// -- tensor cores ------------------------------------------------------------

namespace tc {

constexpr int BM = 64;               // rows per block
constexpr int BN = 256;              // columns per N tile (a weight slab)
constexpr int NT = 256;              // 8 warps: 2 along M x 4 along N
constexpr int WM = BM / 2;           // rows per warp
constexpr int WN = BN / 4;           // columns per warp
constexpr int MT = WM / 16;          // m16 tiles per warp
constexpr int NT8 = WN / 8;          // n8 tiles per warp
constexpr int STAGES = 2;
constexpr int A_CHUNK = BM * CK;     // one 64-byte K chunk of the rows
constexpr int W_BYTES = BN * CK;     // one packed weight slab
constexpr int RING_BYTES = STAGES * W_BYTES;
constexpr int G = 4;                 // 16-value items loaded together

// the quantized rows, the ring, and every warp's output staging
template <typename T>
constexpr long long smem_bytes(int K) {
  return (long long)(K / CK) * A_CHUNK + RING_BYTES +
         (long long)NT / 32 * WM * WN * (long long)sizeof(T);
}

// cp.async of one packed slab (256 columns x 64 K bytes) into ring stage st
__device__ __forceinline__ void load_slab(uint32_t st,
                                          const int8_t* __restrict__ slab,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < W_BYTES / 16; i += NT)
    cp_async16(st + swz(i / ROW_CHUNKS, i % ROW_CHUNKS), slab + i * 16);
}

// ACT: the epilogue's activation (w8a8_common.cuh act_fn), a template
// argument so that the unrolled epilogue holds one activation's code only
template <typename T, int ACT>
__global__ void __launch_bounds__(NT, 2) mm_w8a8_tc(
    const T* __restrict__ x, const int8_t* __restrict__ wp,
    const T* __restrict__ amax, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ y, int M, int N, int K) {
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
  const int nk = K / CK;
  const int total = (N + BN - 1) / BN * nk;   // slabs, N tile-major
  const uint32_t a_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring = a_s + nk * A_CHUNK;
  unsigned char* so = smem + nk * A_CHUNK + RING_BYTES + warp * WM * RB;

  // the first slab flies while the rows are quantized
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total)
      load_slab(ring + st * W_BYTES, wp + (size_t)st * W_BYTES, tid);
    cp_async_commit();
  }

  // the block's rows, quantized once: item i is 16 values, row i / (K / 16)
  // at K offset 16 (i % (K / 16)); zero past M
  const float s = scale_of(*amax);
  const float r = __frcp_rn(s);
  const int row_items = K / 16;
  const int items = BM * row_items;
  for (int i0 = tid; i0 < items; i0 += NT * G) {
    Raw<T> raw[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = i0 + j * NT;
      const int rr = i / row_items;
      const bool ok = i < items && m0 + rr < M;
      load16(raw[j],
             ok ? x + (size_t)(m0 + rr) * K + (i - rr * row_items) * 16 : x,
             ok);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = i0 + j * NT;
      if (i < items) {
        const int rr = i / row_items;
        const int c16 = i - rr * row_items;
        *reinterpret_cast<uint4*>(smem + (c16 >> 2) * A_CHUNK +
                                  swz(rr, c16 & 3)) = quant16(raw[j], s, r);
      }
    }
  }

  int acc[MT][NT8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

  for (int j = 0; j < total; ++j) {
    cp_async_wait<STAGES - 2>();  // slab j has landed
    __syncthreads();              // ... for every thread, and the rows are
                                  // quantized; stage j - 1 is free
    const int nx = j + STAGES - 1;
    if (nx < total)
      load_slab(ring + (nx % STAGES) * W_BYTES, wp + (size_t)nx * W_BYTES,
                tid);
    cp_async_commit();
    const int tile = j / nk;
    const int kc = j - tile * nk;
    const int n0 = tile * BN + wn * WN;       // the warp's first column
    if (n0 >= N) continue;                    // warp-uniform
    mma_k64<MT, NT8>(acc, a_s + kc * A_CHUNK, wm * WM,
                     ring + (j % STAGES) * W_BYTES, wn * WN, lane);
    if (kc != nk - 1) continue;

    // the N tile's epilogue: C fragment element e of (m, n) is row
    // wm * WM + 16 m + g + 8 (e >> 1), column n0 + 8 n + 2 q4 + (e & 1)
    float2 scl[NT8], bia[NT8];
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const int col = n0 + n * 8 + 2 * q4;
      const float2 w2 = *reinterpret_cast<const float2*>(sw + col);
      scl[n] = make_float2(__fmul_rn(s, w2.x), __fmul_rn(s, w2.y));
      bia[n] = bias ? *reinterpret_cast<const float2*>(bias + col)
                    : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = __fmul_rn(__int2float_rn(acc[m][n][2 * h]), scl[n].x);
          float v1 = __fmul_rn(__int2float_rn(acc[m][n][2 * h + 1]), scl[n].y);
          if (bias) {
            v0 = __fadd_rn(v0, bia[n].x);
            v1 = __fadd_rn(v1, bia[n].y);
          }
          v0 = act_fn(v0, ACT);
          v1 = act_fn(v1, ACT);
          put2(so + stage_off<RB, SPAN>(m * 16 + h * 8 + g,
                                         (n * 8 + 2 * q4) * (int)sizeof(T)),
               from_f<T>(v0), from_f<T>(v1));
          acc[m][n][2 * h] = 0;
          acc[m][n][2 * h + 1] = 0;
        }
    }
    __syncwarp();
    const int row0 = m0 + wm * WM;
#pragma unroll
    for (int jj = 0; jj < WM * CH / 32; ++jj) {
      const int idx = jj * 32 + lane;
      const int px = idx / CH;
      const int c = idx % CH;
      if (row0 + px < M)
        reinterpret_cast<uint4*>(y + (size_t)(row0 + px) * N + n0)[c] =
            *reinterpret_cast<const uint4*>(so + stage_off<RB, SPAN>(px, c * 16));
    }
    __syncwarp();  // the staging is read before the next tile writes it
  }
}

template <typename T, int ACT>
int launch_act(const void* x, const int8_t* wp, const void* amax,
               const float* sw, const float* bias, void* y, int M, int N,
               int K, cudaStream_t stream) {
  const long long smem = smem_bytes<T>(K);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mm_w8a8_tc<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)M + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  mm_w8a8_tc<T, ACT><<<(unsigned)blocks, NT, (size_t)smem, stream>>>(
      (const T*)x, wp, (const T*)amax, sw, bias, (T*)y, M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const int8_t* wp, const void* amax, const float* sw,
           const float* bias, void* y, int M, int N, int K, int act,
           cudaStream_t stream) {
  if (K <= 0 || K % CK != 0 || N % WN != 0) return (int)cudaErrorInvalidValue;
  switch (act) {
    case 0: return launch_act<T, 0>(x, wp, amax, sw, bias, y, M, N, K, stream);
    case 1: return launch_act<T, 1>(x, wp, amax, sw, bias, y, M, N, K, stream);
    case 2: return launch_act<T, 2>(x, wp, amax, sw, bias, y, M, N, K, stream);
    case 3: return launch_act<T, 3>(x, wp, amax, sw, bias, y, M, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// -- dp4a ----------------------------------------------------------------------

namespace dp4a {

constexpr int BM = 32;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int WS = BK + 16;  // weight tile row stride in bytes

template <typename T>
__global__ void __launch_bounds__(NT) mm_w8a8_dp4a(
    const T* __restrict__ x, const int8_t* __restrict__ wq,
    const T* __restrict__ amax, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ y, int M, int N, int K,
    int Kp, int act) {
  extern __shared__ __align__(16) int8_t smem[];
  const int XS = Kp + 16;
  int8_t* xs = smem;            // [BM][XS]
  int8_t* ws = smem + BM * XS;  // [BN][WS]
  const int m0 = blockIdx.x * BM;
  const int t = threadIdx.x;
  const float s = scale_of(*amax);

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
int launch(const void* x, const int8_t* wq, const void* amax, const float* sw,
           const float* bias, void* y, int M, int N, int K, int act,
           cudaStream_t stream) {
  const int Kp = (K + 15) / 16 * 16;
  const size_t smem = (size_t)BM * (Kp + 16) + (size_t)BN * WS;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mm_w8a8_dp4a<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + BM - 1) / BM);
  mm_w8a8_dp4a<T><<<grid, NT, smem, stream>>>((const T*)x, wq, (const T*)amax,
                                               sw, bias, (T*)y, M, N, K, Kp,
                                               act);
  return (int)cudaGetLastError();
}

}  // namespace dp4a

template <typename T>
int dispatch(int route, const void* x, const int8_t* wq, const void* amax,
             const float* sw, const float* bias, void* y, int M, int N,
             int K, int act, cudaStream_t stream) {
  if (route == 1)
    return tc::launch<T>(x, wq, amax, sw, bias, y, M, N, K, act, stream);
  if (route == 0)
    return dp4a::launch<T>(x, wq, amax, sw, bias, y, M, N, K, act, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, amax and y). x: (M, K); amax: max
// |x| on the device, one value (s_x = max(amax / 127, 1e-12) is taken
// here); sw: (N,) f32; bias: (N,) f32 or null; y: (M, N). act: 0
// none, 1 gelu(tanh), 2 silu, 3 lrelu. route 0 (dp4a): wq (N, K) int8, any
// K and N. route 1 (tensor cores): K % 64 == 0, N % 64 == 0, K <= 2048, x
// 16-byte aligned; wq packed (N tiles of 256, K / 64, 256, 64) int8 with
// zero rows past N.
extern "C" int femasr_matmul_w8a8(const void* x, const void* wq, const void* amax,
                                  const void* sw, const void* bias, void* y,
                                  int M, int N, int K, int act, int dtype,
                                  int route, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* w8 = (const int8_t*)wq;
  const float* swf = (const float*)sw;
  const float* bf = (const float*)bias;
  if (dtype == 0)
    return dispatch<float>(route, x, w8, amax, swf, bf, y, M, N, K, act, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(route, x, w8, amax, swf, bf, y, M, N, K,
                                   act, s);
  return (int)cudaErrorInvalidValue;
}
