// w8a8 3x3 SAME convolution over NHWC:
//   y[b, p, o] = act(acc * (s_x * s_w[o]) + bias[o]),
//   acc = sum_{tap, c} round(x[b, p + tap, c] / s_x) * w_q[tap, o, c]
// with one per-tensor s_x for the whole batch and zero padding (0 quantizes
// to 0, so the halo is exact).
//
// Replaces: femasr_tpu/ops/pallas/int8_dense.py, conv3_w8a8 /
// _conv3_single / _conv_kernel. On the main path of the int8 serving lane
// it runs every conv of the three decoder levels, out_conv and the two
// encoder up blocks: 26 launches per forward, the largest 2112x2112 with
// 128 -> 64 channels (after the materialized x2 upsample) and 64 -> 64, for
// a 512px LR image.
//
// What bounds it on the H100: at 2112^2 x 64 -> 64 the conv does 329 G int8
// operations on 1.14 GB of bf16 traffic (one read, one write), ~290 per
// byte: below the int8 tensor cores' ridge (~590), so on the tensor cores
// it is bound by device memory (~0.34 ms).
//
// Tensor cores (conv3_w8a8_tc, every Ci that is a multiple of 64 with O a
// multiple of 64 or O <= 8: all convs of the int8 lane): implicit GEMM by
// mma.sync m16n8k32 s8 x s8 -> s32. A block computes an 8x32 pixel tile
// for one 64-channel tile of O (out_conv: one n8 tile, zero weights past
// O); the O tile is the fastest-varying part of the block index, so the O
// tiles of one pixel tile read its input from L2. M = the tile's pixels
// (one output row of 32 per warp, two m16 tiles), N = 64 output channels
// (eight n8 tiles), K = 9 taps x Ci, swept in chunks of 64 input channels.
// Per chunk the block copies the chunk's weights, packed (O tiles, Ci
// chunks, 9, 64, 64) int8 by the wrapper so that each is one contiguous
// 36 KB slab, into shared memory by 16-byte cp.async, and meanwhile loads
// the haloed 10x34 x 64-channel input, quantizes it and stores it as int8.
// The quantize is round-half-even of the correctly rounded x / s_x, as
// torch.round(torch.div(x, s_x)): the quotient comes from the correctly
// rounded reciprocal of s_x, one remainder step to a faithful quotient and
// Markstein's q + (x - s_x q) / s_x step to the correctly rounded one,
// without the IEEE division's per-value slow-path check. Shared rows are
// 64 bytes (one pixel or one output channel of the chunk) with the 16-byte
// chunk index XORed with bits 1-2 of the row, so the eight row addresses
// of every ldmatrix fall on distinct banks; each tap is a shifted view of
// the one haloed tile, so no im2col copy is made. The epilogue keeps the
// reference's association, acc * (s_x * s_w[o]) then + bias, with _rn
// intrinsics so nvcc cannot fuse them into one FMA, then the activation,
// and stages each warp's 32 x 64 outputs through shared memory so the NHWC
// stores are 16 bytes wide.
// What holds it above its byte bound: a block stages and then multiplies,
// and its MMA warps wait on ldmatrix and mma.sync latency; the 58 KB of
// shared memory and 128 registers let two blocks share an SM, so one
// block's staging overlaps the other's MMAs, and the 16 warps per SM are
// what hides the latency. Two persistent designs were slower at every
// main-path shape: blocks that walk many tiles with the weights resident
// (more registers, spills), and B1's warp specialisation (8 producer warps
// beside 8 MMA warps in one 512-thread block: half the MMA warps per SM).
// The next step is wgmma, whose B operand the tensor cores read from
// shared memory once per warpgroup.
//
// dp4a (conv3_w8a8_dp4a, every other shape): __dp4a on the CUDA cores,
// the same arithmetic. One block computes an 8x32 pixel tile for 4*OPT
// output channels. Input channels are swept in chunks of 32: the
// (8+2)x(32+2) haloed input chunk is quantized while it is staged (a true
// IEEE division) into shared memory as int8, each pixel's 32 channels
// contiguous, zero outside the image or past Ci; the chunk's weights
// (int8, (9, O, Ci) from the wrapper) beside it. Each thread keeps 4 pixels
// x OPT outputs of int32 sums in registers and reads 16 channels of a
// pixel or a weight row per shared load.
//
// Output is written in the input dtype.

#include "w8a8_common.cuh"
#include "w8a8_mma.cuh"

namespace {

using namespace w8a8;

// -- tensor cores ------------------------------------------------------------

namespace tc {

constexpr int TH = 8;                        // output rows per tile
constexpr int TW = 32;                       // output columns per tile
constexpr int HH = TH + 2;
constexpr int HW = TW + 2;
constexpr int NT = 256;                      // 8 warps, one output row each
constexpr int IN_CHUNKS = HH * HW * ROW_CHUNKS;     // 1360
constexpr int PER_T = (IN_CHUNKS + NT - 1) / NT;    // 6
constexpr int IN_BYTES = HH * HW * CK;              // 21,760

template <int OT>
__host__ __device__ constexpr int w_bytes() { return 9 * OT * CK; }

template <typename T, int OT>
__host__ __device__ constexpr int smem_bytes() {
  // input + weights of a chunk; the epilogue's staging reuses them
  return (IN_BYTES + w_bytes<OT>()) > (TH * TW * OT * (int)sizeof(T))
             ? (IN_BYTES + w_bytes<OT>())
             : (TH * TW * OT * (int)sizeof(T));
}

// The MMAs of one 64-channel chunk: warp w's output row (w) of the tile,
// 32 pixels (two m16 tiles) x OT outputs (NT8 n8 tiles), K = 9 taps x 64
// channels. a_in: the haloed int8 input chunk (10 x 34 rows of 64 bytes),
// a_w: the chunk's weights (9 x OT rows of 64 bytes), both swizzled. Each
// tap is a shifted view of the one haloed tile (w8a8_mma.cuh mma_k64).
template <int OT>
__device__ __forceinline__ void mma_chunk(int (&acc)[2][OT / 8][4],
                                          uint32_t a_in, uint32_t a_w,
                                          int warp, int lane) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    mma_k64<2, OT / 8>(acc, a_in, (warp + ky) * HW + kx, a_w, tap * OT, lane);
  }
}

// The epilogue of warp w's output row gy = ty0 + w: act(acc * (s_x *
// s_w[o]) + bias[o]) in x's dtype. C fragment element e: pixel
// g + 8 * (e >> 1) of the m16 tile, channel 2 * q4 + (e & 1) of the n8.
// OT = 8: scalar stores of the O <= 8 outputs. OT = 64: the warp's 32 x 64
// outputs go through its own staging area `so` (rows of 64 * sizeof(T)
// bytes, the 16-byte chunk index XORed with the row's low three bits) so
// the NHWC stores are 16 bytes wide.
template <typename T, int OT>
__device__ __forceinline__ void epilogue(const int (&acc)[2][OT / 8][4],
                                         T* __restrict__ y, int b, int gy,
                                         int tx0, int H, int W, int O, int o0,
                                         float s, const float* __restrict__ sw,
                                         const float* __restrict__ bias,
                                         int act, unsigned char* so, int lane) {
  constexpr int NT8 = OT / 8;
  const int g = lane >> 2;
  const int q4 = lane & 3;
  if constexpr (NT8 == 1) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gx = tx0 + m * 16 + g + 8 * (e >> 1);
        const int o = 2 * q4 + (e & 1);
        if (gy < H && gx < W && o < O)
          y[(((size_t)b * H + gy) * W + gx) * O + o] =
              from_f<T>(act_fn(dequant(acc[m][0][e], s, sw[o], bias, o), act));
      }
  } else {
    constexpr int ROW_BYTES = OT * (int)sizeof(T);
    constexpr int OUT_CHUNKS = ROW_BYTES / 16;
    auto out_off = [&](int px, int byte) {
      return px * ROW_BYTES + (((byte >> 4) ^ (px & 7)) << 4) + (byte & 15);
    };
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const int o = o0 + n * 8 + 2 * q4;
      const float sw0 = sw[o], sw1 = sw[o + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = m * 16 + g + 8 * h;
          T* dst = reinterpret_cast<T*>(
              so + out_off(px, (n * 8 + 2 * q4) * (int)sizeof(T)));
          dst[0] = from_f<T>(act_fn(dequant(acc[m][n][2 * h], s, sw0, bias, o), act));
          dst[1] = from_f<T>(act_fn(dequant(acc[m][n][2 * h + 1], s, sw1, bias, o + 1), act));
        }
    }
    __syncwarp();
    if (gy < H) {
      T* yr = y + (((size_t)b * H + gy) * W + tx0) * O + o0;
#pragma unroll
      for (int j = 0; j < TW * OUT_CHUNKS / 32; ++j) {
        const int idx = j * 32 + lane;
        const int px = idx / OUT_CHUNKS;
        const int c = idx % OUT_CHUNKS;
        if (tx0 + px < W)
          reinterpret_cast<uint4*>(yr + (size_t)px * O)[c] =
              *reinterpret_cast<const uint4*>(so + out_off(px, c * 16));
      }
    }
    __syncwarp();
  }
}

// OT: output channels per block, 64 (O % 64 == 0) or 8 (O <= 8).
template <typename T, int OT>
__global__ void __launch_bounds__(NT, 2) conv3_w8a8_tc(
    const T* __restrict__ x, const int8_t* __restrict__ wp,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Ci,
    int O, int act) {
  constexpr int NT8 = OT / 8;
  constexpr int G = sizeof(T) == 2 ? 3 : 2;    // chunks loaded together
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_in = smem;
  unsigned char* s_w = smem + IN_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_ot = OT == 8 ? 1 : O / OT;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_img = ((H + TH - 1) / TH) * tiles_w;
  const int ot = blockIdx.x % n_ot;
  const int tile = blockIdx.x / n_ot;
  const int b = tile / tiles_img;
  const int rem = tile - b * tiles_img;
  const int ty0 = (rem / tiles_w) * TH;
  const int tx0 = (rem % tiles_w) * TW;
  const int nck = Ci / CK;
  const float s = *sx;
  const float r = __frcp_rn(s);
  const T* xb = x + (size_t)b * H * W * Ci;

  const uint32_t a_in = (uint32_t)__cvta_generic_to_shared(s_in);
  const uint32_t a_w = (uint32_t)__cvta_generic_to_shared(s_w);
  int acc[2][NT8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;

  for (int cc = 0; cc < nck; ++cc) {
    if (cc > 0) __syncthreads();  // every warp is done with the last chunk
    // the chunk's weights: one contiguous slab, by cp.async
    const int8_t* wsrc = wp + ((size_t)ot * nck + cc) * w_bytes<OT>();
    for (int i = tid; i < w_bytes<OT>() / 16; i += NT)
      cp_async16(a_w + swz(i / ROW_CHUNKS, i % ROW_CHUNKS), wsrc + i * 16);
    cp_async_commit();
    // the haloed input: 16 channels of one pixel per item, zero outside
    // the image
#pragma unroll
    for (int j0 = 0; j0 < PER_T; j0 += G) {
      Raw<T> raw[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int i = tid + (j0 + j) * NT;
        const int p = i / ROW_CHUNKS;
        const int gy = ty0 + p / HW - 1;
        const int gx = tx0 + p % HW - 1;
        const bool ok = i < IN_CHUNKS && gy >= 0 && gy < H && gx >= 0 && gx < W;
        load16(raw[j], ok ? xb + ((size_t)gy * W + gx) * Ci + cc * CK +
                                (i % ROW_CHUNKS) * 16
                          : xb, ok);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int i = tid + (j0 + j) * NT;
        if (i < IN_CHUNKS)
          *reinterpret_cast<uint4*>(s_in + swz(i / ROW_CHUNKS, i % ROW_CHUNKS)) =
              quant16(raw[j], s, r);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    mma_chunk<OT>(acc, a_in, a_w, warp, lane);
  }

  // the staging reuses the chunk buffers: every warp is done reading them
  if (OT == 64) __syncthreads();
  epilogue<T, OT>(acc, y, b, ty0 + warp, tx0, H, W, O, ot * OT, s, sw, bias,
                  act, smem + warp * TW * OT * (int)sizeof(T), lane);
}

template <typename T, int OT>
int launch(const void* x, const int8_t* wp, const float* sx, const float* sw,
           const float* bias, void* y, int B, int H, int W, int Ci, int O,
           int act, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, OT>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3_w8a8_tc<T, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((H + TH - 1) / TH) *
                           ((W + TW - 1) / TW) * (OT == 8 ? 1 : O / OT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv3_w8a8_tc<T, OT><<<(unsigned)blocks, NT, smem, stream>>>(
      (const T*)x, wp, sx, sw, bias, (T*)y, H, W, Ci, O, act);
  return (int)cudaGetLastError();
}

template <typename T>
int route(const void* x, const int8_t* wp, const float* sx, const float* sw,
          const float* bias, void* y, int B, int H, int W, int Ci, int O,
          int act, cudaStream_t stream) {
  if (Ci % CK != 0 || !(O % 64 == 0 || O <= 8))
    return (int)cudaErrorInvalidValue;
  if (O <= 8)
    return launch<T, 8>(x, wp, sx, sw, bias, y, B, H, W, Ci, O, act, stream);
  return launch<T, 64>(x, wp, sx, sw, bias, y, B, H, W, Ci, O, act, stream);
}

}  // namespace tc

// -- dp4a ----------------------------------------------------------------------

namespace dp4a {

constexpr int TH = 8;
constexpr int TW = 32;
constexpr int CK = 32;
constexpr int NT = 256;

template <typename T, int OPT>
__global__ void __launch_bounds__(NT) conv3_w8a8_dp4a(
    const T* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Ci,
    int O, int act) {
  constexpr int OB = 4 * OPT;
  __shared__ __align__(16) int8_t s_in[TH + 2][TW + 2][CK];
  __shared__ __align__(16) int8_t s_w[9][OB][CK];

  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y;
  const int o0 = blockIdx.z * OB;
  const int t = threadIdx.x;
  const int pg = t & 63;
  const int og = t >> 6;
  const int r = pg >> 3;
  const int c0 = (pg & 7) * 4;
  const float s = *sx;

  int acc[4][OPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < OPT; ++o) acc[j][o] = 0;

  const T* xb = x + (size_t)b * H * W * Ci;

  for (int ci0 = 0; ci0 < Ci; ci0 += CK) {
    for (int i = t; i < CK * (TH + 2) * (TW + 2); i += NT) {
      const int c = i % CK;
      const int p = i / CK;
      const int px = p % (TW + 2);
      const int py = p / (TW + 2);
      const int gy = ty0 + py - 1;
      const int gx = tx0 + px - 1;
      const int gc = ci0 + c;
      int q = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Ci)
        q = __float2int_rn(__fdiv_rn(to_f(xb[((size_t)gy * W + gx) * Ci + gc]), s));
      s_in[py][px][c] = (int8_t)q;
    }
    for (int i = t; i < 9 * OB * CK; i += NT) {
      const int c = i % CK;
      const int o = (i / CK) % OB;
      const int k = i / (CK * OB);
      const int gc = ci0 + c;
      const int go = o0 + o;
      s_w[k][o][c] = (gc < Ci && go < O) ? wq[((size_t)k * O + go) * Ci + gc] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int sub = 0; sub < CK; sub += 16) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        int4 xin[6];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          xin[j] = *reinterpret_cast<const int4*>(&s_in[r + ky][c0 + j][sub]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int o = 0; o < OPT; ++o) {
            const int4 wv = *reinterpret_cast<const int4*>(&s_w[ky * 3 + kx][og * OPT + o][sub]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j][o] = dot16(xin[j + kx], wv, acc[j][o]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gy = ty0 + r;
  if (gy >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gx = tx0 + c0 + j;
    if (gx >= W) continue;
    T* yp = y + (((size_t)b * H + gy) * W + gx) * O;
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const int go = o0 + og * OPT + o;
      if (go >= O) continue;
      yp[go] = from_f<T>(act_fn(dequant(acc[j][o], s, sw[go], bias, go), act));
    }
  }
}

template <typename T>
int launch(const void* x, const int8_t* wq, const float* sx, const float* sw,
           const float* bias, void* y, int B, int H, int W, int Ci, int O,
           int act, cudaStream_t stream) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (O % 64 == 0) {
    dim3 grid(tiles, B, O / 64);
    conv3_w8a8_dp4a<T, 16><<<grid, NT, 0, stream>>>(
        (const T*)x, wq, sx, sw, bias, (T*)y, H, W, Ci, O, act);
  } else {
    dim3 grid(tiles, B, (O + 3) / 4);
    conv3_w8a8_dp4a<T, 1><<<grid, NT, 0, stream>>>(
        (const T*)x, wq, sx, sw, bias, (T*)y, H, W, Ci, O, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace dp4a

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). x: (B, H, W, Ci); sx: one f32
// on the device (the whole batch's scale); sw: (O,) f32; bias: (O,) f32 or
// null; y: (B, H, W, O). act: 0 none, 1 gelu(tanh), 2 silu, 3 lrelu.
// route 0 (dp4a): wq (9, O, Ci) int8, any Ci and O. route 1 (tensor
// cores): Ci % 64 == 0 and O % 64 == 0 or O <= 8, wq packed (O tiles,
// Ci / 64, 9, OT, 64) int8 with OT = 64, or 8 when O <= 8 (zero rows past
// O); x 16-byte aligned.
extern "C" int femasr_conv3_w8a8(const void* x, const void* wq, const void* sx,
                                 const void* sw, const void* bias, void* y, int B,
                                 int H, int W, int Ci, int O, int act, int dtype,
                                 int route, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* w8 = (const int8_t*)wq;
  const float* sxf = (const float*)sx;
  const float* swf = (const float*)sw;
  const float* bf = (const float*)bias;
  if (route == 1 && dtype == 0)
    return tc::route<float>(x, w8, sxf, swf, bf, y, B, H, W, Ci, O, act, s);
  if (route == 1 && dtype == 1)
    return tc::route<__nv_bfloat16>(x, w8, sxf, swf, bf, y, B, H, W, Ci, O, act, s);
  if (route == 0 && dtype == 0)
    return dp4a::launch<float>(x, w8, sxf, swf, bf, y, B, H, W, Ci, O, act, s);
  if (route == 0 && dtype == 1)
    return dp4a::launch<__nv_bfloat16>(x, w8, sxf, swf, bf, y, B, H, W, Ci, O, act, s);
  return (int)cudaErrorInvalidValue;
}
