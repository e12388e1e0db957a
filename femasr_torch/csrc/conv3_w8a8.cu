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
// byte: below the int8 tensor cores' ridge, so a tensor-core version would
// be bound by device memory (~0.34 ms). This first version multiplies with
// __dp4a on the CUDA cores (4 MACs per instruction, ~130 TOPS), so it is
// bound by those operations, several times above the memory bound; an
// implicit-GEMM mma.sync / wgmma s8 version is later work.
//
// Design: the tiling of csrc/conv3.cu. One block computes an 8x32 pixel
// tile for 4*OPT output channels. Input channels are swept in chunks of 32:
// the (8+2)x(32+2) haloed input chunk is quantized while it is staged
// (round-half-even of a true IEEE division, as jnp.round(x / s_x)) into
// shared memory as int8 with each pixel's 32 channels contiguous, zero
// outside the image or past Ci; the chunk's weights (int8, laid out
// (9, O, Ci) by the wrapper) beside it. Each thread keeps 4 pixels x OPT
// outputs of int32 sums in registers and reads 16 channels of a pixel or a
// weight row per shared load. The epilogue keeps the reference's
// association, acc * (s_x * s_w[o]) then + bias, with _rn intrinsics so
// nvcc cannot fuse them into one FMA. Output is written in the input dtype.

#include "w8a8_common.cuh"

namespace {

constexpr int TH = 8;
constexpr int TW = 32;
constexpr int CK = 32;
constexpr int NT = 256;

using namespace w8a8;

template <typename T, int OPT>
__global__ void __launch_bounds__(NT) conv3_w8a8_kernel(
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
    conv3_w8a8_kernel<T, 16><<<grid, NT, 0, stream>>>(
        (const T*)x, wq, sx, sw, bias, (T*)y, H, W, Ci, O, act);
  } else {
    dim3 grid(tiles, B, (O + 3) / 4);
    conv3_w8a8_kernel<T, 1><<<grid, NT, 0, stream>>>(
        (const T*)x, wq, sx, sw, bias, (T*)y, H, W, Ci, O, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). x: (B, H, W, Ci); wq: (9, O,
// Ci) int8; sx: one f32 on the device (the whole batch's scale); sw: (O,)
// f32; bias: (O,) f32 or null; y: (B, H, W, O). act: 0 none, 1 gelu(tanh),
// 2 silu, 3 lrelu.
extern "C" int femasr_conv3_w8a8(const void* x, const void* wq, const void* sx,
                                 const void* sw, const void* bias, void* y, int B,
                                 int H, int W, int Ci, int O, int act, int dtype,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* w8 = (const int8_t*)wq;
  const float* sxf = (const float*)sx;
  const float* swf = (const float*)sw;
  const float* bf = (const float*)bias;
  if (dtype == 0)
    return launch<float>(x, w8, sxf, swf, bf, y, B, H, W, Ci, O, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w8, sxf, swf, bf, y, B, H, W, Ci, O, act, s);
  return (int)cudaErrorInvalidValue;
}
