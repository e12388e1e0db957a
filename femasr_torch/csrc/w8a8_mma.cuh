// The int8 tensor-core pieces of the w8a8 kernels (conv3_w8a8.cu,
// matmul_w8a8.cu, matmul_w8a8_q.cu): shared rows of one 64-byte K chunk
// with a bank-conflict-free swizzle, 16-byte cp.async copies, ldmatrix
// fragment loads, mma.sync m16n8k32 s8 x s8 -> s32 and a warp's MMA sweep
// over one chunk, the exact int8 quantize without IEEE division (also of
// 16 float or bf16 values loaded as raw 16-byte words), and the swizzled
// staging of a warp's outputs for 16-byte stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w8a8 {

constexpr int CK = 64;               // K bytes (int8 values) per chunk
constexpr int ROW_CHUNKS = CK / 16;  // 16-byte chunks per 64-byte row

// byte offset of 16-byte chunk c of 64-byte row r, swizzled: the eight
// row addresses of every ldmatrix phase fall on distinct banks
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// zero-fills the 16 bytes instead of reading src when !ok
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's MMAs over one 64-byte K chunk: MT m16 tiles of A (swizzled rows
// a_row0 + 16 m + 0..15 at a_s) times NT8 n8 tiles of B (swizzled rows
// w_row0 + 8 n + 0..7 at w_s, one output column per row), summed into acc.
// Per-lane ldmatrix rows: A row (lane & 15) of an m16 tile at chunk
// +(lane >> 4); B row (lane & 7) + 8 * (lane >> 4) at chunk
// +((lane >> 3) & 1). An int8 k32 fragment is the bf16 k16 fragment's
// bytes. C fragment element e: row g + 8 * (e >> 1) of the m16 tile,
// column 2 * q4 + (e & 1) of the n8 tile (g = lane >> 2, q4 = lane & 3).
template <int MT, int NT8>
__device__ __forceinline__ void mma_k64(int (&acc)[MT][NT8][4], uint32_t a_s,
                                        int a_row0, uint32_t w_s, int w_row0,
                                        int lane) {
  const int a_row = lane & 15;
  const int a_chk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_chk = (lane >> 3) & 1;
#pragma unroll
  for (int kc = 0; kc < CK / 32; ++kc) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldsm_x4(a_s + swz(a_row0 + m * 16 + a_row, kc * 2 + a_chk), a[m]);
    if constexpr (NT8 == 1) {
      uint32_t bf[2];
      ldsm_x2(w_s + swz(w_row0 + (lane & 7), kc * 2 + b_chk), bf);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_s8(acc[m][0], a[m], bf[0], bf[1]);
    } else {
      // all B fragments first: no spill at 128 registers
      uint32_t bf[NT8 / 2][4];
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np)
        ldsm_x4(w_s + swz(w_row0 + np * 16 + b_row, kc * 2 + b_chk), bf[np]);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_s8(acc[m][2 * np], a[m], bf[np][0], bf[np][1]);
          mma_s8(acc[m][2 * np + 1], a[m], bf[np][2], bf[np][3]);
        }
    }
  }
}

// round(v / s) to an int8 code (low byte), half to even, v / s correctly
// rounded as torch.round(torch.div(v, s)) takes it; r = 1 / s correctly
// rounded (__frcp_rn). The first remainder step makes the quotient
// faithful, the second (Markstein's) correctly rounded, without the IEEE
// division's per-value slow-path check.
__device__ __forceinline__ uint32_t quant(float v, float s, float r) {
  float q = __fmul_rn(v, r);
  q = __fmaf_rn(__fmaf_rn(-s, q, v), r, q);
  q = __fmaf_rn(__fmaf_rn(-s, q, v), r, q);
  return (uint32_t)__float2int_rn(q) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d,
                                          float s, float r) {
  return quant(a, s, r) | (quant(b, s, r) << 8) | (quant(c, s, r) << 16) |
         (quant(d, s, r) << 24);
}

// 16 input values as raw 16-byte words: bf16 two, f32 four
template <typename T>
struct Raw {
  static constexpr int N = sizeof(T) == 2 ? 2 : 4;
  uint4 u[N];
};

template <typename T>
__device__ __forceinline__ void load16(Raw<T>& raw, const T* src, bool ok) {
#pragma unroll
  for (int k = 0; k < Raw<T>::N; ++k)
    raw.u[k] = ok ? __ldg(reinterpret_cast<const uint4*>(src) + k)
                  : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ uint4 quant16(const Raw<float>& raw, float s,
                                         float r) {
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 f = *reinterpret_cast<const float4*>(&raw.u[k]);
    o[k] = pack4(f.x, f.y, f.z, f.w, s, r);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint4 quant16(const Raw<__nv_bfloat16>& raw,
                                         float s, float r) {
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw.u[k >> 1]) +
                        2 * (k & 1);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + 1));
    o[k] = pack4(lo.x, lo.y, hi.x, hi.y, s, r);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// byte offset of byte `byte` of staged row px (RB bytes a row): the 16-byte
// chunk index XORed with the row's low bits, so the fragment writes of a
// warp spread over the banks
template <int RB, int SPAN>
__device__ __forceinline__ int stage_off(int px, int byte) {
  return px * RB + (((byte >> 4) ^ (px & (SPAN - 1))) << 4) + (byte & 15);
}

// a pair of outputs of one C fragment row, into the staging area
__device__ __forceinline__ void put2(unsigned char* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(unsigned char* p, __nv_bfloat16 a,
                                     __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

}  // namespace w8a8
