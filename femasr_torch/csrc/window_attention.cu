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
// bound is device memory (~0.05 ms per Swin block at 3.35 TB/s, the shift
// mask included). The logits, the bias and mask adds and the softmax
// never leave the SM.
//
// bf16 (wattn_tc): tensor cores. A persistent block of four warps walks a
// contiguous run of (window, head) items, window-major, so it reads each
// window's mask once (into registers, reused for all heads). Each item's
// q/k/v head slices (3 x 64 rows of 64 bytes, which may be strided column
// slices of one packed qkv) are copied with 16-byte cp.async into one of
// two shared-memory buffers while the previous item computes. Each warp
// owns 16 query rows: S = q k^T by mma.sync m16n8k16 (2 k-steps x 8 key
// tiles, operands by ldmatrix), bias and mask added in f32 on the
// accumulator fragment, row max and sum over the quad of lanes that holds
// a row, p = e / sum in f32 (one division per row and Markstein's
// correction per element: correctly rounded, and free of the IEEE
// division's slow path that the denormal e of masked logits took) rounded
// to bf16 (the JAX kernel's rounding point, window_attention.py:50) and
// packed from the accumulator registers straight into the A fragments of
// P V, with V read by ldmatrix.trans. The warp stages its 16 x 32 bf16
// output in its own q rows (no other warp reads them) and stores it with
// 16-byte writes. Shared rows are 64 bytes; the 16-byte chunk index is
// XORed with bits 1-2 of the row so every ldmatrix is free of bank
// conflicts. What holds it above its bound: one item in flight per block
// (three blocks per SM at 145 registers) and the bias, read from L2 per
// item without a prefetch.
//
// f32 (wattn_f32): FFMA, kept for the f32 correctness gate. One block of
// 256 threads per (window, head), q/k/v staged in shared memory in f32,
// four threads per query row.
//
// q is pre-scaled by the caller. Token strides are arguments.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int N = 64;
constexpr int HD = 32;

// -- f32: FFMA ---------------------------------------------------------------

namespace f32 {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) wattn_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ out, int nw, long ldq,
    long ldk, long ldv, long ldo) {
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
    sq[n][d] = q[(tok0 + n) * ldq + h * HD + d];
    sk[n][d] = k[(tok0 + n) * ldk + h * HD + d];
    sv[n][d] = v[(tok0 + n) * ldv + h * HD + d];
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
  float* op = out + (tok0 + row) * ldo + h * HD + d0;
#pragma unroll
  for (int e = 0; e < 8; ++e) op[e] = acc[e];
}

int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* mask, float* out, int nwin, int nh, int nw, long ldq,
           long ldk, long ldv, long ldo, cudaStream_t stream) {
  dim3 grid(nwin, nh);
  wattn_f32<<<grid, NT, 0, stream>>>(q, k, v, bias, mask, out, nw, ldq, ldk,
                                     ldv, ldo);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bf16: tensor cores ------------------------------------------------------

namespace tc {

constexpr int NWARP = 4;                  // 16 query rows each
constexpr int NT = NWARP * 32;
constexpr int ROW = HD * 2;               // 64-byte rows
constexpr int SLICE = N * ROW;            // one head's q, k or v: 4 KB
constexpr int LOADS = 3 * N * (ROW / 16) / NT;   // 16-byte copies per thread

// byte offset of 16-byte chunk c (0..3) of 64-byte row r, swizzled
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * ROW + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(NT) wattn_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ out,
    int nwin, int nh, int nw, long ldq, long ldk, long ldv, long ldo) {
  // [buffer][q, k, v][64 rows x 64 B]
  __shared__ __align__(128) unsigned char smem[2 * 3 * SLICE];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q4 = lane & 3;
  const long items = (long)nwin * nh;
  const long lo = items * blockIdx.x / gridDim.x;
  const long hi = items * (blockIdx.x + 1) / gridDim.x;

  auto issue = [&](long it, int buf) {
    const long win = it / nh;
    const int h = (int)(it % nh);
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * NT;
      const int which = i / (N * 4);       // 0 q, 1 k, 2 v
      const int r = (i >> 2) & (N - 1);
      const int c = i & 3;
      const __nv_bfloat16* base = which == 0 ? q : (which == 1 ? k : v);
      const long ld = which == 0 ? ldq : (which == 1 ? ldk : ldv);
      const __nv_bfloat16* src = base + (win * N + r) * ld + h * HD + c * 8;
      const uint32_t dst = s0 + (buf * 3 + which) * SLICE + swz(r, c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // C fragment element e of key tile n sits at query row
  // warp*16 + g + 8*(e >> 1), key n*8 + 2*q4 + (e & 1)
  const int row0 = warp * 16 + g;
  float mk[8][4];
  long cur_win = -1;

  if (lo < hi) issue(lo, 0);
  int buf = 0;
  for (long it = lo; it < hi; ++it) {
    if (it + 1 < hi) {
      issue(it + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    const long win = it / nh;
    const int h = (int)(it % nh);
    if (win != cur_win) {
      cur_win = win;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2 m2 = make_float2(0.f, 0.f);
          if (mask)
            m2 = *reinterpret_cast<const float2*>(
                mask + ((win % nw) * N + row0 + 8 * hh) * N + n * 8 + 2 * q4);
          mk[n][2 * hh] = m2.x;
          mk[n][2 * hh + 1] = m2.y;
        }
    }

    const uint32_t sq = s0 + (buf * 3 + 0) * SLICE;
    const uint32_t sk = s0 + (buf * 3 + 1) * SLICE;
    const uint32_t sv = s0 + (buf * 3 + 2) * SLICE;

    // S = q k^T: A rows warp*16 + (lane & 15), chunk 2*ks + (lane >> 4);
    // B: key tile n, row n*8 + (lane & 7), chunk lane >> 3 (regs 0-1 the
    // first k-step, 2-3 the second)
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(sq + swz(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)), a[ks]);
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t b[4];
      ldsm_x4(sk + swz(n * 8 + (lane & 7), lane >> 3), b);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      mma(s[n], a[0], b[0], b[1]);
      mma(s[n], a[1], b[2], b[3]);
    }

    // + bias + mask, softmax in f32 (rows g and g + 8 of the warp)
    const float* bh = bias + (size_t)h * N * N;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 b2 = *reinterpret_cast<const float2*>(
            bh + (row0 + 8 * hh) * N + n * 8 + 2 * q4);
        float& s0v = s[n][2 * hh];
        float& s1v = s[n][2 * hh + 1];
        s0v = s0v + b2.x;
        s1v = s1v + b2.y;
        if (mask) {
          s0v = s0v + mk[n][2 * hh];
          s1v = s1v + mk[n][2 * hh + 1];
        }
        mx[hh] = fmaxf(mx[hh], fmaxf(s0v, s1v));
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mx[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    // p = e / sum correctly rounded with one division per row: with y the
    // correctly rounded 1 / sum, q = e y, Markstein's q + (e - sum q) y is
    // e / sum rounded (the per-element IEEE division took its slow path on
    // the denormal e of masked logits)
    float rs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      rs[hh] = 1.f / sum[hh];
    }
    auto prob = [&](float e, int hh) {
      const float q = e * rs[hh];
      return fmaf(rs[hh], fmaf(-sum[hh], q, e), q);
    };

    // out = p v: p's A fragment for keys 16kk.. is key tiles 2kk, 2kk+1 of
    // S; V's B fragments by ldmatrix.trans (keys 16kk + (lane & 7) +
    // 8*((lane >> 3) & 1), chunk 2*dp + (lane >> 4))
    float o[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(prob(s[2 * kk][0], 0), prob(s[2 * kk][1], 0));
      pa[1] = pack_bf16(prob(s[2 * kk][2], 1), prob(s[2 * kk][3], 1));
      pa[2] = pack_bf16(prob(s[2 * kk + 1][0], 0), prob(s[2 * kk + 1][1], 0));
      pa[3] = pack_bf16(prob(s[2 * kk + 1][2], 1), prob(s[2 * kk + 1][3], 1));
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(sv + swz(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                           2 * dp + (lane >> 4)),
                  b);
        mma(o[2 * dp], pa, b[0], b[1]);
        mma(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }

    // stage the warp's 16 x 32 output in its own q rows, then 16-byte
    // stores: two per lane, four lanes per 64-byte row
    unsigned char* qrows = smem + (buf * 3 + 0) * SLICE;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(qrows + swz(row0 + 8 * hh, n) + 4 * q4) =
            pack_bf16(o[n][2 * hh], o[n][2 * hh + 1]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = j * 32 + lane;
      const int r = warp * 16 + (idx >> 2);
      const int c = idx & 3;
      *reinterpret_cast<uint4*>(out + (win * N + r) * ldo + h * HD + c * 8) =
          *reinterpret_cast<const uint4*>(qrows + swz(r, c));
    }
    __syncthreads();
    buf ^= 1;
  }
}

int launch(const void* q, const void* k, const void* v, const float* bias,
           const float* mask, void* out, int nwin, int nh, int nw, long ldq,
           long ldk, long ldv, long ldo, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wattn_tc, NT, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long items = (long)nwin * nh;
  const long slots = (long)sms * per_sm;
  const int grid = (int)(items < slots ? items : slots);
  wattn_tc<<<grid, NT, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, bias, mask, (__nv_bfloat16*)out, nwin, nh, nw,
      ldq, ldk, ldv, ldo);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q/k/v/out: (nwin, 64, nh*32) with token strides ldq/ldk/ldv/ldo (elements)
// and unit feature stride. bias: (nh, 64, 64) f32. mask: (nw, 64, 64) f32 or
// null; window b uses mask[b % nw]. dtype: 0 = float32, 1 = bfloat16 (q, k,
// v 16-byte aligned with strides a multiple of 8).
extern "C" int femasr_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* mask, void* out, int nwin,
                                       int n, int nh, int hd, int nw, long ldq,
                                       long ldk, long ldv, long ldo, int dtype,
                                       void* stream) {
  if (n != N || hd != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return f32::launch((const float*)q, (const float*)k, (const float*)v,
                       (const float*)bias, (const float*)mask, (float*)out,
                       nwin, nh, nw, ldq, ldk, ldv, ldo, s);
  if (dtype == 1)
    return tc::launch(q, k, v, (const float*)bias, (const float*)mask, out,
                      nwin, nh, nw, ldq, ldk, ldv, ldo, s);
  return (int)cudaErrorInvalidValue;
}
