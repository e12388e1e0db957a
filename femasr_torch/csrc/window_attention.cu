// Windowed multi-head self-attention: for each window and head,
// softmax(q k^T + relative-position bias [+ shift mask]) v.
//
// Replaces: femasr_tpu/ops/pallas/window_attention.py,
// window_attention_fused / _wattn_kernel, which takes any window length N
// and any head_dim. Here N <= 64 and head_dim <= 64 (the wrapper raises
// beyond). It is the attention core of FeMaSR's 24 Swin blocks (window 8
// -> N = 64 tokens, 8 heads of 32, 1089 windows per block for a 512px LR
// image) and of SwinIR's (N = 64 or 49, head_dim 30 or 10, packed qkv rows
// of 540 or 180 elements).
//
// What bounds it on the H100: per (window, head) it reads 3 x N x hd
// inputs and writes N x hd outputs for 4 N^2 hd FLOP, about 32 FLOP/byte
// at N = 64, hd = 32 in bf16: well below the bf16 ridge, so the bound is
// device memory (~0.05 ms per FeMaSR Swin block at 3.35 TB/s, the shift
// mask included). The logits, the bias and mask adds and the softmax
// never leave the SM.
//
// Three routes (the wrapper's `route_of` picks one; the entry point checks
// its conditions):
//
// route 1, bf16, N = 64, hd = 32, 16-byte aligned rows (wattn_tc, FeMaSR's
// shape): tensor cores. A persistent block of four warps
// walks a contiguous run of (window, head) items, window-major, so it
// reads each window's mask once (into registers, reused for all heads).
// Each item's q/k/v head slices (3 x 64 rows of 64 bytes, which may be
// strided column slices of one packed qkv) are copied with 16-byte
// cp.async into one of two shared-memory buffers while the previous item
// computes. Each warp owns 16 query rows: S = q k^T by mma.sync m16n8k16
// (2 k-steps x 8 key tiles, operands by ldmatrix), bias and mask added in
// f32 on the accumulator fragment, row max and sum over the quad of lanes
// that holds a row, p = e / sum in f32 (one division per row and
// Markstein's correction per element: correctly rounded, and free of the
// IEEE division's slow path that the denormal e of masked logits took)
// rounded to bf16 (the JAX kernel's rounding point, window_attention.py:50)
// and packed from the accumulator registers straight into the A fragments
// of P V, with V read by ldmatrix.trans. The warp stages its 16 x 32 bf16
// output in its own q rows (no other warp reads them) and stores it with
// 16-byte writes. Shared rows are 64 bytes; the 16-byte chunk index is
// XORed with bits 1-2 of the row so every ldmatrix is free of bank
// conflicts. What holds it above its bound: one item in flight per block
// (three blocks per SM at 145 registers) and the bias, read from L2 per
// item without a prefetch.
//
// route 2, bf16, any other N <= 64 and hd <= 64 (wattn_tc_any<HDP>, the
// SwinIR shapes): the same tensor-core arithmetic and rounding points, in
// a simple form. One block of four warps per (window, head). The head
// slices are staged in shared memory zero-padded to 64 rows and to HDP =
// hd rounded up to 16 columns (zero columns change neither q k^T nor the
// stored columns), by bf16 pairs where q, k, v and their strides are
// 4-byte aligned (a packed C = 180 qkv row is only that) and by single
// elements otherwise: no pass repacks q/k/v. Shared rows are HDP + 8
// elements, so the eight rows of every ldmatrix fall in distinct banks.
// Key columns j >= N are set to -inf before the softmax (e = 0, so they
// reach neither the max nor the sum) and query rows >= N are never stored.
// Stores are per element. What holds it above its bound: every item waits
// for its own loads (no overlap), the padding of N = 49 to 64 and of hd =
// 30 / 10 to 32 / 16 (1.7x / 2.1x the tensor-core work), and 2-byte
// stores.
//
// route 0, f32 (wattn_f32<HDP>): FFMA, kept for the f32 correctness gate;
// true f32 sums. One block of 256 threads per (window, head), q/k/v staged
// in shared memory in f32 (zero-padded as in route 2), four threads per
// query row.
//
// q is pre-scaled by the caller. Token strides are arguments.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NMAX = 64;      // tokens per window, at most
constexpr int HDMAX = 64;     // head_dim, at most

// -- PTX helpers (tensor-core routes) ------------------------------------------

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

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// softmax's p = e / sum correctly rounded with one division per row: with
// y the correctly rounded 1 / sum, q = e y, Markstein's q + (e - sum q) y
// is e / sum rounded (the per-element IEEE division took its slow path on
// the denormal e of masked logits)
__device__ __forceinline__ float prob(float e, float sum, float rs) {
  const float q = e * rs;
  return fmaf(rs, fmaf(-sum, q, e), q);
}

// The tensor-core routes' softmax over a warp's S = q k^T + bias [+ mask]
// in the m16n8k16 C fragments of 8 key tiles: element e of tile n sits at
// the warp's row g + 8*(e >> 1) (g = lane >> 2), so rows g and g + 8 are
// each spread over the quad of lanes that share g. On entry mx holds the
// lane's partial row maxima; on exit s holds e = exp(s - max), sum the row
// sums and rs their reciprocals, all in f32.
__device__ __forceinline__ void softmax_rows(float (&s)[8][4], float (&mx)[2],
                                             float (&sum)[2],
                                             float (&rs)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    sum[hh] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - mx[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    rs[hh] = 1.f / sum[hh];
  }
}

// P V's A fragment for keys 16kk..16kk + 15: key tiles 2kk and 2kk + 1 of
// softmax_rows' e, as p = e / sum rounded to bf16 (the JAX kernel's
// rounding point, window_attention.py:50)
__device__ __forceinline__ void p_fragment(const float (&s)[8][4], int kk,
                                           const float (&sum)[2],
                                           const float (&rs)[2],
                                           uint32_t* pa) {
  pa[0] = pack_bf16(prob(s[2 * kk][0], sum[0], rs[0]),
                    prob(s[2 * kk][1], sum[0], rs[0]));
  pa[1] = pack_bf16(prob(s[2 * kk][2], sum[1], rs[1]),
                    prob(s[2 * kk][3], sum[1], rs[1]));
  pa[2] = pack_bf16(prob(s[2 * kk + 1][0], sum[0], rs[0]),
                    prob(s[2 * kk + 1][1], sum[0], rs[0]));
  pa[3] = pack_bf16(prob(s[2 * kk + 1][2], sum[1], rs[1]),
                    prob(s[2 * kk + 1][3], sum[1], rs[1]));
}

// -- route 0, f32: FFMA ------------------------------------------------------

namespace f32 {

constexpr int NT = 256;

template <int HDP>
constexpr int smem_bytes() {
  return (2 * NMAX * (HDP + 1) + NMAX * HDP + NMAX * (NMAX + 1)) * 4;
}

template <int HDP>
__global__ void __launch_bounds__(NT) wattn_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ out, int n, int hd,
    int nw, long ldq, long ldk, long ldv, long ldo) {
  extern __shared__ float fsm[];
  float(*sq)[HDP + 1] = reinterpret_cast<float(*)[HDP + 1]>(fsm);
  float(*sk)[HDP + 1] =
      reinterpret_cast<float(*)[HDP + 1]>(fsm + NMAX * (HDP + 1));
  float(*sv)[HDP] =
      reinterpret_cast<float(*)[HDP]>(fsm + 2 * NMAX * (HDP + 1));
  float(*sp)[NMAX + 1] = reinterpret_cast<float(*)[NMAX + 1]>(
      fsm + 2 * NMAX * (HDP + 1) + NMAX * HDP);

  const long win = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const size_t tok0 = (size_t)win * n;
  const size_t col0 = (size_t)h * hd;

  // zero-padded to NMAX rows and HDP columns
  for (int i = t; i < NMAX * HDP; i += NT) {
    const int r = i / HDP;
    const int d = i % HDP;
    const bool in = r < n && d < hd;
    sq[r][d] = in ? q[(tok0 + r) * ldq + col0 + d] : 0.f;
    sk[r][d] = in ? k[(tok0 + r) * ldk + col0 + d] : 0.f;
    sv[r][d] = in ? v[(tok0 + r) * ldv + col0 + d] : 0.f;
  }
  __syncthreads();

  const int row = t >> 2;
  const int lane4 = t & 3;
  const bool live = row < n;
  float qr[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) qr[d] = sq[row][d];

  const float* brow = bias + ((size_t)h * n + row) * n;
  const float* mrow =
      mask ? mask + ((size_t)(win % nw) * n + row) * n : nullptr;
  float lg[16];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int j = lane4 + 4 * m;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HDP; ++d) s = fmaf(qr[d], sk[j][d], s);
    if (j >= n) {
      s = -CUDART_INF_F;
    } else if (live) {
      s += brow[j];
      if (mrow) s += mrow[j];
    }
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

  constexpr int DPT = HDP / 4;          // output columns per thread
  const int d0 = lane4 * DPT;
  float acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float pj = sp[row][j];
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[e] = fmaf(pj, sv[j][d0 + e], acc[e]);
  }
  if (!live) return;
  float* op = out + (tok0 + row) * ldo + col0;
#pragma unroll
  for (int e = 0; e < DPT; ++e)
    if (d0 + e < hd) op[d0 + e] = acc[e];
}

template <int HDP>
int launch_hdp(const float* q, const float* k, const float* v,
               const float* bias, const float* mask, float* out, int nwin,
               int n, int hd, int nh, int nw, long ldq, long ldk, long ldv,
               long ldo, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      wattn_f32<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nwin, nh);
  wattn_f32<HDP><<<grid, NT, bytes, stream>>>(q, k, v, bias, mask, out, n,
                                              hd, nw, ldq, ldk, ldv, ldo);
  return (int)cudaGetLastError();
}

int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* mask, float* out, int nwin, int n, int hd, int nh,
           int nw, long ldq, long ldk, long ldv, long ldo,
           cudaStream_t stream) {
  if (hd <= 16)
    return launch_hdp<16>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                          ldk, ldv, ldo, stream);
  if (hd <= 32)
    return launch_hdp<32>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                          ldk, ldv, ldo, stream);
  if (hd <= 48)
    return launch_hdp<48>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                          ldk, ldv, ldo, stream);
  return launch_hdp<64>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                        ldk, ldv, ldo, stream);
}

}  // namespace f32

// -- route 1, bf16, N = 64, hd = 32: tensor cores --------------------------------

namespace tc {

constexpr int N = 64;
constexpr int HD = 32;

constexpr int NWARP = 4;                  // 16 query rows each
constexpr int NT = NWARP * 32;
constexpr int ROW = HD * 2;               // 64-byte rows
constexpr int SLICE = N * ROW;            // one head's q, k or v: 4 KB
constexpr int LOADS = 3 * N * (ROW / 16) / NT;   // 16-byte copies per thread

// byte offset of 16-byte chunk c (0..3) of 64-byte row r, swizzled
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * ROW + ((c ^ ((r >> 1) & 3)) << 4));
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
    float sum[2], rs[2];
    softmax_rows(s, mx, sum, rs);

    // out = p v: V's B fragments by ldmatrix.trans (keys 16kk + (lane & 7)
    // + 8*((lane >> 3) & 1), chunk 2*dp + (lane >> 4))
    float o[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      p_fragment(s, kk, sum, rs, pa);
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

// -- route 2, bf16, N <= 64, hd <= 64: tensor cores, padded -------------------

namespace tc_any {

constexpr int NWARP = 4;                  // 16 query rows each
constexpr int NT = NWARP * 32;

template <int HDP>
__global__ void __launch_bounds__(NT) wattn_tc_any(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int n,
    int hd, int nh, int nw, long ldq, long ldk, long ldv, long ldo,
    int pairs) {
  constexpr int RS = (HDP + 8) * 2;       // shared row, bytes
  constexpr int SLICE = NMAX * RS;
  constexpr int PR = HDP / 2;             // bf16 pairs per row
  constexpr int KS = HDP / 16;            // k-steps of q k^T
  __shared__ __align__(128) unsigned char smem[3 * SLICE];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q4 = lane & 3;
  const long win = blockIdx.x / nh;
  const int h = (int)(blockIdx.x % nh);
  const size_t tok0 = (size_t)win * n;
  const size_t col0 = (size_t)h * hd;

  // stage q, k, v zero-padded: pair i of row r holds columns 2i, 2i + 1
  for (int i = tid; i < 3 * NMAX * PR; i += NT) {
    const int which = i / (NMAX * PR);    // 0 q, 1 k, 2 v
    const int r = (i / PR) % NMAX;
    const int d = 2 * (i % PR);
    uint32_t val = 0;
    if (r < n && d < hd) {
      const __nv_bfloat16* base = which == 0 ? q : (which == 1 ? k : v);
      const long ld = which == 0 ? ldq : (which == 1 ? ldk : ldv);
      const __nv_bfloat16* src = base + (tok0 + r) * ld + col0 + d;
      if (pairs) {
        val = *reinterpret_cast<const uint32_t*>(src);
      } else {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
        val = s16[0];
        if (d + 1 < hd) val |= (uint32_t)s16[1] << 16;
      }
    }
    *reinterpret_cast<uint32_t*>(smem + which * SLICE + r * RS + 2 * d) = val;
  }
  __syncthreads();

  const uint32_t sq = s0;
  const uint32_t sk = s0 + SLICE;
  const uint32_t sv = s0 + 2 * SLICE;

  // S = q k^T. A: rows warp*16 + (lane & 15), chunk 2*ks + (lane >> 4). B:
  // key tile nt, row nt*8 + (lane & 7); an x4 load holds the chunks of two
  // k-steps, an x2 load those of the last one when KS is odd.
  uint32_t a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(sq + (warp * 16 + (lane & 15)) * RS + (2 * ks + (lane >> 4)) * 16,
            a[ks]);
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const uint32_t krow = sk + (nt * 8 + (lane & 7)) * RS;
#pragma unroll
    for (int ks = 0; ks < KS; ks += 2) {
      uint32_t b[4];
      if (ks + 1 < KS) {
        ldsm_x4(krow + (2 * ks + (lane >> 3)) * 16, b);
        mma(s[nt], a[ks], b[0], b[1]);
        mma(s[nt], a[ks + 1], b[2], b[3]);
      } else {
        ldsm_x2(krow + (2 * ks + ((lane >> 3) & 1)) * 16, b);
        mma(s[nt], a[ks], b[0], b[1]);
      }
    }
  }

  // + bias + mask in f32; key columns >= n to -inf. C fragment element e
  // of key tile nt sits at query row warp*16 + g + 8*(e >> 1), key
  // nt*8 + 2*q4 + (e & 1).
  const int row0 = warp * 16 + g;
  const float* bh = bias + (size_t)h * n * n;
  const float* mw = mask ? mask + (size_t)(win % nw) * n * n : nullptr;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + 8 * (e >> 1);
      const int j = nt * 8 + 2 * q4 + (e & 1);
      float& sv_ = s[nt][e];
      if (j >= n) {
        sv_ = -CUDART_INF_F;
      } else if (r < n) {
        sv_ = sv_ + bh[r * n + j];
        if (mw) sv_ = sv_ + mw[r * n + j];
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sv_);
    }
  float sum[2], rs[2];
  softmax_rows(s, mx, sum, rs);

  // out = p v: V's B fragments by ldmatrix.trans (keys 16kk + (lane & 7) +
  // 8*((lane >> 3) & 1), chunk 2*dp + (lane >> 4))
  constexpr int NTO = HDP / 8;
  float o[NTO][4];
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    p_fragment(s, kk, sum, rs, pa);
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(sv + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                    (2 * dp + (lane >> 4)) * 16,
                b);
      mma(o[2 * dp], pa, b[0], b[1]);
      mma(o[2 * dp + 1], pa, b[2], b[3]);
    }
  }

  // rows < n, columns < hd, one bf16 at a time
#pragma unroll
  for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      const int d = nt * 8 + 2 * q4;
      if (r >= n) continue;
      __nv_bfloat16* dst = out + (tok0 + r) * ldo + col0 + d;
      if (d < hd) dst[0] = __float2bfloat16_rn(o[nt][2 * hh]);
      if (d + 1 < hd) dst[1] = __float2bfloat16_rn(o[nt][2 * hh + 1]);
    }
}

template <int HDP>
int launch_hdp(const void* q, const void* k, const void* v, const float* bias,
               const float* mask, void* out, int nwin, int n, int hd, int nh,
               int nw, long ldq, long ldk, long ldv, long ldo, int pairs,
               cudaStream_t stream) {
  const long items = (long)nwin * nh;
  wattn_tc_any<HDP><<<(unsigned)items, NT, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, bias, mask, (__nv_bfloat16*)out, n, hd, nh,
      nw, ldq, ldk, ldv, ldo, pairs);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const float* bias,
           const float* mask, void* out, int nwin, int n, int hd, int nh,
           int nw, long ldq, long ldk, long ldv, long ldo,
           cudaStream_t stream) {
  // bf16 pairs where every pair is 4-byte aligned: hd even (a pair never
  // straddles two heads), even token strides, 4-byte aligned bases
  const int pairs = hd % 2 == 0 && ldq % 2 == 0 && ldk % 2 == 0 &&
                    ldv % 2 == 0 &&
                    (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 3) == 0;
  if (hd <= 16)
    return launch_hdp<16>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                          ldk, ldv, ldo, pairs, stream);
  if (hd <= 32)
    return launch_hdp<32>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                          ldk, ldv, ldo, pairs, stream);
  if (hd <= 48)
    return launch_hdp<48>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                          ldk, ldv, ldo, pairs, stream);
  return launch_hdp<64>(q, k, v, bias, mask, out, nwin, n, hd, nh, nw, ldq,
                        ldk, ldv, ldo, pairs, stream);
}

}  // namespace tc_any

}  // namespace

// q/k/v/out: (nwin, n, nh*hd) with token strides ldq/ldk/ldv/ldo (elements)
// and unit feature stride; 1 <= n <= 64, 1 <= hd <= 64. bias: (nh, n, n)
// f32. mask: (nw, n, n) f32 or null; window b uses mask[b % nw]. route: 0
// float32 (FFMA); 1 bfloat16 on the N = 64, hd = 32 tensor-core kernel (q,
// k, v 16-byte aligned with strides a multiple of 8); 2 bfloat16 on the
// padded tensor-core kernel (any alignment).
extern "C" int femasr_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* mask, void* out, int nwin,
                                       int n, int nh, int hd, int nw, long ldq,
                                       long ldk, long ldv, long ldo, int route,
                                       void* stream) {
  if (n < 1 || n > NMAX || hd < 1 || hd > HDMAX || nwin < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0)
    return f32::launch((const float*)q, (const float*)k, (const float*)v,
                       (const float*)bias, (const float*)mask, (float*)out,
                       nwin, n, hd, nh, nw, ldq, ldk, ldv, ldo, s);
  if (route == 1) {
    const bool aligned =
        (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0 &&
        ldq % 8 == 0 && ldk % 8 == 0 && ldv % 8 == 0 && ldo % 8 == 0;
    if (n != tc::N || hd != tc::HD || !aligned)
      return (int)cudaErrorInvalidValue;
    return tc::launch(q, k, v, (const float*)bias, (const float*)mask, out,
                      nwin, nh, nw, ldq, ldk, ldv, ldo, s);
  }
  if (route == 2)
    return tc_any::launch(q, k, v, (const float*)bias, (const float*)mask,
                          out, nwin, n, hd, nh, nw, ldq, ldk, ldv, ldo, s);
  return (int)cudaErrorInvalidValue;
}
