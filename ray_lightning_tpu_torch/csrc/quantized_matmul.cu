// Fused dequant-matmul: out = x @ dequant(W), the weight read as int8 or
// int4 codes plus f32 scales and never materialized in device memory.
//
// Replaces ray_lightning_tpu/models/pallas_matmul.py:_kernel (with
// _dequant_block and unpack_int4_block): the same function, not a copy of
// the Pallas grid.
//
//   x       (M, K) float32 or bfloat16, row-major
//   out     (M, N) in x's dtype
//   codes   transpose == 0: (K, N) int8, or (K, N/2) packed int4
//           transpose == 1: (N, K) int8, or (N, K/2) packed int4 (the tied
//           LM head's x @ E^T: the contraction runs over the stored last
//           axis)
//   scales  int8, transpose == 0: per-output-channel vector of length
//           `period`; column n reads scales[n % period] (the qkv kernel's
//           64 head_dim scales repeat over its 3*H heads)
//           int8, transpose == 1: (1, K), riding the contraction axis
//           int4: (K, N/gs) or (N, K/gs), one scale per group of gs along
//           the stored last axis
//
// Rounding points, one for one with the Pallas kernel: each weight element
// becomes f32(code) * scale in f32, is rounded to the param dtype and then
// to the compute dtype (x's); it multiplies x's value; the products are
// summed in f32 over all of K; the output is rounded once to x's dtype. No
// scale is ever folded into x or pulled out of the sum: in the transposed
// int8 case the scale rides the contraction axis, and folding it would
// change the bf16 rounding. JAX's two accumulation modes (one full-K dot,
// or f32-accumulated tile_k partial dots) both become this one f32 sum (in
// another order); tile_k is a TPU occupancy knob with no counterpart here.
//
// int4 nibbles are sign-extended with arithmetic shifts, low nibble first,
// value for value quant.unpack_int4 over all 256 bytes.
//
// Design (the numbers are in PERF.md). Four kernels; the caller names the
// one that runs (`route`, models/quantized_matmul.py:_route) and a route
// that does not take the call is refused, never replaced:
//
//   * gemv_dense (M <= 16, transpose == 0, N % 4 == 0): a decode step's
//     projections, on the CUDA cores. At M = 8 each weight byte is used 8
//     times, so the call is bound by the code bytes over the memory rate,
//     and what matters is keeping code loads in flight. A block owns 128
//     columns and 8 rows of x; each lane owns 4 adjacent columns (one
//     32-bit load of int8 codes, 16 bits of int4) and its warp a stride-8
//     share of the K rows, kUnroll rows of loads in flight; x sits in
//     shared memory as f32, up to 1024 rows of K at a time (all of it for
//     K = 768), and is read as broadcast float4s; the 8 warps' partial
//     sums meet in the same buffer. Where the trouble lies: qkv (N = 2304)
//     gives only 18 blocks for 132 SMs, out and down (N = 768) only 6 -- a
//     split over K across blocks (later work) is what fills the card there.
//   * gemv_attend (M <= 16, transpose == 1, K % 4 == 0 for int8, K % 8 for
//     int4): the tied head at decode. One warp per output column (a code
//     row of the table, contiguous along K), lanes split K with one 32-bit
//     load each (4 int8 or 8 int4 codes), a warp shuffle sum at the end;
//     the head's 50257 columns give 6283 blocks.
//   * tc (bf16 x, every call the GEMVs do not take: prefill's M = 1024,
//     ragged prefills, misaligned small shapes). At M = 1024 a call is
//     bound by operations (the head: 2 * 1024 * 768 * 50257 = 79 GFLOP),
//     so the products run on the tensor cores: wgmma m64nNk16, bf16 in,
//     f32 accumulators. One block per 128 x 128 output tile (64 x 64 where
//     128 x 128 would leave SMs idle: the N = 768 projections get 192
//     blocks, not 48), a warpgroup per 64 rows, walking K in steps of 64.
//     A ring of raw tiles -- the bf16 x tile, 128-byte swizzled, and the
//     codes as stored (8 KB of int8 or 4 KB of int4 for 128 columns) --
//     is filled by 16-byte cp.async (element loads where a row is ragged
//     or misaligned), two stages ahead for 128 x 128 (two blocks fit an
//     SM) and three for 64 x 64. Codes become f32 by the magic-number trick
//     (code_f32), not by I2F, a quarter-rate conversion. The threads
//     dequantize each stage's codes through registers into a bf16 B tile
//     in ONE canonical layout, K-major and 128-byte swizzled, whatever the
//     code layout (int8 or int4, (K, N) or transposed (N, K)), so all four
//     share one wgmma path; two B tiles alternate, so the threads
//     dequantize tile k + 1 while the tensor cores take tile k
//     (fence.proxy.async orders the threads' writes before wgmma's reads).
//     Each B element is dequantized with its own scale and rounded to bf16
//     (for bf16 x, rounding to the param dtype and then to bf16 is one
//     rounding to bf16), so the transposed int8 case, whose scale rides K,
//     needs nothing special. The output is rounded once to bf16 and
//     leaves through shared memory along rows: 16-byte stores where rows
//     are 16-byte aligned, else bf16 pairs on 4-byte boundaries (the
//     head's rows are 100514 bytes). No split over K and no atomics:
//     results repeat bitwise. What bounds it now: each K step is one
//     latency chain -- the copies landing, the dequant, the wgmma, two
//     barriers -- with no one part dominant, because the threads that
//     dequantize also wait on every wgmma and barrier; a producer
//     warpgroup (copies and dequant) feeding consumer warpgroups that
//     only issue wgmma is the next step.
//   * tiled_f32 (f32 x, every call the GEMVs do not take): the parity
//     path, on the CUDA cores in f32 -- tensor-core TF32 would not hold
//     its 1e-5. One block per (64 rows, 128 columns) of the output walks K
//     in steps of 32, staging the x tile and the dequantized weight tile
//     in shared memory as f32; each of 256 threads accumulates 8 x 4
//     outputs.
//
// Every kernel masks its edges (zeros past M, N and K), so any M >= 1 and
// any N -- the odd vocab 50257 included -- is taken.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns the CUDA error code of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

template <typename T> struct Val;
template <> struct Val<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Val<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// One weight element: f32(code) * scale, rounded to the param dtype, then
// to the compute dtype.
template <typename XT>
__device__ __forceinline__ float dequant(int code, float scale,
                                         bool param_bf16) {
  float w = static_cast<float>(code) * scale;
  if (param_bf16) w = Val<__nv_bfloat16>::round(w);
  return Val<XT>::round(w);
}

// Code i of a 32-bit word: int8 (i < 4) or int4 (i < 8, low nibble
// first), sign-extended.
template <int BITS>
__device__ __forceinline__ int code_at(uint32_t word, int i) {
  if (BITS == 8) return static_cast<int>(word << (24 - 8 * i)) >> 24;
  return static_cast<int>(word << (28 - 4 * i)) >> 28;
}

// ------------------------------------------------------------ decode GEMVs
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvRows = 8;        // rows of x a block computes
constexpr int kUnroll = 16;         // code rows in flight per lane
constexpr int kChunk = 1024;        // K of x staged in shared memory per pass

template <typename XT, int BITS>
__global__ void __launch_bounds__(kGemvThreads)
gemv_dense_kernel(const XT* __restrict__ x, const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, XT* __restrict__ out,
                  int M, int N, int K, int gs, int period, int param_bf16) {
  constexpr int kCols = 4;                 // adjacent columns per lane
  constexpr int BN = 32 * kCols;           // columns per block
  static_assert(kChunk * kGemvRows == kGemvWarps * kGemvRows * BN,
                "x staging and the warps' partial sums share one buffer");
  __shared__ __align__(16) float smem[kChunk * kGemvRows];   // 32 KB
  float (*xs)[kGemvRows] = reinterpret_cast<float (*)[kGemvRows]>(smem);
  float (*red)[kGemvRows][BN] =
      reinterpret_cast<float (*)[kGemvRows][BN]>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + lane * kCols;   // N % 4 == 0: all 4 valid
  const int m0 = blockIdx.y * kGemvRows;
  const bool active = n < N;
  const bool pbf = param_bf16 != 0;

  float acc[kGemvRows][kCols];
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.0f;
  // int8: the lane's 4 per-channel scales; int4: its 4 columns' groups
  float s8[kCols];
  int grp[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    s8[j] = (BITS == 8 && active) ? scales[(n + j) % period] : 0.0f;
    grp[j] = BITS == 4 ? (n + j) / gs : 0;
  }
  const int groups = BITS == 4 ? N / gs : 0;

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int kc = min(kChunk, K - c0);
    __syncthreads();                       // the last chunk's readers are done
    // fixed trip count, unrolled: a thread's x loads are all in flight
#pragma unroll
    for (int i = threadIdx.x; i < kChunk * kGemvRows; i += kGemvThreads) {
      const int m = i / kChunk, k = i % kChunk;   // k fastest: coalesced x
      xs[k][m] = (m0 + m < M && k < kc)
          ? Val<XT>::load(x + (size_t)(m0 + m) * K + c0 + k) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int kb = warp; kb < kc; kb += kGemvWarps * kUnroll) {
      uint32_t word[kUnroll];
      float s4[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kGemvWarps;
        word[u] = 0u;
        if (k < kc) {
          const size_t row = (size_t)(c0 + k);
          if (BITS == 8) {
            word[u] = *reinterpret_cast<const uint32_t*>(codes + row * N + n);
          } else {
            word[u] = *reinterpret_cast<const uint16_t*>(
                codes + row * (N / 2) + n / 2);
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              s4[u][j] = scales[row * groups + grp[j]];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kGemvWarps;
        if (k >= kc) break;                 // warp-uniform
        float w[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          w[j] = dequant<XT>(code_at<BITS>(word[u], j),
                             BITS == 8 ? s8[j] : s4[u][j], pbf);
        const float4 xa = *reinterpret_cast<const float4*>(&xs[k][0]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[k][4]);
        const float xv[kGemvRows] = {xa.x, xa.y, xa.z, xa.w,
                                     xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[m][j] = fmaf(xv[m], w[j], acc[m][j]);
      }
    }
  }
  // the warps' partial sums, added in shared memory (x's buffer)
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[warp][m][lane * kCols + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kGemvRows * BN; i += kGemvThreads) {
    const int m = i / BN, col = i % BN;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[w][m][col];
    const int gm = m0 + m, gn = blockIdx.x * BN + col;
    if (gm < M && gn < N) Val<XT>::store(out + (size_t)gm * N + gn, s);
  }
}

template <typename XT, int BITS>
__global__ void __launch_bounds__(kGemvThreads)
gemv_attend_kernel(const XT* __restrict__ x,
                   const int8_t* __restrict__ codes,
                   const float* __restrict__ scales, XT* __restrict__ out,
                   int M, int N, int K, int gs, int param_bf16) {
  constexpr int kPer = BITS == 8 ? 4 : 8;  // codes per 32-bit word
  constexpr int kSpan = 32 * kPer;         // K per warp sweep
  constexpr int kAttUnroll = 4;
  __shared__ __align__(16) float xs[kGemvRows][kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kGemvWarps + warp;   // this warp's column
  const int m0 = blockIdx.y * kGemvRows;
  const bool pbf = param_bf16 != 0;
  const int8_t* crow = codes + (size_t)n * (K * BITS / 8);
  const float* srow = BITS == 8 ? scales : scales + (size_t)n * (K / gs);

  float acc[kGemvRows];
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m) acc[m] = 0.0f;

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int kc = min(kChunk, K - c0);
    __syncthreads();
#pragma unroll
    for (int i = threadIdx.x; i < kGemvRows * kChunk; i += kGemvThreads) {
      const int m = i / kChunk, k = i % kChunk;
      xs[m][k] = (m0 + m < M && k < kc)
          ? Val<XT>::load(x + (size_t)(m0 + m) * K + c0 + k) : 0.0f;
    }
    __syncthreads();
    if (n >= N) continue;
    for (int kb = lane * kPer; kb < kc; kb += kSpan * kAttUnroll) {
      uint32_t word[kAttUnroll];
      float sc[kAttUnroll][kPer];
#pragma unroll
      for (int u = 0; u < kAttUnroll; ++u) {
        const int k = kb + u * kSpan;      // kc % kPer == 0: whole words
        word[u] = 0u;
        if (k < kc) {
          const int gk = c0 + k;
          word[u] = *reinterpret_cast<const uint32_t*>(crow +
                                                       gk * BITS / 8);
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            sc[u][e] = BITS == 8 ? srow[gk + e] : srow[(gk + e) / gs];
        }
      }
#pragma unroll
      for (int u = 0; u < kAttUnroll; ++u) {
        const int k = kb + u * kSpan;
        if (k >= kc) break;                 // lanes stop in K order
        // x at the lane's kPer positions: float4 reads, lanes contiguous
        float xv[kGemvRows][kPer];
#pragma unroll
        for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
          for (int q = 0; q < kPer / 4; ++q) {
            const float4 t =
                *reinterpret_cast<const float4*>(&xs[m][k + 4 * q]);
            xv[m][4 * q] = t.x;
            xv[m][4 * q + 1] = t.y;
            xv[m][4 * q + 2] = t.z;
            xv[m][4 * q + 3] = t.w;
          }
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const float w = dequant<XT>(code_at<BITS>(word[u], e), sc[u][e],
                                      pbf);
#pragma unroll
          for (int m = 0; m < kGemvRows; ++m)
            acc[m] = fmaf(xv[m][e], w, acc[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
  if (n < N && lane < kGemvRows && m0 + lane < M) {
    float v = acc[0];
#pragma unroll
    for (int m = 1; m < kGemvRows; ++m) v = lane == m ? acc[m] : v;
    Val<XT>::store(out + (size_t)(m0 + lane) * N + n, v);
  }
}

// ------------------------------------------------------------- tiled_f32
// f32 x on the CUDA cores (the parity path; the header says why).
constexpr int kBM = 64, kBN = 128, kBK = 32, kTM = 8, kTN = 4;
constexpr int kTiledThreads = (kBM / kTM) * (kBN / kTN);

// Stage the dequantized (kBK, kBN) weight tile at (k0, n0) into ws; zeros
// outside K and N. Each loop has a fixed trip count and is unrolled, so a
// thread's code loads are all in flight before the first is used.
template <int BITS, bool TRANS>
__device__ __forceinline__ void stage_weights(
    float (*ws)[kBN + 1], const int8_t* __restrict__ codes,
    const float* __restrict__ scales, int k0, int n0, int N, int K, int gs,
    int period, bool param_bf16) {
  const int tid = threadIdx.x;
  if (!TRANS && BITS == 8) {            // codes (K, N): n fastest
#pragma unroll
    for (int i = tid; i < kBK * kBN; i += kTiledThreads) {
      const int k = i / kBN, n = i % kBN, gk = k0 + k, gn = n0 + n;
      float w = 0.0f;
      if (gk < K && gn < N)
        w = dequant<float>(codes[(size_t)gk * N + gn], scales[gn % period],
                        param_bf16);
      ws[k][n] = w;
    }
  } else if (!TRANS) {                  // codes (K, N/2): one byte, 2 columns
    const int half = N / 2, groups = N / gs;
#pragma unroll
    for (int i = tid; i < kBK * (kBN / 2); i += kTiledThreads) {
      const int k = i / (kBN / 2), u = i % (kBN / 2);
      const int gk = k0 + k, gn = n0 + 2 * u;
      float w0 = 0.0f, w1 = 0.0f;
      if (gk < K && gn < N) {
        const uint32_t byte = static_cast<uint8_t>(
            codes[(size_t)gk * half + gn / 2]);
        // gs is even, so columns gn and gn + 1 share one group
        const float s = scales[(size_t)gk * groups + gn / gs];
        w0 = dequant<float>(code_at<4>(byte, 0), s, param_bf16);
        w1 = dequant<float>(code_at<4>(byte, 1), s, param_bf16);
      }
      ws[k][2 * u] = w0;
      ws[k][2 * u + 1] = w1;
    }
  } else if (BITS == 8) {               // codes (N, K): k fastest
#pragma unroll
    for (int i = tid; i < kBK * kBN; i += kTiledThreads) {
      const int k = i % kBK, n = i / kBK, gk = k0 + k, gn = n0 + n;
      float w = 0.0f;
      if (gk < K && gn < N)
        w = dequant<float>(codes[(size_t)gn * K + gk], scales[gk], param_bf16);
      ws[k][n] = w;
    }
  } else {                              // codes (N, K/2): one byte, 2 rows
    const int half = K / 2, groups = K / gs;
#pragma unroll
    for (int i = tid; i < (kBK / 2) * kBN; i += kTiledThreads) {
      const int u = i % (kBK / 2), n = i / (kBK / 2);
      const int gk = k0 + 2 * u, gn = n0 + n;
      float w0 = 0.0f, w1 = 0.0f;
      if (gk < K && gn < N) {
        const uint32_t byte = static_cast<uint8_t>(
            codes[(size_t)gn * half + gk / 2]);
        const float s = scales[(size_t)gn * groups + gk / gs];
        w0 = dequant<float>(code_at<4>(byte, 0), s, param_bf16);
        w1 = dequant<float>(code_at<4>(byte, 1), s, param_bf16);
      }
      ws[2 * u][n] = w0;
      ws[2 * u + 1][n] = w1;
    }
  }
}

template <int BITS, bool TRANS>
__global__ void __launch_bounds__(kTiledThreads)
tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
             const float* __restrict__ scales, float* __restrict__ out, int M,
             int N, int K, int gs, int period, int param_bf16) {
  constexpr int kThreadsN = kBN / kTN, kThreadsM = kBM / kTM;
  // +1 columns: staging with k fastest (x, transposed codes) is then free
  // of bank conflicts
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN, ty = tid / kThreadsN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = tid; i < kBM * kBK; i += kTiledThreads) {  // k fastest
      const int m = i / kBK, k = i % kBK, gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk]
                                    : 0.0f;
    }
    stage_weights<BITS, TRANS>(ws, codes, scales, k0, n0, N, K, gs,
                                   period, param_bf16 != 0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[k][ty + i * kThreadsM];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[k][tx + j * kThreadsN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * kThreadsM;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * kThreadsN;
      if (gm < M && gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------- tc
// bf16 x on the tensor cores (the header says why and how).
constexpr int kTcBK = 64;      // K per stage: one 128-byte swizzled bf16 row

// Code i of a 32-bit word of codes as an exact f32, without I2F (a
// quarter-rate conversion): the code c, offset to c + 2^(BITS - 1) >= 0,
// becomes the low mantissa bits of 2^23, which is then subtracted.
// `flipped` is the word XOR 0x80808080 (int8) or 0x88888888 (int4).
template <int BITS>
__device__ __forceinline__ float code_f32(uint32_t flipped, int i) {
  if (BITS == 8)
    return __uint_as_float(__byte_perm(flipped, 0x4B00u, 0x5440 + i)) -
           8388736.0f;                       // 2^23 + 128
  return __uint_as_float(0x4B000000u | ((flipped >> (4 * i)) & 0xFu)) -
         8388616.0f;                         // 2^23 + 8
}

template <int BITS, bool TRANS, int BM, int BN>
struct Tc {
  // raw (x tile, code tile) stages in the ring: three for 128 x 128 (two
  // blocks fit an SM), four for 64 x 64 (three fit)
  static constexpr int kStages = BM == 128 ? 3 : 4;
  static constexpr int kThreads = 2 * BM;     // a warpgroup per 64 rows
  static constexpr int kABytes = BM * 128;    // x tile, bf16, swizzled
  static constexpr int kBBytes = BN * 128;    // dequantized tile, swizzled
  // one stage's raw codes, as stored: (K, N) rows of K or (N, K) rows of N
  static constexpr int kRows = TRANS ? BN : kTcBK;
  static constexpr int kRowBytes = (TRANS ? kTcBK : BN) * BITS / 8;
  static constexpr int kStageBytes = kABytes + kRows * kRowBytes;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kBBytes + 1024;
  static_assert(kABytes % 1024 == 0 && (kRows * kRowBytes) % 1024 == 0,
                "every swizzled tile starts on a 1024-byte boundary");
};

// Issue the copies of k tile `k0` into `stage`: the x tile (BM rows of 64
// bf16, swizzled) and the raw code tile (unswizzled rows). 16-byte
// cp.async where the rows allow it, zero-filled past M, N and K; ragged
// or misaligned chunks are read element by element instead.
template <int BITS, bool TRANS, int BM, int BN>
__device__ __forceinline__ void tc_load(
    uint8_t* stage, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ codes, int m0, int n0, int k0, int M, int N,
    int K, bool x_vec, bool c_vec) {
  using S = Tc<BITS, TRANS, BM, BN>;
  const uint32_t a_s = hopper::smem_u32(stage);
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  for (int i = threadIdx.x; i < BM * 8; i += S::kThreads) {
    const int r = i >> 3, c = i & 7, gm = m0 + r, gk = k0 + 8 * c;
    const uint32_t dst = a_s + hopper::swz(r, c);
    if (x_vec) {                          // K % 8 == 0: whole chunks
      const bool in = gm < M && gk < K;
      hopper::cp_async16(dst, in ? x + (size_t)gm * K + gk : x,
                         in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = gk + 2 * e;
        const uint32_t lo = gm < M && k < K ? xb[(size_t)gm * K + k] : 0u;
        const uint32_t hi =
            gm < M && k + 1 < K ? xb[(size_t)gm * K + k + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      hopper::st_shared16(dst, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
  constexpr int kChunks = S::kRowBytes / 16;
  const uint32_t c_s = a_s + S::kABytes;
  const int r0 = TRANS ? n0 : k0, rows = TRANS ? N : K;
  const int b0 = (TRANS ? k0 : n0) * BITS / 8;
  const int row_bytes = (TRANS ? K : N) * BITS / 8;
  const uint8_t* cb = reinterpret_cast<const uint8_t*>(codes);
  for (int i = threadIdx.x; i < S::kRows * kChunks; i += S::kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int gr = r0 + r, gb = b0 + 16 * c;
    const uint32_t dst = c_s + r * S::kRowBytes + 16 * c;
    if (c_vec) {                          // row_bytes % 16 == 0
      const bool in = gr < rows && gb < row_bytes;
      hopper::cp_async16(dst, in ? cb + (size_t)gr * row_bytes + gb : cb,
                         in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int at = gb + 4 * e + b;
          if (gr < rows && at < row_bytes)
            w[e] |= static_cast<uint32_t>(cb[(size_t)gr * row_bytes + at])
                    << (8 * b);
        }
      }
      hopper::st_shared16(dst, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

// Dequantize one stage's raw codes into the bf16 B tile at `b_s`: row n
// holds the tile's 64 K values of column n0 + n (K-major), chunk kc (8 K
// values) at swizzled chunk kc ^ (n % 8). Each value is
// bf16(f32(code) * scale), exactly dequant()'s rounding for bf16 x
// whatever the leaf's dtype (rounding to bf16 twice is rounding once);
// zeros past N and K. Dense layouts give a thread a fixed column (its
// int8 scale `s_n` read once); transposed ones a fixed chunk of a row.
template <int BITS, bool TRANS, int BM, int BN>
__device__ __forceinline__ void tc_dequant(
    uint32_t b_s, const int8_t* cs, const float* __restrict__ scales,
    float s_n, int n0, int k0, int N, int K, int gs, bool s_vec) {
  using S = Tc<BITS, TRANS, BM, BN>;
  constexpr int kSteps = 8 * BN / S::kThreads;
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    int n, kc;
    if (!TRANS) {
      n = tid % BN;
      kc = tid / BN + s * (S::kThreads / BN);
    } else {
      n = tid / 8 + s * (S::kThreads / 8);
      kc = tid % 8;
    }
    const int gn = n0 + n;
    float w[8];
    const uint8_t* cu = reinterpret_cast<const uint8_t*>(cs);
    if (!TRANS && BITS == 8) {            // raw (64, BN)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e] = code_f32<8>(cu[(kc * 8 + e) * BN + n] ^ 0x80u, 0) * s_n;
    } else if (!TRANS) {                  // raw (64, BN / 2)
      // the column's group is fixed: scales (K, N / gs), a row apart
      const int groups = N / gs;
      const float* sg = scales + (gn < N ? gn / gs : 0);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int gk = k0 + kc * 8 + e;
        const uint32_t byte = cu[(kc * 8 + e) * (BN / 2) + n / 2] ^ 0x88u;
        const float sc = gk < K && gn < N ? sg[(size_t)gk * groups] : 0.0f;
        w[e] = code_f32<4>(byte, n & 1) * sc;
      }
    } else if (BITS == 8) {               // raw (BN, 64)
      const uint2 raw = *reinterpret_cast<const uint2*>(cs + n * 64 + kc * 8);
      const int gk = k0 + kc * 8;
      float sc[8];
      if (s_vec && gk + 8 <= K) {         // the 8 scales as two float4s
        const float4 a = *reinterpret_cast<const float4*>(scales + gk);
        const float4 b = *reinterpret_cast<const float4*>(scales + gk + 4);
        sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
        sc[4] = b.x; sc[5] = b.y; sc[6] = b.z; sc[7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) sc[e] = gk + e < K ? scales[gk + e] : 0.0f;
      }
      const uint32_t lo = raw.x ^ 0x80808080u, hi = raw.y ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e] = code_f32<8>(e < 4 ? lo : hi, e & 3) * sc[e];
    } else {                              // raw (BN, 32)
      const uint32_t raw =
          *reinterpret_cast<const uint32_t*>(cs + n * 32 + kc * 4) ^
          0x88888888u;
      // scales (N, K / gs): a chunk's 8 K values share one group when
      // gs % 8 == 0 (K % gs == 0, so the chunk is inside K)
      const float* sr = scales + (size_t)(gn < N ? gn : 0) * (K / gs);
      const int gk = k0 + kc * 8;
      if (gs % 8 == 0) {
        const float sc = gk < K && gn < N ? sr[gk / gs] : 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = code_f32<4>(raw, e) * sc;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = code_f32<4>(raw, e) *
                 (gk + e < K && gn < N ? sr[(gk + e) / gs] : 0.0f);
      }
    }
    hopper::st_shared16(
        b_s + hopper::swz(n, kc),
        make_uint4(hopper::pack_bf16(w[0], w[1]), hopper::pack_bf16(w[2], w[3]),
                   hopper::pack_bf16(w[4], w[5]),
                   hopper::pack_bf16(w[6], w[7])));
  }
}

template <int BN>
__device__ __forceinline__ void tc_mma(float (&acc)[BN / 2], uint64_t a,
                                       uint64_t b) {
  if constexpr (BN == 128) hopper::mma_ss_n128(acc, a, b, 1);
  else hopper::mma_ss_n64(acc, a, b, 1);
}

template <int BITS, bool TRANS, int BM, int BN>
__global__ void __launch_bounds__(2 * BM, 2)
tc_kernel(const __nv_bfloat16* __restrict__ x,
          const int8_t* __restrict__ codes, const float* __restrict__ scales,
          __nv_bfloat16* __restrict__ out, int M, int N, int K, int gs,
          int period) {
  using S = Tc<BITS, TRANS, BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  // [stages 0 .. kStages - 1: x tile, code tile][B tile 0][B tile 1]
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t b_tiles =
      hopper::smem_u32(smem + S::kStages * S::kStageBytes);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;
  const bool x_vec =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 && K % 8 == 0;
  const bool c_vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0 &&
                     ((TRANS ? K : N) * BITS / 8) % 16 == 0;
  const bool s_vec = (reinterpret_cast<uintptr_t>(scales) & 15) == 0;
  float s_n = 0.0f;
  if (BITS == 8 && !TRANS) {
    const int gn = n0 + threadIdx.x % BN;
    s_n = gn < N ? scales[gn % period] : 0.0f;
  }

  const int nk = (K + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < nk)
      tc_load<BITS, TRANS, BM, BN>(smem + s * S::kStageBytes, x, codes, m0,
                                   n0, s * kTcBK, M, N, K, x_vec, c_vec);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<S::kStages - 2>();
  __syncthreads();
  tc_dequant<BITS, TRANS, BM, BN>(
      b_tiles, reinterpret_cast<const int8_t*>(smem + S::kABytes), scales,
      s_n, n0, 0, N, K, gs, s_vec);
  hopper::fence_proxy_async();
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int pre = kt + S::kStages - 1;
    if (pre < nk)
      tc_load<BITS, TRANS, BM, BN>(
          smem + (pre % S::kStages) * S::kStageBytes, x, codes, m0, n0,
          pre * kTcBK, M, N, K, x_vec, c_vec);
    hopper::cp_async_commit();
    // the tensor cores take tile kt while the threads dequantize kt + 1
    const uint32_t a_s =
        hopper::smem_u32(smem + (kt % S::kStages) * S::kStageBytes) +
        wg * 64 * 128;
    const uint32_t b_s = b_tiles + (kt & 1) * S::kBBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks)
      tc_mma<BN>(acc, hopper::desc_kmajor(a_s + 32 * ks),
                 hopper::desc_kmajor(b_s + 32 * ks));
    hopper::wgmma_commit();
    if (kt + 1 < nk) {
      hopper::cp_async_wait<S::kStages - 2>();
      __syncthreads();
      tc_dequant<BITS, TRANS, BM, BN>(
          b_tiles + ((kt + 1) & 1) * S::kBBytes,
          reinterpret_cast<const int8_t*>(
              smem + ((kt + 1) % S::kStages) * S::kStageBytes + S::kABytes),
          scales, s_n, n0, (kt + 1) * kTcBK, N, K, gs, s_vec);
    }
    hopper::fence_proxy_async();
    hopper::wgmma_wait<0>();
    __syncthreads();
  }

  // the output, rounded once to bf16, through shared memory (the ring is
  // free: every copy has landed, every wgmma has read) so that the global
  // stores run along rows
  hopper::cp_async_wait<0>();
  __syncthreads();
  constexpr int kOs = BN + 8;             // padded row stride, bf16
  uint16_t* os = reinterpret_cast<uint16_t*>(smem);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(os + (r0 + 8 * i) * kOs + 8 * j +
                                   2 * (lane & 3)) =
          hopper::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  __syncthreads();
  uint16_t* ob = reinterpret_cast<uint16_t*>(out);
  if (N % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    // rows start on 16-byte boundaries: 8 outputs a store
    for (int i = threadIdx.x; i < BM * BN / 8; i += S::kThreads) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      const int gm = m0 + r, gn = n0 + c;
      if (gm < M && gn < N)
        *reinterpret_cast<uint4*>(ob + (size_t)gm * N + gn) =
            *reinterpret_cast<const uint4*>(os + r * kOs + c);
    }
  } else {
    // odd rows (the head's N = 50257): bf16 pairs on 4-byte boundaries,
    // a row's first or last element alone where its parity leaves one
    for (int i = threadIdx.x; i < BM * (BN / 2 + 1); i += S::kThreads) {
      const int r = i / (BN / 2 + 1), gm = m0 + r;
      if (gm >= M) continue;
      const size_t row = (size_t)gm * N;
      // 1 if the tile's first column of this row sits at an odd bf16
      const int odd = (int)(reinterpret_cast<uintptr_t>(ob + row + n0) >> 1)
                      & 1;
      const int c = 2 * (i % (BN / 2 + 1)) - odd;
      const int gn = n0 + c;
      const bool lo = c >= 0 && c < BN && gn < N;
      const bool hi = c + 1 < BN && gn + 1 < N;
      if (lo && hi)
        *reinterpret_cast<uint32_t*>(ob + row + gn) =
            os[r * kOs + c] | (uint32_t(os[r * kOs + c + 1]) << 16);
      else if (lo)
        ob[row + gn] = os[r * kOs + c];
      else if (hi)
        ob[row + gn + 1] = os[r * kOs + c + 1];
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <int BITS, bool TRANS, int BM, int BN>
int launch_tc_tile(const void* x, const void* codes, const void* scales,
                   void* out, int M, int N, int K, int gs, int period,
                   cudaStream_t stream) {
  using S = Tc<BITS, TRANS, BM, BN>;
  void (*kernel)(const __nv_bfloat16*, const int8_t*, const float*,
                 __nv_bfloat16*, int, int, int, int, int) =
      tc_kernel<BITS, TRANS, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned rows = (unsigned)((M + BM - 1) / BM);
  if (rows > 65535u) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((N + BN - 1) / BN, rows), S::kThreads, S::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), M,
      N, K, gs, period);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles where they give every SM a block, else 64 x 64 (at
// M = 1024 the N = 768 projections: 48 blocks against 192).
template <int BITS, bool TRANS>
int launch_tc(const void* x, const void* codes, const void* scales,
              void* out, int M, int N, int K, int gs, int period,
              cudaStream_t stream) {
  const long long big = (long long)((N + 127) / 128) * ((M + 127) / 128);
  if (big >= sm_count())
    return launch_tc_tile<BITS, TRANS, 128, 128>(x, codes, scales, out, M, N,
                                                 K, gs, period, stream);
  return launch_tc_tile<BITS, TRANS, 64, 64>(x, codes, scales, out, M, N, K,
                                             gs, period, stream);
}

// ----------------------------------------------------------------- launch
// The route is the wrapper's choice (models/quantized_matmul.py:_route);
// a route that does not take the call is refused, never replaced.
enum Route { kGemvDense = 0, kGemvAttend = 1, kTc = 2, kTiledF32 = 3 };

template <typename XT, int BITS, bool TRANS>
int launch(int route, const void* x, const void* codes, const void* scales,
           void* out, int M, int N, int K, int gs, int period,
           int param_bf16, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<XT, __nv_bfloat16>::value;
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* cp = static_cast<const int8_t*>(codes);
  const float* sp = static_cast<const float*>(scales);
  XT* op = static_cast<XT*>(out);
  const int mb = (M + kGemvRows - 1) / kGemvRows;
  if (route == kGemvDense && M <= 16 && !TRANS && N % 4 == 0) {
    gemv_dense_kernel<XT, BITS>
        <<<dim3((N + 127) / 128, mb), kGemvThreads, 0, stream>>>(
            xp, cp, sp, op, M, N, K, gs, period, param_bf16);
  } else if (route == kGemvAttend && M <= 16 && TRANS &&
             K % (BITS == 8 ? 4 : 8) == 0) {
    gemv_attend_kernel<XT, BITS>
        <<<dim3((N + kGemvWarps - 1) / kGemvWarps, mb), kGemvThreads, 0,
           stream>>>(xp, cp, sp, op, M, N, K, gs, param_bf16);
  } else if (route == kTc) {
    if constexpr (kBf16)
      return launch_tc<BITS, TRANS>(x, codes, scales, out, M, N, K, gs,
                                    period, stream);
    return (int)cudaErrorInvalidValue;
  } else if (route == kTiledF32) {
    if constexpr (!kBf16) {
      tiled_kernel<BITS, TRANS>
          <<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM), kTiledThreads,
             0, stream>>>(xp, cp, sp, op, M, N, K, gs, period, param_bf16);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_x(int route, const void* x, const void* codes,
             const void* scales, void* out, int M, int N, int K, int bits,
             int transpose, int gs, int period, int param_bf16,
             cudaStream_t stream) {
  if (bits == 8)
    return transpose
        ? launch<XT, 8, true>(route, x, codes, scales, out, M, N, K, gs,
                              period, param_bf16, stream)
        : launch<XT, 8, false>(route, x, codes, scales, out, M, N, K, gs,
                               period, param_bf16, stream);
  return transpose
      ? launch<XT, 4, true>(route, x, codes, scales, out, M, N, K, gs,
                            period, param_bf16, stream)
      : launch<XT, 4, false>(route, x, codes, scales, out, M, N, K, gs,
                             period, param_bf16, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. bits: 8 or 4. group_size: the int4
// group length (even, dividing the stored last axis); scale_period: the
// int8 dense per-channel vector's length. param_bf16: the quantized leaf's
// own dtype is bfloat16 (else float32). route: which kernel runs (0
// gemv_dense, 1 gemv_attend, 2 tc, 3 tiled_f32), chosen by the caller;
// one that does not take the call returns cudaErrorInvalidValue. Codes,
// scales and x must be contiguous and 4-byte aligned (torch allocations
// are).
extern "C" int quantized_matmul_launch(
    const void* x, const void* codes, const void* scales, void* out, int M,
    int N, int K, int bits, int transpose, int group_size, int scale_period,
    int x_dtype, int param_bf16, int route, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (bits != 8 && bits != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bits == 4 && (group_size < 2 || group_size % 2 != 0 ||
                    (transpose ? K : N) % group_size != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bits == 8 && !transpose &&
      (scale_period < 1 || N % scale_period != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_x<float>(route, x, codes, scales, out, M, N, K, bits,
                           transpose, group_size, scale_period, param_bf16,
                           s);
  if (x_dtype == 1)
    return launch_x<__nv_bfloat16>(route, x, codes, scales, out, M, N, K,
                                   bits, transpose, group_size, scale_period,
                                   param_bf16, s);
  return (int)cudaErrorInvalidValue;
}

// The routes' names in enum Route's numbering; the wrapper checks its own
// numbering against them when it loads the library.
extern "C" const char* quantized_matmul_route_names() {
  return "gemv_dense,gemv_attend,tc,tiled_f32";
}

extern "C" const char* quantized_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
