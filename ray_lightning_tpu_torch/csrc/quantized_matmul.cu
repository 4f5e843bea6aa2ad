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
// Design (right and simple first; the numbers are in PERF.md). Products
// run on the CUDA cores in f32. Three kernels:
//
//   * gemv_dense (M <= 16, transpose == 0, N % 4 == 0): a decode step's
//     projections. At M = 8 each weight byte is used 8 times, so the call
//     is bound by the code bytes over the memory rate, and what matters is
//     keeping code loads in flight. A block owns 128 columns and 8 rows of
//     x; each lane owns 4 adjacent columns (one 32-bit load of int8 codes,
//     16 bits of int4) and its warp a stride-8 share of the K rows, kUnroll
//     rows of loads in flight; x sits in shared memory as f32, up to 1024
//     rows of K at a time (all of it for K = 768), and is read as broadcast
//     float4s; the 8 warps' partial sums meet in the same buffer. Where the trouble lies: qkv (N = 2304) gives only 18 blocks
//     for 132 SMs, out and down (N = 768) only 6 -- a split over K across
//     blocks (later work) is what fills the card there.
//   * gemv_attend (M <= 16, transpose == 1, K % 4 == 0 for int8, K % 8 for
//     int4): the tied head at decode. One warp per output column (a code
//     row of the table, contiguous along K), lanes split K with one 32-bit
//     load each (4 int8 or 8 int4 codes), a warp shuffle sum at the end;
//     the head's 50257 columns give 6283 blocks.
//   * tiled (everything else: prefill's M = 1024, and shapes the GEMVs do
//     not take): one block per (64 rows, 128 columns) of the output walks K
//     in steps of 32, staging the x tile and the dequantized weight tile in
//     shared memory as f32; each of 256 threads accumulates 8 x 4 outputs.
//     At M = 1024 the call is bound by operations: the tied head is
//     2 * 1024 * 768 * 50257 = 79 GFLOP, milliseconds on the CUDA cores
//     where the tensor cores (wgmma, TMA loads of the codes) would take
//     about 0.1 ms -- later work.
//
// Every kernel masks its edges (zeros past M, N and K), so any M >= 1 and
// any N -- the odd vocab 50257 included -- is taken.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns the CUDA error code of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// ------------------------------------------------------------------ tiled
constexpr int kBM = 64, kBN = 128, kBK = 32, kTM = 8, kTN = 4;
constexpr int kTiledThreads = (kBM / kTM) * (kBN / kTN);

// Stage the dequantized (kBK, kBN) weight tile at (k0, n0) into ws; zeros
// outside K and N. Each loop has a fixed trip count and is unrolled, so a
// thread's code loads are all in flight before the first is used.
template <typename XT, int BITS, bool TRANS>
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
        w = dequant<XT>(codes[(size_t)gk * N + gn], scales[gn % period],
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
        w0 = dequant<XT>(code_at<4>(byte, 0), s, param_bf16);
        w1 = dequant<XT>(code_at<4>(byte, 1), s, param_bf16);
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
        w = dequant<XT>(codes[(size_t)gn * K + gk], scales[gk], param_bf16);
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
        w0 = dequant<XT>(code_at<4>(byte, 0), s, param_bf16);
        w1 = dequant<XT>(code_at<4>(byte, 1), s, param_bf16);
      }
      ws[2 * u][n] = w0;
      ws[2 * u + 1][n] = w1;
    }
  }
}

template <typename XT, int BITS, bool TRANS>
__global__ void __launch_bounds__(kTiledThreads)
tiled_kernel(const XT* __restrict__ x, const int8_t* __restrict__ codes,
             const float* __restrict__ scales, XT* __restrict__ out, int M,
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
      xs[k][m] = (gm < M && gk < K) ? Val<XT>::load(x + (size_t)gm * K + gk)
                                    : 0.0f;
    }
    stage_weights<XT, BITS, TRANS>(ws, codes, scales, k0, n0, N, K, gs,
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
      if (gm < M && gn < N) Val<XT>::store(out + (size_t)gm * N + gn,
                                           acc[i][j]);
    }
  }
}

// ----------------------------------------------------------------- launch
template <typename XT, int BITS, bool TRANS>
int launch(const void* x, const void* codes, const void* scales, void* out,
           int M, int N, int K, int gs, int period, int param_bf16,
           cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* cp = static_cast<const int8_t*>(codes);
  const float* sp = static_cast<const float*>(scales);
  XT* op = static_cast<XT*>(out);
  const int mb = (M + kGemvRows - 1) / kGemvRows;
  if (M <= 16 && !TRANS && N % 4 == 0) {
    gemv_dense_kernel<XT, BITS>
        <<<dim3((N + 127) / 128, mb), kGemvThreads, 0, stream>>>(
            xp, cp, sp, op, M, N, K, gs, period, param_bf16);
  } else if (M <= 16 && TRANS && K % (BITS == 8 ? 4 : 8) == 0) {
    gemv_attend_kernel<XT, BITS>
        <<<dim3((N + kGemvWarps - 1) / kGemvWarps, mb), kGemvThreads, 0,
           stream>>>(xp, cp, sp, op, M, N, K, gs, param_bf16);
  } else {
    tiled_kernel<XT, BITS, TRANS>
        <<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM), kTiledThreads, 0,
           stream>>>(xp, cp, sp, op, M, N, K, gs, period, param_bf16);
  }
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_x(const void* x, const void* codes, const void* scales, void* out,
             int M, int N, int K, int bits, int transpose, int gs,
             int period, int param_bf16, cudaStream_t stream) {
  if (bits == 8)
    return transpose
        ? launch<XT, 8, true>(x, codes, scales, out, M, N, K, gs, period,
                              param_bf16, stream)
        : launch<XT, 8, false>(x, codes, scales, out, M, N, K, gs, period,
                               param_bf16, stream);
  return transpose
      ? launch<XT, 4, true>(x, codes, scales, out, M, N, K, gs, period,
                            param_bf16, stream)
      : launch<XT, 4, false>(x, codes, scales, out, M, N, K, gs, period,
                             param_bf16, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. bits: 8 or 4. group_size: the int4
// group length (even, dividing the stored last axis); scale_period: the
// int8 dense per-channel vector's length. param_bf16: the quantized leaf's
// own dtype is bfloat16 (else float32). Codes, scales and x must be
// contiguous and 4-byte aligned (torch allocations are).
extern "C" int quantized_matmul_launch(
    const void* x, const void* codes, const void* scales, void* out, int M,
    int N, int K, int bits, int transpose, int group_size, int scale_period,
    int x_dtype, int param_bf16, void* stream) {
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
    return launch_x<float>(x, codes, scales, out, M, N, K, bits, transpose,
                           group_size, scale_period, param_bf16, s);
  if (x_dtype == 1)
    return launch_x<__nv_bfloat16>(x, codes, scales, out, M, N, K, bits,
                                   transpose, group_size, scale_period,
                                   param_bf16, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* quantized_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
