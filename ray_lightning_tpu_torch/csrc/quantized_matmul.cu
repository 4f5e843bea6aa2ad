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
// Design (the numbers are in PERF.md). Four routes; the caller names the
// one that runs (`route`, models/quantized_matmul.py:_route) and a route
// that does not take the call is refused, never replaced:
//
//   * gemv_dense (M <= 16, transpose == 0, N % 4 == 0): a decode step's
//     projections. What bounds it: the code bytes over 3.35 TB/s are
//     0.2-0.7 us at M = 8 (0.6-2.4 MB a call), below the launch and one
//     trip to device memory, so a call is a chain of latencies, and it
//     needs every SM. So K is split across the blocks of a thread-block
//     cluster (cluster.cuh): a cluster owns 16, 32 or 64 columns, block
//     `rank` takes an equal share of K, and the narrowest tile and
//     smallest power-of-two cluster that put two blocks on every SM are
//     taken (dense_plan: bf16 x with int8 codes at M = 8 gives qkv 144
//     tiles of 16 columns x 2 = 288 blocks, up 192 x 2 = 384, out and down
//     48 x 8 = 384, where one block per 128 columns and 8 rows of x gave
//     18, 24, 6 and 6). A block copies its share's code rows
//     (and int4's scales) to shared memory with 16-byte cp.async -- every
//     copy in flight at once, no registers held -- and stages x beside
//     them. Its loops are not unrolled: a block runs its code about once,
//     and every instruction fetched is another trip to memory, so small
//     code is fast code here. bf16 x (the serving path) runs the products
//     on the tensor cores (gemv_dense_tc_kernel: mma.sync m16n8k16, x's
//     rows as A, up to 16 of them in one block, the dequantized codes as
//     B, fragment indices permuted so each thread's operands are single
//     shared-memory reads); f32 x (the parity path) on the CUDA cores in
//     f32, a thread owning 16 adjacent columns (4 where N is not a
//     multiple of 16) of every RL-th row. The warps' sums meet in shared
//     memory; each block writes its (M, BN) partial into slot `rank` of
//     rank 0's shared memory (distributed shared memory), and after one
//     cluster barrier rank 0 adds the slots in rank order and stores.
//   * gemv_attend (M <= 16, transpose == 1, K % 4 == 0 for int8, K % 8 for
//     int4): the tied head at decode, whose 38.6 MB of int8 codes are
//     12 us at 3.35 TB/s while its 8 x 768 x 50257 FMAs are 9 us at the
//     CUDA cores' f32 rate: bound by both. A block owns 128 columns (code
//     rows, contiguous along K) and stages x (and int8's per-k scales,
//     which ride the contraction axis) in shared memory ONCE for all of
//     them; each column gets 16 lanes (8 for int4) reading 16-byte vectors
//     of its row (4-byte where a row's bytes are not a multiple of 16), a
//     thread 4 columns at a time so that each staged x value serves 4
//     columns, 2 vectors of each in flight; a reduce-scatter over the
//     column's lanes ends the sums. The 50257 columns give 393 blocks;
//     the odd last ones are masked.
//   Both repeat bitwise (no atomics, a fixed order of sums), allocate
//   nothing and synchronize nothing: a call can be captured in a CUDA
//   graph. A cluster launch the card refuses returns its CUDA error.
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

#include <algorithm>
#include <type_traits>

#include "cluster.cuh"
#include "wgmma.cuh"

namespace {

template <typename T> struct Val;
template <> struct Val<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float f32(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Val<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
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

// ------------------------------------------------------------ decode GEMVs
constexpr int kGemvRows = 8;        // rows of x a block computes
constexpr int kChunk = 1024;        // K of x staged per pass: gemv_attend
constexpr int kDenseWarps = 4;
constexpr int kDenseThreads = 32 * kDenseWarps;
constexpr int kMaxCluster = 8;      // portable cluster size
// gemv_dense aims at two blocks for every SM: with one, the SMs that hold
// a second block set the time; with more, the cluster's sums cost more
constexpr int kBlocksPerSm = 2;
constexpr int kAttWarps = 8;
constexpr int kAttThreads = 32 * kAttWarps;
constexpr int kAttCols = 128;       // head columns (code rows) per block
constexpr int kAttColsPerThread = 4;
constexpr int kAttUnroll = 2;       // chunk loads in flight per column

// BYTES of codes loaded as one vector (16, 8, 4 or 2 bytes), kept as
// loaded: nothing uses a load until every load of its batch is issued,
// so a thread's loads are in flight together (XOR-flipping the words for
// code_f32 right after each load would make each wait for the last).
template <int BYTES, int BITS>
struct CodeVec {
  static constexpr int kWords = BYTES >= 4 ? BYTES / 4 : 1;
  static constexpr uint32_t kFlip = BITS == 8 ? 0x80808080u : 0x88888888u;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (BYTES == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (BYTES == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else if constexpr (BYTES == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
  __device__ __forceinline__ void load_shared(const uint8_t* p) {
    if constexpr (BYTES == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (BYTES == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else if constexpr (BYTES == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }
  __device__ __forceinline__ void store_shared(uint8_t* p) const {
    if constexpr (BYTES == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (BYTES == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;   // codes 0
  }
  // code j as an exact f32
  __device__ __forceinline__ float code(int j) const {
    constexpr int kPerWord = 32 / BITS;
    return code_f32<BITS>(w[j / kPerWord] ^ kFlip, j % kPerWord);
  }
};

// One weight element from its exact f32 code: code * scale in f32, rounded
// to the param dtype and then to x's. Both roundings are to bf16 or none,
// and rounding to bf16 twice is rounding once.
template <typename XT>
__device__ __forceinline__ float weight(float code, float scale, bool pbf) {
  const float w = code * scale;
  return (pbf || !std::is_same<XT, float>::value)
      ? Val<__nv_bfloat16>::round(w) : w;
}

// The 16 bytes v as kVec values of x's dtype, widened to f32.
template <typename XT>
__device__ __forceinline__ void widen16(const uint4& v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<XT, float>::value) {
      out[i] = __uint_as_float(w[i]);
    } else {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Stage x[m0 .. m0 + 8)[c0 .. c0 + kc) as f32 through store(m, k, value)
// (zeros past M). Each thread issues a batch of its loads -- 16-byte
// vectors where x's rows allow (K, c0, kc and the address multiples of
// the vector), else single elements -- before it stores any, so staging
// costs one trip to memory, not one per element.
template <typename XT, int THREADS, typename Store>
__device__ __forceinline__ void stage_x(const XT* __restrict__ x, int M,
                                        int K, int m0, int c0, int kc,
                                        Store store) {
  constexpr int kVec = 16 / (int)sizeof(XT);
  constexpr int kBatch = 4;
  const bool vec = K % kVec == 0 && c0 % kVec == 0 && kc % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec) {
    const int per_row = kc / kVec, n = kGemvRows * per_row;
    for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * THREADS, m = i / per_row;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n && m0 + m < M)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + m) * K + c0 + (i % per_row) * kVec));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * THREADS, m = i / per_row;
        if (i >= n) break;
        const int k = (i % per_row) * kVec;
        float e[kVec];
        widen16<XT>(v[u], e);
#pragma unroll
        for (int j = 0; j < kVec; ++j) store(m, k + j, e[j]);
      }
    }
  } else {
    constexpr int kScalars = 4 * kBatch;
    const int n = kGemvRows * kc;
    for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * kScalars) {
      XT v[kScalars];                      // as loaded, widened when stored
#pragma unroll
      for (int u = 0; u < kScalars; ++u) {
        const int i = i0 + u * THREADS, m = i / kc;
        if (i < n && m0 + m < M) v[u] = x[(size_t)(m0 + m) * K + c0 + i % kc];
      }
#pragma unroll
      for (int u = 0; u < kScalars; ++u) {
        const int i = i0 + u * THREADS, m = i / kc;
        if (i < n)
          store(m, i % kc, m0 + m < M ? Val<XT>::f32(v[u]) : 0.0f);
      }
    }
  }
}

// 8 bytes global -> shared, asynchronous.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// Copy rows [c0, c0 + kc) of one dense tile (kRowBytes bytes of codes a
// row, starting at column tile_col) to ct, and int4's scales for the gt
// groups from g0 the tile spans to ss4 (rows gstride apart): gran-byte
// cp.async copies, all in flight together, committed as one group; where
// gran is 0 (rows not 4-byte aligned) each thread loads and stores
// kLoadBytes-byte vectors instead.
template <int BITS, int kRowBytes, int kLoadBytes, int THREADS>
__device__ __forceinline__ void stage_tile(
    uint8_t* ct, float* ss4, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, int c0, int kc, int tile_col, int N,
    int gran, int groups, int g0, int gt, int gstride) {
  const size_t row_bytes = (size_t)N * BITS / 8;
  const int8_t* src = codes + (size_t)c0 * row_bytes + tile_col * BITS / 8;
  if (gran > 0) {
    const int per = kRowBytes / gran, total = kc * per;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int r = i / per, c = (i % per) * gran;
      const bool in = tile_col + c * 8 / BITS < N;
      const uint32_t dst = hopper::smem_u32(ct + r * kRowBytes + c);
      const int8_t* from = src + r * row_bytes + c;
      if (gran == 16) hopper::cp_async16(dst, from, in ? 16 : 0);
      else if (in && gran == 8) cp_async8(dst, from);
      else if (in) hopper::cp_async4(dst, from);
    }
  } else {
    constexpr int kPer = kRowBytes / kLoadBytes;
    for (int i = threadIdx.x; i < kc * kPer; i += THREADS) {
      const int r = i / kPer, c = (i % kPer) * kLoadBytes;
      CodeVec<kLoadBytes, BITS> v;
      v.zero();
      if (tile_col + c * 8 / BITS < N) v.load(src + r * row_bytes + c);
      v.store_shared(ct + r * kRowBytes + c);
    }
  }
  if (BITS == 4)
    for (int i = threadIdx.x; i < kc * gt; i += THREADS) {
      const int r = i / gt, g = i % gt;
      hopper::cp_async4(hopper::smem_u32(ss4 + r * gstride + g),
                        scales + (size_t)(c0 + r) * groups + g0 + g);
    }
  hopper::cp_async_commit();
}

// gemv_dense's shared memory ahead of rank 0's slots: a chunk of `rows`
// rows (x as 8 f32, the tile's codes, int4's gstride scales), or, after
// the rows, every thread's V partial sums in rows of V + 4 floats --
// whichever is larger, rounded up to 16 bytes.
__host__ __device__ constexpr size_t dense_stage_bytes(int rows,
                                                       int row_bytes,
                                                       int gstride, int v) {
  return (((size_t)rows * (kGemvRows * sizeof(float) + row_bytes +
                           sizeof(float) * gstride) >
           sizeof(float) * kDenseThreads * (v + 4)
               ? (size_t)rows * (kGemvRows * sizeof(float) + row_bytes +
                                 sizeof(float) * gstride)
               : sizeof(float) * kDenseThreads * (v + 4)) + 15) / 16 * 16;
}

// gemv_dense on the CUDA cores (f32 x; bf16 x whose rows the tensor-core
// kernel below does not take): x (M, K) @ dequant(codes (K, N)), in f32.
// A cluster of CS blocks owns BN columns and 8 rows of x; block `rank`
// takes K rows [rank * k_share, (rank + 1) * k_share), `rows` at a time:
// the tile's code rows (and int4's scales) are copied to shared memory
// with cp.async -- every copy in flight at once, no registers held --
// while x is staged as f32.
// A thread owns CW adjacent columns (one 16-byte vector of an int8 code
// row, 8 bytes of int4; CW = 4 where N is not a multiple of 16) and every
// RL-th row of the share, walked by a loop that is not unrolled: the code
// a block runs is small, because a block runs it about once and every
// instruction fetched is a trip to memory. The threads' 8 x CW partial
// sums meet in shared memory, the row lanes added in order; each block
// writes its (8, BN) partial into slot `rank` of rank 0's shared memory,
// and after one cluster barrier rank 0 adds the slots in rank order.
template <typename XT, int BITS, int CW, int BN>
__global__ void __launch_bounds__(kDenseThreads, 2)
gemv_dense_kernel(const XT* __restrict__ x, const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, XT* __restrict__ out,
                  int M, int N, int K, int gs, int period, int param_bf16,
                  int k_share, int rows, int gstride, int gran) {
  constexpr int CL = BN / CW;              // column lanes
  constexpr int RPW = 32 / CL;             // row lanes per warp
  constexpr int RL = kDenseWarps * RPW;    // row lanes per block
  constexpr int V = kGemvRows * CW;        // accumulators per thread
  constexpr int kLoadBytes = CW * BITS / 8;
  constexpr int kRowBytes = BN * BITS / 8; // a tile row of codes
  static_assert(CL >= 1 && CL <= 32 && (CL & (CL - 1)) == 0, "lanes");
  using Vec = CodeVec<kLoadBytes, BITS>;
  extern __shared__ __align__(16) unsigned char dsm[];
  float (*xs)[kGemvRows] = reinterpret_cast<float (*)[kGemvRows]>(dsm);
  uint8_t* ct = dsm + (size_t)rows * kGemvRows * sizeof(float);
  float* ss4 = reinterpret_cast<float*>(ct + (size_t)rows * kRowBytes);
  float* red = reinterpret_cast<float*>(dsm);          // after the rows
  float* part = reinterpret_cast<float*>(
      dsm + dense_stage_bytes(rows, kRowBytes, gstride, V));

  auto cluster = rlt::cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane % CL, rl = warp * RPW + lane / CL;
  const int n = tile * BN + cl * CW;       // N % CW == 0: all CW valid
  const int m0 = blockIdx.y * kGemvRows;
  const bool active = n < N;
  const bool pbf = param_bf16 != 0;
  const int k_begin = min(K, rank * k_share);
  const int k_end = min(K, k_begin + k_share);
  const int groups = BITS == 4 ? N / gs : 0;
  const int g0 = BITS == 4 ? tile * BN / gs : 0;   // the tile's first group
  const int gt = BITS == 4 ? min(groups, (min(N, tile * BN + BN) - 1) / gs
                                              - g0 + 1) : 0;
  rlt::cluster_arrive_relaxed();

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  float s8[CW];                            // int8: per-column scales
  if (BITS == 8) {
    int p = active ? n % period : 0;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      s8[j] = active ? scales[p] : 0.0f;
      p = p + 1 == period ? 0 : p + 1;
    }
  }

  for (int c0 = k_begin; c0 < k_end; c0 += rows) {
    const int kc = min(rows, k_end - c0);
    __syncthreads();                       // the last chunk's readers done
    stage_tile<BITS, kRowBytes, kLoadBytes, kDenseThreads>(
        ct, ss4, codes, scales, c0, kc, tile * BN, N, gran, groups, g0, gt,
        gstride);
    stage_x<XT, kDenseThreads>(
        x, M, K, m0, c0, kc, [&](int m, int k, float v) { xs[k][m] = v; });
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (active) {
#pragma unroll 1
      for (int k = rl; k < kc; k += RL) {
        Vec cw;
        cw.load_shared(ct + k * kRowBytes + cl * kLoadBytes);
        const float4 xa = *reinterpret_cast<const float4*>(&xs[k][0]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[k][4]);
        const float xv[kGemvRows] = {xa.x, xa.y, xa.z, xa.w,
                                     xb.x, xb.y, xb.z, xb.w};
        const float* sk = ss4 + k * gstride - g0;
        const float s_row = BITS == 4 ? sk[n / gs] : 0.0f;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          float s;
          if (BITS == 8) s = s8[j];
          else if (gs % CW == 0) s = s_row;       // one group spans the CW
          else s = sk[(n + j) / gs];
          const float w = weight<XT>(cw.code(j), s, pbf);
#pragma unroll
          for (int m = 0; m < kGemvRows; ++m)
            acc[m * CW + j] = fmaf(xv[m], w, acc[m * CW + j]);
        }
      }
    }
  }

  // every thread's partials, rows padded by 4 floats (no bank conflicts
  // for the float4 stores); then each output adds its RL row lanes in
  // order and goes to slot `rank` of rank 0's `part`
  __syncthreads();                         // the rows are no longer read
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(&red[threadIdx.x * (V + 4) + i]) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  __syncthreads();
  rlt::cluster_wait();                     // every block has started
  float* dst = cluster.map_shared_rank(part, 0) + rank * kGemvRows * BN;
  for (int i = threadIdx.x; i < kGemvRows * BN; i += kDenseThreads) {
    const int m = i / BN, col = i % BN;
    const float* at = red + (col / CW) * (V + 4) + m * CW + col % CW;
    // row lane r is thread (r / RPW) * 32 + (r % RPW) * CL + cl; eight
    // running sums (lanes r = u mod 8), added in a fixed order
    float s8p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) s8p[u] = 0.0f;
#pragma unroll 1
    for (int r0 = 0; r0 < RL; r0 += 8)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u;
        if (r < RL) s8p[u] += at[((r / RPW) * 32 + (r % RPW) * CL) * (V + 4)];
      }
    dst[i] = ((s8p[0] + s8p[1]) + (s8p[2] + s8p[3])) +
             ((s8p[4] + s8p[5]) + (s8p[6] + s8p[7]));
  }
  cluster.sync();
  if (rank != 0) return;
  for (int i = threadIdx.x; i < kGemvRows * BN; i += kDenseThreads) {
    float s = part[i];
    for (int r = 1; r < cs; ++r) s += part[r * kGemvRows * BN + i];
    const int gm = m0 + i / BN, gn = tile * BN + i % BN;
    if (gm < M && gn < N) Val<XT>::store(out + (size_t)gm * N + gn, s);
  }
}

// gemv_dense_tc_kernel's shared memory ahead of rank 0's slots: a chunk
// of `rows` rows (the tile's codes, int4's gstride scales, 16 rows of x
// as stored, padded by 8), or, after the rows, the warps' (16, BN) f32
// accumulators -- whichever is larger, rounded up to 16 bytes.
__host__ __device__ constexpr size_t dense_tc_stage_bytes(int rows,
                                                          int row_bytes,
                                                          int gstride,
                                                          int bn) {
  return (((size_t)rows * (row_bytes + 4 * gstride) +
               (size_t)2 * kGemvRows * (rows + 8) * 2 >
           (size_t)kDenseWarps * 2 * kGemvRows * bn * 4
               ? (size_t)rows * (row_bytes + 4 * gstride) +
                     (size_t)2 * kGemvRows * (rows + 8) * 2
               : (size_t)kDenseWarps * 2 * kGemvRows * bn * 4) + 15) / 16 * 16;
}

// gemv_dense for bf16 x: the same cluster split and staging, the products
// on the tensor cores. mma.sync m16n8k16 (bf16 in, f32 accumulators) with
// the 16 rows of x as A (rows past M zero) and the dequantized codes as B.
// The k and n indices of the fragments are permuted so that each thread's
// operands are contiguous in shared memory: in k-block kb a thread with
// lane t % 4 = tig takes code rows kb*16 + 4j + tig (j < 4: its k-slots
// 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9), and with t / 4 = gid columns
// gid * BN/8 + i of the tile for n-tile i (its n-slot gid): one read of
// 1 to 8 bytes per code row. x's 16 rows are copied as stored, in rows
// padded so that the threads' reads of them meet no bank conflict. Each
// weight is rounded once to bf16 (for bf16 x the param dtype's
// rounding and x's are one rounding), the products are exact and summed
// in f32 by the tensor cores. Warps split the share's k-blocks; their
// accumulators meet in shared memory, the blocks' in rank 0's.
template <int BITS, int BN>
__global__ void __launch_bounds__(kDenseThreads, 2)
gemv_dense_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ codes,
                     const float* __restrict__ scales,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     int gs, int period, int k_share, int rows, int gstride,
                     int gran) {
  constexpr int kTiles = BN / 8;           // n-tiles; a thread's columns
  constexpr int kRowBytes = BN * BITS / 8;
  constexpr int kThreadBytes = kTiles * BITS / 8;   // of one code row
  static_assert(kThreadBytes >= 2, "a thread reads 2 to 16 bytes a row");
  constexpr int kWords = kThreadBytes >= 4 ? kThreadBytes / 4 : 1;
  constexpr uint32_t kFlip = BITS == 8 ? 0x80808080u : 0x88888888u;
  constexpr int kRowsX = 2 * kGemvRows;    // A's 16 rows
  extern __shared__ __align__(16) unsigned char dsm[];
  const int xstride = rows + 8;            // bf16s a staged row of x
  uint8_t* ct = dsm;                                     // (rows, BN) codes
  float* ss4 = reinterpret_cast<float*>(ct + (size_t)rows * kRowBytes);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<uint8_t*>(ss4) + (size_t)rows * gstride * 4);
  float* red = reinterpret_cast<float*>(dsm);          // after the rows
  float* part = reinterpret_cast<float*>(
      dsm + dense_tc_stage_bytes(rows, kRowBytes, gstride, BN));

  auto cluster = rlt::cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = tile * BN + gid * kTiles; // this thread's first column
  const int k_begin = min(K, rank * k_share);
  const int k_end = min(K, k_begin + k_share);
  const int groups = BITS == 4 ? N / gs : 0;
  const int g0 = BITS == 4 ? tile * BN / gs : 0;
  const int gt = BITS == 4 ? min(groups, (min(N, tile * BN + BN) - 1) / gs
                                              - g0 + 1) : 0;
  rlt::cluster_arrive_relaxed();

  float acc[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  float s8[kTiles];                        // int8: per-column scales
  int gi[kTiles];                          // int4: the columns' groups
#pragma unroll
  for (int i = 0; i < kTiles; ++i) gi[i] = BITS == 4 ? (n0 + i) / gs - g0 : 0;
  if (BITS == 8) {
    int p = n0 < N ? n0 % period : 0;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      s8[i] = n0 + i < N ? scales[p] : 0.0f;
      p = p + 1 == period ? 0 : p + 1;
    }
  }

  for (int c0 = k_begin; c0 < k_end; c0 += rows) {
    const int kc = min(rows, k_end - c0);
    const int kcp = (kc + 15) / 16 * 16;
    __syncthreads();                       // the last chunk's readers done
    stage_tile<BITS, kRowBytes, kThreadBytes, kDenseThreads>(
        ct, ss4, codes, scales, c0, kc, tile * BN, N, gran, groups, g0, gt,
        gstride);
    // x's 16 rows as stored (bf16), copied the same way: rows past M
    // zero-filled, and zeros past kc to the end of the last k-block
    const int vecs = kc / 8;               // kc % 8 == 0 (K % 8 == 0)
    for (int i = threadIdx.x; i < kRowsX * vecs; i += kDenseThreads) {
      const int m = i / vecs, v = i % vecs;
      hopper::cp_async16(hopper::smem_u32(xb + m * xstride + v * 8),
                         x + (size_t)min(m, M - 1) * K + c0 + v * 8,
                         m < M ? 16 : 0);
    }
    hopper::cp_async_commit();
    for (int i = threadIdx.x; i < kRowsX * (kcp - kc); i += kDenseThreads)
      xb[(i / (kcp - kc)) * xstride + kc + i % (kcp - kc)] =
          __float2bfloat16(0.0f);
    hopper::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kb = warp; kb < kcp / 16; kb += kDenseWarps) {
      uint32_t cw[4][kWords];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = kb * 16 + 4 * j + tig;
        const uint8_t* p = ct + r * kRowBytes + gid * kThreadBytes;
        if constexpr (kThreadBytes == 8) {
          const uint2 v = r < kc ? *reinterpret_cast<const uint2*>(p)
                                 : make_uint2(0u, 0u);
          cw[j][0] = v.x; cw[j][1] = v.y;
        } else if constexpr (kThreadBytes == 16) {
          const uint4 v = r < kc ? *reinterpret_cast<const uint4*>(p)
                                 : make_uint4(0u, 0u, 0u, 0u);
          cw[j][0] = v.x; cw[j][1] = v.y; cw[j][2] = v.z; cw[j][3] = v.w;
        } else if constexpr (kThreadBytes == 4) {
          cw[j][0] = r < kc ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        } else {
          cw[j][0] = r < kc ? *reinterpret_cast<const uint16_t*>(p) : 0u;
        }
      }
      // A: x at rows gid and gid + 8, k = kb * 16 + 4 j + tig, paired
      // (j = 0, 1) and (j = 2, 3)
      uint32_t xa[2], xc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint16_t* lo = reinterpret_cast<const uint16_t*>(
            xb + gid * xstride + kb * 16 + 8 * h + tig);
        const uint16_t* hi = lo + kGemvRows * xstride;
        xa[h] = (uint32_t)lo[0] | ((uint32_t)lo[4] << 16);
        xc[h] = (uint32_t)hi[0] | ((uint32_t)hi[4] << 16);
      }
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = kb * 16 + 4 * j + tig;
          float s;
          if (BITS == 8) {
            s = s8[i];
          } else {
            s = (r < kc && n0 + i < N) ? ss4[r * gstride + gi[i]] : 0.0f;
          }
          constexpr int kPerWord = 32 / BITS;
          w[j] = code_f32<BITS>(cw[j][i / kPerWord] ^ kFlip, i % kPerWord)
                 * s;
        }
        const uint32_t b0 = hopper::pack_bf16(w[0], w[1]);
        const uint32_t b1 = hopper::pack_bf16(w[2], w[3]);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]),
              "+f"(acc[i][3])
            : "r"(xa[0]), "r"(xc[0]), "r"(xa[1]), "r"(xc[1]), "r"(b0),
              "r"(b1));
      }
    }
  }

  // the warps' accumulators: (warp, m, column) in shared memory, added in
  // warp order into slot `rank` of rank 0's `part`
  __syncthreads();                         // the rows are no longer read
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = gid + (e >> 1) * kGemvRows;
      const int col = (2 * tig + (e & 1)) * kTiles + i;
      red[(warp * kRowsX + m) * BN + col] = acc[i][e];
    }
  __syncthreads();
  rlt::cluster_wait();                     // every block has started
  const int outs = min(M, kRowsX) * BN;    // rank 0's slots: (cs, outs)
  float* dst = cluster.map_shared_rank(part, 0) + rank * outs;
  for (int i = threadIdx.x; i < outs; i += kDenseThreads) {
    float s = red[i];
#pragma unroll
    for (int w = 1; w < kDenseWarps; ++w) s += red[w * kRowsX * BN + i];
    dst[i] = s;
  }
  cluster.sync();
  if (rank != 0) return;
  for (int i = threadIdx.x; i < outs; i += kDenseThreads) {
    float s = part[i];
    for (int r = 1; r < cs; ++r) s += part[r * outs + i];
    const int gm = i / BN, gn = tile * BN + i % BN;
    if (gm < M && gn < N)
      out[(size_t)gm * N + gn] = __float2bfloat16(s);
  }
}

// gemv_attend: the tied head, x (M, K) @ dequant(codes (N, K))^T, each
// output column a code row contiguous along K. A block owns kAttCols
// columns and 8 rows of x, stages x (and int8's per-k scales) once in
// shared memory for all of them, and gives each column G lanes; a lane
// reads VB-byte vectors of its columns' rows (16 bytes where the row
// allows), kAttUnroll of them in flight for each of kAttColsPerThread
// columns, and reuses every staged x value for those columns. The G
// lanes' partials meet by a reduce-scatter of the thread's 4 x 8 values.
template <typename XT, int BITS, int VB>
__global__ void __launch_bounds__(kAttThreads, 2)
gemv_attend_kernel(const XT* __restrict__ x,
                   const int8_t* __restrict__ codes,
                   const float* __restrict__ scales, XT* __restrict__ out,
                   int M, int N, int K, int gs, int param_bf16) {
  constexpr int kPer = VB * 8 / BITS;      // codes per vector
  constexpr int G = VB == 16 ? (BITS == 8 ? 16 : 8) : 32;   // lanes/column
  constexpr int kSlots = 32 / G;           // column slots per warp
  constexpr int C = kAttColsPerThread;
  constexpr int kPass = kAttWarps * kSlots * C;   // columns per pass
  constexpr int V = C * kGemvRows;
  constexpr int kSteps = G == 8 ? 3 : G == 16 ? 4 : 5;
  static_assert(kAttCols % kPass == 0, "whole passes");
  using Vec = CodeVec<VB, BITS>;
  // x and the scales are staged with 4 floats of padding after every
  // vector's kPer values where kPer >= 16: the G lanes of a column read
  // kPer apart, and unpadded their float4 reads would hit the same banks
  constexpr int kPad = kPer >= 16 ? 4 : 0;
  constexpr int kRow = kChunk + kChunk / kPer * kPad;
  auto px = [](int k) { return k + k / kPer * kPad; };
  __shared__ __align__(16) float xs[kGemvRows][kRow];     // 32-40 KB
  __shared__ __align__(16) float ss[BITS == 8 ? kRow : 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % G, slot = lane / G;
  const int m0 = blockIdx.y * kGemvRows;
  const bool pbf = param_bf16 != 0;
  const size_t row_bytes = (size_t)K * BITS / 8;
  const int groups = BITS == 4 ? K / gs : 0;
  const bool one_group = BITS == 4 && gs % kPer == 0;

  for (int pass = 0; pass < kAttCols / kPass; ++pass) {
    const int n = blockIdx.x * kAttCols + pass * kPass
                  + (warp * kSlots + slot) * C;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int c0 = 0; c0 < K; c0 += kChunk) {
      const int kc = min(kChunk, K - c0);
      const int rc = kc / kPer;            // vectors in this chunk of a row
      if (pass == 0 || K > kChunk) {       // stage x (and int8 scales) once
        __syncthreads();
        stage_x<XT, kAttThreads>(
            x, M, K, m0, c0, kc,
            [&](int m, int k, float v) { xs[m][px(k)] = v; });
        if (BITS == 8) {                   // all loads first, then stores
          float sv[kChunk / kAttThreads];
#pragma unroll
          for (int u = 0; u < kChunk / kAttThreads; ++u) {
            const int k = threadIdx.x + u * kAttThreads;
            sv[u] = k < kc ? scales[c0 + k] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kChunk / kAttThreads; ++u) {
            const int k = threadIdx.x + u * kAttThreads;
            if (k < kc) ss[px(k)] = sv[u];
          }
        }
        __syncthreads();
      }
      for (int j0 = gl; j0 < rc; j0 += G * kAttUnroll) {
        Vec cw[kAttUnroll][C];
        float s4[kAttUnroll][C];
#pragma unroll
        for (int u = 0; u < kAttUnroll; ++u)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int j = j0 + u * G;
            s4[u][c] = 0.0f;
            if (j < rc && n + c < N) {
              const size_t at = (size_t)(n + c) * row_bytes
                                + (size_t)(c0 + j * kPer) * BITS / 8;
              cw[u][c].load(codes + at);
              if (one_group)
                s4[u][c] = scales[(size_t)(n + c) * groups
                                  + (c0 + j * kPer) / gs];
            } else {
              cw[u][c].zero();
            }
          }
#pragma unroll
        for (int u = 0; u < kAttUnroll; ++u) {
          const int j = j0 + u * G;
          if (j >= rc) break;
          const int k0 = j * kPer;         // within the staged chunk
          const int p0 = j * (kPer + kPad);
#pragma unroll
          for (int e4 = 0; e4 < kPer; e4 += 4) {
            float xv[kGemvRows][4];
#pragma unroll
            for (int m = 0; m < kGemvRows; ++m) {
              const float4 t = *reinterpret_cast<const float4*>(
                  &xs[m][p0 + e4]);
              xv[m][0] = t.x; xv[m][1] = t.y; xv[m][2] = t.z; xv[m][3] = t.w;
            }
            float sk[4];
            if (BITS == 8) {
              const float4 t = *reinterpret_cast<const float4*>(&ss[p0 + e4]);
              sk[0] = t.x; sk[1] = t.y; sk[2] = t.z; sk[3] = t.w;
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float s;
                if (BITS == 8) s = sk[e];
                else if (one_group) s = s4[u][c];
                else s = n + c < N ? scales[(size_t)(n + c) * groups
                                            + (c0 + k0 + e4 + e) / gs]
                                   : 0.0f;
                const float w = weight<XT>(cw[u][c].code(e4 + e), s, pbf);
#pragma unroll
                for (int m = 0; m < kGemvRows; ++m)
                  acc[c * kGemvRows + m] =
                      fmaf(xv[m][e], w, acc[c * kGemvRows + m]);
              }
            }
          }
        }
      }
    }
    // the column group's G lanes: each ends with V / G of the thread's
    // C x 8 sums, and stores them
    static_assert(V % G == 0, "every lane keeps whole sums");
    int base = 0;
    rlt::ReduceScatter<V, 1, kSteps>::run(acc, lane, base);
#pragma unroll
    for (int i = 0; i < V / G; ++i) {
      const int v = base + i, c = v / kGemvRows, m = v % kGemvRows;
      if (n + c < N && m0 + m < M)
        Val<XT>::store(out + (size_t)(m0 + m) * N + n + c, acc[i]);
    }
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

// How a GEMV call is cut: grid, cluster size, columns per block (dense:
// per cluster), bytes per code load, K rows per block.
struct GemvPlan {
  dim3 grid;
  int threads, cluster, cols, load_bytes, k_share;
  int rows = 0, gstride = 0, gran = 0;     // gemv_dense's staging
  size_t smem = 0;                         // dynamic shared memory
  bool tc = false;                         // gemv_dense on the tensor cores
};

constexpr int kMaxSmem = 232448;           // opt-in shared memory a block

// gemv_dense: the tensor-core kernel for bf16 x where N is a multiple of
// 16, K of 8 and the codes' and x's addresses allow 16-byte copies; else
// the CUDA-core kernel, 16 columns a thread where N allows, else 4. Then
// the narrowest column tile and the smallest power-of-two cluster (at
// most 8, each block keeping at least 16 rows of K) that put two blocks
// on every SM; the header gives the counts at GPT-2-small's shapes.
GemvPlan dense_plan(const void* x, const void* codes, int M, int N, int K,
                    int bits, int gs, bool bf16_x) {
  GemvPlan p;
  const bool wide = N % 16 == 0 &&
      reinterpret_cast<uintptr_t>(codes) % (16 * bits / 8) == 0;
  p.load_bytes = (wide ? 16 : 4) * bits / 8;
  p.threads = kDenseThreads;
  const int max_cs = K >= 16 * kMaxCluster ? kMaxCluster
                     : K >= 64 ? 4 : K >= 32 ? 2 : 1;
  // staging copies of 16, 8 or 4 bytes as the code rows' stride, the
  // tile's bytes and the address allow (else each thread's vectors are
  // loaded and stored); the tensor cores take bf16 x where the rows allow
  // 16-column vectors and copies
  auto gran_for = [&](int cols) {
    const int tile_bytes = cols * bits / 8;
    const size_t row_bytes = (size_t)N * bits / 8;
    for (int g = 16; g >= 4; g /= 2)
      if (row_bytes % g == 0 && tile_bytes % g == 0 &&
          reinterpret_cast<uintptr_t>(codes) % g == 0)
        return g;
    return 0;
  };
  p.tc = bf16_x && wide && gran_for(16) > 0 && K % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;  // x in 16-byte copies
  const int mb = p.tc ? 1 : (M + kGemvRows - 1) / kGemvRows;
  p.cols = 32;
  p.cluster = max_cs;
  bool found = false;
  // narrow tiles first: a narrower tile needs a smaller cluster for the
  // same blocks, and the partial sums a cluster adds shrink with both
  // (tiles of at least 16 bytes of codes a row: whole 16-byte copies)
  for (int bn = p.tc ? 128 / bits : 32; bn <= 64 && !found; bn *= 2)
    for (int cs = 1; cs <= max_cs && !found; cs *= 2)
      if ((long long)((N + bn - 1) / bn) * mb * cs >=
          kBlocksPerSm * sm_count()) {
        p.cols = bn;
        p.cluster = cs;
        found = true;
      }
  // a multiple of 16: whole k-blocks of the tensor cores, and each block's
  // rows of x start on a 16-byte vector
  p.k_share = ((K + p.cluster - 1) / p.cluster + 15) / 16 * 16;
  p.grid = dim3((N + p.cols - 1) / p.cols * p.cluster, mb);
  // up to 512 rows a chunk (all of a block's share at these shapes);
  // int4 scales for the groups one tile spans
  const int tile_bytes = p.cols * bits / 8;
  p.gran = gran_for(p.cols);
  p.gstride = bits == 4 ? std::min(N / gs, p.cols / gs + 2) : 0;
  const int v = kGemvRows * (wide ? 16 : 4);
  p.rows = std::min(p.k_share, 512);
  for (;;) {
    p.smem = p.tc
        ? dense_tc_stage_bytes(p.rows, tile_bytes, p.gstride, p.cols) +
              sizeof(float) * (size_t)p.cluster * std::min(M, 16) * p.cols
        : dense_stage_bytes(p.rows, tile_bytes, p.gstride, v) +
              sizeof(float) * (size_t)p.cluster * kGemvRows * p.cols;
    if (p.smem <= (size_t)kMaxSmem || p.rows <= 16) break;
    p.rows /= 2;
  }
  return p;
}

// gemv_attend: 16-byte loads where a code row's bytes and the codes'
// address allow, else 4; kAttCols columns a block, no cluster.
GemvPlan attend_plan(const void* codes, int M, int N, int K, int bits) {
  GemvPlan p;
  const int row_bytes = K * bits / 8;
  p.load_bytes = (row_bytes % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(codes) % 16 == 0) ? 16 : 4;
  p.threads = kAttThreads;
  p.cluster = 1;
  p.cols = kAttCols;
  p.k_share = K;
  p.grid = dim3((N + kAttCols - 1) / kAttCols,
                (M + kGemvRows - 1) / kGemvRows);
  return p;
}

// Launch the dense GEMV instantiation of plan p, or (query) report how
// many of its clusters fit the card at once.
template <typename XT, int BITS, int CW, int BN>
int dense_go(const GemvPlan& p, bool query, const void* x, const void* codes,
             const void* scales, void* out, int M, int N, int K, int gs,
             int period, int param_bf16, cudaStream_t stream) {
  auto kernel = gemv_dense_kernel<XT, BITS, CW, BN>;
  const size_t smem = p.smem;
  if (smem > (size_t)kMaxSmem) return query ? -(int)cudaErrorInvalidValue
                                            : (int)cudaErrorInvalidValue;
  static bool opted_in = false;            // once, before any graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return query ? -(int)err : (int)err;
    opted_in = true;
  }
  if (query) {
    int err = 0;
    const int n = rlt::max_active_clusters(kernel, p.grid, p.threads, smem,
                                           p.cluster, &err);
    return err != 0 ? -err : n;
  }
  return rlt::launch_cluster(
      kernel, p.grid, p.threads, smem, p.cluster, stream,
      static_cast<const XT*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<XT*>(out), M, N, K, gs,
      period, param_bf16, p.k_share, p.rows, p.gstride, p.gran);
}

// The same for gemv_dense's tensor-core kernel (bf16 x).
template <int BITS, int BN>
int dense_tc_go(const GemvPlan& p, bool query, const void* x,
                const void* codes, const void* scales, void* out, int M,
                int N, int K, int gs, int period, cudaStream_t stream) {
  auto kernel = gemv_dense_tc_kernel<BITS, BN>;
  if (p.smem > (size_t)kMaxSmem) return query ? -(int)cudaErrorInvalidValue
                                              : (int)cudaErrorInvalidValue;
  static bool opted_in = false;            // once, before any graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return query ? -(int)err : (int)err;
    opted_in = true;
  }
  if (query) {
    int err = 0;
    const int n = rlt::max_active_clusters(kernel, p.grid, p.threads, p.smem,
                                           p.cluster, &err);
    return err != 0 ? -err : n;
  }
  return rlt::launch_cluster(
      kernel, p.grid, p.threads, p.smem, p.cluster, stream,
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), M,
      N, K, gs, period, p.k_share, p.rows, p.gstride, p.gran);
}

template <typename XT, int BITS>
int dense(const GemvPlan& p, bool query, const void* x, const void* codes,
          const void* scales, void* out, int M, int N, int K, int gs,
          int period, int param_bf16, cudaStream_t stream) {
  if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
    if constexpr (BITS == 8)               // int4 tiles start at 32
      if (p.tc && p.cols == 16)
        return dense_tc_go<BITS, 16>(p, query, x, codes, scales, out, M, N,
                                     K, gs, period, stream);
    if (p.tc)
      return p.cols == 64
          ? dense_tc_go<BITS, 64>(p, query, x, codes, scales, out, M, N, K,
                                  gs, period, stream)
          : dense_tc_go<BITS, 32>(p, query, x, codes, scales, out, M, N, K,
                                  gs, period, stream);
  }
  const bool wide = p.load_bytes == 16 * BITS / 8;
  if (wide && p.cols == 64)
    return dense_go<XT, BITS, 16, 64>(p, query, x, codes, scales, out, M, N,
                                      K, gs, period, param_bf16, stream);
  if (wide)
    return dense_go<XT, BITS, 16, 32>(p, query, x, codes, scales, out, M, N,
                                      K, gs, period, param_bf16, stream);
  if (p.cols == 64)
    return dense_go<XT, BITS, 4, 64>(p, query, x, codes, scales, out, M, N,
                                     K, gs, period, param_bf16, stream);
  return dense_go<XT, BITS, 4, 32>(p, query, x, codes, scales, out, M, N, K,
                                   gs, period, param_bf16, stream);
}

template <typename XT, int BITS>
int attend(const GemvPlan& p, const void* x, const void* codes,
           const void* scales, void* out, int M, int N, int K, int gs,
           int param_bf16, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* cp = static_cast<const int8_t*>(codes);
  const float* sp = static_cast<const float*>(scales);
  XT* op = static_cast<XT*>(out);
  if (p.load_bytes == 16)
    gemv_attend_kernel<XT, BITS, 16><<<p.grid, p.threads, 0, stream>>>(
        xp, cp, sp, op, M, N, K, gs, param_bf16);
  else
    gemv_attend_kernel<XT, BITS, 4><<<p.grid, p.threads, 0, stream>>>(
        xp, cp, sp, op, M, N, K, gs, param_bf16);
  return (int)cudaGetLastError();
}

bool takes_dense(int M, int N, bool trans) {
  return M <= 16 && !trans && N % 4 == 0;
}

bool takes_attend(int M, int K, int bits, bool trans) {
  return M <= 16 && trans && K % (bits == 8 ? 4 : 8) == 0;
}

template <typename XT, int BITS, bool TRANS>
int launch(int route, const void* x, const void* codes, const void* scales,
           void* out, int M, int N, int K, int gs, int period,
           int param_bf16, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<XT, __nv_bfloat16>::value;
  if (route == kGemvDense && takes_dense(M, N, TRANS)) {
    return dense<XT, BITS>(dense_plan(x, codes, M, N, K, BITS, gs, kBf16),
                           false, x, codes,
                           scales, out, M, N, K, gs, period, param_bf16,
                           stream);
  } else if (route == kGemvAttend && takes_attend(M, K, BITS, TRANS)) {
    return attend<XT, BITS>(attend_plan(codes, M, N, K, BITS), x, codes,
                            scales, out, M, N, K, gs, param_bf16, stream);
  } else if (route == kTc) {
    if constexpr (kBf16)
      return launch_tc<BITS, TRANS>(x, codes, scales, out, M, N, K, gs,
                                    period, stream);
    return (int)cudaErrorInvalidValue;
  } else if (route == kTiledF32) {
    if constexpr (!kBf16) {
      tiled_kernel<BITS, TRANS>
          <<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM), kTiledThreads,
             0, stream>>>(static_cast<const float*>(x),
                          static_cast<const int8_t*>(codes),
                          static_cast<const float*>(scales),
                          static_cast<float*>(out), M, N, K, gs, period,
                          param_bf16);
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

// The launch geometry a GEMV route gives this call, for reports: out[0..8]
// = grid x, grid y, cluster size, threads a block, columns a block (dense:
// a cluster's), bytes per code load (dense: per asynchronous copy), K rows
// a block, how many clusters of that size (gemv_attend: blocks) the card
// holds at once (cudaOccupancyMaxActiveClusters), and whether the products
// run on the tensor cores. Returns 0, or the CUDA error of the
// query, or cudaErrorInvalidValue where the route does not take the call.
extern "C" int quantized_matmul_geometry(const void* codes, int M, int N,
                                         int K, int bits, int transpose,
                                         int group_size, int x_dtype,
                                         int route, int* out) {
  if (M < 1 || N < 1 || K < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && group_size < 2) || (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  GemvPlan p;
  int active = 0;
  if (route == kGemvDense && takes_dense(M, N, transpose != 0)) {
    p = dense_plan(nullptr, codes, M, N, K, bits, group_size, x_dtype == 1);
    if (x_dtype == 0)
      active = bits == 8
          ? dense<float, 8>(p, true, nullptr, codes, nullptr, nullptr, M, N,
                            K, 2, 1, 0, nullptr)
          : dense<float, 4>(p, true, nullptr, codes, nullptr, nullptr, M, N,
                            K, 2, 1, 0, nullptr);
    else
      active = bits == 8
          ? dense<__nv_bfloat16, 8>(p, true, nullptr, codes, nullptr,
                                    nullptr, M, N, K, 2, 1, 0, nullptr)
          : dense<__nv_bfloat16, 4>(p, true, nullptr, codes, nullptr,
                                    nullptr, M, N, K, 2, 1, 0, nullptr);
  } else if (route == kGemvAttend && takes_attend(M, K, bits, transpose)) {
    p = attend_plan(codes, M, N, K, bits);
    int err = 0;
    // one instantiation stands for all: the same threads and shared memory
    active = rlt::max_active_clusters(
        gemv_attend_kernel<__nv_bfloat16, 8, 16>, p.grid, p.threads, 0, 1,
        &err);
    if (err != 0) active = -err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (active < 0) return -active;
  const int v[9] = {(int)p.grid.x, (int)p.grid.y, p.cluster, p.threads,
                    p.cols, p.gran > 0 ? p.gran : p.load_bytes, p.k_share,
                    active, (int)p.tc};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// The routes' names in enum Route's numbering; the wrapper checks its own
// numbering against them when it loads the library.
extern "C" const char* quantized_matmul_route_names() {
  return "gemv_dense,gemv_attend,tc,tiled_f32";
}

extern "C" const char* quantized_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
