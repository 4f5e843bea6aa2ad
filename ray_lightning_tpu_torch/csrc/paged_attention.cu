// Paged attention, the read side of one layer's cached decode/verify step.
//
// Replaces ray_lightning_tpu/models/pallas_attention.py:_kernel (and its
// full-precision wrapper _kernel_plain): it computes the same function,
// not a copy of the Pallas grid.
//
// Bound on the H100: bytes. The kernel must read the K and V pages that
// hold admitted positions once each; the bound is the bytes of those
// occupied K/V pages (plus q, scales, positions, page table and the
// output) over 3.35 TB/s -- about 3 us at the serving path's shapes. The
// operations (4·D per row, head, query and key) are far below the card's
// rates. At decode sizes the call is a chain of latencies (the launch,
// the page table, K, a softmax, V, the output), so the design is about
// spreading each (row, head) over many SMs and keeping that chain short:
//
//   * a thread-block cluster of CS blocks (1..8, the wrapper's choice from
//     S) per (row, head). The row's admitted keys (n_keys: up to the end
//     of the page holding its furthest position) are split
//     into CS equal shares, so a short row's blocks are short too and the
//     longest row no longer runs on one SM. At batch 8, 12 heads, CS = 8:
//     768 blocks of 4 warps. The kernel is instantiated for T rounded up
//     to 1, 2, 4 or 8, so decode's registers and code are sized to T = 1;
//   * q, the positions and the page table come in one trip to memory;
//     then the block copies its keys' K rows into shared memory with
//     cp.async (every copy in flight at once, no registers held; up to
//     16 KB a chunk, all of a block's share at the serving shapes), and
//     pass 1 scores them (a group of G lanes per key, 16 bytes of its
//     D-vector a lane) into shared memory (T x its share, f32). Their V
//     rows follow into the same buffer while the softmax and the cluster's
//     merge run. The loops over keys are not unrolled: a block runs them
//     about once, and each instruction fetched is a trip to memory;
//   * the block's (max, sum of exp(score - max)) per query is written
//     into every peer's shared memory; after one cluster barrier each
//     block merges the cluster's pairs in rank order (the flash-decoding
//     merge, all in f32) into the row's max M and sum L; a weight is
//     exp(score - M) / L, and only then rounded to the compute dtype, as
//     in the Pallas kernel: ONE exact softmax per query over the row's
//     admitted keys. A query with no admitted key (kv_positions < 0)
//     weighs 0, so an empty row emits 0;
//   * pass 2: weight x V in f32 registers per group, the groups of a warp
//     summed by shuffles and the warps in shared memory; each block
//     writes its partial (T, D) into slot `rank` of rank 0's shared
//     memory, and after a second cluster barrier rank 0 adds the slots in
//     rank order and rounds the output once. Every remote write precedes
//     a barrier every block reaches, and no block reads a peer's shared
//     memory, so a block may exit after the last barrier.
//
// One launch, no workspace, no atomics: the sums run in a fixed order and
// results repeat bitwise. Nothing is allocated, synchronized or carried
// between calls, so a call can be captured in a CUDA graph.
//
// Unmapped (-1) page-table entries clamp to page 0, like the Pallas index
// map. Rounding points follow the Pallas kernel: int8 codes become
// (code * scale) in f32 and are then rounded to the compute dtype; the
// scale multiplies the f32 dot; masked scores get + finfo(f32).min;
// weights are normalized by the row's full sum and then rounded to the
// compute dtype before the V product; the output is rounded to q's dtype.
// Only the order and grouping of the f32 sums differ.
//
// Plain C interface (bound with ctypes); launches on the caller's stream
// and returns the CUDA error code of the launch (a cluster the card cannot
// schedule is refused, never replaced). Pages must be 16-byte aligned (the
// wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 8;
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr float kBigNeg = -3.4028234663852886e+38f;  // finfo(float32).min

template <typename QT> struct Compute;
template <> struct Compute<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float f32(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};
template <> struct Compute<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

// One lane's slice of a K or V row: kElems consecutive elements in one
// vector load (Raw, kept as loaded), then widened to f32 in the compute
// dtype's values. Nothing uses a load until all of a batch's loads are
// issued, so they are in flight together.
template <typename QT, typename KT> struct Row;
template <> struct Row<float, float> {
  static constexpr int kElems = 4;   // 16 bytes
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void widen(const Raw& v, float,
                                               float* x) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Row<__nv_bfloat16, __nv_bfloat16> {
  static constexpr int kElems = 8;   // 16 bytes
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void widen(const Raw& v, float,
                                               float* x) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <typename QT> struct Row<QT, int8_t> {
  static constexpr int kElems = 8;   // 8 bytes
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ void widen(const Raw& v, float s,
                                               float* x) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t w = i < 4 ? v.x : v.y;
      const int8_t c = static_cast<int8_t>((w >> (8 * (i & 3))) & 0xffu);
      // dequantize in f32, then round to the compute dtype
      x[i] = Compute<QT>::round(static_cast<float>(c) * s);
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}


// A block stages its keys' K rows, then their V rows, in one shared buffer,
// `chunk` keys at a time (all of its share at the serving shapes), with
// cp.async: every copy in flight at once and no registers held; V's rows
// are copied in while the softmax and the cluster's merge run.
constexpr int kChunkBytes = 16384;   // most bytes of K (or of V) a chunk

// Keys a chunk holds: a block's share of the slot (kb_max) where it fits.
__host__ __device__ constexpr int chunk_keys(int kb_max, int row_bytes) {
  return kb_max < kChunkBytes / row_bytes ? kb_max : kChunkBytes / row_bytes;
}

// Shared memory of one block, in 4-byte words: the K or V chunk (and its
// int8 page scales), scores (T, kb_max), the warps' partial outputs
// (kWarps, T, D), every block's partial output (kMaxCluster, T, D: rank 0
// adds them), every block's (max, sum) per query (kMaxCluster, 2, kMaxT),
// the warps' reduction scratch (2, kWarps, kMaxT), positions and the
// row's page ids.
__host__ __device__ constexpr size_t smem_words(int T, int D, int kb_max,
                                                int pp, int row_bytes,
                                                bool quantized) {
  return (size_t)chunk_keys(kb_max, row_bytes) *
             (row_bytes / 4 + (quantized ? 1 : 0)) +
         (size_t)T * kb_max + (size_t)(kWarps + kMaxCluster) * T * D +
         2 * kMaxCluster * kMaxT + 2 * kWarps * kMaxT + kMaxT + pp;
}

// kT: T rounded up to 1, 2, 4 or 8 -- the queries' registers and unrolled
// loops are sized to it, so decode (T = 1) carries no verify-sized code.
template <typename QT, typename KT, int D, int kT>
__global__ void __launch_bounds__(kThreads, kT == 1 ? 6 : 2)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                       const KT* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ kv_positions,
                       const int* __restrict__ page_table,
                       QT* __restrict__ out, int T, int H, int P, int ps,
                       int pp, int kb_max, float scale) {
  using R = Row<QT, KT>;
  constexpr int kElems = R::kElems;
  constexpr int G = D / kElems;            // lanes per key
  constexpr int kKeysPerWarp = 32 / G;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "group size");
  constexpr int kStride = kWarps * kKeysPerWarp;   // keys per block sweep
  constexpr int kRowBytes = D * (int)sizeof(KT);
  constexpr int kPieces = kRowBytes / 16;          // 16-byte copies a row
  static_assert(kRowBytes % 16 == 0, "rows copy in 16-byte pieces");
  rlt::cluster_arrive_relaxed();
  auto cluster = rlt::cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / cs;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, gl = lane % G;   // key slot, lane in group
  const int S = pp * ps;
  const int chunk = chunk_keys(kb_max, kRowBytes);
  const bool quantized = ks != nullptr;

  extern __shared__ __align__(16) float smem[];
  uint8_t* kv = reinterpret_cast<uint8_t*>(smem);    // (chunk, D) K or V
  float* kvsc = reinterpret_cast<float*>(kv + (size_t)chunk * kRowBytes);
  float* logits = kvsc + (quantized ? chunk : 0);    // (T, kb_max)
  float* red = logits + (size_t)T * kb_max;          // (kWarps, T, D)
  float* part = red + kWarps * T * D;                // (kMaxCluster, T, D)
  float* stat = part + kMaxCluster * T * D;          // (kMaxCluster, 2, kMaxT)
  float* scratch = stat + 2 * kMaxCluster * kMaxT;   // (2, kWarps, kMaxT)
  int* pos_s = reinterpret_cast<int*>(scratch + 2 * kWarps * kMaxT);
  int* pt_s = pos_s + kMaxT;                         // (pp) clamped page ids

  // this lane's slice of every query, in the compute dtype's values; its
  // loads share one trip to memory with the positions and page table
  QT qraw[kT][kElems];
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      if (t < T)
        qraw[t][e] = q[((size_t)(b * T + t) * H + h) * D + gl * kElems + e];
  for (int i = threadIdx.x; i < pp; i += kThreads)
    pt_s[i] = page_table[b * pp + i];
  if (threadIdx.x < T) pos_s[threadIdx.x] = kv_positions[b * T + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.x; i < pp; i += kThreads)
    pt_s[i] = min(max(pt_s[i], 0), P - 1);
  float qr[kT][kElems];
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      qr[t][e] = t < T ? Compute<QT>::f32(qraw[t][e]) : 0.0f;
  __syncthreads();

  int max_pos = -1;
  for (int t = 0; t < T; ++t) max_pos = max(max_pos, pos_s[t]);
  // keys up to the end of the page holding the furthest admitted
  // position, the same in every block of the cluster; block `rank` takes
  // an equal share of them
  const int n_keys = max_pos < 0 ? 0 : min(S, (max_pos / ps + 1) * ps);
  const int per = (n_keys + cs - 1) / cs;
  const int kb0 = min(n_keys, rank * per);
  const int nk = min(n_keys, kb0 + per) - kb0;
  const int chunks = (nk + chunk - 1) / chunk;

  // copy keys [c0, c0 + cn) of the block's share: their rows of `pages`
  // (and int8 page scales) into the buffer, one cp.async group
  auto stage = [&](const KT* pages, const float* sc, int c0, int cn) {
    for (int i = threadIdx.x; i < cn * kPieces; i += kThreads) {
      const int r = i / kPieces, piece = i % kPieces;
      const int k = kb0 + c0 + r, col = k / ps;
      const size_t at = ((size_t)(pt_s[col] * ps + k - col * ps) * H + h) * D;
      hopper::cp_async16(hopper::smem_u32(kv + r * kRowBytes + piece * 16),
                         reinterpret_cast<const uint8_t*>(pages + at) +
                             piece * 16,
                         16);
    }
    if (sc != nullptr)
      for (int r = threadIdx.x; r < cn; r += kThreads)
        hopper::cp_async4(hopper::smem_u32(kvsc + r),
                          sc + pt_s[(kb0 + c0 + r) / ps] * H + h);
    hopper::cp_async_commit();
  };

  // ---- pass 1: masked, scaled scores for the block's keys. The sweep
  // base is warp-uniform so every lane of a warp joins each shuffle.
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * chunk, cn = min(chunk, nk - c0);
    if (ci > 0) __syncthreads();           // the last chunk's readers done
    stage(kp, ks, c0, cn);
    hopper::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int base = warp * kKeysPerWarp; base < cn; base += kStride) {
      const int kl = base + grp;
      float kr[kElems];
      if (kl < cn) {
        R::widen(R::load(reinterpret_cast<const KT*>(kv + kl * kRowBytes) +
                         gl * kElems),
                 quantized ? kvsc[kl] : 1.0f, kr);
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) kr[e] = 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < T) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc += qr[t][e] * kr[e];
#pragma unroll
          for (int o = G / 2; o > 0; o >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if (gl == 0 && kl < cn) {
            const float s = acc * scale;
            logits[t * kb_max + c0 + kl] =
                kb0 + c0 + kl <= pos_s[t] ? s : s + kBigNeg;
          }
        }
      }
    }
  }
  __syncthreads();
  // one chunk (the serving shapes): V's rows come into the buffer while
  // the softmax and the cluster's merge run
  if (chunks == 1) stage(vp, vs, 0, nk);

  // ---- the block's (max, sum of exp(score - max)) per query (-inf and 0
  // for a block without keys), written into every block's `stat`
  float mx[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    float m = -INFINITY;
    if (t < T)
      for (int k = threadIdx.x; k < nk; k += kThreads)
        m = fmaxf(m, logits[t * kb_max + k]);
    m = warp_max(m);
    if (lane == 0) scratch[warp * kMaxT + t] = m;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    mx[t] = scratch[t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      mx[t] = fmaxf(mx[t], scratch[w * kMaxT + t]);
    float s = 0.0f;
    if (t < T)
      for (int k = threadIdx.x; k < nk; k += kThreads)
        s += expf(logits[t * kb_max + k] - mx[t]);
    s = warp_sum(s);
    if (lane == 0) scratch[(kWarps + warp) * kMaxT + t] = s;
  }
  __syncthreads();
  rlt::cluster_wait();                     // every peer has started
  if (threadIdx.x < T * cs) {              // thread (peer r, query t)
    const int t = threadIdx.x % T, r = threadIdx.x / T;
    float m = mx[0];
#pragma unroll
    for (int u = 1; u < kT; ++u)
      if (u == t) m = mx[u];
    float s = scratch[kWarps * kMaxT + t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += scratch[(kWarps + w) * kMaxT + t];
    float* dst = cluster.map_shared_rank(stat, r) + rank * 2 * kMaxT;
    dst[t] = m;
    dst[kMaxT + t] = s;
  }
  cluster.sync();

  // ---- the row's max and sum, merged from the cluster's pairs in rank
  // order (the flash-decoding merge: f32 throughout, only its grouping
  // differs from one sum over the row). Pass 2 weighs each key by
  // exp(score - the row's max) over the row's full sum, and only then
  // rounds the weight to the compute dtype; a query with no admitted key
  // (kv_positions < 0) weighs 0, so a row with none emits 0.
  float row_max[kT], row_sum[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    row_max[t] = -INFINITY;
    row_sum[t] = 0.0f;
    if (t < T) {
      for (int r = 0; r < cs; ++r)
        row_max[t] = fmaxf(row_max[t], stat[r * 2 * kMaxT + t]);
      for (int r = 0; r < cs; ++r) {
        const float l = stat[r * 2 * kMaxT + kMaxT + t];
        if (l > 0.0f)
          row_sum[t] += l * expf(stat[r * 2 * kMaxT + t] - row_max[t]);
      }
    }
  }

  // ---- pass 2: weights x V, f32 accumulators per group of lanes
  float acc[kT][kElems];
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[t][e] = 0.0f;
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * chunk, cn = min(chunk, nk - c0);
    if (chunks > 1) {
      __syncthreads();                     // the last chunk's readers done
      stage(vp, vs, c0, cn);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kl = warp * kKeysPerWarp + grp; kl < cn; kl += kStride) {
      float v[kElems];
      R::widen(R::load(reinterpret_cast<const KT*>(kv + kl * kRowBytes) +
                       gl * kElems),
               quantized ? kvsc[kl] : 1.0f, v);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < T) {
          const float w = pos_s[t] < 0 ? 0.0f : Compute<QT>::round(
              expf(logits[t * kb_max + c0 + kl] - row_max[t]) / row_sum[t]);
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[t][e] += w * v[e];
        }
      }
    }
  }
  // sum the groups of the warp (lanes with the same gl), then the warps;
  // the block's partial goes to slot `rank` of rank 0's `part`
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    if (t < T) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        float x = acc[t][e];
#pragma unroll
        for (int o = G; o < 32; o <<= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        if (grp == 0) red[(warp * T + t) * D + gl * kElems + e] = x;
      }
    }
  }
  __syncthreads();
  float* dst = cluster.map_shared_rank(part, 0) + rank * T * D;
  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    float o = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += red[w * T * D + i];
    dst[i] = o;
  }

  // ---- rank 0 adds the cluster's partial outputs in rank order and
  // rounds the (T, D) output once
  cluster.sync();
  if (rank != 0) return;
  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    float o = part[i];
    for (int r = 1; r < cs; ++r) o += part[r * T * D + i];
    const int t = i / D, d = i % D;
    Compute<QT>::store(out + ((size_t)(b * T + t) * H + h) * D + d, o);
  }
}

constexpr int kMaxSmem = 232448;   // opt-in dynamic shared memory a block

template <typename QT, typename KT, int D, int kT>
int launch_t(bool query, const void* q, const void* kp, const void* vp,
             const float* ks, const float* vs, const int* pos, const int* pt,
             void* out, int B, int T, int H, int P, int ps, int pp, int cs,
             float scale, cudaStream_t stream, int* geometry) {
  const int kb_max = (pp * ps + cs - 1) / cs;
  const size_t smem = sizeof(float) * smem_words(
      T, D, kb_max, pp, D * (int)sizeof(KT), ks != nullptr);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<QT, KT, D, kT>;
  // once per instantiation, before any graph capture of it
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(B * H * cs);
  if (query) {
    int err = 0;
    const int n = rlt::max_active_clusters(kernel, grid, kThreads, smem, cs,
                                           &err);
    if (err != 0) return err;
    const int v[5] = {(int)grid.x, cs, kThreads, (int)smem, n};
    for (int i = 0; i < 5; ++i) geometry[i] = v[i];
    return 0;
  }
  return rlt::launch_cluster(
      kernel, grid, kThreads, smem, cs, stream, static_cast<const QT*>(q),
      static_cast<const KT*>(kp), static_cast<const KT*>(vp), ks, vs, pos,
      pt, static_cast<QT*>(out), T, H, P, ps, pp, kb_max, scale);
}

template <typename QT, typename KT, int D>
int launch(bool query, const void* q, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* pos, const int* pt,
           void* out, int B, int T, int H, int P, int ps, int pp, int cs,
           float scale, cudaStream_t stream, int* geometry) {
  if (T == 1)
    return launch_t<QT, KT, D, 1>(query, q, kp, vp, ks, vs, pos, pt, out, B,
                                  T, H, P, ps, pp, cs, scale, stream,
                                  geometry);
  if (T == 2)
    return launch_t<QT, KT, D, 2>(query, q, kp, vp, ks, vs, pos, pt, out, B,
                                  T, H, P, ps, pp, cs, scale, stream,
                                  geometry);
  if (T <= 4)
    return launch_t<QT, KT, D, 4>(query, q, kp, vp, ks, vs, pos, pt, out, B,
                                  T, H, P, ps, pp, cs, scale, stream,
                                  geometry);
  return launch_t<QT, KT, D, 8>(query, q, kp, vp, ks, vs, pos, pt, out, B, T,
                                H, P, ps, pp, cs, scale, stream, geometry);
}

template <typename QT, typename KT>
int launch_d(int D, bool query, const void* q, const void* kp,
             const void* vp, const float* ks, const float* vs,
             const int* pos, const int* pt, void* out, int B, int T, int H,
             int P, int ps, int pp, int cs, float scale, cudaStream_t stream,
             int* geometry) {
  switch (D) {
    case 32:
      return launch<QT, KT, 32>(query, q, kp, vp, ks, vs, pos, pt, out, B, T,
                                H, P, ps, pp, cs, scale, stream, geometry);
    case 64:
      return launch<QT, KT, 64>(query, q, kp, vp, ks, vs, pos, pt, out, B, T,
                                H, P, ps, pp, cs, scale, stream, geometry);
    case 128:
      return launch<QT, KT, 128>(query, q, kp, vp, ks, vs, pos, pt, out, B,
                                 T, H, P, ps, pp, cs, scale, stream,
                                 geometry);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(bool query, const void* q, const void* k_pages,
             const void* v_pages, const void* k_scales, const void* v_scales,
             const void* kv_positions, const void* page_table, void* out,
             int B, int T, int H, int D, int P, int page_size,
             int pages_per_slot, int q_dtype, int quantized, int cluster,
             float scale, void* stream, int* geometry) {
  if (T < 1 || T > kMaxT || B < 1 || H < 1 || P < 1 || page_size < 1 ||
      pages_per_slot < 1 || cluster < 1 || cluster > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  const float* ks = quantized ? static_cast<const float*>(k_scales) : nullptr;
  const float* vs = quantized ? static_cast<const float*>(v_scales) : nullptr;
  const int* pos = static_cast<const int*>(kv_positions);
  const int* pt = static_cast<const int*>(page_table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    return quantized
        ? launch_d<float, int8_t>(D, query, q, k_pages, v_pages, ks, vs, pos,
                                  pt, out, B, T, H, P, page_size,
                                  pages_per_slot, cluster, scale, s,
                                  geometry)
        : launch_d<float, float>(D, query, q, k_pages, v_pages, ks, vs, pos,
                                 pt, out, B, T, H, P, page_size,
                                 pages_per_slot, cluster, scale, s, geometry);
  }
  if (q_dtype == 1) {
    return quantized
        ? launch_d<__nv_bfloat16, int8_t>(D, query, q, k_pages, v_pages, ks,
                                          vs, pos, pt, out, B, T, H, P,
                                          page_size, pages_per_slot, cluster,
                                          scale, s, geometry)
        : launch_d<__nv_bfloat16, __nv_bfloat16>(
              D, query, q, k_pages, v_pages, ks, vs, pos, pt, out, B, T, H,
              P, page_size, pages_per_slot, cluster, scale, s, geometry);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. quantized: pages are int8 codes with
// per-page-per-head f32 scales (k_scales/v_scales), else pages share q's
// dtype and the scale pointers are ignored. cluster: blocks per (row,
// head), 1..8, chosen by the wrapper (models/paged_attention.py).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* kv_positions,
    const void* page_table, void* out, int B, int T, int H, int D, int P,
    int page_size, int pages_per_slot, int q_dtype, int quantized,
    int cluster, float scale, void* stream) {
  return dispatch(false, q, k_pages, v_pages, k_scales, v_scales,
                  kv_positions, page_table, out, B, T, H, D, P, page_size,
                  pages_per_slot, q_dtype, quantized, cluster, scale, stream,
                  nullptr);
}

// The launch geometry of such a call, for reports: out[0..4] = grid,
// cluster size, threads a block, dynamic shared memory bytes a block, and
// how many clusters of that size the card holds at once
// (cudaOccupancyMaxActiveClusters). Launches nothing.
extern "C" int paged_attention_geometry(int B, int T, int H, int D, int P,
                                        int page_size, int pages_per_slot,
                                        int q_dtype, int quantized,
                                        int cluster, int* out) {
  return dispatch(true, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, B, T, H, D, P, page_size, pages_per_slot,
                  q_dtype, quantized, cluster, 1.0f, nullptr, out);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
