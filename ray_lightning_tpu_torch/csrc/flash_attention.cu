// Flash attention, forward and backward, for training.
//
// Replaces the three Pallas kernels of ray_lightning_tpu/ops/pallas_flash.py:
//
//   flash_fwd_tc_kernel     <- _flash_kernel      (forward, bf16: tensor
//                                                  cores)
//   flash_fwd_kernel        <- _flash_kernel      (forward: out and lse)
//   flash_bwd_dkv_tc_kernel <- _flash_dkv_kernel  (dK and dV, bf16: tensor
//                                                  cores)
//   flash_bwd_dkv_kernel    <- _flash_dkv_kernel  (backward: dK and dV)
//   flash_bwd_dq_tc_kernel  <- _flash_dq_kernel   (dQ, bf16: tensor cores)
//   flash_bwd_dq_kernel     <- _flash_dq_kernel   (backward: dQ)
//
// Each computes the same function as its Pallas kernel; none copies the
// Pallas grid. The TPU grid's innermost axis runs in order on one core and
// carries the online-softmax state (or the dK/dV, dQ sums) from one grid
// step to the next in scratch memory. Here that axis is a loop inside one
// thread block, which keeps its running state in registers: a block owns
// one (batch row, head, q or kv tile) and walks the tiles of the other
// operand itself. Nothing is carried between blocks and nothing is added
// with atomics, so every result repeats bitwise from run to run.
//
// Layout: q, k, v, dO and the outputs are (B, T|S, H, D) tensors read and
// written through their batch, sequence and head strides (the last axis must
// be contiguous), so the q/k/v views of one fused qkv projection are read
// in place. lse and delta are (B, H, T) contiguous f32.
//
// Conventions kept one for one from pallas_flash.py:
//   * scores are f32 sums of products of the input dtype's values (exact
//     in f32), with the scale applied after the dot;
//   * masked scores are _BIG_NEG = -0.7 * finfo(f32).max (not finfo.min:
//     exp(m_prev - m_new) of two masked maxima must stay 1, not NaN);
//   * a key is admitted iff kpos < S and, causal, kpos <= qpos + (S - T):
//     the causal diagonal is end-aligned when T != S;
//   * KV tiles wholly above the diagonal are skipped (the forward and dQ
//     loops stop early, the dK/dV loop starts late); a tile with no work
//     still writes zeros;
//   * a row that admits no key emits out = 0 and lse = 1e30, so that
//     p = exp(s - lse) = 0 in the backward and it adds nothing anywhere;
//   * p is rounded to v's dtype before P.V; in the backward p is rounded to
//     dO's dtype for dV, ds to q's dtype for dK and to k's dtype for dQ,
//     and each tile's dK / dQ product is multiplied by the scale before it
//     joins the f32 sum; every output is rounded to its input's dtype.
// The order of the f32 sums differs from the Pallas kernels, and so, in
// flash_fwd_tc_kernel, does each exp: it computes p = 2^(s * scale * log2 e
// - m) by ex2.approx and lse = m * ln 2 + log(l), where _flash_kernel takes
// exp(s * scale - m) and m + log(l). The two p differ by a few f32 ulps,
// enough to flip an occasional bf16 rounding of p. On the H100 lse stays
// within 9.5e-7 of the plain version, as on the f32 route's expf, and out
// within the element-wise bound of ops/cuda_flash.py:flash_out_bound.
//
// Bound on the H100 (dense peaks: 989 TFLOP/s bf16 and 67 TFLOP/s f32 for
// these products, 3.35 TB/s of device memory). With N = B*H*T*S*D, about
// half of it under causal masking:
//   forward: 4N operations (Q.K^T and P.V); bytes = read q, k, v, write out
//            and lse;
//   dK/dV:   8N (Q.K^T, dO.V^T, P^T.dO, dS^T.Q); bytes = read q, k, v, dO,
//            lse, delta, write dk, dv;
//   dQ:      6N (Q.K^T, dO.V^T, dS.K); bytes = read q, k, v, dO, lse,
//            delta, write dq.
// At the training shapes (T = S = 1024, D = 64) all three are bound by
// operations, by far.
//
// Each kernel has two versions; the caller names the one that runs
// (`route`). The forward's (ops/cuda_flash.py:_fwd_route):
//   * flash_fwd_tc_kernel (bf16 q/k/v whose rows allow 16-byte copies:
//     the training path's views of one fused qkv projection). The
//     products run on the tensor cores (wgmma, bf16 in, f32 accumulators:
//     the same f32 sums of exact bf16 products). One block per (batch
//     row, head, 128-row q tile), two warpgroups of 64 rows; Q is copied
//     into shared memory once, K and V tiles of 64 keys go through a
//     3-stage ring filled one tile ahead by 16-byte cp.async (one barrier
//     a tile), all in the 128-byte swizzle (head dims 32 and 128 as one
//     or two 64-column blocks, 32 zero-padded). S = Q K^T is one wgmma
//     per 16 of D (A = Q, B = K, both K-major); the online softmax runs
//     in registers on the accumulator fragment's rows (a row's 64 scores
//     in one quad of threads, reduced by two shuffles); p, rounded to
//     bf16, is repacked
//     in registers as the A operand of P V (B = V, MN-major: its rows are
//     keys, D contiguous). The softmax keeps scores in the log2 domain
//     (s * scale * log2 e), so each exp is one ex2.approx on the MUFU
//     unit; lse returns to the natural log at the end. Tiles that every
//     row of a warp admits whole skip the mask. What bounds it
//     now: the softmax's instructions a score and the synchronous wait on
//     each wgmma -- the tensor cores idle while a warpgroup does its
//     softmax, unless the other warpgroups of the SM fill the gap.
//   * flash_fwd_kernel (f32, and bf16 views the tc kernel cannot copy):
//     the products on the CUDA cores in f32, one FMA per pair of values,
//     from shared-memory tiles -- f32 keeps f32 products (TF32 would not
//     hold the f32 path's 1e-5).
// The backward has two kernels for each of K3 and K4, chosen the same way
// (ops/cuda_flash.py:_bwd_route: bf16 q, k, v and dO with 16-byte-aligned
// rows take `tc`):
//   * flash_bwd_dkv_tc_kernel (K3): one block per (batch row, head, 128
//     keys), two warpgroups of 64 keys. K and V are copied once; the q
//     tiles (64 rows) from the first that admits the block's first key
//     come, with their lse and delta, through a 3-stage cp.async ring one
//     tile ahead. The scores are computed transposed, S^T = K Q^T and
//     dP^T = V dO^T (one wgmma group, A = K or V, B = the q tile, both
//     K-major), so that p^T and ds^T = p^T (dp^T - delta), computed in
//     registers with lse and delta indexed by the fragment's column (the
//     query), come out in the layout of the A fragments of dV += P^T dO
//     and dK += dS^T Q (register-sourced wgmma, B = dO or Q read MN-major
//     from the same swizzled copy that served the K-major reads).
//   * flash_bwd_dq_tc_kernel (K4): one block per (batch row, head, 128 q
//     rows), two warpgroups of 64 rows, as the tc forward; Q, dO, lse and
//     delta copied once, K and V tiles of 64 keys through the forward's
//     3-stage ring, the causal loop stopping at the forward's n_j, the q
//     tiles with the most work first. S = Q K^T and dP = dO V^T (K-major),
//     ds in registers, dQ += dS K (B = K, MN-major).
//   Both keep every Pallas rounding point of the list above: p rounded
//   to bf16 for dV, ds for dK and dQ, each output once; masked entries are
//   exactly 0, keys past S masked explicitly (a zero-filled K row scores 0,
//   and exp(0 - lse) is not 0), rows past T staged with lse = 1e30 and
//   delta = 0; a tile with no work writes zeros. p = 2^(s * scale * log2 e
//   - lse * log2 e) by ex2.approx, a few f32 ulps from Pallas's exp, so an
//   occasional bf16 rounding of p or ds flips (ops/cuda_flash.py:
//   flash_grad_bound covers it). dK and dQ take the scale once, on the f32
//   sum at the end, where Pallas scales each tile's product: at D = 64 the
//   scale is 2^-3 and the two are bitwise the same; at D = 32 and 128 they
//   differ by f32 rounding only. D = 32 runs as one zero-padded 64-column
//   block (its score sums take two k16 slices), D = 128 as two. No
//   atomics, no split of a sum across blocks: results repeat bitwise. B
//   descriptors are uniform across a block (only A, the warpgroup's rows,
//   varies): the card's ptxas crashes otherwise. Registers at D = 64: dK,
//   dV (K3) or dQ (K4) accumulators, S and dP fragments, the packed A
//   fragments; one 256-thread K3 block an SM, two K4 blocks. What bounds
//   them now: each warpgroup waits on its score wgmmas, does its
//   element-wise work, then waits on its gradient wgmmas; the tensor cores
//   idle unless the SM's other warpgroups fill the gaps.
//   * flash_bwd_dkv_kernel, flash_bwd_dq_kernel (f32, and bf16 views the
//     tc kernels cannot copy): the CUDA-core design -- 256 threads per
//     block as 16 x 16; a thread owns 4 rows x 4 columns of each 64 x 64
//     score tile (rows ty + 16a, columns tx + 16b), so a row's reductions
//     are shuffles within 16 lanes, and 4 rows x D/16 columns of each 64 x
//     D output tile; f32 keeps f32 products (TF32 would not hold the f32
//     path's 1e-4).
//
// Plain C interface (bound with ctypes). Each launch runs on the caller's
// stream and returns the CUDA error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kTile = 64;        // q rows per q tile, keys per kv tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kSub = 4;          // rows (and score columns) per thread
constexpr int kPs = kTile + 1;   // padded row stride of a score tile
constexpr float kBigNeg = static_cast<float>(-0.7 * 3.4028234663852886e+38);
constexpr float kPadLse = 1e30f;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

// A (B, L, H, D) operand: base pointer and its batch, sequence and head
// strides in elements (the D axis is contiguous).
struct Operand {
  const void* ptr;
  long long sb, sl, sh;
};

struct Params {
  Operand q, k, v, dout, out, dq, dk, dv;
  const float* lse_in;     // (B, H, T), backward
  const float* delta;      // (B, H, T), backward
  float* lse_out;          // (B, H, T), forward
  int B, H, T, S, causal;
  float scale;
};

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [row0, row0 + kTile) of operand `x` (sequence length L) for
// batch b and head h into shared memory as f32, rows of stride D + 1;
// rows past L are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const Operand& x, int b,
                                      int h, int row0, int L) {
  const T* base = static_cast<const T*>(x.ptr) + b * x.sb + h * x.sh;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] =
        row < L ? Cvt<T>::load(base + (long long)row * x.sl + d) : 0.0f;
  }
}

// Is key `kpos` admitted for query `qpos`? (qpos < T, kpos < S, causal
// end-aligned)
__device__ __forceinline__ bool admitted(const Params& p, int qpos,
                                         int kpos) {
  return qpos < p.T && kpos < p.S &&
         (!p.causal || kpos <= qpos + (p.S - p.T));
}

// Number of kv tiles q tile i must visit: causal stops at the tile holding
// the key its last real row reaches (0 if no row admits any key).
__device__ __forceinline__ int kv_tiles_for(const Params& p, int i) {
  const int n_k = (p.S + kTile - 1) / kTile;
  if (!p.causal) return n_k;
  const int last_q = min(i * kTile + kTile - 1, p.T - 1) + (p.S - p.T);
  return last_q < 0 ? 0 : min(n_k, last_q / kTile + 1);
}

// s[a][b] = sum_d X[ty + 16a][d] * Y[tx + 16b][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kSub][kSub],
                                         const float* xs, const float* ys,
                                         int tx, int ty) {
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int b = 0; b < kSub; ++b) s[a][b] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float xv[kSub], yv[kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a) xv[a] = xs[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
    for (int b = 0; b < kSub; ++b) yv[b] = ys[(tx + 16 * b) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int b = 0; b < kSub; ++b) s[a][b] += xv[a] * yv[b];
  }
}

// ------------------------------------------------------------------ K2
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  constexpr int kC = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // kTile x (D + 1)
  float* ks = qs + kTile * (D + 1);          // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);          // kTile x (D + 1)
  float* ps = vs + kTile * (D + 1);          // kTile x kPs

  const int n_q = (p.T + kTile - 1) / kTile;
  // the q tiles with the most causal work start first
  const int i = n_q - 1 - (int)(blockIdx.x % n_q);
  const int bh = blockIdx.x / n_q;
  const int b = bh / p.H, h = bh % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage<T, D>(qs, p.q, b, h, i * kTile, p.T);

  float m[kSub], l[kSub], acc[kSub][kC];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    m[a] = kBigNeg;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[a][c] = 0.0f;
  }

  const int n_j = kv_tiles_for(p, i);
  for (int j = 0; j < n_j; ++j) {
    __syncthreads();    // the previous tile's ks/vs/ps are consumed
    stage<T, D>(ks, p.k, b, h, j * kTile, p.S);
    stage<T, D>(vs, p.v, b, h, j * kTile, p.S);
    __syncthreads();

    float s[kSub][kSub];
    tile_dot<D>(s, qs, ks, tx, ty);
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int qpos = i * kTile + ty + 16 * a;
      float mx = kBigNeg;
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        const int kpos = j * kTile + tx + 16 * c;
        s[a][c] = admitted(p, qpos, kpos) ? s[a][c] * p.scale : kBigNeg;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], group_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        const int kpos = j * kTile + tx + 16 * c;
        const float e = admitted(p, qpos, kpos) ? expf(s[a][c] - m_new)
                                                : 0.0f;
        rs += e;
        ps[(ty + 16 * a) * kPs + tx + 16 * c] = Cvt<T>::round(e);
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + group_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) vv[c] = vs[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const float w = ps[(ty + 16 * a) * kPs + kk];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[a][c] += w * vv[c];
      }
    }
  }

  T* out = static_cast<T*>(const_cast<void*>(p.out.ptr)) + b * p.out.sb +
           h * p.out.sh;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int row = i * kTile + ty + 16 * a;
    if (row >= p.T) continue;
    const float safe_l = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      Cvt<T>::store(out + (long long)row * p.out.sl + tx + 16 * c,
                    l[a] > 0.0f ? acc[a][c] / safe_l : 0.0f);
    if (tx == 0)
      p.lse_out[((long long)b * p.H + h) * p.T + row] =
          l[a] > 0.0f ? m[a] + logf(safe_l) : kPadLse;
  }
}

// ------------------------------------------------------------- K2, tc
// bf16 q/k/v on the tensor cores (the header says why and how).
constexpr int kTcQ = 128;        // q rows per block: two warpgroups of 64
constexpr int kTcK = 64;         // keys per kv tile
constexpr int kTcThreads = 256;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^x by the MUFU unit (ex2.approx: about 2 ulp; 2^x of kBigNeg - m is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kTcStages = 3;     // K/V tiles in the ring

template <int D>
struct TcFwd {
  static constexpr int kDP = D < 64 ? 64 : D;  // whole 128-byte rows
  static constexpr int kNB = kDP / 64;         // 64-column blocks a row
  static constexpr int kQBytes = kTcQ * 128;   // one Q block
  static constexpr int kKBytes = kTcK * 128;   // one K or V block
  // Q, then the stages of K, then those of V
  static constexpr int kSmem =
      kNB * (kQBytes + 2 * kTcStages * kKBytes) + 1024;
};

// One kv tile's online-softmax update on the thread's two accumulator
// rows: s (the tile's scores, f32 sums of exact bf16 products) is scaled
// into the log2 domain and masked (MASK: key kpos is admitted iff kpos <
// lim[r]; without MASK every key is), m and l advance, o is rescaled by
// alpha, and p = 2^(s - m), rounded to bf16, is packed as the A fragments
// of the P.V wgmma (the S fragment's columns 16t..16t+15 are the A
// fragment of k16 slice t). A row's 64 scores sit in one quad of threads.
template <bool MASK, int kNB>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], uint32_t (&pa)[4][4], float (&m)[2], float (&l)[2],
    float (&o)[kNB][32], const int (&lim)[2], int kbase, float scale2) {
  const int lane = threadIdx.x % 32;
  float mx[2] = {kBigNeg, kBigNeg};
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = kbase + 8 * c + 2 * (lane & 3) + e;
        float& v = s[4 * c + 2 * r + e];
        v = !MASK || kpos < lim[r] ? v * scale2 : kBigNeg;
        mx[r] = fmaxf(mx[r], v);
      }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
    const float alpha = ex2(m[r] - m_new[r]);
    m[r] = m_new[r];
    l[r] *= alpha;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        o[c][4 * jj + 2 * r] *= alpha;
        o[c][4 * jj + 2 * r + 1] *= alpha;
      }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = kbase + 8 * c + 2 * (lane & 3);
      const float e0 = !MASK || kpos < lim[r]
                           ? ex2(s[4 * c + 2 * r] - m_new[r]) : 0.0f;
      const float e1 = !MASK || kpos + 1 < lim[r]
                           ? ex2(s[4 * c + 2 * r + 1] - m_new[r]) : 0.0f;
      l[r] += e0 + e1;
      pa[c / 2][(c % 2) * 2 + r] = hopper::pack_bf16(e0, e1);
    }
}

// Copy rows [row0, row0 + rows) of (b, h) of `x` into kNB swizzled blocks
// of 64 columns at `dst` (`blk` bytes apart): 16-byte cp.async, zeros for
// rows past L and for the padding columns past D.
template <int D>
__device__ __forceinline__ void tc_stage(uint32_t dst, int blk,
                                         const Operand& x, int b, int h,
                                         int row0, int rows, int L) {
  constexpr int kCh = TcFwd<D>::kDP / 8;       // 16-byte chunks a row
  const __nv_bfloat16* base =
      static_cast<const __nv_bfloat16*>(x.ptr) + b * x.sb + h * x.sh;
  for (int e = threadIdx.x; e < rows * kCh; e += kTcThreads) {
    const int r = e / kCh, c = e % kCh;
    const uint32_t at = dst + (c / 8) * blk + hopper::swz(r, c % 8);
    if (c * 8 < D) {
      const int row = row0 + r;
      const bool in = row < L;
      hopper::cp_async16(at, in ? base + (long long)row * x.sl + c * 8 : base,
                         in ? 16 : 0);
    } else {
      hopper::st_shared16(at, make_uint4(0u, 0u, 0u, 0u));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
flash_fwd_tc_kernel(Params p) {
  using S = TcFwd<D>;
  constexpr int kNB = S::kNB;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const uint32_t raw = hopper::smem_u32(tc_smem);
  const uint32_t q_s = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t k_s = q_s + kNB * S::kQBytes;
  const uint32_t v_s = k_s + kTcStages * kNB * S::kKBytes;

  const int n_q = (p.T + kTcQ - 1) / kTcQ;
  // the q tiles with the most causal work start first
  const int i = n_q - 1 - (int)(blockIdx.x % n_q);
  const int bh = blockIdx.x / n_q;
  const int b = bh / p.H, h = bh % p.H;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  // kv tiles this q tile visits: causal stops at the tile holding the key
  // its last real row reaches (0 if no row admits any key)
  const int n_k = (p.S + kTcK - 1) / kTcK;
  int n_j = n_k;
  if (p.causal) {
    const int last_q = min(i * kTcQ + kTcQ - 1, p.T - 1) + (p.S - p.T);
    n_j = last_q < 0 ? 0 : min(n_k, last_q / kTcK + 1);
  }

  // this thread's rows of the accumulator fragments: r and r + 8 of its
  // warpgroup's 64; lim[r] = keys [0, lim) are admitted (0 past T)
  const int q_warp = i * kTcQ + wg * 64 + warp * 16;   // the warp's first
  const int q_lo = q_warp + lane / 4;
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q_lo + 8 * r;
    lim[r] = qpos >= p.T ? 0
             : p.causal  ? max(0, min(p.S, qpos + (p.S - p.T) + 1))
                         : p.S;
  }

  if (n_j > 0) {
    tc_stage<D>(q_s, S::kQBytes, p.q, b, h, i * kTcQ, kTcQ, p.T);
    tc_stage<D>(k_s, S::kKBytes, p.k, b, h, 0, kTcK, p.S);
    tc_stage<D>(v_s, S::kKBytes, p.v, b, h, 0, kTcK, p.S);
  }
  hopper::cp_async_commit();

  const float scale2 = p.scale * kLog2e;
  float m[2] = {kBigNeg, kBigNeg}, l[2] = {0.0f, 0.0f};
  float o[kNB][32];
#pragma unroll
  for (int c = 0; c < kNB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.0f;

  for (int j = 0; j < n_j; ++j) {
    const int st = j % kTcStages;
    const uint32_t k_t = k_s + st * kNB * S::kKBytes;
    const uint32_t v_t = v_s + st * kNB * S::kKBytes;
    // the next tile's copies fly while this one is computed; its stage
    // last held tile j - 2, which every thread finished before the
    // barrier of iteration j - 1
    if (j + 1 < n_j) {
      const int nx = (j + 1) % kTcStages;
      tc_stage<D>(k_s + nx * kNB * S::kKBytes, S::kKBytes, p.k, b, h,
                  (j + 1) * kTcK, kTcK, p.S);
      tc_stage<D>(v_s + nx * kNB * S::kKBytes, S::kKBytes, p.v, b, h,
                  (j + 1) * kTcK, kTcK, p.S);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();          // Q and tile j have landed
    hopper::fence_proxy_async();
    __syncthreads();

    // S = Q K^T: f32 sums of exact bf16 products
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < S::kDP / 16; ++ks)
      hopper::mma_ss_n64(
          s,
          hopper::desc_kmajor(q_s + (ks / 4) * S::kQBytes + wg * 64 * 128 +
                              (ks % 4) * 32),
          hopper::desc_kmajor(k_t + (ks / 4) * S::kKBytes + (ks % 4) * 32),
          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();

    // a tile every row of the warp admits whole skips the mask
    const int kend = (j + 1) * kTcK;
    uint32_t pa[4][4];
    if (kend <= p.S && q_warp + 15 < p.T &&
        (!p.causal || kend - 1 <= q_warp + (p.S - p.T)))
      softmax_tile<false, kNB>(s, pa, m, l, o, lim, j * kTcK, scale2);
    else
      softmax_tile<true, kNB>(s, pa, m, l, o, lim, j * kTcK, scale2);

    // O += P V, V read MN-major (the tile's rows are keys, D contiguous)
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < kNB; ++c)
        hopper::mma_rs_n64_mn(
            o[c], pa[t],
            hopper::desc_mnmajor(v_t + c * S::kKBytes + t * 16 * 128), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
  }
  hopper::cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(
                           const_cast<void*>(p.out.ptr)) +
                       b * p.out.sb + h * p.out.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q_lo + 8 * r;
    if (row >= p.T) continue;
    const float safe_l = fmaxf(l[r], 1e-30f);
    const bool any = l[r] > 0.0f;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * c + 8 * jj + 2 * (lane & 3);
        if (col < D)
          *reinterpret_cast<uint32_t*>(out + (long long)row * p.out.sl + col) =
              hopper::pack_bf16(any ? o[c][4 * jj + 2 * r] / safe_l : 0.0f,
                                any ? o[c][4 * jj + 2 * r + 1] / safe_l
                                    : 0.0f);
      }
    if ((lane & 3) == 0)            // back from the log2 domain
      p.lse_out[((long long)b * p.H + h) * p.T + row] =
          any ? m[r] * kLn2 + logf(safe_l) : kPadLse;
  }
}

// Rebuild p = exp(s * scale - lse) and ds = p * (dO.V^T - delta) for the
// thread's 4 x 4 entries of a (q tile i, kv tile j) score tile
// (_recomputed_p_ds); masked entries are exactly 0 in both.
template <int D>
__device__ __forceinline__ void recompute_p_ds(
    float (&pv)[kSub][kSub], float (&ds)[kSub][kSub], const Params& p,
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, int i, int j, int tx, int ty) {
  float dp[kSub][kSub];
  tile_dot<D>(pv, qs, ks, tx, ty);
  tile_dot<D>(dp, dos, vs, tx, ty);
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int r = ty + 16 * a;
    const int qpos = i * kTile + r;
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
      const int kpos = j * kTile + tx + 16 * c;
      const float e = admitted(p, qpos, kpos)
                          ? expf(pv[a][c] * p.scale - lse_s[r]) : 0.0f;
      pv[a][c] = e;
      ds[a][c] = e * (dp[a][c] - delta_s[r]);
    }
  }
}

// Stage a q tile's lse and delta; rows past T get lse = 1e30, delta = 0.
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const Params& p, int b, int h,
                                           int row0) {
  if (threadIdx.x < kTile) {
    const int row = row0 + threadIdx.x;
    const long long at = ((long long)b * p.H + h) * p.T + row;
    lse_s[threadIdx.x] = row < p.T ? p.lse_in[at] : kPadLse;
    delta_s[threadIdx.x] = row < p.T ? p.delta[at] : 0.0f;
  }
}

// ------------------------------------------------------------------ K3
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Params p) {
  constexpr int kC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                          // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);
  float* qs = vs + kTile * (D + 1);
  float* dos = qs + kTile * (D + 1);
  float* ps = dos + kTile * (D + 1);         // kTile x kPs, [q][k]
  float* dss = ps + kTile * kPs;             // kTile x kPs, [q][k]
  float* lse_s = dss + kTile * kPs;          // kTile
  float* delta_s = lse_s + kTile;            // kTile

  const int n_k = (p.S + kTile - 1) / kTile;
  const int n_q = (p.T + kTile - 1) / kTile;
  // under causal masking the first kv tiles have the most q tiles
  const int j = (int)(blockIdx.x % n_k);
  const int bh = blockIdx.x / n_k;
  const int b = bh / p.H, h = bh % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage<T, D>(ks, p.k, b, h, j * kTile, p.S);
  stage<T, D>(vs, p.v, b, h, j * kTile, p.S);

  // the first q row that may admit key j * kTile, and its tile
  int i0 = 0;
  if (p.causal) {
    const int first_q = j * kTile - (p.S - p.T);
    i0 = first_q >= p.T ? n_q : max(first_q, 0) / kTile;
  }

  float dk[kSub][kC], dv[kSub][kC];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[a][c] = dv[a][c] = 0.0f;

  for (int i = i0; i < n_q; ++i) {
    __syncthreads();    // the previous q tile's staging is consumed
    stage<T, D>(qs, p.q, b, h, i * kTile, p.T);
    stage<T, D>(dos, p.dout, b, h, i * kTile, p.T);
    stage_rows(lse_s, delta_s, p, b, h, i * kTile);
    __syncthreads();

    float pv[kSub][kSub], ds[kSub][kSub];
    recompute_p_ds<D>(pv, ds, p, qs, dos, ks, vs, lse_s, delta_s, i, j, tx,
                      ty);
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        const int at = (ty + 16 * a) * kPs + tx + 16 * c;
        ps[at] = Cvt<T>::round(pv[a][c]);    // p.astype(dO.dtype)
        dss[at] = Cvt<T>::round(ds[a][c]);   // ds.astype(q.dtype)
      }
    __syncthreads();

    // this thread: keys ty + 16a, columns tx + 16c
    float dkt[kSub][kC];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kC; ++c) dkt[a][c] = 0.0f;
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float dov[kC], qv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        dov[c] = dos[qq * (D + 1) + tx + 16 * c];
        qv[c] = qs[qq * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const float pw = ps[qq * kPs + ty + 16 * a];
        const float dw = dss[qq * kPs + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dv[a][c] += pw * dov[c];
          dkt[a][c] += dw * qv[c];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kC; ++c) dk[a][c] += dkt[a][c] * p.scale;
  }

  T* dk_out = static_cast<T*>(const_cast<void*>(p.dk.ptr)) + b * p.dk.sb +
              h * p.dk.sh;
  T* dv_out = static_cast<T*>(const_cast<void*>(p.dv.ptr)) + b * p.dv.sb +
              h * p.dv.sh;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int row = j * kTile + ty + 16 * a;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      Cvt<T>::store(dk_out + (long long)row * p.dk.sl + tx + 16 * c,
                    dk[a][c]);
      Cvt<T>::store(dv_out + (long long)row * p.dv.sl + tx + 16 * c,
                    dv[a][c]);
    }
  }
}

// ------------------------------------------------------------------ K4
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Params p) {
  constexpr int kC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                          // kTile x (D + 1)
  float* dos = qs + kTile * (D + 1);
  float* ks = dos + kTile * (D + 1);
  float* vs = ks + kTile * (D + 1);
  float* dss = vs + kTile * (D + 1);         // kTile x kPs, [q][k]
  float* lse_s = dss + kTile * kPs;
  float* delta_s = lse_s + kTile;

  const int n_q = (p.T + kTile - 1) / kTile;
  const int i = n_q - 1 - (int)(blockIdx.x % n_q);
  const int bh = blockIdx.x / n_q;
  const int b = bh / p.H, h = bh % p.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage<T, D>(qs, p.q, b, h, i * kTile, p.T);
  stage<T, D>(dos, p.dout, b, h, i * kTile, p.T);
  stage_rows(lse_s, delta_s, p, b, h, i * kTile);

  float dq[kSub][kC];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) dq[a][c] = 0.0f;

  const int n_j = kv_tiles_for(p, i);
  for (int j = 0; j < n_j; ++j) {
    __syncthreads();
    stage<T, D>(ks, p.k, b, h, j * kTile, p.S);
    stage<T, D>(vs, p.v, b, h, j * kTile, p.S);
    __syncthreads();

    float pv[kSub][kSub], ds[kSub][kSub];
    recompute_p_ds<D>(pv, ds, p, qs, dos, ks, vs, lse_s, delta_s, i, j, tx,
                      ty);
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kSub; ++c)
        dss[(ty + 16 * a) * kPs + tx + 16 * c] =
            Cvt<T>::round(ds[a][c]);         // ds.astype(k.dtype)
    __syncthreads();

    // this thread: q rows ty + 16a, columns tx + 16c
    float dqt[kSub][kC];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kC; ++c) dqt[a][c] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) kv[c] = ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const float w = dss[(ty + 16 * a) * kPs + kk];
#pragma unroll
        for (int c = 0; c < kC; ++c) dqt[a][c] += w * kv[c];
      }
    }
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kC; ++c) dq[a][c] += dqt[a][c] * p.scale;
  }

  T* dq_out = static_cast<T*>(const_cast<void*>(p.dq.ptr)) + b * p.dq.sb +
              h * p.dq.sh;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int row = i * kTile + ty + 16 * a;
    if (row >= p.T) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      Cvt<T>::store(dq_out + (long long)row * p.dq.sl + tx + 16 * c,
                    dq[a][c]);
  }
}

// --------------------------------------------------------- K3, K4, tc
// bf16 backward on the tensor cores (the header says why and how).
constexpr int kBwdKeys = 128;    // K3: keys per block, two warpgroups of 64
constexpr int kBwdRows = 64;     // K3: q rows per staged q tile

template <int D>
struct TcBwd {
  static constexpr int kDP = D < 64 ? 64 : D;  // whole 128-byte rows
  static constexpr int kNB = kDP / 64;         // 64-column blocks a row
  static constexpr int kKS = D / 16;           // k16 slices of a D-sum
  static constexpr int kBig = 128 * 128;       // one 128-row block
  static constexpr int kSmall = 64 * 128;      // one 64-row block
  // K3: K and V (128 keys), then the stages of Q, dO and lse | delta
  static constexpr int kDkvSmem = kNB * (2 * kBig + 2 * kTcStages * kSmall) +
                                  kTcStages * 2 * kBwdRows * 4 + 1024;
  // K4: Q and dO (128 rows), lse | delta, then the stages of K and V
  static constexpr int kDqSmem = kNB * (2 * kBig + 2 * kTcStages * kSmall) +
                                 2 * kTcQ * 4 + 1024;
};

// Stage lse and delta of rows [row0, row0 + rows) of (b, h) into
// lse_dst[0, rows) and delta_dst[0, rows): 4-byte cp.async (a row of lse
// starts wherever (b H + h) T puts it); rows past T get lse = 1e30 and
// delta = 0, so p = 0 there.
__device__ __forceinline__ void tc_stage_rows(float* lse_dst, float* delta_dst,
                                              const Params& p, int b, int h,
                                              int row0, int rows) {
  const long long base = ((long long)b * p.H + h) * p.T;
  for (int e = threadIdx.x; e < 2 * rows; e += kTcThreads) {
    const bool lse = e < rows;
    const int r = lse ? e : e - rows;
    float* dst = (lse ? lse_dst : delta_dst) + r;
    const int row = row0 + r;
    if (row < p.T)
      hopper::cp_async4(hopper::smem_u32(dst),
                        (lse ? p.lse_in : p.delta) + base + row);
    else
      *dst = lse ? kPadLse : 0.0f;
  }
}

// K3's scores of one (kv, q) tile pair, transposed: s = S^T and dp = dP^T,
// rows the thread's two keys, columns 16 of the tile's 64 queries. Writes
// p^T = 2^(s * scale * log2 e - lse * log2 e) and ds^T = p^T (dp^T -
// delta), each rounded to bf16, as the A fragments of dV += P^T dO and
// dK += dS^T Q (columns 16t..16t+15 are the fragment of k16 slice t).
// MASK: query q is admitted for row r iff qmin[r] <= q < T; without MASK
// every entry is. Masked entries are exactly 0 in both.
template <bool MASK>
__device__ __forceinline__ void dkv_p_ds(const float (&s)[32],
                                         const float (&dp)[32],
                                         uint32_t (&pp)[4][4],
                                         uint32_t (&pds)[4][4],
                                         const float* lse_t,
                                         const float* delta_t,
                                         const int (&qmin)[2], int q0, int T,
                                         float scale2) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    const float2 l = *reinterpret_cast<const float2*>(lse_t + col);
    const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
    const float n0 = -l.x * kLog2e, n1 = -l.y * kLog2e;
    const int qpos = q0 + col;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool a0 = !MASK || (qpos >= qmin[r] && qpos < T);
      const bool a1 = !MASK || (qpos + 1 >= qmin[r] && qpos + 1 < T);
      const float e0 = a0 ? ex2(fmaf(s[4 * c + 2 * r], scale2, n0)) : 0.0f;
      const float e1 = a1 ? ex2(fmaf(s[4 * c + 2 * r + 1], scale2, n1))
                          : 0.0f;
      // p.astype(dO.dtype), ds.astype(q.dtype)
      pp[c / 2][(c % 2) * 2 + r] = hopper::pack_bf16(e0, e1);
      pds[c / 2][(c % 2) * 2 + r] =
          hopper::pack_bf16(e0 * (dp[4 * c + 2 * r] - dl.x),
                            e1 * (dp[4 * c + 2 * r + 1] - dl.y));
    }
  }
}

// K3's q tile i into ring stage st: Q and dO (64 rows each, swizzled),
// then its 64 lse and 64 delta values.
template <int D>
__device__ __forceinline__ void dkv_stage_q(uint32_t q_s, uint32_t do_s,
                                            float* rows_s, const Params& p,
                                            int b, int h, int i, int st) {
  using S = TcBwd<D>;
  tc_stage<D>(q_s + st * S::kNB * S::kSmall, S::kSmall, p.q, b, h,
              i * kBwdRows, kBwdRows, p.T);
  tc_stage<D>(do_s + st * S::kNB * S::kSmall, S::kSmall, p.dout, b, h,
              i * kBwdRows, kBwdRows, p.T);
  tc_stage_rows(rows_s + st * 2 * kBwdRows,
                rows_s + st * 2 * kBwdRows + kBwdRows, p, b, h,
                i * kBwdRows, kBwdRows);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(Params p) {
  using S = TcBwd<D>;
  constexpr int kNB = S::kNB;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const uint32_t raw = hopper::smem_u32(tc_smem);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t k_s = raw + pad;
  const uint32_t v_s = k_s + kNB * S::kBig;
  const uint32_t q_s = v_s + kNB * S::kBig;
  const uint32_t do_s = q_s + kTcStages * kNB * S::kSmall;
  // per stage: 64 lse, then 64 delta
  float* rows_s = reinterpret_cast<float*>(
      tc_smem + pad + kNB * (2 * S::kBig + 2 * kTcStages * S::kSmall));

  const int BH = p.B * p.H;
  // the kv tiles with the most causal work (the first) start first
  const int j = (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / p.H, h = bh % p.H;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int n_q = (p.T + kBwdRows - 1) / kBwdRows;
  const int key0 = j * kBwdKeys;

  // the first q row that may admit key key0, and its tile
  int i0 = 0;
  if (p.causal) {
    const int first_q = key0 - (p.S - p.T);
    i0 = first_q >= p.T ? n_q : max(first_q, 0) / kBwdRows;
  }

  // this thread's keys: rows r and r + 8 of its warpgroup's 64; query q is
  // admitted for key r iff qmin[r] <= q < T (never for a key past S)
  const int key_warp = key0 + wg * 64 + warp * 16;
  int qmin[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key_warp + lane / 4 + 8 * r;
    qmin[r] = kpos >= p.S ? 0x7fffffff : p.causal ? kpos - (p.S - p.T) : 0;
  }

  if (i0 < n_q) {
    tc_stage<D>(k_s, S::kBig, p.k, b, h, key0, kBwdKeys, p.S);
    tc_stage<D>(v_s, S::kBig, p.v, b, h, key0, kBwdKeys, p.S);
    dkv_stage_q<D>(q_s, do_s, rows_s, p, b, h, i0, 0);
  }
  hopper::cp_async_commit();

  const float scale2 = p.scale * kLog2e;
  float dk[kNB][32], dv[kNB][32];
#pragma unroll
  for (int c = 0; c < kNB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.0f;

  for (int i = i0; i < n_q; ++i) {
    const int st = (i - i0) % kTcStages;
    const uint32_t q_t = q_s + st * kNB * S::kSmall;
    const uint32_t do_t = do_s + st * kNB * S::kSmall;
    // the next q tile's copies fly while this one is computed; its stage
    // last held tile i - 2, which every thread finished before the
    // barrier of iteration i - 1
    if (i + 1 < n_q)
      dkv_stage_q<D>(q_s, do_s, rows_s, p, b, h, i + 1,
                     (i + 1 - i0) % kTcStages);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();          // K, V and tile i have landed
    hopper::fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, one group: A (keys) varies by
    // warpgroup, B (the q tile, K-major) is the block's
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < S::kKS; ++ks)
      hopper::mma_ss_n64(
          s,
          hopper::desc_kmajor(k_s + (ks / 4) * S::kBig + wg * 64 * 128 +
                              (ks % 4) * 32),
          hopper::desc_kmajor(q_t + (ks / 4) * S::kSmall + (ks % 4) * 32), 1);
#pragma unroll
    for (int ks = 0; ks < S::kKS; ++ks)
      hopper::mma_ss_n64(
          dp,
          hopper::desc_kmajor(v_s + (ks / 4) * S::kBig + wg * 64 * 128 +
                              (ks % 4) * 32),
          hopper::desc_kmajor(do_t + (ks / 4) * S::kSmall + (ks % 4) * 32),
          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();

    const float* lse_t = rows_s + st * 2 * kBwdRows;
    const int q0 = i * kBwdRows;
    uint32_t pp[4][4], pds[4][4];
    // a tile that every key of the warp admits whole skips the mask
    if (q0 + kBwdRows <= p.T && key_warp + 15 < p.S &&
        (!p.causal || key_warp + 15 - (p.S - p.T) <= q0))
      dkv_p_ds<false>(s, dp, pp, pds, lse_t, lse_t + kBwdRows, qmin, q0, p.T,
                      scale2);
    else
      dkv_p_ds<true>(s, dp, pp, pds, lse_t, lse_t + kBwdRows, qmin, q0, p.T,
                     scale2);

    // dV += P^T dO and dK += dS^T Q: A in registers, B (the q tile's rows
    // are queries, D contiguous) read MN-major from the same copies
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < kNB; ++c)
        hopper::mma_rs_n64_mn(
            dv[c], pp[t],
            hopper::desc_mnmajor(do_t + c * S::kSmall + t * 16 * 128), 1);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < kNB; ++c)
        hopper::mma_rs_n64_mn(
            dk[c], pds[t],
            hopper::desc_mnmajor(q_t + c * S::kSmall + t * 16 * 128), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
  }
  hopper::cp_async_wait<0>();

  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(
                              const_cast<void*>(p.dk.ptr)) +
                          b * p.dk.sb + h * p.dk.sh;
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(
                              const_cast<void*>(p.dv.ptr)) +
                          b * p.dv.sb + h * p.dv.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key_warp + lane / 4 + 8 * r;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * c + 8 * jj + 2 * (lane & 3);
        if (col >= D) continue;
        // the scale once, on the f32 sum
        *reinterpret_cast<uint32_t*>(dk_out + (long long)row * p.dk.sl +
                                     col) =
            hopper::pack_bf16(dk[c][4 * jj + 2 * r] * p.scale,
                              dk[c][4 * jj + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv_out + (long long)row * p.dv.sl +
                                     col) =
            hopper::pack_bf16(dv[c][4 * jj + 2 * r],
                              dv[c][4 * jj + 2 * r + 1]);
      }
  }
}

// K4's ds of one (q, kv) tile pair on the thread's two rows: p = 2^(s *
// scale * log2 e - lse * log2 e) (nl[r] = -lse * log2 e of row r), ds = p
// (dp - delta), rounded to bf16 as the A fragments of dQ += dS K. MASK:
// key kpos is admitted iff kpos < lim[r]; without MASK every key is.
template <bool MASK>
__device__ __forceinline__ void dq_ds(const float (&s)[32],
                                      const float (&dp)[32],
                                      uint32_t (&pds)[4][4],
                                      const float (&nl)[2],
                                      const float (&dl)[2],
                                      const int (&lim)[2], int kbase,
                                      float scale2) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = kbase + 8 * c + 2 * (lane & 3);
      const float e0 = !MASK || kpos < lim[r]
                           ? ex2(fmaf(s[4 * c + 2 * r], scale2, nl[r])) : 0.0f;
      const float e1 = !MASK || kpos + 1 < lim[r]
                           ? ex2(fmaf(s[4 * c + 2 * r + 1], scale2, nl[r]))
                           : 0.0f;
      // ds.astype(k.dtype)
      pds[c / 2][(c % 2) * 2 + r] =
          hopper::pack_bf16(e0 * (dp[4 * c + 2 * r] - dl[r]),
                            e1 * (dp[4 * c + 2 * r + 1] - dl[r]));
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
flash_bwd_dq_tc_kernel(Params p) {
  using S = TcBwd<D>;
  constexpr int kNB = S::kNB;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const uint32_t raw = hopper::smem_u32(tc_smem);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t q_s = raw + pad;
  const uint32_t do_s = q_s + kNB * S::kBig;
  const uint32_t k_s = do_s + kNB * S::kBig;
  const uint32_t v_s = k_s + kTcStages * kNB * S::kSmall;
  float* lse_s = reinterpret_cast<float*>(
      tc_smem + pad + kNB * (2 * S::kBig + 2 * kTcStages * S::kSmall));
  float* delta_s = lse_s + kTcQ;

  const int BH = p.B * p.H;
  const int n_q = (p.T + kTcQ - 1) / kTcQ;
  // the q tiles with the most causal work (the last) start first
  const int i = n_q - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / p.H, h = bh % p.H;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  // kv tiles this q tile visits: causal stops at the tile holding the key
  // its last real row reaches (0 if no row admits any key)
  const int n_k = (p.S + kTcK - 1) / kTcK;
  int n_j = n_k;
  if (p.causal) {
    const int last_q = min(i * kTcQ + kTcQ - 1, p.T - 1) + (p.S - p.T);
    n_j = last_q < 0 ? 0 : min(n_k, last_q / kTcK + 1);
  }

  // this thread's rows: r and r + 8 of its warpgroup's 64; keys [0, lim)
  // are admitted (0 past T)
  const int q_warp = i * kTcQ + wg * 64 + warp * 16;
  const int q_lo = q_warp + lane / 4;
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q_lo + 8 * r;
    lim[r] = qpos >= p.T ? 0
             : p.causal  ? max(0, min(p.S, qpos + (p.S - p.T) + 1))
                         : p.S;
  }

  if (n_j > 0) {
    tc_stage<D>(q_s, S::kBig, p.q, b, h, i * kTcQ, kTcQ, p.T);
    tc_stage<D>(do_s, S::kBig, p.dout, b, h, i * kTcQ, kTcQ, p.T);
    tc_stage_rows(lse_s, delta_s, p, b, h, i * kTcQ, kTcQ);
    tc_stage<D>(k_s, S::kSmall, p.k, b, h, 0, kTcK, p.S);
    tc_stage<D>(v_s, S::kSmall, p.v, b, h, 0, kTcK, p.S);
  }
  hopper::cp_async_commit();

  const float scale2 = p.scale * kLog2e;
  float dq[kNB][32];
#pragma unroll
  for (int c = 0; c < kNB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[c][e] = 0.0f;

  for (int j = 0; j < n_j; ++j) {
    const int st = j % kTcStages;
    const uint32_t k_t = k_s + st * kNB * S::kSmall;
    const uint32_t v_t = v_s + st * kNB * S::kSmall;
    // the forward's ring: tile j + 1 flies while tile j is computed
    if (j + 1 < n_j) {
      const int nx = (j + 1) % kTcStages;
      tc_stage<D>(k_s + nx * kNB * S::kSmall, S::kSmall, p.k, b, h,
                  (j + 1) * kTcK, kTcK, p.S);
      tc_stage<D>(v_s + nx * kNB * S::kSmall, S::kSmall, p.v, b, h,
                  (j + 1) * kTcK, kTcK, p.S);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();          // Q, dO, the rows and tile j
    hopper::fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, one group: A (rows) varies by
    // warpgroup, B (the kv tile, K-major) is the block's
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < S::kKS; ++ks)
      hopper::mma_ss_n64(
          s,
          hopper::desc_kmajor(q_s + (ks / 4) * S::kBig + wg * 64 * 128 +
                              (ks % 4) * 32),
          hopper::desc_kmajor(k_t + (ks / 4) * S::kSmall + (ks % 4) * 32), 1);
#pragma unroll
    for (int ks = 0; ks < S::kKS; ++ks)
      hopper::mma_ss_n64(
          dp,
          hopper::desc_kmajor(do_s + (ks / 4) * S::kBig + wg * 64 * 128 +
                              (ks % 4) * 32),
          hopper::desc_kmajor(v_t + (ks / 4) * S::kSmall + (ks % 4) * 32), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();

    float nl[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = wg * 64 + warp * 16 + lane / 4 + 8 * r;
      nl[r] = -lse_s[at] * kLog2e;
      dl[r] = delta_s[at];
    }
    uint32_t pds[4][4];
    // a tile every row of the warp admits whole skips the mask
    const int kend = (j + 1) * kTcK;
    if (kend <= p.S && q_warp + 15 < p.T &&
        (!p.causal || kend - 1 <= q_warp + (p.S - p.T)))
      dq_ds<false>(s, dp, pds, nl, dl, lim, j * kTcK, scale2);
    else
      dq_ds<true>(s, dp, pds, nl, dl, lim, j * kTcK, scale2);

    // dQ += dS K, K read MN-major (the tile's rows are keys, D contiguous)
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < kNB; ++c)
        hopper::mma_rs_n64_mn(
            dq[c], pds[t],
            hopper::desc_mnmajor(k_t + c * S::kSmall + t * 16 * 128), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
  }
  hopper::cp_async_wait<0>();

  __nv_bfloat16* dq_out = static_cast<__nv_bfloat16*>(
                              const_cast<void*>(p.dq.ptr)) +
                          b * p.dq.sb + h * p.dq.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + 8 * r;
    if (row >= p.T) continue;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * c + 8 * jj + 2 * (lane & 3);
        if (col < D)
          *reinterpret_cast<uint32_t*>(dq_out + (long long)row * p.dq.sl +
                                       col) =
              hopper::pack_bf16(dq[c][4 * jj + 2 * r] * p.scale,
                                dq[c][4 * jj + 2 * r + 1] * p.scale);
      }
  }
}

// ------------------------------------------------------------ launchers
enum Which { kFwd = 0, kDkv = 1, kDq = 2 };

template <int D>
size_t smem_bytes(Which w) {
  const size_t tile = (size_t)kTile * (D + 1), score = (size_t)kTile * kPs;
  switch (w) {
    case kFwd: return sizeof(float) * (3 * tile + score);
    case kDkv: return sizeof(float) * (4 * tile + 2 * score + 2 * kTile);
    default:   return sizeof(float) * (4 * tile + score + 2 * kTile);
  }
}

template <typename T, int D>
int launch(Which w, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(w);
  const int n_q = (p.T + kTile - 1) / kTile;
  const int n_k = (p.S + kTile - 1) / kTile;
  const long long blocks = (long long)p.B * p.H * (w == kDkv ? n_k : n_q);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void (*kernel)(Params) = w == kFwd ? flash_fwd_kernel<T, D>
                           : w == kDkv ? flash_bwd_dkv_kernel<T, D>
                                       : flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(Which w, int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(w, p, stream);
    case 64: return launch<T, 64>(w, p, stream);
    case 128: return launch<T, 128>(w, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_fwd_tc(const Params& p, cudaStream_t stream) {
  const long long blocks =
      (long long)p.B * p.H * ((p.T + kTcQ - 1) / kTcQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TcFwd<D>::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tc_kernel<D>
      <<<(unsigned)blocks, kTcThreads, TcFwd<D>::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_tc(Which w, const Params& p, cudaStream_t stream) {
  const bool dkv = w == kDkv;
  const long long tiles = dkv ? (p.S + kBwdKeys - 1) / kBwdKeys
                              : (p.T + kTcQ - 1) / kTcQ;
  const long long blocks = (long long)p.B * p.H * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = dkv ? TcBwd<D>::kDkvSmem : TcBwd<D>::kDqSmem;
  void (*kernel)(Params) = dkv ? flash_bwd_dkv_tc_kernel<D>
                               : flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The tensor-core kernels read q, k, v (and dO) in 16-byte copies: every
// base pointer 16-byte aligned and every batch, sequence and head stride a
// multiple of 8 elements; the outputs (fresh allocations) 4-byte aligned.
bool rows_aligned(const Operand& x, int bytes, int elems) {
  return reinterpret_cast<uintptr_t>(x.ptr) % bytes == 0 &&
         x.sb % elems == 0 && x.sl % elems == 0 && x.sh % elems == 0;
}

bool tc_aligned(Which w, const Params& p) {
  const bool in = rows_aligned(p.q, 16, 8) && rows_aligned(p.k, 16, 8) &&
                  rows_aligned(p.v, 16, 8);
  switch (w) {
    case kFwd: return in && rows_aligned(p.out, 4, 2);
    case kDkv: return in && rows_aligned(p.dout, 16, 8) &&
                      rows_aligned(p.dk, 4, 2) && rows_aligned(p.dv, 4, 2);
    default:   return in && rows_aligned(p.dout, 16, 8) &&
                      rows_aligned(p.dq, 4, 2);
  }
}

// Each kernel's routes, one numbering for the forward and the backward.
enum Route { kSimt = 0, kTensorCores = 1 };

template <int D>
int launch_tc(Which w, const Params& p, cudaStream_t stream) {
  return w == kFwd ? launch_fwd_tc<D>(p, stream)
                   : launch_bwd_tc<D>(w, p, stream);
}

int dispatch(Which w, int dtype, int D, const Params& p, void* stream,
             int route) {
  if (p.B < 1 || p.H < 1 || p.T < 1 || p.S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kTensorCores) {          // bf16 on the tensor cores
    if (dtype != 1 || !tc_aligned(w, p)) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32: return launch_tc<32>(w, p, s);
      case 64: return launch_tc<64>(w, p, s);
      case 128: return launch_tc<128>(w, p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != kSimt) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_d<float>(w, D, p, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(w, D, p, s);
  return (int)cudaErrorInvalidValue;
}

Operand operand(const void* ptr, const long long* st) {
  return Operand{ptr, st[0], st[1], st[2]};
}

Params params(int B, int H, int T, int S, int causal, float scale) {
  Params p{};
  p.B = B; p.H = H; p.T = T; p.S = S; p.causal = causal; p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and every output alike).
// `strides` holds (batch, sequence, head) element strides for each operand,
// three per operand, in the order the pointers are given. The route of
// each launch is the caller's choice (ops/cuda_flash.py:_fwd_route,
// _bwd_route): 0 the CUDA-core kernel, 1 the tensor-core one (bf16,
// 16-byte-aligned rows); a route that does not take the call returns
// cudaErrorInvalidValue -- nothing falls back to another kernel.

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse,
                                const long long* strides, int B, int H,
                                int T, int S, int D, int dtype, int causal,
                                float scale, int route, void* stream) {
  Params p = params(B, H, T, S, causal, scale);
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.out = operand(out, strides + 9);
  p.lse_out = lse;
  return dispatch(kFwd, dtype, D, p, stream, route);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv,
                                    const long long* strides, int B, int H,
                                    int T, int S, int D, int dtype,
                                    int causal, float scale, int route,
                                    void* stream) {
  Params p = params(B, H, T, S, causal, scale);
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.dout = operand(dout, strides + 9);
  p.dk = operand(dk, strides + 12);
  p.dv = operand(dv, strides + 15);
  p.lse_in = lse;
  p.delta = delta;
  return dispatch(kDkv, dtype, D, p, stream, route);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, const long long* strides, int B,
                                   int H, int T, int S, int D, int dtype,
                                   int causal, float scale, int route,
                                   void* stream) {
  Params p = params(B, H, T, S, causal, scale);
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.dout = operand(dout, strides + 9);
  p.dq = operand(dq, strides + 12);
  p.lse_in = lse;
  p.delta = delta;
  return dispatch(kDq, dtype, D, p, stream, route);
}

// The routes' names in enum Route's numbering, the forward's and the
// backward's (both kernels); the wrapper checks its own numbering against
// them when it loads the library.
extern "C" const char* flash_fwd_route_names() { return "simt,tc"; }
extern "C" const char* flash_bwd_route_names() { return "simt,tc"; }

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
