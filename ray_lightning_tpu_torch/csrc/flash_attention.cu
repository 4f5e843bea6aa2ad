// Flash attention, forward and backward, for training.
//
// Replaces the three Pallas kernels of ray_lightning_tpu/ops/pallas_flash.py:
//
//   flash_fwd_kernel     <- _flash_kernel      (forward: out and logsumexp)
//   flash_bwd_dkv_kernel <- _flash_dkv_kernel  (backward: dK and dV)
//   flash_bwd_dq_kernel  <- _flash_dq_kernel   (backward: dQ)
//
// Each computes the same function as its Pallas kernel; none copies the
// Pallas grid. The TPU grid's innermost axis runs in order on one core and
// carries the online-softmax state (or the dK/dV, dQ sums) from one grid
// step to the next in scratch memory. Here that axis is a loop inside one
// thread block, which keeps its running state in registers: a block owns
// one (batch row, head, 64-row tile) and walks the tiles of the other
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
// Only the order of the f32 sums differs from the Pallas kernels.
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
// operations, by far. This first version is simple and right rather than
// fast: the products run on the CUDA cores in f32 (one FMA per pair of
// values, from shared-memory tiles, 4x4 register blocking per thread), not
// on the tensor cores, so it cannot approach the bf16 bound; wgmma and TMA
// are the later step. 256 threads per block as 16 x 16; a thread owns 4
// rows x 4 columns of each 64 x 64 score tile (rows ty + 16a, columns
// tx + 16b), so a row's reductions are shuffles within 16 lanes, and
// 4 rows x D/16 columns of each 64 x D output tile.
//
// Plain C interface (bound with ctypes). Each launch runs on the caller's
// stream and returns the CUDA error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

int dispatch(Which w, int dtype, int D, const Params& p, void* stream) {
  if (p.B < 1 || p.H < 1 || p.T < 1 || p.S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
// three per operand, in the order the pointers are given.

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse,
                                const long long* strides, int B, int H,
                                int T, int S, int D, int dtype, int causal,
                                float scale, void* stream) {
  Params p = params(B, H, T, S, causal, scale);
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.out = operand(out, strides + 9);
  p.lse_out = lse;
  return dispatch(kFwd, dtype, D, p, stream);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv,
                                    const long long* strides, int B, int H,
                                    int T, int S, int D, int dtype,
                                    int causal, float scale, void* stream) {
  Params p = params(B, H, T, S, causal, scale);
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.dout = operand(dout, strides + 9);
  p.dk = operand(dk, strides + 12);
  p.dv = operand(dv, strides + 15);
  p.lse_in = lse;
  p.delta = delta;
  return dispatch(kDkv, dtype, D, p, stream);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, const long long* strides, int B,
                                   int H, int T, int S, int D, int dtype,
                                   int causal, float scale, void* stream) {
  Params p = params(B, H, T, S, causal, scale);
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.dout = operand(dout, strides + 9);
  p.dq = operand(dq, strides + 12);
  p.lse_in = lse;
  p.delta = delta;
  return dispatch(kDq, dtype, D, p, stream);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
