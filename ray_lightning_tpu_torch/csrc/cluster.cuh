// Thread-block clusters for the decode kernels (csrc/paged_attention.cu,
// the GEMVs of csrc/quantized_matmul.cu): the launch, the occupancy query
// and the split barrier; and an in-warp reduce-scatter (the tied head's
// GEMV).
//
// A cluster of CS blocks (grid x a multiple of CS, cluster dims (CS, 1, 1))
// is scheduled on neighbouring SMs of one GPC; its blocks write each
// other's shared memory (cooperative_groups::this_cluster()
// .map_shared_rank). The decode kernels split one output tile's reduction
// over the blocks of a cluster, and rank 0 adds the blocks' f32 partials in
// rank order after a cluster barrier: one launch, no workspace, no
// atomics, the same bits every call.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace rlt {

namespace cg = cooperative_groups;

// The cluster barrier split in two: a block arrives (relaxed: it orders
// nothing) as it starts and waits just before its first write to a peer's
// shared memory, so that no peer's shared memory is written before that
// peer has started -- by then the wait is free.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launch `kernel` on `stream` as clusters of `cs` blocks along x. A launch
// CUDA refuses (a cluster that cannot be scheduled, too much shared
// memory) returns its CUDA error; nothing falls back.
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                          size_t smem, int cs, cudaStream_t stream,
                          Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cs` blocks of `kernel` the card can hold at once
// (cudaOccupancyMaxActiveClusters), or -1 with the error in *err.
template <typename... Params>
inline int max_active_clusters(void (*kernel)(Params...), dim3 grid,
                               int threads, size_t smem, int cs, int* err) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kernel), &cfg);
  *err = (int)e;
  return e == cudaSuccess ? n : -1;
}

// Reduce-scatter of V f32 values per lane over the lanes that differ in
// lane bits MASK, 2 MASK, ... (STEPS of them): at each step a lane keeps
// one half of its values, sends the other half to its partner and adds
// what it receives (own + partner's, a fixed order). After the steps each
// lane holds V >> STEPS fully reduced values, a[0 .. V >> STEPS), which
// are values base .. base + (V >> STEPS) - 1 of the original array; the
// lanes of a group hold disjoint slices that cover all V. Once one value
// is left, further steps are plain butterfly sums (every lane gets the
// total). About V shuffles a lane, against V * STEPS for a butterfly sum
// of every value.
template <int V, int MASK, int STEPS>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* a, int lane, int& base) {
    if constexpr (V > 1) {
      const bool hi = (lane & MASK) != 0;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const float send = hi ? a[i] : a[i + V / 2];
        const float keep = hi ? a[i + V / 2] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
      }
      base += hi ? V / 2 : 0;
      ReduceScatter<V / 2, MASK * 2, STEPS - 1>::run(a, lane, base);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], MASK);
      ReduceScatter<1, MASK * 2, STEPS - 1>::run(a, lane, base);
    }
  }
};
template <int V, int MASK>
struct ReduceScatter<V, MASK, 0> {
  static __device__ __forceinline__ void run(float*, int, int&) {}
};

}  // namespace rlt
