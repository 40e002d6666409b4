// Thread-block clusters for the GLM kernels that split one problem over a
// cluster's blocks (glm_sgd.cu's cluster and rows kernels, glm_grad.cu's
// wide kernel): a block's rank, the cluster barrier, and stores into a
// peer's shared memory (distributed shared memory) that complete on the
// peer's mbarrier.
#pragma once

#include <cstdint>

#include "ring.cuh"

namespace repro {

// The address of `p`'s twin in the shared memory of block `rank` of the
// cluster (a shared::cluster address).
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Store v at a shared::cluster address of a peer block and count its 4
// bytes on the peer's mbarrier at `bar` (complete_tx): the peer sees the
// value once that barrier's phase completes, with no fence on either side.
__device__ __forceinline__ void peer_store(uint32_t addr, float v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// peer_store of four floats at a 16-byte-aligned address: 16 bytes counted.
__device__ __forceinline__ void peer_store4(uint32_t addr, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// This thread's arrival on a local mbarrier, and `bytes` more that the
// phase waits for (expect_tx).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned long long timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// nanoseconds a cluster kernel's wait may last before it traps
constexpr unsigned long long kClusterWaitNs = 4000000000ull;

// mbar_wait that traps (a launch error, not a hang) once the phase has
// been waited for past kClusterWaitNs: a cluster whose peer never stores
// its bytes would otherwise spin for ever.  The clock is read only after a
// first try fails.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  auto done = [&] {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return ok != 0;
  };
  if (done()) return;
  const unsigned long long start = timer_ns();
  while (!done())
    if (timer_ns() - start > kClusterWaitNs) __trap();
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// Launch `kernel` on `grid` blocks of `threads` in clusters of `cluster`
// blocks with `smem` bytes of dynamic shared memory.  Past the portable 8
// blocks the kernel is allowed a larger cluster, and a cluster that asks
// this much shared memory of each SM must still find its SMs
// (cudaOccupancyMaxActiveClusters), else the runtime's code for a cluster
// it cannot place.
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, int grid, int threads,
                             int cluster, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidClusterSize;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of `kernel` (`threads` threads,
// `smem` bytes each) the card holds at once.
template <typename Kernel>
int max_active_clusters(Kernel kernel, int threads, int cluster,
                        size_t smem) {
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  if (cluster > 8 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

}  // namespace repro
