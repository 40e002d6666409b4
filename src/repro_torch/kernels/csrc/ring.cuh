// The shared-memory ring of the fused SGD epochs' warp kernels (glm_sgd.cu,
// glm_sgd_sparse.cu): mbarriers, cp.async copies completing on them, and a
// copy of a run of 4-byte words as it lies in memory.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// The mbarrier's arrival once this thread's earlier cp.async copies land
// (.noinc: the arrival is one of the count the barrier was made with).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4-byte words past the last 16-byte boundary at p: a run is staged at the
// same offset, so its 16-byte pieces line up with shared memory's.
__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// One warp copies `count` 4-byte words from src to dst (dst at the same
// offset from a 16-byte boundary as src: misalign(src) words into a
// 16-byte-aligned buffer): 4-byte copies up to the first boundary, 16-byte
// copies, 4-byte copies for the rest.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           int count, int lane) {
  const int head = min((4 - misalign(src)) & 3, count);
  const int runs = (count - head) >> 2;  // 16-byte runs
  const int tail = count - head - 4 * runs;
  for (int e = lane; e < head; e += 32) copy4(dst + e, src + e);
  for (int e = lane; e < runs; e += 32)
    copy16(dst + head + 4 * e, src + head + 4 * e);
  for (int e = lane; e < tail; e += 32)
    copy4(dst + head + 4 * runs + e, src + head + 4 * runs + e);
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

}  // namespace repro
