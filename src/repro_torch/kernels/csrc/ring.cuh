// The shared-memory ring of the fused SGD epochs' streaming kernels (glm_sgd.cu,
// glm_sgd_sparse.cu): mbarriers, cp.async copies completing on them, a copy
// of a run of 4-byte words as it lies in memory, the order in which a ring
// streams an epoch's micro-batches in chunks, and a warp sum of several rows'
// partials at once.
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

// Sum RB rows' per-lane partials over the warp at once, by a transposed
// butterfly: in round k (lane offset 16 >> k) a lane keeps the half of its
// rows its lane bit selects and receives that half's partials from its
// partner; after log2 RB rounds it holds one row, and the rounds left sum the
// lanes sharing it (RB - 1 + 5 - log2 RB shuffles for RB rows instead of
// 5 RB).  Lane l returns the total of row l >> (5 - log2 RB), the same bits
// on every lane of that row.  Every loop bound is a constant, so the rounds
// unroll and v stays in registers.
template <int RB>
__device__ __forceinline__ float transposed_sum(float (&v)[RB], int lane) {
  constexpr int L = log2i(RB);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int off = 16 >> k;
    if (k < L) {
      const int h = RB >> (k + 1);
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < (RB + 1) / 2; ++i) {
        if (i < h) {
          const float send = upper ? v[i] : v[i + h];
          const float keep = upper ? v[i + h] : v[i];
          v[i] = keep + __shfl_xor_sync(kFullMask, send, off);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(kFullMask, v[0], off);
    }
  }
  return v[0];
}

// The fills of a ring that streams an epoch's micro-batches (batch b holds
// rows [b * mb, min(n, (b + 1) * mb))) in chunks of at most `crows` rows.  A
// batch of one chunk is one fill, which serves both its margins and its
// update (pass 2); a longer batch is its chunks twice, first for the
// margins against the batch's model (pass 0), then for the update (pass 1),
// its pulls kept in between.
struct Fill {
  int start;       // the fill's first row
  int rows;        // rows it holds
  int batch_rows;  // rows of its batch: mb, or the ragged tail's
  int chunk;       // its chunk of the batch
  int pass;        // 0 margins, 1 update, 2 both
};

__host__ __device__ constexpr int fills_of(int rows, int crows) {
  return rows <= crows ? 1 : 2 * ((rows + crows - 1) / crows);
}

__host__ __device__ inline int fill_count(int n, int mb, int crows) {
  const int batches = (n + mb - 1) / mb;
  return (batches - 1) * fills_of(mb, crows) +
         fills_of(n - (batches - 1) * mb, crows);
}

// The fills in order, with no division a fill: a chain takes them one by
// one, a copy warp every `copiers`-th (next() that many times).
struct FillWalk {
  int n, mb, crows;
  int chunks;  // of the current batch
  int local;   // the fill's place among its batch's fills
  Fill fl;

  __device__ __forceinline__ FillWalk(int n_, int mb_, int crows_)
      : n(n_), mb(mb_), crows(crows_), local(0) {
    batch(0);
  }
  __device__ __forceinline__ void batch(int start) {
    fl.batch_rows = min(mb, n - start);
    chunks = (fl.batch_rows + crows - 1) / crows;
    local = 0;
    fl.start = start;
    fl.chunk = 0;
    fl.pass = chunks == 1 ? 2 : 0;
    fl.rows = min(crows, fl.batch_rows);
  }
  __device__ __forceinline__ void next() {
    const int first = fl.start - fl.chunk * crows;  // the batch's first row
    if (++local == (chunks == 1 ? 1 : 2 * chunks)) {
      batch(first + fl.batch_rows);
      return;
    }
    fl.pass = local < chunks ? 0 : 1;
    fl.chunk = local < chunks ? local : local - chunks;
    fl.start = first + fl.chunk * crows;
    fl.rows = min(crows, fl.batch_rows - fl.chunk * crows);
  }
};

}  // namespace repro
