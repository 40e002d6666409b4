// glm_sgd: one fused mini-batch SGD epoch on dense data, for R replicas.
//
// Replaces: glm_sgd_pallas (src/repro/kernels/glm_sgd/kernel.py:59, body
//   _kernel l.39, pallas_call l.73) — for each [MB, d] tile in order,
//   m = y * (X_k w), then w -= (alpha/MB) * X_k^T pull(m), the model resident
//   for the whole epoch.
//
// What bounds it on the H100: not bytes and not operations but the chain of
//   dependent updates.  Each micro-batch reads the model its predecessor
//   wrote, so one replica's epoch is ceil(n/MB) steps in sequence (covtype
//   at MB=16: 36,314 steps on one SM; the bytes alone, 125.5 MB of X, would
//   take about 38 us at 3.35 TB/s).  The time per update is the target.
//
// Four kernels, chosen by kernels/glm_sgd/ops.py:variant(d, micro_batch);
// the wrapper passes the warp kernel's ring as `stages` and `group`
// (ops.py:warp_plan), and stages = 0 for the shared-memory kernel; the
// cluster and global-memory kernels have their own entry points
// (glm_sgd_epoch_cluster, glm_sgd_epoch_global):
//
// glm_sgd_warp_kernel (d <= WARP_MAX_D = 1024, and a ring of at least two
//   stages fits in shared memory).  The chain is one warp's alone:
//   - the model lives in the chain warp's registers, feature j on lane j % 32
//     (C = ceil(d/32) rounded up to a power of two values a lane);
//   - the MB margins of a micro-batch are per-lane partial dots, reduced for
//     all rows at once by a transposed butterfly: each of the 5 shuffle
//     rounds halves the rows a lane carries (RB-1 shuffles for RB rows
//     instead of 5 RB); the lanes of row i then compute its pull, and
//     __shfl_sync broadcasts it to the update (RB * C <= 64: a batch of
//     more rows goes RB rows at a time, its pulls through shared memory);
//   - each lane updates its own features from the tile values it read for
//     the margins, held in registers; no __syncthreads on the chain, only
//     warp-synchronous steps, and no branch that differs between lanes: a
//     lane past d reads its neighbour row's finite value against a model
//     value of 0, and only its model update is masked;
//   - the block's other three warps keep a ring of `stages` stages ahead of
//     the chain, each holding `group` consecutive micro-batches (about 32
//     rows: X as it lies in memory, and y) copied with 16-byte cp.async;
//     each copy warp takes every third fill (no more copy warps than
//     stages), each fill completing on a "full" mbarrier
//     (cp.async.mbarrier.arrive.noinc), and the chain warp releases a stage
//     on its "empty" mbarrier.  The chain waits on shared memory, not on
//     DRAM, and once per stage, not per micro-batch.
//   What it leaves for later: TMA bulk copies (a stage's rows start at
//   d * 4-byte offsets, not 16-byte aligned in general: covtype's 216);
//   overlapping the next batch's pull with this batch's update.  The ring
//   (ring.cuh) is shared with glm_sgd_sparse's warp kernel.
//
// glm_sgd_cluster_kernel (WARP_MAX_D < d <= 16 x 4,096 = 65,536, any
//   micro-batch: ops.py:cluster_plan).  A replica's model is split over a
//   thread-block cluster of `cluster` blocks on neighbouring SMs (grid
//   R x cluster, launched with a cluster-dimension attribute; past 8
//   blocks the launch checks with cudaOccupancyMaxActiveClusters that one
//   can be placed).  One block walking a whole wide row per update left
//   131 SMs and 7 of its 8 warps idle (81.8 us an update at real-sim's
//   d = 20,958); here:
//   - block `rank` owns features [rank * slice, (rank + 1) * slice), in
//     its 8 chain warps' registers (feature j0 + t + 256 c on chain thread
//     t; at most 8 values a thread where 16 blocks allow, else 16: fewer
//     made each update shorter, and 32 took every register and ran
//     slower); the cluster is the smallest such that leaves a ring of two
//     stages of a whole batch (up to 32 rows) beside the slice;
//   - 4 copy warps keep a ring of the block's slice of the next rows and
//     their labels, copied with 16-byte cp.async as they lie in memory
//     (rows start at d * 4-byte offsets, not 16-byte aligned in general, so
//     no TMA), completing on "full" mbarriers and released by each chain
//     warp on "empty" ones (ring.cuh's pattern, no more copy warps than
//     stages); the chain reads X from shared memory only, once for both the
//     margin and the update, the values held in registers between;
//   - each chain warp sums its threads' partial margins (transposed
//     butterfly) and stores them with st.async into slot [parity][rank]
//     [warp] of every block of the cluster (distributed shared memory),
//     which counts their bytes on that block's exchange mbarrier of the
//     update's parity; each warp waits on its own block's and sums the
//     cluster's partials in rank and warp order, so every warp of every
//     block computes the same pulls bit for bit (the blocks' slices stay
//     one model, and an epoch gives the same bits on every call); each
//     block then updates its own slice.  One exchange barrier an update:
//     the slots are double-buffered by parity (why that is enough: at the
//     exchange), and no chain barrier (__syncthreads would wait on the copy
//     warps, which also keep a barrier.cluster from serving);
//   - a batch longer than a fill (ops.py: more than 32 rows, or more than
//     two stages hold) is streamed twice, its margins and then its update
//     (ring.cuh:Fill), its pulls kept in a global scratch between;
//   - a final barrier.cluster: no block leaves while a peer may still
//     write into its shared memory.
//   What it leaves for later: an update is still a chain of latencies
//   (a butterfly, a round trip through distributed shared memory, the
//   pull), about 1.3 us at real-sim's width (PERF.md).
//
// glm_sgd_kernel (the first port; d + micro_batch floats within a block's
//   shared memory): what is left of it is d <= WARP_MAX_D with batches too
//   long for the warp kernel's ring.  One block of 256 threads per
//   replica, the model in dynamic shared memory; per micro-batch a warp per
//   row computes the margin with a shuffle sum and writes the pull into
//   shared memory; after a barrier each thread updates its features with
//   the tile's X^T pull.
//
// glm_sgd_global_kernel (any wider d: past the cluster's 65,536, or a
//   batch past shared memory at d <= WARP_MAX_D): glm_sgd_kernel's loop with the
//   replica's model left in the output tensor in global memory.  A row's
//   margin is split over the whole block (a thread per feature), summed
//   with shuffles and then across the warps in warp order; the batch's
//   pulls go to a global scratch the wrapper allocates (a batch may hold
//   more rows than shared memory).  Each feature's update belongs to one
//   thread, so no atomics.  The block reads back in its next margin pass
//   what other threads of it wrote, so the model is read and written with
//   L1-bypassing __ldcg / __stcg (L1 is not coherent), and __syncthreads
//   orders the passes.
//
// All: one block (a cluster for glm_sgd_cluster_kernel) per replica
//   (R = 1 for SyncSGD), fp32 throughout, no fast math (the LR pull's expf over 36k updates); a ragged
//   tail is one final smaller batch at its own scale alpha/|tail|
//   (glm_sgd/ref.py); the step arrives as a runtime float (scale = alpha/MB
//   computed by the caller).
#include <cstdint>

#include "ring.cuh"

namespace {

using namespace repro;

__global__ void glm_sgd_kernel(const float* __restrict__ X,  // [R, n, d]
                               const float* __restrict__ y,  // [R, n]
                               float* __restrict__ W,        // [R, d] in/out
                               int n, int d, int mb, int task, float scale,
                               float tail_scale) {
  extern __shared__ float smem[];
  float* w = smem;       // [d]   the replica's model
  float* pl = smem + d;  // [mb]  pulls of the current micro-batch

  const int r = blockIdx.x;
  const float* Xr = X + static_cast<size_t>(r) * n * d;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int j = tid; j < d; j += blockDim.x) w[j] = Wr[j];
  __syncthreads();

  for (int start = 0; start < n; start += mb) {
    const int rows = min(mb, n - start);
    const float s = rows == mb ? scale : tail_scale;
    const float* Xb = Xr + static_cast<size_t>(start) * d;

    for (int i = warp; i < rows; i += nwarps) {
      const float* xi = Xb + static_cast<size_t>(i) * d;
      float acc = 0.0f;
      for (int j = lane; j < d; j += 32) acc += xi[j] * w[j];
      acc = repro::warp_sum(acc);
      if (lane == 0) {
        const float yi = yr[start + i];
        pl[i] = repro::pull(task, yi * acc, yi);
      }
    }
    __syncthreads();  // every margin of the batch used the same w

    for (int j = tid; j < d; j += blockDim.x) {
      float g = 0.0f;
      for (int i = 0; i < rows; ++i) g += Xb[static_cast<size_t>(i) * d + j] * pl[i];
      w[j] -= s * g;
    }
    __syncthreads();  // the next batch reads the updated model
  }

  for (int j = tid; j < d; j += blockDim.x) Wr[j] = w[j];
}

constexpr int kGlobalThreads = 1024;
constexpr int kGlobalWarps = kGlobalThreads / 32;
// rows whose margins one pass of the global kernels sums at a time
constexpr int kMarginRows = 32;

__global__ void __launch_bounds__(kGlobalThreads)
glm_sgd_global_kernel(const float* __restrict__ X,  // [R, n, d]
                      const float* __restrict__ y,  // [R, n]
                      float* __restrict__ W,        // [R, d] in/out
                      float* __restrict__ P,        // [R, mb] scratch
                      int n, int d, int mb, int task, float scale,
                      float tail_scale) {
  __shared__ float red[kMarginRows][kGlobalWarps];
  const int r = blockIdx.x;
  const float* Xr = X + static_cast<size_t>(r) * n * d;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  float* pl = P + static_cast<size_t>(r) * mb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int start = 0; start < n; start += mb) {
    const int rows = min(mb, n - start);
    const float s = rows == mb ? scale : tail_scale;
    const float* Xb = Xr + static_cast<size_t>(start) * d;
    for (int i0 = 0; i0 < rows; i0 += kMarginRows) {
      const int cr = min(kMarginRows, rows - i0);
      for (int i = 0; i < cr; ++i) {
        const float* xi = Xb + static_cast<size_t>(i0 + i) * d;
        float acc = 0.0f;
        for (int j = tid; j < d; j += kGlobalThreads)
          acc += xi[j] * __ldcg(&Wr[j]);
        acc = repro::warp_sum(acc);
        if (lane == 0) red[i][warp] = acc;
      }
      __syncthreads();
      if (tid < cr) {
        float m = 0.0f;
        for (int q = 0; q < kGlobalWarps; ++q) m += red[tid][q];
        const float yi = yr[start + i0 + tid];
        pl[i0 + tid] = repro::pull(task, yi * m, yi);
      }
      __syncthreads();  // red is free again, the pulls are visible
    }
    for (int j = tid; j < d; j += kGlobalThreads) {
      float g = 0.0f;
      for (int i = 0; i < rows; ++i) g += Xb[static_cast<size_t>(i) * d + j] * pl[i];
      __stcg(&Wr[j], __ldcg(&Wr[j]) - s * g);
    }
    __syncthreads();  // the next batch reads the updated model
  }
}

// ---------------------------------------------------------------------------
// The warp kernel: shared-memory ring, mbarriers, cp.async
// ---------------------------------------------------------------------------

constexpr int kWarpThreads = 128;  // the chain warp + 3 copy warps
constexpr int kCopyWarps = kWarpThreads / 32 - 1;

// One stage of the ring holds `rows` = group * mb consecutive rows of X as
// they lie in memory (after up to 3 floats of alignment), 32 C floats of
// slack that a lane past d may read on the last row, then the rows' labels.
// kernels/glm_sgd/ops.py:warp_smem_bytes computes the same layout.
__host__ __device__ constexpr int x_floats(int C, int d, int rows) {
  return pad4(rows * d + 3) + 32 * C;
}
__host__ __device__ constexpr int stage_floats(int C, int d, int rows) {
  return x_floats(C, d, rows) + pad4(rows);
}
// [2 * stages mbarriers][pad4(mb) pulls][stages x stage_floats]
size_t warp_smem_bytes(int C, int d, int mb, int stages, int group) {
  return 16 * static_cast<size_t>(stages) + 4 * static_cast<size_t>(pad4(mb)) +
         4 * static_cast<size_t>(stages) * stage_floats(C, d, group * mb);
}

// Margins of rows r0 .. r0 + RB - 1 of a staged batch (row i of it at
// xl + i * d, this lane's elements 32 apart) against the model in
// registers, reduced across the warp: lane l returns the pull of row
// r0 + (l >> (5 - log2 RB)), 0 past the batch's rows.  The rows' values go
// to xr for the update.  Rows past the batch repeat its last row, and their
// pulls are 0.  A lane past d reads the next row's (finite) value against
// a model value of 0, which adds exactly nothing.
template <int C, int RB>
__device__ __forceinline__ float pulls(const float* xl, const float* ys,
                                       const float (&w)[C], float (&xr)[RB][C],
                                       int r0, int rows, int d, int lane,
                                       int task) {
  float v[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const float* xi = xl + min(r0 + i, rows - 1) * d;
    v[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      xr[i][c] = xi[32 * c];
      v[i] = fmaf(xr[i][c], w[c], v[i]);
    }
  }
  const float m = transposed_sum<RB>(v, lane);
  const int row = r0 + (lane >> (5 - log2i(RB)));
  const float yi = ys[min(row, rows - 1)];
  const float p = repro::pull(task, yi * m, yi);
  return row < rows ? p : 0.0f;
}

// C: model values a lane holds (feature j on lane j % 32); RB: rows whose
// partials a lane carries through one butterfly, RB * C <= 64
template <int C, int RB>
__global__ void __launch_bounds__(kWarpThreads)
glm_sgd_warp_kernel(const float* __restrict__ X,  // [R, n, d]
                    const float* __restrict__ y,  // [R, n]
                    float* __restrict__ W,        // [R, d] in/out
                    int n, int d, int mb, int task, float scale,
                    float tail_scale, int stages, int group) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);      // [stages]
  uint64_t* empty = full + stages;                         // [stages]
  float* pls = reinterpret_cast<float*>(empty + stages);  // [pad4(mb)]
  float* ring = pls + pad4(mb);  // [stages][stage_floats]
  const int srows = group * mb;  // rows a stage holds
  const int sf = stage_floats(C, d, srows), xf = x_floats(C, d, srows);

  const int r = blockIdx.x;
  const float* Xr = X + static_cast<size_t>(r) * n * d;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  const int fills = (n + srows - 1) / srows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // one copy warp fills a stage
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // what a lane past d may read before any copy wrote it is finite
  for (int e = threadIdx.x; e < stages * sf; e += kWarpThreads) ring[e] = 0.0f;
  __syncthreads();

  if (threadIdx.x >= 32) {
    // copy warp cw fills stages' worth of rows f = cw, cw + copiers, ...
    // into stage f % stages once the chain has released its previous
    // fill.  No more copy warps than stages: a parity wait tells apart only
    // adjacent phases, so no warp may run two laps ahead of the chain
    const int copiers = min(kCopyWarps, stages);
    const int cw = threadIdx.x / 32 - 1, t = threadIdx.x % 32;
    for (int f = cw; cw < copiers && f < fills; f += copiers) {
      const int s = f % stages, use = f / stages;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      const int start = f * srows, rows = min(srows, n - start);
      const float* src = Xr + static_cast<size_t>(start) * d;
      copy_words(reinterpret_cast<uint32_t*>(ring + s * sf + misalign(src)),
                 reinterpret_cast<const uint32_t*>(src), rows * d, t);
      float* ys = ring + s * sf + xf;
      for (int e = t; e < rows; e += 32) copy4(ys + e, yr + start + e);
      mbar_arrive_on_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // the chain warp
  const int lane = threadIdx.x;
  constexpr int kShift = 5 - log2i(RB);
  float w[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    w[c] = j < d ? Wr[j] : 0.0f;
  }
  int s = 0;            // stage of fill f
  uint32_t parity = 0;  // of that fill: flips each lap of the ring
  for (int f = 0; f < fills; ++f) {
    mbar_wait(&full[s], parity);
    const int fstart = f * srows, frows = min(srows, n - fstart);
    const float* xs = ring + s * sf +
                      misalign(Xr + static_cast<size_t>(fstart) * d) + lane;
    const float* yf = ring + s * sf + xf;
    for (int b0 = 0; b0 < frows; b0 += mb) {
      const int rows = min(mb, frows - b0);
      const float* xl = xs + b0 * d;  // this lane's column of the batch
      const float* ys = yf + b0;
      const float step = rows == mb ? scale : tail_scale;
      float g[C], xr[RB][C];
#pragma unroll
      for (int c = 0; c < C; ++c) g[c] = 0.0f;
      if (mb <= RB) {
        // one butterfly: row i's pull is on lane i << kShift (on every lane
        // when RB = 1); unrolled and free of branches, so the broadcasts of
        // all rows issue before their sums (a row past the batch has pull 0
        // and adds exactly nothing)
        const float p = pulls<C, RB>(xl, ys, w, xr, 0, rows, d, lane, task);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float pi =
              RB == 1 ? p : __shfl_sync(repro::kFullMask, p, i << kShift);
#pragma unroll
          for (int c = 0; c < C; ++c) g[c] = fmaf(xr[i][c], pi, g[c]);
        }
      } else {
        // RB rows at a time, every margin against the same w first; the
        // first lane of each row stores its pull
        for (int r0 = 0; r0 < rows; r0 += RB) {
          const float p =
              pulls<C, RB>(xl, ys, w, xr, r0, rows, d, lane, task);
          const int row = r0 + (lane >> kShift);
          if ((lane & ((1 << kShift) - 1)) == 0 && row < rows) pls[row] = p;
        }
        __syncwarp();
        for (int i = 0; i < rows; ++i) {
          const float pi = pls[i];
#pragma unroll
          for (int c = 0; c < C; ++c) g[c] = fmaf(xl[i * d + 32 * c], pi, g[c]);
        }
        __syncwarp();  // the pulls are read before the next batch writes
      }
      // features past d keep w = 0 (their g is another row's values)
#pragma unroll
      for (int c = 0; c < C; ++c)
        w[c] = c * 32 + lane < d ? w[c] - step * g[c] : 0.0f;
    }
    __syncwarp();  // every lane has read the stage
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < d) Wr[j] = w[c];
  }
}

template <int C, int RB>
int launch_warp(const float* X, const float* y, float* W, int R, int n, int d,
                int mb, int task, float scale, float tail_scale, int stages,
                int group, cudaStream_t stream) {
  auto kernel = glm_sgd_warp_kernel<C, RB>;
  const size_t smem = warp_smem_bytes(C, d, mb, stages, group);
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<R, kWarpThreads, smem, stream>>>(X, y, W, n, d, mb, task, scale,
                                            tail_scale, stages, group);
  return static_cast<int>(cudaGetLastError());
}

// RB: the smallest power of two >= mb, at most 64 / C (and a warp), so a
// lane's RB x C tile values fit its registers
template <int C, int RB = (64 / C < 32 ? 64 / C : 32)>
int by_rows(const float* X, const float* y, float* W, int R, int n, int d,
            int mb, int task, float scale, float tail_scale, int stages,
            int group, cudaStream_t s) {
  if constexpr (RB > 1) {
    if (mb <= RB / 2)
      return by_rows<C, RB / 2>(X, y, W, R, n, d, mb, task, scale, tail_scale,
                                stages, group, s);
  }
  return launch_warp<C, RB>(X, y, W, R, n, d, mb, task, scale, tail_scale,
                            stages, group, s);
}

// C: ceil(d / 32) rounded up to a power of two (ops.py:warp_columns)
int warp_path(const float* X, const float* y, float* W, int R, int n, int d,
              int mb, int task, float scale, float tail_scale, int stages,
              int group, cudaStream_t s) {
  const int cn = (d + 31) / 32;
  if (cn <= 1) return by_rows<1>(X, y, W, R, n, d, mb, task, scale, tail_scale, stages, group, s);
  if (cn <= 2) return by_rows<2>(X, y, W, R, n, d, mb, task, scale, tail_scale, stages, group, s);
  if (cn <= 4) return by_rows<4>(X, y, W, R, n, d, mb, task, scale, tail_scale, stages, group, s);
  if (cn <= 8) return by_rows<8>(X, y, W, R, n, d, mb, task, scale, tail_scale, stages, group, s);
  if (cn <= 16) return by_rows<16>(X, y, W, R, n, d, mb, task, scale, tail_scale, stages, group, s);
  if (cn <= 32) return by_rows<32>(X, y, W, R, n, d, mb, task, scale, tail_scale, stages, group, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The cluster kernel: one replica's model split over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kChainWarps = 8;
constexpr int kChainThreads = 32 * kChainWarps;
constexpr int kClusterCopyWarps = 4;
constexpr int kClusterThreads = kChainThreads + 32 * kClusterCopyWarps;
constexpr int kChunkRows = 32;  // most rows a fill (and an exchange) holds
constexpr int kMaxCluster = 16;

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

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// The chain warps' barrier (the copy warps do not take part).
__device__ __forceinline__ void chain_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kChainThreads) : "memory");
}

// A stage of the ring holds `crows` rows of the block's slice of X, each at
// the offset from a 16-byte boundary it has in memory (row_floats: the
// slice and up to 3 words of alignment), then the rows' labels.  A chain
// thread reads its V values of a row unclamped (the ones past the slice's
// width are read and dropped), so the ring ends in 256 V - slice floats of
// slack for the last row.  kernels/glm_sgd/ops.py:cluster_smem_bytes
// computes the same layout:
// [2 * stages + 2 mbarriers]
// [2 x cluster x kChainWarps x crows exchange slots][stages x stage][slack]
__host__ __device__ constexpr int row_floats(int slice) { return pad4(slice + 3); }
__host__ __device__ constexpr int cluster_stage_floats(int slice, int crows) {
  return crows * row_floats(slice) + pad4(crows);
}
// V: the smallest of 4, 8, 16 with 256 V >= slice
__host__ __device__ constexpr int cluster_values(int slice) {
  return slice <= 4 * kChainThreads ? 4 : slice <= 8 * kChainThreads ? 8 : 16;
}
size_t cluster_smem_bytes(int cluster, int slice, int stages, int crows) {
  return 16 * static_cast<size_t>(stages + 1) +
         4 * static_cast<size_t>(2 * cluster * kChainWarps * crows) +
         4 * static_cast<size_t>(stages) * cluster_stage_floats(slice, crows) +
         4 * static_cast<size_t>(kChainThreads * cluster_values(slice) - slice);
}

// V: model values a chain thread holds in registers (feature j0 + k of the
// slice on chain thread k % 256, slice <= 256 V); RB: rows whose partial
// margins a chain thread carries at once, RB * V <= 64.
template <int V, int RB>
__global__ void __launch_bounds__(kClusterThreads, 1)
glm_sgd_cluster_kernel(const float* __restrict__ X,  // [R, n, d]
                       const float* __restrict__ y,  // [R, n]
                       float* __restrict__ W,        // [R, d] in/out
                       float* __restrict__ P,  // [R * cluster, mb] scratch
                       int n, int d, int mb, int task, float scale,
                       float tail_scale, int cluster, int slice, int stages,
                       int crows) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);  // [stages]
  uint64_t* empty = full + stages;                     // [stages]
  uint64_t* xbar = empty + stages;                     // [2] exchanges
  float* slots = reinterpret_cast<float*>(xbar + 2);  // [2][cluster][8][crows]
  float* ring = slots + 2 * cluster * kChainWarps * crows;

  const int rank = static_cast<int>(cluster_rank());
  const int r = blockIdx.x / cluster;
  const int j0 = rank * slice, width = min(slice, d - j0);
  const float* Xr = X + static_cast<size_t>(r) * n * d + j0;  // the slice
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d + j0;
  float* Pb = P + static_cast<size_t>(blockIdx.x) * mb;
  const int rowf = row_floats(slice), sf = cluster_stage_floats(slice, crows);
  const int fills = fill_count(n, mb, crows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // one copy warp fills a stage
      mbar_init(&empty[s], kChainWarps);
    }
    mbar_init(&xbar[0], 1);  // the block's own arrival, and the peers'
    mbar_init(&xbar[1], 1);  // bytes (expect_tx / complete_tx)
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // no peer arrives on a barrier before it is made

  if (warp >= kChainWarps) {
    // copy warp cw fills f = cw, cw + copiers, ... into stage f % stages
    // once the chain has released the stage's previous fill; no more copy
    // warps than stages (a parity wait tells apart only adjacent phases)
    const int copiers = min(kClusterCopyWarps, stages);
    const int cw = warp - kChainWarps;
    FillWalk walk(n, mb, crows);
    for (int k = 0; k < cw; ++k) walk.next();
    for (int f = cw; cw < copiers && f < fills; f += copiers) {
      const int s = f % stages, use = f / stages;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      const Fill& fl = walk.fl;
      float* st = ring + s * sf;
      for (int i = 0; i < fl.rows; ++i) {
        const float* src = Xr + static_cast<size_t>(fl.start + i) * d;
        copy_words(reinterpret_cast<uint32_t*>(st + i * rowf + misalign(src)),
                   reinterpret_cast<const uint32_t*>(src), width, lane);
      }
      for (int e = lane; e < fl.rows; e += 32)
        copy4(st + crows * rowf + e, yr + fl.start + e);
      mbar_arrive_on_copies(&full[s]);
      for (int k = 0; k < copiers; ++k) walk.next();
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // a chain thread: features j0 + t + 256 c of the slice
    const int t = threadIdx.x;
    constexpr int kShift = 5 - log2i(RB);
    float w[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int k = t + kChainThreads * c;
      w[c] = k < width ? Wr[k] : 0.0f;
    }
    int s = 0;            // stage of fill f
    uint32_t parity = 0;  // of that fill: flips each lap of the ring
    int xe = 0;           // exchanges so far
    FillWalk walk(n, mb, crows);
    for (int f = 0; f < fills; ++f, walk.next()) {
      const Fill& fl = walk.fl;
      mbar_wait(&full[s], parity);
      const float* st = ring + s * sf;
      const float* xrow0 = Xr + static_cast<size_t>(fl.start) * d;
      // row i's value at this thread's feature t + 256 c, 0 past the
      // slice's width (read all the same: the slot, the next one or the
      // ring's slack holds something there)
      auto x_at = [&](int i, int c) {
        const float* xi = st + i * rowf + t +
                          misalign(xrow0 + static_cast<size_t>(i) * d);
        const float v = xi[kChainThreads * c];
        return t + kChainThreads * c < width ? v : 0.0f;
      };
      const float step = fl.batch_rows == mb ? scale : tail_scale;
      float xr[RB][V];  // a fill of at most RB rows, kept for the update
      float pr = 0.0f;  // lane i: the pull of the fill's row i
      if (fl.pass != 1) {
        // The fill's margins over this block's slice, RB rows at a time,
        // and the exchange.  Each warp sums its threads' partials (a
        // transposed butterfly), and its lane q stores them into slot
        // [parity][rank][warp] of block q with st.async, which counts their
        // bytes on block q's exchange barrier of that parity; warp 0's lane
        // 0 arrives on this block's own, expecting the bytes of every warp
        // of every block.  Each warp then waits there and sums the slots in
        // rank and warp order (a fixed order and a butterfly), so every
        // warp of every block computes the same bits, and no chain barrier
        // is needed.  The copy warps keep a barrier.cluster from serving
        // here (it waits on every thread of the cluster), so this barrier
        // is the exchange's one cluster barrier.
        //
        // Why one barrier an exchange is enough: slots of parity p are
        // written again two exchanges later.  A warp stores there only
        // after its wait on exchange e + 1, which needs the bytes of every
        // warp of every peer for e + 1, which each warp stores after it
        // has read its slots of exchange e.  So no block can get two
        // exchanges ahead of another, and none overwrites slots a peer has
        // yet to read.
        const int xp = xe & 1;
        uint32_t dst = 0u, bar = 0u;
        if (lane < cluster) {
          dst = peer_addr(
              slots + ((xp * cluster + rank) * kChainWarps + warp) * crows,
              lane);
          bar = peer_addr(&xbar[xp], lane);
        }
        for (int r0 = 0; r0 < fl.rows; r0 += RB) {
          float v[RB];
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const int row = min(r0 + i, fl.rows - 1);
            float even = 0.0f, odd = 0.0f;  // two chains of FMAs, not one
#pragma unroll
            for (int c = 0; c < V; c += 2) {
              xr[i][c] = x_at(row, c);
              xr[i][c + 1] = x_at(row, c + 1);
              even = fmaf(xr[i][c], w[c], even);
              odd = fmaf(xr[i][c + 1], w[c + 1], odd);
            }
            v[i] = even + odd;
          }
          const float p = transposed_sum<RB>(v, lane);  // row lane >> kShift
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float pi = __shfl_sync(kFullMask, p, i << kShift);
            if (lane < cluster && r0 + i < fl.rows)
              peer_store(dst + 4 * (r0 + i), pi, bar);
          }
        }
        if (warp == 0 && lane == 0)
          mbar_expect(&xbar[xp], 4 * cluster * kChainWarps * fl.rows);
        mbar_wait(&xbar[xp], (xe >> 1) & 1);
        const float* got = slots + xp * cluster * kChainWarps * crows;
        for (int i = 0; i < fl.rows; ++i) {
          float m = 0.0f;
          for (int j = lane; j < cluster * kChainWarps; j += 32)
            m += got[j * crows + i];
          m = repro::warp_sum(m);
          if (lane == i) {
            const float yi = st[crows * rowf + i];
            pr = repro::pull(task, yi * m, yi);
            if (fl.pass == 0 && warp == 0)
              __stcg(Pb + fl.chunk * crows + i, pr);
          }
        }
        ++xe;
        // a batch's pulls are all in the scratch before its update pass
        if (fl.pass == 0) chain_sync();
      }
      if (fl.pass != 0) {
        // w -= step * X_fill^T pulls, a row at a time (one FMA a value),
        // each row's values from registers where the fill's rows were kept
        // there, else read again; past the slice's width x is 0, so w
        // stays 0 there
        if (fl.pass == 2 && fl.rows <= RB) {
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float sp = -step * __shfl_sync(kFullMask, pr, i);
            if (i < fl.rows) {
#pragma unroll
              for (int c = 0; c < V; ++c) w[c] = fmaf(sp, xr[i][c], w[c]);
            }
          }
        } else {
          for (int i = 0; i < fl.rows; ++i) {
            const float sp =
                -step * (fl.pass == 1 ? __ldcg(Pb + fl.chunk * crows + i)
                                      : __shfl_sync(kFullMask, pr, i));
#pragma unroll
            for (int c = 0; c < V; ++c) w[c] = fmaf(sp, x_at(i, c), w[c]);
          }
        }
      }
      __syncwarp();  // every lane has read the stage
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int k = t + kChainThreads * c;
      if (k < width) Wr[k] = w[c];
    }
  }
  cluster_sync();  // no block leaves while a peer may write to its memory
}

template <int V, int RB>
int launch_cluster(const float* X, const float* y, float* W, float* P, int R,
                   int n, int d, int mb, int task, float scale,
                   float tail_scale, int cluster, int slice, int stages,
                   int crows, cudaStream_t stream) {
  auto kernel = glm_sgd_cluster_kernel<V, RB>;
  const size_t smem = cluster_smem_bytes(cluster, slice, stages, crows);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * cluster);
  cfg.blockDim = dim3(kClusterThreads);
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
    // past the portable 8 blocks: allowed per kernel, and a cluster that
    // asks this much shared memory of each SM must still find its SMs
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    // (the code the runtime gives a cluster it cannot place)
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, X, y, W, P, n, d, mb, task, scale,
                           tail_scale, cluster, slice, stages, crows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// RB: the smallest power of two >= a fill's rows, at most 64 / V, so a
// thread's RB x V values of the fill fit its registers
template <int V, int RB = 64 / V>
int cluster_rows(const float* X, const float* y, float* W, float* P, int R,
                 int n, int d, int mb, int task, float scale, float tail_scale,
                 int cluster, int slice, int stages, int crows,
                 cudaStream_t s) {
  if constexpr (RB > 1) {
    if (crows <= RB / 2)
      return cluster_rows<V, RB / 2>(X, y, W, P, R, n, d, mb, task, scale,
                                     tail_scale, cluster, slice, stages,
                                     crows, s);
  }
  return launch_cluster<V, RB>(X, y, W, P, R, n, d, mb, task, scale,
                               tail_scale, cluster, slice, stages, crows, s);
}

}  // namespace

// glm_sgd_cluster_kernel: a cluster of `cluster` blocks per replica, block
// `rank` holding features [rank * slice, (rank + 1) * slice) of d, a ring of
// `stages` fills of at most `crows` rows (kernels/glm_sgd/ops.py:
// cluster_plan checks that it fits).  X, y contiguous fp32 [R, n, d] and
// [R, n]; W [R, d] updated in place; P an fp32 scratch of R * cluster * mb
// floats (the pulls of a batch longer than a fill).
extern "C" int glm_sgd_epoch_cluster(const void* X, const void* y, void* W,
                                     void* P, int R, int n, int d, int mb,
                                     int task, float scale, float tail_scale,
                                     int cluster, int slice, int stages,
                                     int crows, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || stages < 2 || crows < 1 ||
      crows > kChunkRows || (cluster - 1) * slice >= d || cluster * slice < d)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* Xf = static_cast<const float*>(X);
  const auto* yf = static_cast<const float*>(y);
  auto* Wf = static_cast<float*>(W);
  auto* Pf = static_cast<float*>(P);
  const int vn = (slice + kChainThreads - 1) / kChainThreads;
#define REPRO_CLUSTER_CASE(v)                                                \
  if (vn <= v)                                                               \
    return cluster_rows<v>(Xf, yf, Wf, Pf, R, n, d, mb, task, scale,        \
                           tail_scale, cluster, slice, stages, crows, s);
  REPRO_CLUSTER_CASE(4)
  REPRO_CLUSTER_CASE(8)
  REPRO_CLUSTER_CASE(16)
#undef REPRO_CLUSTER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// glm_sgd_global_kernel: X, y contiguous fp32 [R, n, d] and [R, n]; W [R, d]
// updated in place; P an fp32 scratch of R * mb floats.
extern "C" int glm_sgd_epoch_global(const void* X, const void* y, void* W,
                                    void* P, int R, int n, int d, int mb,
                                    int task, float scale, float tail_scale,
                                    void* stream) {
  glm_sgd_global_kernel<<<R, kGlobalThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<float*>(W), static_cast<float*>(P), n, d, mb, task, scale,
      tail_scale);
  return static_cast<int>(cudaGetLastError());
}

// stages > 1: glm_sgd_warp_kernel with a ring of that many stages of
// `group` micro-batches each (the wrapper checks d <= 1024 and that the ring
// fits: ops.py:warp_plan); stages == 0: the shared-memory kernel.  X, y
// contiguous fp32 [R, n, d] and [R, n]; W [R, d] updated in place.
extern "C" int glm_sgd_epoch(const void* X, const void* y, void* W, int R, int n,
                             int d, int mb, int task, float scale,
                             float tail_scale, int stages, int group,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* Xf = static_cast<const float*>(X);
  const auto* yf = static_cast<const float*>(y);
  auto* Wf = static_cast<float*>(W);
  if (stages > 1 && group > 0)
    return warp_path(Xf, yf, Wf, R, n, d, mb, task, scale, tail_scale, stages,
                     group, s);
  if (stages != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(d + mb) * sizeof(float);
  cudaError_t err = repro::allow_smem(glm_sgd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  glm_sgd_kernel<<<R, 256, smem, s>>>(Xf, yf, Wf, n, d, mb, task, scale,
                                      tail_scale);
  return static_cast<int>(cudaGetLastError());
}
