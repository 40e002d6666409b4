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
// Six kernels, chosen by kernels/glm_sgd/ops.py:variant(d, micro_batch,
// replicas, SMs); the wrapper passes the warp kernel's ring as `stages` and
// `group` (ops.py:warp_plan), and stages = 0 for the shared-memory kernel;
// the rows, cluster, grid and global-memory kernels have their own entry
// points (glm_sgd_epoch_rows, glm_sgd_epoch_cluster, glm_sgd_epoch_grid,
// glm_sgd_epoch_global):
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
// glm_sgd_rows_kernel (d <= WARP_MAX_D where the warp kernel's ring does
//   not fit a batch, or from ops.py:ROWS_MIN_BATCH = 48 rows a batch:
//   SyncSGD(batch=1024) and AsyncLocalSGD's full-partition batches on
//   covtype).  The first port ran these on one block of one SM, its update
//   pass busying d of 256 threads, each walking the batch's rows from
//   global memory, X read twice (126 ms a covtype epoch at B=1,024, 222 us
//   an update), or, past shared memory, on the global kernel (40.5 ms for
//   10 replicas of 58,101 rows).  Bound by bytes where a batch is long
//   (one update a replica: 125.5 MB, 38 us), else by the update's chain of
//   latencies.  Here:
//   - a replica is a thread-block cluster of `cluster` blocks (grid
//     R x cluster, ops.py:rows_plan: up to 16, a power of two, no more than
//     the SMs a replica's share of the card allows); each batch's rows are
//     split over the cluster in contiguous runs, and every block holds the
//     whole model in the lanes of each of its 8 chain warps, as the warp
//     kernel's chain warp does;
//   - 4 copy warps keep a ring of the block's next rows as they lie in
//     memory (16-byte cp.async, ring.cuh; covtype's 216-byte rows start at
//     4-byte offsets, so no TMA), a run longer than a fill streamed through
//     it;
//   - each chain warp takes tiles of RB rows of a fill: their margins (the
//     warp kernel's transposed butterfly), pulls, and x_i * pull_i into a
//     partial gradient in registers from the values the margins read, so
//     X leaves HBM once; the partial stays in registers across a run's
//     fills;
//   - once a batch: the warps' partials summed in warp order, the block's
//     stored into every peer's slot of the batch's parity with st.async
//     (16 bytes a store), and each block sums the slots in rank order and
//     applies the same update bit for bit (one exchange barrier a batch,
//     slots double-buffered by parity, as the cluster kernel's);
//   - a final barrier.cluster: no block leaves while a peer may still
//     write into its shared memory.
//   What it leaves for later: the update is a chain of latencies (a chain
//   barrier, a round trip through distributed shared memory, a second
//   chain barrier) each batch.
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
// glm_sgd_grid_kernel (past the cluster's 65,536 features, where
//   ops.py:grid_plan fits: news's Table 4 seq epoch, d = 1,355,191).  The
//   cluster kernel stretched from one cluster to the whole card: a
//   replica's model is split over `blocks` blocks, one a SM, all
//   co-resident (a cooperative launch, which fails rather than hangs when
//   the grid cannot be placed), each owning a slice in its 16 chain warps'
//   registers for the whole epoch (read at the start, written at the end).
//   glm_sgd_global_kernel, its predecessor there, walked the whole row and
//   the model through L2 on one SM: 132 us an update at d = 58,112.  Here:
//   - 2 copy warps keep a ring of the block's slice of the next rows
//     (ring.cuh, as the cluster kernel), so the chain reads X from shared
//     memory only;
//   - each chain warp sums its threads' partial margins (a transposed
//     butterfly) into shared memory; after a chain barrier warp 0 adds the
//     16 warps' partials in warp order and stores the block's into slot
//     [parity][block] of a global exchange as one 8-byte word tagged with
//     the exchange's number, so the tag and the value land together: no
//     counter, fence or grid barrier.  Warp 0 then reads every block's slot
//     of the row until each carries the exchange's tag (a lane's 5 slots
//     loaded together a pass) and sums them in block order (lanes, then a
//     butterfly: a fixed order), so every block computes the same pulls bit
//     for bit and an epoch gives the same bits on every call; the pulls go
//     to shared memory, and after a second chain barrier each block updates
//     only its own slice, with no atomics.  Slots of parity p are written
//     again two exchanges later, which a block reaches only after every
//     block's slot of the exchange between, and each block writes that only
//     after its warp 0 has read exchange e's slots.  Measured slower: every
//     chain warp polling the slots (16 times the loads at L2), and a counter
//     that each block's arrival bumps with red.release before an
//     ld.acquire wait (the arrivals queue on one address).  No cluster: the
//     exchange's cost is a store's and a load's trip through L2, and summing
//     132 slots a row is five loads a lane;
//   - a batch longer than a fill is streamed twice (ring.cuh:Fill), its
//     pulls kept in a global scratch between;
//   - a wait that lasts past 4 s traps (a launch error, not a hang).
//   What it leaves for later: an update is still a chain of latencies (a
//   butterfly, a chain barrier, the exchange's trip through L2, the sum of
//   the slots); the chain re-reads X from shared memory for the update.
//
// glm_sgd_kernel (the first port; d + micro_batch floats within a block's
//   shared memory): since the rows kernel took d <= WARP_MAX_D's batches
//   past the warp kernel's ring, no shape picks it; it stays as the rows
//   kernel's predecessor, timed beside it.  One block of 256 threads per
//   replica, the model in dynamic shared memory; per micro-batch a warp per
//   row computes the margin with a shuffle sum and writes the pull into
//   shared memory; after a barrier each thread updates its features with
//   the tile's X^T pull.
//
// glm_sgd_global_kernel (what the others refuse: a wide model past the grid
//   plan, such as many replicas past 65,536 features): glm_sgd_kernel's
//   loop with the replica's model left in the output tensor in global
//   memory.  A row's
//   margin is split over the whole block (a thread per feature), summed
//   with shuffles and then across the warps in warp order; the batch's
//   pulls go to a global scratch the wrapper allocates (a batch may hold
//   more rows than shared memory).  Each feature's update belongs to one
//   thread, so no atomics.  The block reads back in its next margin pass
//   what other threads of it wrote, so the model is read and written with
//   L1-bypassing __ldcg / __stcg (L1 is not coherent), and __syncthreads
//   orders the passes.
//
// All: one block (a cluster for glm_sgd_rows_kernel and
//   glm_sgd_cluster_kernel, `blocks` for glm_sgd_grid_kernel) per replica (R = 1 for SyncSGD), fp32 throughout, no fast math (the LR pull's expf over 36k updates); a ragged
//   tail is one final smaller batch at its own scale alpha/|tail|
//   (glm_sgd/ref.py); the step arrives as a runtime float (scale = alpha/MB
//   computed by the caller).
#include <cstdint>

#include "cluster.cuh"

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
  return static_cast<int>(launch_clustered(
      glm_sgd_cluster_kernel<V, RB>, R * cluster, kClusterThreads, cluster,
      cluster_smem_bytes(cluster, slice, stages, crows), stream, X, y, W, P,
      n, d, mb, task, scale, tail_scale, cluster, slice, stages, crows));
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

// ---------------------------------------------------------------------------
// The rows kernel: one replica's micro-batches split by rows over a cluster
// ---------------------------------------------------------------------------

constexpr int kRowsChainWarps = 8;
constexpr int kRowsChainThreads = 32 * kRowsChainWarps;
constexpr int kRowsCopyWarps = 4;
constexpr int kRowsThreads = kRowsChainThreads + 32 * kRowsCopyWarps;
constexpr int kRowsMaxCluster = 16;
constexpr int kRowsTileValues = 32;  // RB x C values a lane keeps of a tile
static_assert(kRowsChainThreads == kChainThreads, "chain_sync's count");

// The rows a block takes of a batch and the fills they stream in: batch
// b's `batch_rows` rows are split over the cluster in contiguous runs,
// block `rank` taking [rank * rows / cluster, (rank + 1) * rows / cluster)
// (a run may be empty when a ragged tail is shorter than the cluster), and
// a run is streamed in fills of at most `frows` rows, at least one fill a
// batch.  The chain walks the fills one by one, a copy warp every
// `copiers`-th (next() that many times).  kernels/glm_sgd/ops.py:rows_split
// computes the same runs.
struct RowsWalk {
  int n, mb, cluster, rank, frows;
  int batch_start, batch_rows;  // the batch
  int lo, run;                  // this block's run of it
  int f, fills;                 // the fill of the run, and their number

  __device__ __forceinline__ RowsWalk(int n_, int mb_, int cluster_,
                                      int rank_, int frows_)
      : n(n_), mb(mb_), cluster(cluster_), rank(rank_), frows(frows_) {
    batch(0);
  }
  __device__ __forceinline__ void batch(int start) {
    batch_start = start;
    batch_rows = min(mb, n - start);
    lo = rank * batch_rows / cluster;
    run = (rank + 1) * batch_rows / cluster - lo;
    f = 0;
    fills = max(1, (run + frows - 1) / frows);
  }
  __device__ __forceinline__ bool done() const { return batch_start >= n; }
  __device__ __forceinline__ int start() const {
    return batch_start + lo + f * frows;
  }
  __device__ __forceinline__ int rows() const {
    return min(frows, run - f * frows);
  }
  __device__ __forceinline__ bool last() const { return f == fills - 1; }
  __device__ __forceinline__ void next() {
    if (++f == fills) batch(batch_start + batch_rows);
  }
};

// Shared memory of a rows block (kernels/glm_sgd/ops.py:rows_smem_bytes
// computes the same layout): [2 * stages + 2 mbarriers][the chain warps'
// partial gradients, 8 x 32 C][the gradient, pad4(d)][the exchange slots
// of both parities, 2 x cluster x pad4(d)][stages x stage_floats(C, d,
// frows): the warp kernel's stage, `frows` rows as they lie in memory, 32 C
// floats of slack, the labels]
size_t rows_smem_bytes(int C, int d, int cluster, int stages, int frows) {
  return 16 * static_cast<size_t>(stages + 1) +
         4 * static_cast<size_t>(kRowsChainWarps * 32 * C +
                                 (1 + 2 * cluster) * pad4(d)) +
         4 * static_cast<size_t>(stages) * stage_floats(C, d, frows);
}

// C: model values a lane holds (feature j on lane j % 32, as the warp
// kernel); RB: rows a chain warp takes of a fill at once, RB * C <=
// kRowsTileValues.
template <int C, int RB>
__global__ void __launch_bounds__(kRowsThreads, 1)
glm_sgd_rows_kernel(const float* __restrict__ X,  // [R, n, d]
                    const float* __restrict__ y,  // [R, n]
                    float* __restrict__ W,        // [R, d] in/out
                    int n, int d, int mb, int task, float scale,
                    float tail_scale, int cluster, int frows, int stages) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);  // [stages]
  uint64_t* empty = full + stages;                     // [stages]
  uint64_t* xbar = empty + stages;                     // [2] exchanges
  float* red = reinterpret_cast<float*>(xbar + 2);     // [8][32 C]
  const int dp = pad4(d);
  float* gs = red + kRowsChainWarps * 32 * C;  // [dp]
  float* slots = gs + dp;                      // [2][cluster][dp]
  float* ring = slots + 2 * cluster * dp;      // [stages][stage_floats]
  const int sf = stage_floats(C, d, frows), xf = x_floats(C, d, frows);

  const int rank = static_cast<int>(cluster_rank());
  const int r = blockIdx.x / cluster;
  const float* Xr = X + static_cast<size_t>(r) * n * d;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // one copy warp fills a stage
      mbar_init(&empty[s], kRowsChainWarps);
    }
    mbar_init(&xbar[0], 1);  // the block's own arrival, and the peers'
    mbar_init(&xbar[1], 1);  // bytes (expect_tx / complete_tx)
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // what a lane past d may read before any copy wrote it is finite
  for (int e = threadIdx.x; e < stages * sf; e += kRowsThreads) ring[e] = 0.0f;
  cluster_sync();  // no peer arrives on a barrier before it is made

  if (warp >= kRowsChainWarps) {
    // copy warp cw fills f = cw, cw + copiers, ... into stage f % stages
    // once the chain has released the stage's previous fill; no more copy
    // warps than stages (a parity wait tells apart only adjacent phases)
    const int copiers = min(kRowsCopyWarps, stages);
    const int cw = warp - kRowsChainWarps;
    RowsWalk walk(n, mb, cluster, rank, frows);
    for (int k = 0; k < cw; ++k) walk.next();
    for (int f = cw; cw < copiers && !walk.done(); f += copiers) {
      const int s = f % stages, use = f / stages;
      if (use > 0) mbar_wait_or_trap(&empty[s], (use - 1) & 1);
      const int start = walk.start(), rows = walk.rows();
      const float* src = Xr + static_cast<size_t>(start) * d;
      copy_words(reinterpret_cast<uint32_t*>(ring + s * sf + misalign(src)),
                 reinterpret_cast<const uint32_t*>(src), rows * d, lane);
      float* ys = ring + s * sf + xf;
      for (int e = lane; e < rows; e += 32) copy4(ys + e, yr + start + e);
      // with no copies (an empty run) the arrival is at once
      mbar_arrive_on_copies(&full[s]);
      for (int k = 0; k < copiers; ++k) walk.next();
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // a chain warp: the whole model in its lanes' registers (every chain
    // warp of every block of the cluster holds the same values), the
    // partial gradient of its rows of the batch beside it
    constexpr int kShift = 5 - log2i(RB);
    const int t = threadIdx.x;
    float w[C], g[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      w[c] = j < d ? Wr[j] : 0.0f;
      g[c] = 0.0f;
    }
    int s = 0;            // stage of the fill
    uint32_t parity = 0;  // of that fill: flips each lap of the ring
    int xe = 0;           // exchanges so far
    for (RowsWalk walk(n, mb, cluster, rank, frows); !walk.done();
         walk.next()) {
      mbar_wait_or_trap(&full[s], parity);
      const int start = walk.start(), rows = walk.rows();
      const float* xs = ring + s * sf +
                        misalign(Xr + static_cast<size_t>(start) * d) + lane;
      const float* ys = ring + s * sf + xf;
      // the fill's rows in tiles of RB, tile k to warp k % 8: their
      // margins against the batch's model (pulls(): a transposed
      // butterfly, rows past the fill with pull 0), then x_i * pull_i into
      // the partial gradient from the values the margins read
      for (int r0 = warp * RB; r0 < rows; r0 += kRowsChainWarps * RB) {
        float xr[RB][C];
        const float p = pulls<C, RB>(xs, ys, w, xr, r0, rows, d, lane, task);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float pi =
              RB == 1 ? p : __shfl_sync(kFullMask, p, i << kShift);
#pragma unroll
          for (int c = 0; c < C; ++c) g[c] = fmaf(xr[i][c], pi, g[c]);
        }
      }
      __syncwarp();  // every lane has read the stage
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
      if (!walk.last()) continue;

      // The batch's update.  The chain warps' partial gradients into
      // shared memory; after a chain barrier thread t adds features 4t ..
      // 4t + 3 over the warps in warp order and stores the block's four
      // into slot [parity][rank] of every block of the cluster with
      // st.async, which counts their bytes on that block's exchange barrier
      // of the batch's parity; thread 0 arrives on this block's own,
      // expecting every block's pad4(d) floats.  After the wait each
      // feature's gradient is the blocks' partials in rank order, so every
      // block computes the same bits and applies the same update: the
      // blocks' models stay one, and an epoch gives the same bits on every
      // call.  Slots of parity p are written again two exchanges later,
      // which a block reaches only after every peer's stores of the
      // exchange between, each stored after that peer summed its slots of
      // this one (the cluster kernel's argument).
#pragma unroll
      for (int c = 0; c < C; ++c) red[warp * 32 * C + c * 32 + lane] = g[c];
      chain_sync();
      const int xp = xe & 1;
      float* got = slots + xp * cluster * dp;
      for (int v = t; 4 * v < dp; v += kRowsChainThreads) {
        float sum[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * v + e;
          float a = 0.0f;
          for (int q = 0; q < kRowsChainWarps; ++q) a += red[q * 32 * C + j];
          sum[e] = j < d ? a : 0.0f;
        }
        const float4 mine = make_float4(sum[0], sum[1], sum[2], sum[3]);
        for (int q = 0; q < cluster; ++q)
          peer_store4(peer_addr(got + rank * dp + 4 * v, q), mine,
                      peer_addr(&xbar[xp], q));
      }
      if (t == 0) mbar_expect(&xbar[xp], 4 * cluster * dp);
      mbar_wait_or_trap(&xbar[xp], (xe >> 1) & 1);
      for (int j = t; j < d; j += kRowsChainThreads) {
        float a = 0.0f;
        for (int q = 0; q < cluster; ++q) a += got[q * dp + j];
        gs[j] = a;
      }
      chain_sync();  // the gradient is in (and red is read)
      const float step = walk.batch_rows == mb ? scale : tail_scale;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c * 32 + lane;
        w[c] = j < d ? w[c] - step * gs[j] : 0.0f;
        g[c] = 0.0f;
      }
      ++xe;
    }
    if (rank == 0 && warp == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c * 32 + lane;
        if (j < d) Wr[j] = w[c];
      }
    }
  }
  cluster_sync();  // no block leaves while a peer may write to its memory
}

template <int C, int RB>
int launch_rows(const float* X, const float* y, float* W, int R, int n, int d,
                int mb, int task, float scale, float tail_scale, int cluster,
                int frows, int stages, cudaStream_t stream) {
  return static_cast<int>(launch_clustered(
      glm_sgd_rows_kernel<C, RB>, R * cluster, kRowsThreads, cluster,
      rows_smem_bytes(C, d, cluster, stages, frows), stream, X, y, W, n, d,
      mb, task, scale, tail_scale, cluster, frows, stages));
}

// RB: the plan's rows a tile (a power of two, RB * C <= kRowsTileValues)
template <int C, int RB = (kRowsTileValues / C < 32 ? kRowsTileValues / C : 32)>
int rows_by_tile(const float* X, const float* y, float* W, int R, int n,
                 int d, int mb, int task, float scale, float tail_scale,
                 int cluster, int rb, int frows, int stages, cudaStream_t s) {
  if constexpr (RB > 1) {
    if (rb <= RB / 2)
      return rows_by_tile<C, RB / 2>(X, y, W, R, n, d, mb, task, scale,
                                     tail_scale, cluster, rb, frows, stages,
                                     s);
  }
  if (rb != RB) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<C, RB>(X, y, W, R, n, d, mb, task, scale, tail_scale,
                            cluster, frows, stages, s);
}

// ---------------------------------------------------------------------------
// The grid kernel: one replica's model split over co-resident blocks
// ---------------------------------------------------------------------------

constexpr int kGridChainWarps = 16;
constexpr int kGridChainThreads = 32 * kGridChainWarps;
constexpr int kGridCopyWarps = 2;
constexpr int kGridThreads = kGridChainThreads + 32 * kGridCopyWarps;
constexpr int kGridMaxValues = 24;
// nanoseconds a grid-barrier wait may last before it traps
constexpr unsigned long long kGridWaitNs = 4000000000ull;

// A stage of the grid kernel's ring is the cluster kernel's (the block's
// slice of `crows` rows, each at its offset from a 16-byte boundary, then
// the labels); a chain thread reads only its values below the slice's
// width, so there is no slack.  kernels/glm_sgd/ops.py:grid_smem_bytes
// computes the same layout:
// [2 * stages mbarriers][kGridChainWarps x crows partials][pad4(crows)
// pulls][stages x stage]
size_t grid_smem_bytes(int slice, int stages, int crows) {
  return 16 * static_cast<size_t>(stages) +
         4 * static_cast<size_t>(kGridChainWarps * crows + pad4(crows)) +
         4 * static_cast<size_t>(stages) * cluster_stage_floats(slice, crows);
}

// The chain warps' barrier of the grid kernel (the copy warps do not take
// part).
__device__ __forceinline__ void grid_chain_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kGridChainThreads) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A block's partial margin of a fill's row, tagged with its exchange's
// number (from 1) in the high word: one 8-byte store, so a reader that sees
// the tag sees the value with it, with no fence and no flag.
__device__ __forceinline__ void put_tagged(unsigned long long* slot,
                                           unsigned tag, float v) {
  const unsigned long long word =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(slot), "l"(word)
               : "memory");
}

// slots of an exchange row a lane reads at most (blocks <= 32 x this)
constexpr int kGridLaneSlots = 8;

// The sum of row i's slots over the blocks, each once it carries `tag`:
// lane l adds slots l, l + 32, ... in order, then a butterfly (a fixed
// order).  A pass issues all of a lane's loads together and checks their
// tags; passes repeat until every tag has arrived.  Traps past
// kGridWaitNs: a grid that lost a block would otherwise spin for ever.
__device__ __forceinline__ float sum_tagged(const unsigned long long* got,
                                           int crows, int i, int blocks,
                                           int lane, unsigned tag) {
  unsigned long long word[kGridLaneSlots];
  unsigned polls = 0;
  unsigned long long start = 0;
  for (;;) {
    bool ready = true;
#pragma unroll
    for (int k = 0; k < kGridLaneSlots; ++k) {
      const int q = lane + 32 * k;
      if (q < blocks) {
        asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                     : "=l"(word[k])
                     : "l"(got + q * crows + i)
                     : "memory");
        ready &= static_cast<unsigned>(word[k] >> 32) == tag;
      }
    }
    if (ready) break;
    if ((++polls & 1023u) == 0) {
      const unsigned long long now = global_ns();
      if (start == 0) start = now;
      else if (now - start > kGridWaitNs) __trap();
    }
  }
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kGridLaneSlots; ++k)
    if (lane + 32 * k < blocks)
      m += __uint_as_float(static_cast<unsigned>(word[k]));
  return repro::warp_sum(m);
}

// V: model values a chain thread holds in registers (feature j0 + t + 512 c
// of the slice on chain thread t, slice <= 512 V); RB: rows whose partial
// margins a chain thread carries through one butterfly.
template <int V, int RB>
__global__ void __launch_bounds__(kGridThreads, 1)
glm_sgd_grid_kernel(const float* __restrict__ X,  // [R, n, d]
                    const float* __restrict__ y,  // [R, n]
                    float* __restrict__ W,        // [R, d] in/out
                    float* __restrict__ P,        // [R * blocks, mb] scratch
                    // [R, 2, blocks, crows], zero at launch
                    unsigned long long* __restrict__ slots,
                    int n, int d, int mb, int task, float scale,
                    float tail_scale, int blocks, int slice, int stages,
                    int crows) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);  // [stages]
  uint64_t* empty = full + stages;                     // [stages]
  float* red = reinterpret_cast<float*>(empty + stages);  // [16][crows]
  float* pls = red + kGridChainWarps * crows;              // [pad4(crows)]
  float* ring = pls + pad4(crows);

  const int r = blockIdx.x / blocks, b = blockIdx.x % blocks;
  const int j0 = b * slice, width = min(slice, d - j0);
  const float* Xr = X + static_cast<size_t>(r) * n * d + j0;  // the slice
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d + j0;
  float* Pb = P + static_cast<size_t>(blockIdx.x) * mb;
  unsigned long long* sl = slots + static_cast<size_t>(r) * 2 * blocks * crows;
  const int rowf = row_floats(slice), sf = cluster_stage_floats(slice, crows);
  const int fills = fill_count(n, mb, crows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // one copy warp fills a stage
      mbar_init(&empty[s], kGridChainWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kGridChainWarps) {
    // the cluster kernel's copy warps, on this block's slice
    const int copiers = min(kGridCopyWarps, stages);
    const int cw = warp - kGridChainWarps;
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
    return;
  }

  // a chain thread: features j0 + t + 512 c of the slice
  const int t = threadIdx.x;
  constexpr int kShift = 5 - log2i(RB);
  float w[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int k = t + kGridChainThreads * c;
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
    // row i of the fill, this thread's first value
    auto row_at = [&](int i) {
      return st + i * rowf + t + misalign(xrow0 + static_cast<size_t>(i) * d);
    };
    const float step = fl.batch_rows == mb ? scale : tail_scale;
    float pr = 0.0f;  // lane i: the pull of the fill's row i
    if (fl.pass != 1) {
      // the fill's margins over this block's slice, RB rows at a time; the
      // first lane of each row stores its warp's partial
      for (int r0 = 0; r0 < fl.rows; r0 += RB) {
        float v[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float* xi = row_at(min(r0 + i, fl.rows - 1));
          float even = 0.0f, odd = 0.0f;  // two chains of FMAs, not one
#pragma unroll
          for (int c = 0; c < V; c += 2) {
            if (t + kGridChainThreads * c < width)
              even = fmaf(xi[kGridChainThreads * c], w[c], even);
            if (c + 1 < V && t + kGridChainThreads * (c + 1) < width)
              odd = fmaf(xi[kGridChainThreads * (c + 1)], w[c + 1], odd);
          }
          v[i] = even + odd;
        }
        const float p = transposed_sum<RB>(v, lane);  // row lane >> kShift
        const int row = r0 + (lane >> kShift);
        if ((lane & ((1 << kShift) - 1)) == 0 && row < fl.rows)
          red[warp * crows + row] = p;
      }
      grid_chain_sync();
      if (warp == 0) {
        // the block's partial of row `lane`, its warps' in warp order, into
        // its slot of this exchange's parity; then every block's, summed in
        // block order, and the rows' pulls into shared memory
        const int xp = xe & 1;
        const unsigned tag = static_cast<unsigned>(xe + 1);
        if (lane < fl.rows) {
          float m = 0.0f;
#pragma unroll
          for (int q = 0; q < kGridChainWarps; ++q) m += red[q * crows + lane];
          put_tagged(sl + (xp * blocks + b) * crows + lane, tag, m);
        }
        const unsigned long long* got = sl + xp * blocks * crows;
        for (int i = 0; i < fl.rows; ++i) {
          const float m = sum_tagged(got, crows, i, blocks, lane, tag);
          if (lane == i) {
            const float yi = st[crows * rowf + i];
            const float pi = repro::pull(task, yi * m, yi);
            pls[i] = pi;
            if (fl.pass == 0) __stcg(Pb + fl.chunk * crows + i, pi);
          }
        }
      }
      ++xe;
      grid_chain_sync();  // the pulls are in (and in the scratch for pass 0)
      if (lane < fl.rows) pr = pls[lane];
    }
    if (fl.pass != 0) {
      // w -= step * X_fill^T pulls, a row at a time; past the slice's width
      // w stays 0
      for (int i = 0; i < fl.rows; ++i) {
        const float sp =
            -step * (fl.pass == 1 ? __ldcg(Pb + fl.chunk * crows + i)
                                  : __shfl_sync(kFullMask, pr, i));
        const float* xi = row_at(i);
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (t + kGridChainThreads * c < width)
            w[c] = fmaf(sp, xi[kGridChainThreads * c], w[c]);
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
    const int k = t + kGridChainThreads * c;
    if (k < width) Wr[k] = w[c];
  }
}

template <int V, int RB>
int launch_grid(const float* X, const float* y, float* W, float* P,
                unsigned long long* slots, int R, int n, int d, int mb,
                int task, float scale, float tail_scale, int blocks,
                int slice, int stages, int crows, cudaStream_t stream) {
  auto kernel = glm_sgd_grid_kernel<V, RB>;
  const size_t smem = grid_smem_bytes(slice, stages, crows);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * blocks);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // every block co-resident, or the launch fails: the blocks wait on each
  // other at every exchange
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, X, y, W, P, slots, n, d, mb, task,
                           scale, tail_scale, blocks, slice, stages, crows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// RB: the smallest power of two >= a fill's rows, at most 8
template <int V, int RB = 8>
int grid_rows(const float* X, const float* y, float* W, float* P,
              unsigned long long* slots, int R, int n, int d, int mb,
              int task, float scale, float tail_scale, int blocks, int slice,
              int stages, int crows, cudaStream_t s) {
  if constexpr (RB > 1) {
    if (crows <= RB / 2)
      return grid_rows<V, RB / 2>(X, y, W, P, slots, R, n, d, mb, task, scale,
                                  tail_scale, blocks, slice, stages, crows,
                                  s);
  }
  return launch_grid<V, RB>(X, y, W, P, slots, R, n, d, mb, task, scale,
                            tail_scale, blocks, slice, stages, crows, s);
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

// glm_sgd_grid_kernel: `blocks` co-resident blocks per replica, block b
// holding features [b * slice, (b + 1) * slice) of d, a ring of `stages`
// fills of at most `crows` rows (kernels/glm_sgd/ops.py:grid_plan checks
// that it fits).  X, y contiguous fp32 [R, n, d] and [R, n]; W [R, d]
// updated in place; P an fp32 scratch of R * blocks * mb floats; slots
// R * 2 * blocks * crows zeroed 8-byte words.
extern "C" int glm_sgd_epoch_grid(const void* X, const void* y, void* W,
                                  void* P, void* slots, int R, int n, int d,
                                  int mb, int task, float scale,
                                  float tail_scale, int blocks, int slice,
                                  int stages, int crows, void* stream) {
  if (blocks < 1 || stages < 2 || crows < 1 || crows > kChunkRows ||
      (blocks - 1) * slice >= d || blocks * slice < d ||
      blocks > 32 * kGridLaneSlots ||
      slice > kGridChainThreads * kGridMaxValues)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* Xf = static_cast<const float*>(X);
  const auto* yf = static_cast<const float*>(y);
  auto* Wf = static_cast<float*>(W);
  auto* Pf = static_cast<float*>(P);
  auto* sf = static_cast<unsigned long long*>(slots);
  const int vn = (slice + kGridChainThreads - 1) / kGridChainThreads;
#define REPRO_GRID_CASE(v)                                                   \
  if (vn <= v)                                                               \
    return grid_rows<v>(Xf, yf, Wf, Pf, sf, R, n, d, mb, task, scale,        \
                        tail_scale, blocks, slice, stages, crows, s);
  REPRO_GRID_CASE(4)
  REPRO_GRID_CASE(8)
  REPRO_GRID_CASE(16)
  REPRO_GRID_CASE(24)
#undef REPRO_GRID_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// glm_sgd_rows_kernel: a cluster of `cluster` blocks per replica, each
// batch's rows split over it in runs, streamed in fills of at most `frows`
// rows through `stages` stages, `rb` rows a chain warp's tile
// (kernels/glm_sgd/ops.py:rows_plan checks that it fits).  X, y contiguous
// fp32 [R, n, d] and [R, n], d <= 1,024; W [R, d] updated in place.
extern "C" int glm_sgd_epoch_rows(const void* X, const void* y, void* W,
                                  int R, int n, int d, int mb, int task,
                                  float scale, float tail_scale, int cluster,
                                  int rb, int frows, int stages,
                                  void* stream) {
  if (d < 1 || d > 32 * 32 || cluster < 1 || cluster > kRowsMaxCluster ||
      stages < 2 || frows < 1 || rb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* Xf = static_cast<const float*>(X);
  const auto* yf = static_cast<const float*>(y);
  auto* Wf = static_cast<float*>(W);
  const int cn = (d + 31) / 32;
#define REPRO_ROWS_CASE(c)                                                   \
  if (cn <= c)                                                               \
    return rows_by_tile<c>(Xf, yf, Wf, R, n, d, mb, task, scale, tail_scale, \
                           cluster, rb, frows, stages, s);
  REPRO_ROWS_CASE(1)
  REPRO_ROWS_CASE(2)
  REPRO_ROWS_CASE(4)
  REPRO_ROWS_CASE(8)
  REPRO_ROWS_CASE(16)
  REPRO_ROWS_CASE(32)
#undef REPRO_ROWS_CASE
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
