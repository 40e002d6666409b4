// glm_grad: the full-batch sum gradient X^T pull(y * X w), row or col layout.
//
// Replaces: glm_grad_pallas (src/repro/kernels/glm_grad/kernel.py:90, bodies
//   _kernel_row l.38 and _kernel_col l.54), which accumulates g over a
//   sequential grid of row tiles with w resident in VMEM.
//
// What bounds it on the H100: bytes.  X is read once (covtype: 581,012 x 54
//   fp32 = 125.5 MB, about 38 us at 3.35 TB/s); the 4*N*d flops are about
//   2 us at the 67 TFLOP/s fp32 rate.
//
// Design: blocks run in parallel and in no order, so nothing accumulates
//   across them.  Each block writes partial sums into a scratch the caller
//   allocates, and a second launch (glm_grad_reduce, or glm_grad_sum after
//   the wide kernel) sums the partials of each feature in a fixed order, so
//   the result is deterministic.  Four kernels, chosen by
//   kernels/glm_grad/ops.py:variant(d, layout):
//   * ring (row layout, d <= 1,024): X read from HBM once.  Persistent
//     blocks, three per SM, each walk a contiguous run of tiles of T rows
//     (T * d * 4 bytes near 32 KB, at most 128 rows; ops.py:ring_plan).  A
//     copy warp keeps a ring of two stages filled with 16-byte cp.async
//     (ring.cuh's copy of a run of 4-byte words as it lies in memory: a
//     tile of covtype's 216-byte rows starts at any 4-byte offset), each
//     fill completing on a "full" mbarrier and released on an "empty" one.
//     Eight consumer warps read each staged tile twice from shared memory:
//     L lanes per row sum the margins (two a row at covtype's T = 128; each
//     row starts at its own feature, chosen so the rows of a warp read
//     different banks), then the threads that own a
//     feature accumulate x_ij * pull_i in registers across all of the
//     block's tiles.  One partial row per block (covtype: 379 of them, not
//     2,270), summed over the block's row groups in a fixed order.
//     The consumers wait on shared memory and the copies on HBM, so a
//     block's compute hides under its neighbours' copies.
//   * wide (row layout, 1,024 < d <= 16 x 4,096 = 65,536; PR 11's row
//     kernel below ran these at 15-24% of the byte bound, reading X twice
//     and writing a partial row every 8-256 rows): X read from HBM once.
//     A thread-block cluster splits the features (ops.py:wide_plan: the
//     smallest power of two of blocks, at most 16, whose slices take at
//     most 16 values a chain thread), block `rank` owning a contiguous
//     slice, as glm_sgd.cu's cluster kernel splits its model; the clusters
//     (as many as the card holds at once, glm_grad_wide_clusters: 7 of 16
//     blocks, 15 of 8) each walk a contiguous run of tiles of T rows.  4
//     copy warps keep a ring of the block's slice of the next tiles
//     (16-byte cp.async of each row's slice as it lies in memory; no TMA,
//     whose 2-d map needs d % 4 == 0); 8 chain warps compute a tile's
//     partial margins over the slice and store them into every peer's slot
//     with st.async, then, while that exchange is in flight, sum the
//     previous tile's slots (rank and warp order, a butterfly: every block
//     gets the same pulls) and add x_ij * pull_i into their features of
//     the gradient in registers from the same staged rows.  The chain so
//     holds two stages, and the plan leaves a third for the copies (the
//     most rows, up to 8, that leave three).  Each cluster writes one
//     partial row, which glm_grad_sum_kernel adds in cluster order, a
//     thread a feature (the loads of a warp neighbouring words, where
//     glm_grad_reduce_kernel's threads each read another partial row's
//     word).  Bound by bytes; what it leaves: 112-120 of 132 SMs take
//     part (whole clusters of 16 or 8 fit 7 or 15 times).
//   * row (row layout, past the wide kernel's 65,536 features): X is
//     [N, d]; a block takes a tile of
//     up to 256 rows (fewer where N is small, so that the grid fills the
//     card: ops.py:row_tile), a
//     warp per row computes the margin and pull into shared memory, then
//     the block's threads split the rows into groups, each thread summing
//     one feature over its group, and the groups are added in order: one
//     partial row per block.  It reads its tile of X twice, once per pass.
//     w is staged in shared memory where d + 512 floats fit, else read from
//     global memory (the kernel's template flag).
//   * col: X is [d, N] (the transpose materialised up front, the paper's
//     Fig. 8 access path); a thread per example walks the columns, so the
//     loads of a warp are contiguous along N.  Each warp sums x_ij * pull_i
//     over its 32 examples with shuffles: one partial row per warp.
//   Rows past N are masked, where the TPU kernel padded y with 1.0.
#include <cstdint>

#include "cluster.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 256;  // rows of a row-layout block, at most

// kSmemW: w staged in shared memory (d + 512 floats fit), else read from
// global memory
template <bool kSmemW>
__global__ void glm_grad_row_kernel(const float* __restrict__ X,  // [n, d]
                                    const float* __restrict__ y,  // [n]
                                    const float* __restrict__ w,  // [d]
                                    float* __restrict__ partial,  // [nblocks, d]
                                    int n, int d, int task, int tile) {
  extern __shared__ float smem[];
  float* pl = smem + (kSmemW ? d : 0);  // [tile]
  float* red = pl + tile;               // [kThreads]
  const float* ws = kSmemW ? smem : w;  // [d]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int start = blockIdx.x * tile;
  const int rows = min(tile, n - start);
  const float* Xb = X + static_cast<size_t>(start) * d;

  if (kSmemW) {
    for (int j = tid; j < d; j += blockDim.x) smem[j] = w[j];
    __syncthreads();
  }

  for (int i = warp; i < rows; i += nwarps) {
    const float* xi = Xb + static_cast<size_t>(i) * d;
    float acc = 0.0f;
    for (int j = lane; j < d; j += 32) acc += xi[j] * ws[j];
    acc = repro::warp_sum(acc);
    if (lane == 0) {
      const float yi = y[start + i];
      pl[i] = repro::pull(task, yi * acc, yi);
    }
  }
  __syncthreads();

  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  const int groups = d < blockDim.x ? blockDim.x / d : 1;
  if (groups == 1) {
    for (int j = tid; j < d; j += blockDim.x) {
      float g = 0.0f;
      for (int i = 0; i < rows; ++i) g += Xb[static_cast<size_t>(i) * d + j] * pl[i];
      out[j] = g;
    }
    return;
  }
  if (tid < groups * d) {
    const int j = tid % d, q = tid / d;
    float g = 0.0f;
    for (int i = q; i < rows; i += groups) g += Xb[static_cast<size_t>(i) * d + j] * pl[i];
    red[tid] = g;
  }
  __syncthreads();
  for (int j = tid; j < d; j += blockDim.x) {
    float g = 0.0f;
    for (int q = 0; q < groups; ++q) g += red[q * d + j];
    out[j] = g;
  }
}

// ---------------------------------------------------------------------------
// The ring kernel
// ---------------------------------------------------------------------------

constexpr int kRingConsumers = 256;                 // 8 warps
constexpr int kRingThreads = kRingConsumers + 32;  // + the copy warp
constexpr int kRingMaxFeatures = 4;  // a consumer's features: d <= 1,024

// One stage holds T rows of X as they lie in memory (after up to 3 floats
// of alignment), then their labels.  kernels/glm_grad/ops.py:
// ring_smem_bytes computes the same layout.
__host__ __device__ constexpr int ring_x_floats(int d, int T) {
  return pad4(T * d + 3);
}
__host__ __device__ constexpr int ring_stage_floats(int d, int T) {
  return ring_x_floats(d, T) + pad4(T);
}
__host__ __device__ constexpr int ring_red_floats(int d) {
  return pad4(d > kRingConsumers ? d : kRingConsumers);
}
// [2 * stages mbarriers][pad4(T) pulls][pad4(d) w][red][stages x stage]
size_t ring_smem_bytes(int d, int T, int stages) {
  return 16 * static_cast<size_t>(stages) +
         4 * static_cast<size_t>(pad4(T) + pad4(d) + ring_red_floats(d)) +
         4 * static_cast<size_t>(stages) * ring_stage_floats(d, T);
}

// The consumers' barrier (named barrier 1; the copy warp never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kRingConsumers) : "memory");
}

// T rows a tile, L lanes a row in the margin pass (T * L <= 256) with a
// row's first feature `skew` slots after the previous row's, `stages`
// stages, blocks of `per_block` consecutive tiles
__global__ void __launch_bounds__(kRingThreads)
glm_grad_ring_kernel(const float* __restrict__ X,  // [n, d]
                     const float* __restrict__ y,  // [n]
                     const float* __restrict__ w,  // [d]
                     float* __restrict__ partial,  // [gridDim.x, d]
                     int n, int d, int task, int T, int L, int skew,
                     int stages, int per_block) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);     // [stages]
  uint64_t* empty = full + stages;                        // [stages]
  float* pl = reinterpret_cast<float*>(empty + stages);  // [pad4(T)]
  float* ws = pl + pad4(T);                               // [pad4(d)]
  float* red = ws + pad4(d);                              // [ring_red_floats]
  float* ring = red + ring_red_floats(d);  // [stages][ring_stage_floats]
  const int sf = ring_stage_floats(d, T), xf = ring_x_floats(d, T);
  const int tiles = (n + T - 1) / T;
  const int first = blockIdx.x * per_block;
  const int fills = max(0, min(tiles, first + per_block) - first);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // the copy warp's lanes
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int j = tid; j < d; j += kRingThreads) ws[j] = w[j];
  __syncthreads();

  if (tid >= kRingConsumers) {
    // the copy warp: tile first + f into stage f % stages, once the
    // consumers have released the stage's previous tile
    const int lane = tid - kRingConsumers;
    for (int f = 0; f < fills; ++f) {
      const int s = f % stages, use = f / stages;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      const int start = (first + f) * T, rows = min(T, n - start);
      const float* src = X + static_cast<size_t>(start) * d;
      copy_words(reinterpret_cast<uint32_t*>(ring + s * sf + misalign(src)),
                 reinterpret_cast<const uint32_t*>(src), rows * d, lane);
      for (int e = lane; e < rows; e += 32)
        copy4(ring + s * sf + xf + e, y + start + e);
      mbar_arrive_on_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // margins: lane l of row `row` sums features l, l + L, ...  starting at
  // feature l + L * (row * skew mod U): rows then lie d + L * skew words
  // apart in the warp's first reads, which ops.py:ring_skew picks to fall
  // on different banks
  const int row = tid / L, l = tid % L;
  const int U = (d - l + L - 1) / L;
  // partials: `groups` groups of `span` threads; thread (q, j0) owns
  // features j0, j0 + span, ... over rows q, q + groups, ...
  const int span = min(d, kRingConsumers);
  const int groups = d < kRingConsumers ? kRingConsumers / d : 1;
  const int q = tid / span, j0 = tid % span;
  const int F = (d + span - 1) / span;
  float g[kRingMaxFeatures];
#pragma unroll
  for (int c = 0; c < kRingMaxFeatures; ++c) g[c] = 0.0f;

  int s = 0;            // stage of fill f
  uint32_t parity = 0;  // of that fill: flips each lap of the ring
  for (int f = 0; f < fills; ++f) {
    mbar_wait(&full[s], parity);
    const int start = (first + f) * T, rows = min(T, n - start);
    const float* xs = ring + s * sf + misalign(X + static_cast<size_t>(start) * d);
    float acc = 0.0f;
    if (row < rows && U > 0) {
      const float* xi = xs + row * d;
      const int first = l + L * (row * skew % U);
      float a = 0.0f, b = 0.0f;
#pragma unroll 4
      for (int j = first; j < d; j += L) a = fmaf(xi[j], ws[j], a);
#pragma unroll 4
      for (int j = l; j < first; j += L) b = fmaf(xi[j], ws[j], b);
      acc = a + b;
    }
    for (int o = L / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(kFullMask, acc, o);
    if (l == 0 && row < rows) {
      const float yi = ring[s * sf + xf + row];
      pl[row] = pull(task, yi * acc, yi);
    }
    consumer_sync();  // every pull of the tile is in
    if (q < groups) {
#pragma unroll 4
      for (int i = q; i < rows; i += groups) {
        const float p = pl[i];
        const float* xi = xs + i * d;
#pragma unroll
        for (int c = 0; c < kRingMaxFeatures; ++c) {
          const int j = j0 + c * span;
          if (c < F && j < d) g[c] = fmaf(xi[j], p, g[c]);
        }
      }
    }
    consumer_sync();  // the tile and its pulls are read
    if (tid == 0) mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }

  // the block's partial row: its row groups added in order
  if (q < groups) {
#pragma unroll
    for (int c = 0; c < kRingMaxFeatures; ++c) {
      const int j = j0 + c * span;
      if (c < F && j < d) red[q * d + j] = g[c];
    }
  }
  consumer_sync();
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int j = tid; j < d; j += kRingConsumers) {
    float sum = 0.0f;
    for (int p = 0; p < groups; ++p) sum += red[p * d + j];
    out[j] = sum;
  }
}

// ---------------------------------------------------------------------------
// The wide kernel: a row's features split over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kWideChainWarps = 8;
constexpr int kWideChainThreads = 32 * kWideChainWarps;
constexpr int kWideCopyWarps = 4;
constexpr int kWideThreads = kWideChainThreads + 32 * kWideCopyWarps;
constexpr int kWideMaxCluster = 16;
constexpr int kWideMaxValues = 16;  // a chain thread's features: slice <= 4,096
constexpr int kWideMaxRows = 32;    // rows a fill (and an exchange), at most
// exchanges in flight: a block stores tile f + 1's partial margins before
// it waits for tile f's, so a slot buffer is written again 4 exchanges
// later (the kernel's argument below)
constexpr int kWideSlots = 4;

// A stage holds `T` rows of the block's slice of X, each at the offset from
// a 16-byte boundary it has in memory (pad4(slice + 3) floats a row), then
// the rows' labels.  kernels/glm_grad/ops.py:wide_smem_bytes computes the
// same layout: [2 * stages + 4 mbarriers][4 x cluster x 8 x T exchange
// slots][stages x stage]
__host__ __device__ constexpr int wide_row_floats(int slice) {
  return pad4(slice + 3);
}
__host__ __device__ constexpr int wide_stage_floats(int slice, int T) {
  return T * wide_row_floats(slice) + pad4(T);
}
size_t wide_smem_bytes(int cluster, int slice, int stages, int T) {
  return 8 * static_cast<size_t>(2 * stages + kWideSlots) +
         4 * static_cast<size_t>(kWideSlots * cluster * kWideChainWarps * T) +
         4 * static_cast<size_t>(stages) * wide_stage_floats(slice, T);
}

// V: features a chain thread holds (feature j0 + t + 256 c of the slice on
// chain thread t, slice <= 256 V); RB: rows whose partial sums a lane
// carries through one butterfly.
template <int V, int RB>
__global__ void __launch_bounds__(kWideThreads, 1)
glm_grad_wide_kernel(const float* __restrict__ X,  // [n, d]
                     const float* __restrict__ y,  // [n]
                     const float* __restrict__ w,  // [d]
                     float* __restrict__ partial,  // [clusters, d]
                     int n, int d, int task, int cluster, int slice, int T,
                     int stages, int per_cluster) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);  // [stages]
  uint64_t* empty = full + stages;                     // [stages]
  uint64_t* xbar = empty + stages;                     // [kWideSlots]
  // [kWideSlots][cluster][8][T]: a tile's partial margins from each chain
  // warp of each block
  float* slots = reinterpret_cast<float*>(xbar + kWideSlots);
  const int slot_floats = cluster * kWideChainWarps * T;
  float* ring = slots + kWideSlots * slot_floats;

  const int rank = static_cast<int>(cluster_rank());
  const int cid = blockIdx.x / cluster;
  const int j0 = rank * slice, width = min(slice, d - j0);
  const float* Xs = X + j0;  // the slice's first column
  const int rowf = wide_row_floats(slice), sf = wide_stage_floats(slice, T);
  const int tiles = (n + T - 1) / T;
  const int first = cid * per_cluster;
  const int fills = max(0, min(tiles, first + per_cluster) - first);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // one copy warp fills a stage
      mbar_init(&empty[s], kWideChainWarps);
    }
    // the block's own arrival, and the peers' bytes (expect_tx /
    // complete_tx)
    for (int k = 0; k < kWideSlots; ++k) mbar_init(&xbar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // no peer arrives on a barrier before it is made

  if (warp >= kWideChainWarps) {
    // copy warp cw fills tile first + f, f = cw, cw + copiers, ..., into
    // stage f % stages once the chain has released its previous tile: the
    // slice of each row, as it lies in memory, and the labels
    const int copiers = min(kWideCopyWarps, stages);
    const int cw = warp - kWideChainWarps;
    for (int f = cw; cw < copiers && f < fills; f += copiers) {
      const int s = f % stages, use = f / stages;
      if (use > 0) mbar_wait_or_trap(&empty[s], (use - 1) & 1);
      const int start = (first + f) * T, rows = min(T, n - start);
      float* st = ring + s * sf;
      for (int i = 0; i < rows; ++i) {
        const float* src = Xs + static_cast<size_t>(start + i) * d;
        copy_words(reinterpret_cast<uint32_t*>(st + i * rowf + misalign(src)),
                   reinterpret_cast<const uint32_t*>(src), width, lane);
      }
      for (int e = lane; e < rows; e += 32)
        copy4(st + T * rowf + e, y + start + e);
      mbar_arrive_on_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    const int t = threadIdx.x;
    constexpr int kShift = 5 - log2i(RB);  // row r0 + (lane >> kShift)
    constexpr int kHolders = 32 / RB;      // lanes that hold one row's sum
    float wv[V], g[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int k = t + kWideChainThreads * c;
      wv[c] = k < width ? w[j0 + k] : 0.0f;
      g[c] = 0.0f;
    }
    // tile f: its rows, its stage and that stage's parity (flips each lap
    // of the ring), and the staged row i's value at this thread's first
    // feature
    auto tile_rows = [&](int f) { return min(T, n - (first + f) * T); };
    auto stage_of = [&](int f) { return ring + (f % stages) * sf; };
    auto row_at = [&](const float* st, int f, int i) {
      const float* src =
          Xs + static_cast<size_t>((first + f) * T + i) * d;
      return st + i * rowf + t + misalign(src);
    };
    // Tile f's partial margins over this block's slice, RB rows at a time
    // (a transposed butterfly: lane l holds row r0 + (l >> kShift)'s warp
    // sum), stored with st.async into slot [f % 4][rank][warp] of every
    // block of the cluster (the kHolders lanes of a row share the peers),
    // counted on that block's exchange barrier f % 4; warp 0's lane 0
    // arrives on this block's own, expecting every warp of every block's
    // bytes.
    auto exchange = [&](int f) {
      const int k = f % kWideSlots, rows = tile_rows(f);
      const float* st = stage_of(f);
      mbar_wait_or_trap(&full[f % stages], (f / stages) & 1);
      float* mine = slots + k * slot_floats + (rank * kWideChainWarps + warp) * T;
      for (int r0 = 0; r0 < rows; r0 += RB) {
        float v[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float* xi = row_at(st, f, min(r0 + i, rows - 1));
          float even = 0.0f, odd = 0.0f;  // two chains of FMAs, not one
#pragma unroll
          for (int c = 0; c < V; c += 2) {
            if (t + kWideChainThreads * c < width)
              even = fmaf(xi[kWideChainThreads * c], wv[c], even);
            if (t + kWideChainThreads * (c + 1) < width)
              odd = fmaf(xi[kWideChainThreads * (c + 1)], wv[c + 1], odd);
          }
          v[i] = even + odd;
        }
        const float p = transposed_sum<RB>(v, lane);
        const int row = r0 + (lane >> kShift);
        if (row < rows)
          for (int q = lane & (kHolders - 1); q < cluster; q += kHolders)
            peer_store(peer_addr(mine + row, q), p, peer_addr(&xbar[k], q));
      }
      if (warp == 0 && lane == 0)
        mbar_expect(&xbar[k], 4 * cluster * kWideChainWarps * rows);
    };

    // Why four slot buffers: a block stores tile f + 1's partials before
    // it waits for tile f's exchange.  A warp of block A stores into slot
    // (f + 1) % 4 of block B only after A's wait for tile f - 1, which
    // needs every warp of B to have stored tile f - 1, which each does
    // before its wait for f - 2 and after it has summed its slots of f - 3
    // (its previous iteration).  So slot (f - 3) % 4 = (f + 1) % 4 of B is
    // read before A writes it again, and the barrier's phase of f - 3 has
    // completed (B waited on it) before A's bytes of f + 1 count there.
    if (fills > 0) exchange(0);
    for (int f = 0; f < fills; ++f) {
      if (f + 1 < fills) exchange(f + 1);  // under tile f's round trip
      const int k = f % kWideSlots, rows = tile_rows(f);
      const float* st = stage_of(f);
      mbar_wait_or_trap(&xbar[k], (f / kWideSlots) & 1);
      // Each row's margin: the slots of every warp of every block, RB rows
      // at a time, lane l adding slots l, l + 32, ... and a transposed
      // butterfly, so every warp of every block adds in the same order
      // and gets the same bits; then x_ij * pull_i into this thread's
      // features of the gradient from the staged rows (X leaves HBM once)
      const float* got = slots + k * slot_floats;
      for (int r0 = 0; r0 < rows; r0 += RB) {
        float v[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int row = min(r0 + i, rows - 1);
          float m = 0.0f;
          for (int j = lane; j < cluster * kWideChainWarps; j += 32)
            m += got[j * T + row];
          v[i] = m;
        }
        const float m = transposed_sum<RB>(v, lane);
        const int row = min(r0 + (lane >> kShift), rows - 1);
        const float yi = st[T * rowf + row];
        const float p = pull(task, yi * m, yi);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float pi = __shfl_sync(kFullMask, p, i << kShift);
          if (r0 + i < rows) {
            const float* xi = row_at(st, f, r0 + i);
#pragma unroll
            for (int c = 0; c < V; ++c)
              if (t + kWideChainThreads * c < width)
                g[c] = fmaf(xi[kWideChainThreads * c], pi, g[c]);
          }
        }
      }
      __syncwarp();  // every lane has read the stage
      if (lane == 0) mbar_arrive(&empty[f % stages]);
    }
    // the cluster's partial row: this block's slice of it
    float* out = partial + static_cast<size_t>(cid) * d + j0;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int k = t + kWideChainThreads * c;
      if (k < width) out[k] = g[c];
    }
  }
  cluster_sync();  // no block leaves while a peer may write to its memory
}

template <int V, int RB>
int launch_wide(const float* X, const float* y, const float* w, float* partial,
                int n, int d, int task, int cluster, int slice, int T,
                int stages, int per_cluster, int clusters,
                cudaStream_t stream) {
  return static_cast<int>(launch_clustered(
      glm_grad_wide_kernel<V, RB>, clusters * cluster, kWideThreads, cluster,
      wide_smem_bytes(cluster, slice, stages, T), stream, X, y, w, partial, n,
      d, task, cluster, slice, T, stages, per_cluster));
}

// RB: the smallest power of two >= T, at most 8
template <int V, int RB = 8>
int wide_rows(const float* X, const float* y, const float* w, float* partial,
              int n, int d, int task, int cluster, int slice, int T,
              int stages, int per_cluster, int clusters, cudaStream_t s) {
  if constexpr (RB > 1) {
    if (T <= RB / 2)
      return wide_rows<V, RB / 2>(X, y, w, partial, n, d, task, cluster,
                                  slice, T, stages, per_cluster, clusters, s);
  }
  return launch_wide<V, RB>(X, y, w, partial, n, d, task, cluster, slice, T,
                            stages, per_cluster, clusters, s);
}

// g[j] = sum over p of partial[p, j], a thread a feature, the partials in
// order: neighbouring threads read neighbouring words of each partial row.
__global__ void glm_grad_sum_kernel(const float* __restrict__ partial,
                                    float* __restrict__ g, int nparts, int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float acc = 0.0f;
  for (int p = 0; p < nparts; ++p) acc += partial[static_cast<size_t>(p) * d + j];
  g[j] = acc;
}

__global__ void glm_grad_col_kernel(const float* __restrict__ Xc,  // [d, n]
                                    const float* __restrict__ y,   // [n]
                                    const float* __restrict__ w,   // [d]
                                    float* __restrict__ partial,   // [nwarps_total, d]
                                    int n, int d, int task) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = i < n;
  float p = 0.0f;
  if (valid) {
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) acc += Xc[static_cast<size_t>(j) * n + i] * w[j];
    const float yi = y[i];
    p = repro::pull(task, yi * acc, yi);
  }
  float* out = partial + static_cast<size_t>(i >> 5) * d;
  for (int j = 0; j < d; ++j) {
    float v = valid ? Xc[static_cast<size_t>(j) * n + i] * p : 0.0f;
    v = repro::warp_sum(v);
    if (lane == 0) out[j] = v;
  }
}

// g[j] = sum over p of partial[p, j], one block per feature, fixed order.
__global__ void glm_grad_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ g, int nparts, int d) {
  __shared__ float red[kThreads];
  const int j = blockIdx.x, tid = threadIdx.x;
  float acc = 0.0f;
  for (int p = tid; p < nparts; p += blockDim.x) acc += partial[static_cast<size_t>(p) * d + j];
  red[tid] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) g[j] = red[0];
}

}  // namespace


extern "C" int glm_grad_col_rows() { return kThreads; }

// blocks of `tile` rows (ops.py:row_tile); w in shared memory where
// d + tile + 256 floats fit a block's 227 KB, else read from global memory
extern "C" int glm_grad_row(const void* X, const void* y, const void* w,
                            void* partial, int n, int d, int task, int tile,
                            void* stream) {
  constexpr size_t kMaxSmem = 232448;
  if (tile < 1 || tile > kMaxTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t with_w = static_cast<size_t>(d + tile + kThreads) * sizeof(float);
  const bool smem_w = with_w <= kMaxSmem;
  const size_t smem = smem_w ? with_w : (tile + kThreads) * sizeof(float);
  auto kernel = smem_w ? glm_grad_row_kernel<true> : glm_grad_row_kernel<false>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + tile - 1) / tile;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<float*>(partial), n, d, task,
      tile);
  return static_cast<int>(cudaGetLastError());
}

// glm_grad_ring_kernel on `blocks` blocks of `per_block` tiles of T rows,
// L lanes a row, `stages` stages (ops.py:ring_plan, ring_skew): partial
// [blocks, d]
extern "C" int glm_grad_ring(const void* X, const void* y, const void* w,
                             void* partial, int n, int d, int task, int T,
                             int L, int skew, int stages, int per_block,
                             int blocks, void* stream) {
  if (d > kRingConsumers * kRingMaxFeatures || T < 1 || L < 1 || L > 32 ||
      T * L > kRingConsumers || skew < 0 || stages < 2 || per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ring_smem_bytes(d, T, stages);
  cudaError_t err = repro::allow_smem(glm_grad_ring_kernel, smem);
  // the plan puts two blocks on a SM: all of its shared memory, no L1
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(glm_grad_ring_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  glm_grad_ring_kernel<<<blocks, kRingThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<float*>(partial), n, d, task,
      T, L, skew, stages, per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glm_grad_col(const void* Xc, const void* y, const void* w,
                            void* partial, int n, int d, int task, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  glm_grad_col_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Xc), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<float*>(partial), n, d, task);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glm_grad_reduce(const void* partial, void* g, int nparts, int d,
                               void* stream) {
  glm_grad_reduce_kernel<<<d, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(g), nparts, d);
  return static_cast<int>(cudaGetLastError());
}

// glm_grad_wide_kernel on `clusters` clusters of `cluster` blocks, block
// `rank` holding features [rank * slice, (rank + 1) * slice) of d; cluster
// c walks tiles [c * per_cluster, (c + 1) * per_cluster) of T rows through
// `stages` stages (ops.py:wide_plan, wide_split): partial [clusters, d]
extern "C" int glm_grad_wide(const void* X, const void* y, const void* w,
                             void* partial, int n, int d, int task,
                             int cluster, int slice, int T, int stages,
                             int per_cluster, int clusters, void* stream) {
  if (cluster < 1 || cluster > kWideMaxCluster || T < 1 || T > kWideMaxRows ||
      stages < 2 || per_cluster < 1 || clusters < 1 ||
      (cluster - 1) * slice >= d || cluster * slice < d ||
      slice > kWideChainThreads * kWideMaxValues)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* Xf = static_cast<const float*>(X);
  const auto* yf = static_cast<const float*>(y);
  const auto* wf = static_cast<const float*>(w);
  auto* pf = static_cast<float*>(partial);
  const int vn = (slice + kWideChainThreads - 1) / kWideChainThreads;
#define REPRO_WIDE_CASE(v)                                                    \
  if (vn <= v)                                                                \
    return wide_rows<v>(Xf, yf, wf, pf, n, d, task, cluster, slice, T,        \
                        stages, per_cluster, clusters, s);
  REPRO_WIDE_CASE(4)
  REPRO_WIDE_CASE(8)
  REPRO_WIDE_CASE(16)
#undef REPRO_WIDE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of the wide kernel's plan the card holds at once (-1
// where the query fails): the wrapper launches no more, so every cluster
// runs in one wave.
extern "C" int glm_grad_wide_clusters(int cluster, int slice, int T,
                                      int stages) {
  const size_t smem = wide_smem_bytes(cluster, slice, stages, T);
  const int vn = (slice + kWideChainThreads - 1) / kWideChainThreads;
  if (vn <= 4)
    return max_active_clusters(glm_grad_wide_kernel<4, 1>, kWideThreads,
                               cluster, smem);
  if (vn <= 8)
    return max_active_clusters(glm_grad_wide_kernel<8, 1>, kWideThreads,
                               cluster, smem);
  return max_active_clusters(glm_grad_wide_kernel<16, 1>, kWideThreads,
                             cluster, smem);
}

// glm_grad_sum_kernel: g [d] from partial [nparts, d]
extern "C" int glm_grad_sum(const void* partial, void* g, int nparts, int d,
                            void* stream) {
  glm_grad_sum_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(g), nparts, d);
  return static_cast<int>(cudaGetLastError());
}
