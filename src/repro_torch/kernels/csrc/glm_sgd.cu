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
// Two kernels, chosen by kernels/glm_sgd/ops.py:variant(d, micro_batch); the
// wrapper passes the warp kernel's ring as `stages` and `group`
// (ops.py:warp_plan), and stages = 0 for the shared-memory kernel:
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
// glm_sgd_kernel (any other d the wrapper accepts): one block of 256
//   threads per replica, the model in dynamic shared memory; per micro-batch
//   a warp per row computes the margin with a shuffle sum and writes the
//   pull into shared memory; after a barrier each thread updates its
//   features with the tile's X^T pull.
//
// Both: one block per replica (blockIdx.x; R = 1 for SyncSGD), fp32
//   throughout, no fast math (the LR pull's expf over 36k updates); a ragged
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
  constexpr int L = log2i(RB);
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
  // transposed butterfly: in round k (lane offset 16 >> k) a lane keeps the
  // half of its rows its lane bit selects and receives that half's partials
  // from its partner; after log2 RB rounds it holds one row, and the rounds
  // left sum the lanes sharing it (every loop bound is a constant, so the
  // rounds unroll and v stays in registers)
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
          v[i] = keep + __shfl_xor_sync(repro::kFullMask, send, off);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(repro::kFullMask, v[0], off);
    }
  }
  const int row = r0 + (lane >> (5 - L));
  const float yi = ys[min(row, rows - 1)];
  const float p = repro::pull(task, yi * v[0], yi);
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

}  // namespace

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
