// glm_sgd_sparse: one fused mini-batch SGD epoch on padded-ELL data, for R
// replicas.
//
// Replaces: ell_sgd_pallas (src/repro/kernels/glm_sgd_sparse/kernel.py:86,
//   body _kernel l.39), which gathers and scatters through one-hot MXU
//   matmuls against the VMEM-resident model.
//
// What bounds it on the H100: the chain of dependent updates, as in glm_sgd.
//   A replica's epoch is ceil(n/MB) micro-batches in sequence (w8a at R=10,
//   MB=10: 647 per replica); the ELL bytes alone (35.7 MB) would take about
//   11 us at 3.35 TB/s.  The time per update is the target.
//
// All kernels: one block per replica (blockIdx.x); the warp and smem
//   kernels keep the model in dynamic shared memory (the gathers and
//   scatters are data-dependent), the stream and global kernels in global
//   memory, in L2 (news: 5.4 MB a replica); all margins
//   of a batch see the same w (the semantics of sparse.minibatch_epoch);
//   -(alpha/|B|) * vals * pull is scattered with shared-memory atomicAdd;
//   entries whose value is 0 are skipped: they are the index-0 padding, and
//   would otherwise pile atomics onto w[0].  A ragged tail is one final
//   smaller batch at alpha/|tail|; the step arrives as a runtime float.
//   Indices are not range-checked here: the wrapper has checked the operand
//   once before its first launch.  Four kernels, chosen by
//   kernels/glm_sgd_sparse/ops.py:variant(d, K, micro_batch); the wrapper
//   passes the warp kernel's ring as `stages` and `group`
//   (ops.py:warp_plan), and stages = 0 for the shared-memory kernel; the
//   stream and global-memory kernels have their own entry points
//   (ell_sgd_epoch_stream, ell_sgd_epoch_global):
//
// ell_sgd_warp_kernel (K <= 512, and a ring of at least two stages fits next
//   to the model).  glm_sgd_warp_kernel's design, for ELL rows:
//   - the chain belongs to one warp, or to two that split a batch's rows
//     and meet at a 64-thread named barrier after the batch's margins and
//     after its scatter (a one-row batch stays on one warp); no
//     __syncthreads on it.  The block's other warps keep a ring of `stages`
//     stages ahead of it,
//     each holding `group` consecutive micro-batches (about 32 rows): vals,
//     idx and y as they lie in memory, copied with 16-byte cp.async
//     (ring.cuh: rows of K = 69 values start at any 4-byte offset), each
//     fill completing on a "full" mbarrier and released by the chain on an
//     "empty" one; no more copy warps than stages;
//   - lane l holds entries l, l + 32, ... of each row of a batch (C = the
//     next of 1, 2, 3, 4, 6, 8, 12, 16 >= K/32 a row), value and index read
//     from shared memory once and kept in registers from the margin to the
//     scatter; the RB rows' margins are reduced for all rows at once by a
//     transposed butterfly (RB - 1 shuffles for RB rows), the pull is
//     computed on the lanes that own its row and broadcast by shuffle (a
//     batch of more than RB rows goes RB rows at a time, its pulls through
//     shared memory, and its scatter reads the rows again);
//   - the scatter skips value-0 entries and zero pulls (an SVM row past its
//     margin, a row past the batch).  A float atomicAdd on shared memory
//     compiles to a compare-and-swap loop (ATOMS.CAST.SPIN on sm_90a), one
//     loop after another; with one chain warp add_row issues a row's
//     compare-and-swaps together and retries only those that lost (a row
//     may repeat a feature, and the rows of a batch share the popular
//     ones), with two warps on the chain an atomicAdd per entry measured
//     faster (scatter_row).  The chain's barrier orders the scatter before
//     the next batch's gathers.
//   tools/sgd_sparse_scatter_ab.py times this scatter against add_row or
//   an atomicAdd per entry throughout, plain reads and writes, and none
//   (PERF.md has the numbers): with no scatter at all, the margin pass (8
//   rows of 3 slots of 32 lanes a chain warp at w8a's MB = 10) is the floor
//   of this layout.
//   What it leaves for later: a margin pass that does not walk a row's
//   trailing padding without lengthening the chain (w8a's rows hold 11.65
//   nonzeros of K = 69; a warp vote per slot measured slower), and a
//   scatter that resolves a batch's shared features without
//   compare-and-swap.
//
// ell_sgd_kernel (the model fits in shared memory next to the pulls, d up
//   to about 58,000, where the warp kernel does not take the shape).  One
//   block of 256 threads; per micro-batch a warp per row gathers w[idx] and
//   sums the margin with shuffles, a barrier, the block scatters, a
//   barrier.
//
// ell_sgd_stream_kernel (any wider model, rows of up to 8,192 entries:
//   news' d = 1,355,191, K = 2,729, about 455 nonzeros a row;
//   ops.py:stream_plan).  The global kernel's update paid, in series, the
//   row's loads from HBM, a dependent gather, a 32-warp reduction over two
//   __syncthreads, a pull through a global scratch, a second read of the
//   row, and 1,024 threads walking every slot (4.07 us an update); here:
//   - 4 copy warps keep a ring of the next rows in shared memory (values,
//     indices and labels as they lie in memory, 16-byte cp.async, full and
//     empty mbarriers: ring.cuh's pattern, no more copy warps than stages),
//     so the chain never waits on HBM for a row; after each fill a copy
//     warp asks L2 for the model lines of the fill's nonzero entries
//     (prefetch.global.L2), which the chain gathers a few updates later;
//   - 16 chain warps take entries t, t + 512, ... of a row (J <= 16 a
//     thread), wherever its padding lies (a value-0 entry adds nothing to
//     the margin or the scatter); each issues all of its gathers
//     (__ldcg, L2) before using any, so a row costs one trip to L2;
//   - each warp's partial margin goes to shared memory, and after one
//     chain barrier (bar.sync over the chain warps only) every warp sums
//     the 16 in warp order itself: every warp holds the same pull, in a
//     register, with no global scratch and no barrier of its own;
//   - the scatter is RED.ADD.F32 (global atomicAdd) from the values and
//     indices still in registers; one chain barrier then orders it before
//     the next row's gathers;
//   - a batch longer than a fill is streamed twice, its margins and then
//     its scatter (ring.cuh:Fill), its pulls kept in a global scratch
//     between.
//
// ell_sgd_global_kernel (rows past the stream kernel's 8,192 entries).
//   ell_sgd_kernel's loop with the replica's model left in the output
//   tensor in global memory:
//   - a row's margin is split over the whole block (news' rows hold up to
//     2,729 entries), summed with shuffles and then across the warps in warp
//     order; the batch's pulls go to a global scratch the wrapper allocates;
//   - the scatter is a global atomicAdd, which sm_90 performs in L2 as a
//     native float reduction (RED.ADD.F32), not the compare-and-swap loop
//     of a shared-memory float atomic;
//   - the block reads back, in its next margin pass, what its own atomics
//     wrote to L2, so the model is gathered with L1-bypassing __ldcg (L1 is
//     not coherent with L2 atomics) and __syncthreads orders the passes.
#include <cstdint>

#include "ring.cuh"

namespace {

using namespace repro;

__global__ void ell_sgd_kernel(const float* __restrict__ vals,  // [R, n, K]
                               const int* __restrict__ idx,     // [R, n, K]
                               const float* __restrict__ y,     // [R, n]
                               float* __restrict__ W,           // [R, d] in/out
                               int n, int K, int d, int mb, int task,
                               float scale, float tail_scale) {
  extern __shared__ float smem[];
  float* w = smem;       // [d]
  float* pl = smem + d;  // [mb]

  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * n * K;
  const float* vr = vals + base;
  const int* ir = idx + base;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int j = tid; j < d; j += blockDim.x) w[j] = Wr[j];
  __syncthreads();

  for (int start = 0; start < n; start += mb) {
    const int rows = min(mb, n - start);
    const float s = rows == mb ? scale : tail_scale;
    const float* vb = vr + static_cast<size_t>(start) * K;
    const int* ib = ir + static_cast<size_t>(start) * K;

    for (int i = warp; i < rows; i += nwarps) {
      float acc = 0.0f;
      for (int k = lane; k < K; k += 32) {
        const float v = vb[i * K + k];
        const int j = ib[i * K + k];
        if (v != 0.0f) acc += v * w[j];
      }
      acc = repro::warp_sum(acc);
      if (lane == 0) {
        const float yi = yr[start + i];
        pl[i] = repro::pull(task, yi * acc, yi);
      }
    }
    __syncthreads();  // every margin of the batch is in before any update

    for (int e = tid; e < rows * K; e += blockDim.x) {
      const float v = vb[e];
      const int j = ib[e];
      if (v != 0.0f) atomicAdd(&w[j], -s * v * pl[e / K]);
    }
    __syncthreads();
  }

  for (int j = tid; j < d; j += blockDim.x) Wr[j] = w[j];
}

constexpr int kGlobalThreads = 1024;
constexpr int kGlobalWarps = kGlobalThreads / 32;
// rows whose margins one pass of the global kernel sums at a time
constexpr int kMarginRows = 32;

__global__ void __launch_bounds__(kGlobalThreads)
ell_sgd_global_kernel(const float* __restrict__ vals,  // [R, n, K]
                      const int* __restrict__ idx,     // [R, n, K]
                      const float* __restrict__ y,     // [R, n]
                      float* __restrict__ W,           // [R, d] in/out
                      float* __restrict__ P,           // [R, mb] scratch
                      int n, int K, int d, int mb, int task, float scale,
                      float tail_scale) {
  __shared__ float red[kMarginRows][kGlobalWarps];
  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * n * K;
  const float* vr = vals + base;
  const int* ir = idx + base;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  float* pl = P + static_cast<size_t>(r) * mb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int start = 0; start < n; start += mb) {
    const int rows = min(mb, n - start);
    const float s = rows == mb ? scale : tail_scale;
    const float* vb = vr + static_cast<size_t>(start) * K;
    const int* ib = ir + static_cast<size_t>(start) * K;
    for (int i0 = 0; i0 < rows; i0 += kMarginRows) {
      const int cr = min(kMarginRows, rows - i0);
      for (int i = 0; i < cr; ++i) {
        const size_t row = static_cast<size_t>(i0 + i) * K;
        float acc = 0.0f;
        for (int k = tid; k < K; k += kGlobalThreads) {
          const float v = vb[row + k];
          if (v != 0.0f) acc += v * __ldcg(&Wr[ib[row + k]]);
        }
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
    const size_t entries = static_cast<size_t>(rows) * K;
    for (size_t e = tid; e < entries; e += kGlobalThreads) {
      const float v = vb[e];
      if (v == 0.0f) continue;
      const float g = pl[e / K];
      if (g != 0.0f) atomicAdd(&Wr[ib[e]], -s * v * g);
    }
    __syncthreads();  // the scatter lands before the next batch's gathers
  }
}

// ---------------------------------------------------------------------------
// The warp kernel
// ---------------------------------------------------------------------------

constexpr int kWarpThreads = 128;  // 1 or 2 chain warps, the rest copy

// A batch of more than one row is split between two chain warps, which
// meet at two named barriers per batch; a one-row batch stays on one warp
// (the kernel's CW, chosen in warp_path).

// The chain warps' barrier: all of the batch's margins before any of its
// scatter, and the scatter before the next batch's margins.
__device__ __forceinline__ void chain_sync(int chains) {
  if (chains > 1)
    asm volatile("bar.sync 1, 64;" ::: "memory");
  else
    __syncwarp();
}

// One stage of the ring holds `rows` = group * mb consecutive rows: their
// values as they lie in memory (after up to 3 words of alignment), their
// indices the same way, then their labels.  kernels/glm_sgd_sparse/ops.py:
// warp_smem_bytes computes the same layout.
__host__ __device__ constexpr int ell_floats(int K, int rows) {
  return pad4(rows * K + 3);
}
__host__ __device__ constexpr int stage_floats(int K, int rows) {
  return 2 * ell_floats(K, rows) + pad4(rows);
}
// [2 * stages mbarriers][pad4(mb) pulls][pad4(d) model][stages x stage]
size_t warp_smem_bytes(int K, int d, int mb, int stages, int group) {
  return 16 * static_cast<size_t>(stages) + 4 * static_cast<size_t>(pad4(mb)) +
         4 * static_cast<size_t>(pad4(d)) +
         4 * static_cast<size_t>(stages) * stage_floats(K, group * mb);
}

// w[j[c]] += g * v[c] for a row's entries on this lane (value-0 entries and
// a zero pull skipped).  A float atomicAdd on shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN on sm_90a) per entry, one loop
// after another; here the row's entries read w together, each tries one
// compare-and-swap, all issued together, and only those that lost (another
// lane or entry on the same feature) go round again with the value that
// beat them.
template <int C>
__device__ __forceinline__ void add_row(float* w, const float (&v)[C],
                                        const int (&j)[C], float g) {
  bool pend[C];
  float old[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    pend[c] = v[c] != 0.0f && g != 0.0f;
    if (pend[c]) old[c] = w[j[c]];
  }
  int* wi = reinterpret_cast<int*>(w);
  for (bool left = true; left;) {
    left = false;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (pend[c]) {
        const int want = __float_as_int(old[c]);
        const int got =
            atomicCAS(wi + j[c], want, __float_as_int(old[c] + g * v[c]));
        pend[c] = got != want;
        old[c] = __int_as_float(got);
        left |= pend[c];
      }
  }
}

// A row's scatter on this lane: add_row where one warp carries the chain
// (a one-row batch); an atomicAdd per entry where two do, which measured
// faster there (tools/sgd_sparse_scatter_ab.py, PERF.md).
template <int C>
__device__ __forceinline__ void scatter_row(float* w, const float (&v)[C],
                                            const int (&j)[C], float g,
                                            int chains) {
  if (chains == 1) {
    add_row<C>(w, v, j, g);
    return;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (v[c] != 0.0f && g != 0.0f) atomicAdd(&w[j[c]], g * v[c]);
}

// Margins of rows r0 .. r0 + RB - 1 of a staged batch (row i's values at
// vl + i * K, its indices at il + i * K; this lane's entries 32 apart)
// against the model w in shared memory, reduced across the warp: lane l
// returns the pull of row r0 + (l >> (5 - log2 RB)), 0 past the batch's
// rows.  The rows' values and indices go to vr and ir for the scatter.
// Rows past the batch repeat its last row; entries past K are value 0 at
// index 0.
template <int C, int RB>
__device__ __forceinline__ float pulls(const float* vl, const int* il,
                                       const float* ys, const float* w,
                                       float (&vr)[RB][C], int (&ir)[RB][C],
                                       int r0, int rows, int K, int lane,
                                       int task) {
  float v[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int row = min(r0 + i, rows - 1) * K;
    v[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int kk = 32 * c + lane;
      const bool in = kk < K;
      vr[i][c] = in ? vl[row + kk] : 0.0f;
      ir[i][c] = in ? il[row + kk] : 0;
      v[i] = fmaf(vr[i][c], w[ir[i][c]], v[i]);
    }
  }
  const float m = transposed_sum<RB>(v, lane);  // ring.cuh
  const int row = r0 + (lane >> (5 - log2i(RB)));
  const float yi = ys[min(row, rows - 1)];
  const float p = repro::pull(task, yi * m, yi);
  return row < rows ? p : 0.0f;
}

// C: a row's entries a lane holds (entry k on lane k % 32); RB: rows whose
// partials a lane carries through one butterfly, RB * C <= 64; CW: chain
// warps, 2 for a batch of more than one row
template <int C, int RB, int CW>
__global__ void __launch_bounds__(kWarpThreads)
ell_sgd_warp_kernel(const float* __restrict__ vals,  // [R, n, K]
                    const int* __restrict__ idx,     // [R, n, K]
                    const float* __restrict__ y,     // [R, n]
                    float* __restrict__ W,           // [R, d] in/out
                    int n, int K, int d, int mb, int task, float scale,
                    float tail_scale, int stages, int group) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);      // [stages]
  uint64_t* empty = full + stages;                         // [stages]
  float* pls = reinterpret_cast<float*>(empty + stages);  // [pad4(mb)]
  float* w = pls + pad4(mb);                               // [pad4(d)]
  float* ring = w + pad4(d);  // [stages][stage_floats]
  const int srows = group * mb;  // rows a stage holds
  const int sf = stage_floats(K, srows), ef = ell_floats(K, srows);

  const int r = blockIdx.x;
  const float* Vr = vals + static_cast<size_t>(r) * n * K;
  const int* Ir = idx + static_cast<size_t>(r) * n * K;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  const int fills = (n + srows - 1) / srows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int chains = CW;
  const int half = (mb + chains - 1) / chains;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // one copy warp fills a stage
      mbar_init(&empty[s], chains);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int j = threadIdx.x; j < d; j += kWarpThreads) w[j] = Wr[j];
  __syncthreads();

  if (warp >= chains) {
    // copy warp cw fills stages' worth of rows f = cw, cw + copiers, ...
    // into stage f % stages once the chain has released its previous fill.
    // No more copy warps than stages: a parity wait tells apart only
    // adjacent phases, so no warp may run two laps ahead of the chain
    const int copiers = min(kWarpThreads / 32 - chains, stages);
    const int cw = warp - chains;
    for (int f = cw; cw < copiers && f < fills; f += copiers) {
      const int s = f % stages, use = f / stages;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      const int start = f * srows, rows = min(srows, n - start);
      const size_t at = static_cast<size_t>(start) * K;
      float* st = ring + s * sf;
      copy_words(reinterpret_cast<uint32_t*>(st + misalign(Vr + at)),
                 reinterpret_cast<const uint32_t*>(Vr + at), rows * K, lane);
      copy_words(reinterpret_cast<uint32_t*>(st + ef + misalign(Ir + at)),
                 reinterpret_cast<const uint32_t*>(Ir + at), rows * K, lane);
      for (int e = lane; e < rows; e += 32)
        copy4(st + 2 * ef + e, yr + start + e);
      mbar_arrive_on_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // a chain warp: rows [half * warp, half * (warp + 1)) of each batch
    constexpr int kShift = 5 - log2i(RB);
    int s = 0;            // stage of fill f
    uint32_t parity = 0;  // of that fill: flips each lap of the ring
    for (int f = 0; f < fills; ++f) {
      mbar_wait(&full[s], parity);
      const int fstart = f * srows, frows = min(srows, n - fstart);
      const size_t at = static_cast<size_t>(fstart) * K;
      const float* st = ring + s * sf;
      const float* vs = st + misalign(Vr + at);
      const int* is = reinterpret_cast<const int*>(st + ef + misalign(Ir + at));
      const float* yf = st + 2 * ef;
      for (int b0 = 0; b0 < frows; b0 += mb) {
        const int brows = min(mb, frows - b0);
        const float step = brows == mb ? scale : tail_scale;
        const int r0w = half * warp;  // this warp's first row of the batch
        const int rows = max(0, min(half, brows - r0w));
        const float* vl = vs + (b0 + r0w) * K;
        const int* il = is + (b0 + r0w) * K;
        const float* ys = yf + b0 + r0w;
        float* pw = pls + r0w;
        float vr[RB][C];
        int ir[RB][C];
        if (half <= RB) {
          // one butterfly: row i's pull is on lane i << kShift (on every
          // lane when RB = 1); a row past the batch has pull 0
          const float p = rows ? pulls<C, RB>(vl, il, ys, w, vr, ir, 0, rows,
                                              K, lane, task)
                               : 0.0f;
          chain_sync(chains);  // every margin of the batch is taken
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float g =
                -step *
                (RB == 1 ? p : __shfl_sync(repro::kFullMask, p, i << kShift));
            if (i < rows) scatter_row<C>(w, vr[i], ir[i], g, chains);
          }
        } else {
          // RB rows at a time, every margin against the same w first; the
          // first lane of each row stores its pull
          for (int r0 = 0; r0 < rows; r0 += RB) {
            const float p = pulls<C, RB>(vl, il, ys, w, vr, ir, r0, rows, K,
                                         lane, task);
            const int row = r0 + (lane >> kShift);
            if ((lane & ((1 << kShift) - 1)) == 0 && row < rows) pw[row] = p;
          }
          chain_sync(chains);
          for (int i = 0; i < rows; ++i) {
            const float g = -step * pw[i];
            for (int kk = lane; kk < K; kk += 32) {
              const float v = vl[i * K + kk];
              if (v != 0.0f && g != 0.0f) atomicAdd(&w[il[i * K + kk]], g * v);
            }
          }
        }
        chain_sync(chains);  // the scatter lands before the next gathers
      }
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += kWarpThreads) Wr[j] = w[j];
}

template <int C, int RB, int CW>
int launch_warp(const float* vals, const int* idx, const float* y, float* W,
                int R, int n, int K, int d, int mb, int task, float scale,
                float tail_scale, int stages, int group, cudaStream_t stream) {
  auto kernel = ell_sgd_warp_kernel<C, RB, CW>;
  const size_t smem = warp_smem_bytes(K, d, mb, stages, group);
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<R, kWarpThreads, smem, stream>>>(vals, idx, y, W, n, K, d, mb, task,
                                            scale, tail_scale, stages, group);
  return static_cast<int>(cudaGetLastError());
}

// RB: the smallest power of two >= a chain warp's rows of a batch, at most
// 64 / C (and a warp), so a lane's RB x C values and indices fit its
// registers
template <int C, int CW, int RB = (64 / C < 32 ? 64 / C : 32)>
int by_rows(const float* vals, const int* idx, const float* y, float* W, int R,
            int n, int K, int d, int mb, int task, float scale,
            float tail_scale, int stages, int group, cudaStream_t s) {
  constexpr int RBP = RB & (RB - 1) ? 1 << log2i(RB) : RB;  // a power of two
  const int half = (mb + CW - 1) / CW;
  if constexpr (RBP > 1) {
    if (half <= RBP / 2)
      return by_rows<C, CW, RBP / 2>(vals, idx, y, W, R, n, K, d, mb, task,
                                     scale, tail_scale, stages, group, s);
  }
  return launch_warp<C, RBP, CW>(vals, idx, y, W, R, n, K, d, mb, task, scale,
                                 tail_scale, stages, group, s);
}

// C: ceil(K / 32) rounded up to the next of 1, 2, 3, 4, 6, 8, 12, 16
// (ops.py:warp_columns)
int warp_path(const float* vals, const int* idx, const float* y, float* W,
              int R, int n, int K, int d, int mb, int task, float scale,
              float tail_scale, int stages, int group, cudaStream_t s) {
  const int cn = (K + 31) / 32;
// A one-row batch has one chain warp and RB = 1: one kernel per C
#define REPRO_ELL_CASE(c)                                                  \
  if (cn <= c)                                                             \
    return mb == 1 ? launch_warp<c, 1, 1>(vals, idx, y, W, R, n, K, d, mb, \
                                          task, scale, tail_scale, stages, \
                                          group, s)                        \
                   : by_rows<c, 2>(vals, idx, y, W, R, n, K, d, mb, task,  \
                                   scale, tail_scale, stages, group, s);
  REPRO_ELL_CASE(1)
  REPRO_ELL_CASE(2)
  REPRO_ELL_CASE(3)
  REPRO_ELL_CASE(4)
  REPRO_ELL_CASE(6)
  REPRO_ELL_CASE(8)
  REPRO_ELL_CASE(12)
  REPRO_ELL_CASE(16)
#undef REPRO_ELL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The stream kernel: the model in global memory, rows through a ring
// ---------------------------------------------------------------------------

constexpr int kStreamChainWarps = 16;
constexpr int kStreamChain = 32 * kStreamChainWarps;
constexpr int kStreamCopyWarps = 4;
constexpr int kStreamThreads = kStreamChain + 32 * kStreamCopyWarps;
constexpr int kStreamRows = 32;  // most rows a fill holds

// The chain warps' barrier (the copy warps do not take part).
__device__ __forceinline__ void stream_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kStreamChain) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(__cvta_generic_to_global(p)));
}

// A stage holds `crows` rows: their values, each at the offset from a
// 16-byte boundary it has in memory (ell_floats(K, 1) a row), their indices
// the same way, then their labels.  kernels/glm_sgd_sparse/ops.py:
// stream_smem_bytes computes the same layout:
// [2 * stages mbarriers][kStreamRows x kStreamChainWarps partials]
// [stages x stage]
__host__ __device__ constexpr int stream_stage_floats(int K, int crows) {
  return 2 * crows * ell_floats(K, 1) + pad4(crows);
}
size_t stream_smem_bytes(int K, int stages, int crows) {
  return 16 * static_cast<size_t>(stages) +
         4 * static_cast<size_t>(kStreamRows * kStreamChainWarps) +
         4 * static_cast<size_t>(stages) * stream_stage_floats(K, crows);
}

// J: a row's entries a chain thread holds (entry k on chain thread
// k % 512, K <= 512 J)
template <int J>
__global__ void __launch_bounds__(kStreamThreads, 1)
ell_sgd_stream_kernel(const float* __restrict__ vals,  // [R, n, K]
                      const int* __restrict__ idx,     // [R, n, K]
                      const float* __restrict__ y,     // [R, n]
                      float* __restrict__ W,           // [R, d] in/out
                      float* __restrict__ P,           // [R, mb] scratch
                      int n, int K, int d, int mb, int task, float scale,
                      float tail_scale, int stages, int crows) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);      // [stages]
  uint64_t* empty = full + stages;                         // [stages]
  float* wpart = reinterpret_cast<float*>(empty + stages);  // [32][16]
  float* ring = wpart + kStreamRows * kStreamChainWarps;
  const int ef = ell_floats(K, 1), sf = stream_stage_floats(K, crows);

  const int r = blockIdx.x;
  const float* Vr = vals + static_cast<size_t>(r) * n * K;
  const int* Ir = idx + static_cast<size_t>(r) * n * K;
  const float* yr = y + static_cast<size_t>(r) * n;
  float* Wr = W + static_cast<size_t>(r) * d;
  float* Pr = P + static_cast<size_t>(r) * mb;
  const int fills = fill_count(n, mb, crows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // one copy warp fills a stage
      mbar_init(&empty[s], kStreamChainWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kStreamChainWarps) {
    // copy warp cw fills f = cw, cw + copiers, ... into stage f % stages
    // once the chain has released the stage's previous fill (no more copy
    // warps than stages); it then waits for its copies and asks L2 for the
    // model lines of the fill's nonzero entries, which the chain gathers a
    // few updates later
    const int copiers = min(kStreamCopyWarps, stages);
    const int cw = warp - kStreamChainWarps;
    FillWalk walk(n, mb, crows);
    for (int k = 0; k < cw; ++k) walk.next();
    for (int f = cw; cw < copiers && f < fills; f += copiers) {
      const int s = f % stages, use = f / stages;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      const Fill& fl = walk.fl;
      float* st = ring + s * sf;
      for (int i = 0; i < fl.rows; ++i) {
        const size_t at = static_cast<size_t>(fl.start + i) * K;
        copy_words(reinterpret_cast<uint32_t*>(st + i * ef + misalign(Vr + at)),
                   reinterpret_cast<const uint32_t*>(Vr + at), K, lane);
        copy_words(reinterpret_cast<uint32_t*>(st + (crows + i) * ef +
                                               misalign(Ir + at)),
                   reinterpret_cast<const uint32_t*>(Ir + at), K, lane);
      }
      for (int e = lane; e < fl.rows; e += 32)
        copy4(st + 2 * crows * ef + e, yr + fl.start + e);
      mbar_arrive_on_copies(&full[s]);
      if (fl.pass != 1) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        for (int i = 0; i < fl.rows; ++i) {
          const size_t at = static_cast<size_t>(fl.start + i) * K;
          const float* vs = st + i * ef + misalign(Vr + at);
          const int* is = reinterpret_cast<const int*>(st + (crows + i) * ef +
                                                       misalign(Ir + at));
          // the stage may hold a later fill by now: the index is clamped,
          // and a prefetch is only a hint
          for (int k = lane; k < K; k += 32)
            if (vs[k] != 0.0f) prefetch_l2(Wr + min(max(is[k], 0), d - 1));
        }
      }
      for (int k = 0; k < copiers; ++k) walk.next();
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // a chain thread: entries t, t + 512, ... of each row
  const int t = threadIdx.x;
  int s = 0;            // stage of fill f
  uint32_t parity = 0;  // of that fill: flips each lap of the ring
  FillWalk walk(n, mb, crows);
  for (int f = 0; f < fills; ++f, walk.next()) {
    const Fill& fl = walk.fl;
    mbar_wait(&full[s], parity);
    const float* st = ring + s * sf;
    const size_t at0 = static_cast<size_t>(fl.start) * K;
    auto vrow = [&](int i) {
      return st + i * ef + misalign(Vr + at0 + static_cast<size_t>(i) * K);
    };
    auto irow = [&](int i) {
      return reinterpret_cast<const int*>(
          st + (crows + i) * ef +
          misalign(Ir + at0 + static_cast<size_t>(i) * K));
    };
    const float step = fl.batch_rows == mb ? scale : tail_scale;
    // a one-row fill keeps its entries in registers from the gather to
    // the scatter; a longer fill reads them again for the scatter
    float v[J];
    int j[J];
    float g = 0.0f;  // lane i: -step * the pull of the fill's row i
    if (fl.pass != 1) {
      for (int i = 0; i < fl.rows; ++i) {
        const float* vs = vrow(i);
        const int* is = irow(i);
        float wv[J];
#pragma unroll
        for (int c = 0; c < J; ++c) {
          const int k = t + kStreamChain * c;
          const int kk = min(k, K - 1);  // no read leaves the row
          v[c] = k < K ? vs[kk] : 0.0f;
          j[c] = k < K ? is[kk] : 0;
        }
        // every gather of the row issued before any is used: one trip to
        // L2 a row (__ldcg: L1 does not see the scatter's L2 atomics)
#pragma unroll
        for (int c = 0; c < J; ++c)
          wv[c] = v[c] != 0.0f ? __ldcg(Wr + j[c]) : 0.0f;
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < J; ++c) acc = fmaf(v[c], wv[c], acc);
        acc = repro::warp_sum(acc);
        if (lane == 0) wpart[i * kStreamChainWarps + warp] = acc;
      }
      stream_sync();
      // every warp sums each row's partials in warp order (lane i, row i),
      // so all hold the same pulls and none waits on another for them
      if (lane < fl.rows) {
        float m = 0.0f;
#pragma unroll
        for (int q = 0; q < kStreamChainWarps; ++q)
          m += wpart[lane * kStreamChainWarps + q];
        const float yi = st[2 * crows * ef + lane];
        g = -step * repro::pull(task, yi * m, yi);
        if (fl.pass == 0 && warp == 0) __stcg(Pr + fl.chunk * crows + lane, g);
      }
    }
    if (fl.pass != 0) {
      // the scatter: RED.ADD.F32 in L2 for each nonzero entry
      if (fl.pass == 2 && fl.rows == 1) {
        const float g0 = __shfl_sync(repro::kFullMask, g, 0);
#pragma unroll
        for (int c = 0; c < J; ++c)
          if (v[c] != 0.0f && g0 != 0.0f) atomicAdd(Wr + j[c], g0 * v[c]);
      } else {
        for (int i = 0; i < fl.rows; ++i) {
          const float gi = fl.pass == 1
                               ? __ldcg(Pr + fl.chunk * crows + i)
                               : __shfl_sync(repro::kFullMask, g, i);
          if (gi == 0.0f) continue;
          const float* vs = vrow(i);
          const int* is = irow(i);
          for (int k = t; k < K; k += kStreamChain) {
            const float vk = vs[k];
            if (vk != 0.0f) atomicAdd(Wr + is[k], gi * vk);
          }
        }
      }
    }
    __syncwarp();  // every lane has read the stage
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
    stream_sync();  // the scatter lands before the next gathers
  }
}

template <int J>
int launch_stream(const float* vals, const int* idx, const float* y, float* W,
                  float* P, int R, int n, int K, int d, int mb, int task,
                  float scale, float tail_scale, int stages, int crows,
                  cudaStream_t stream) {
  auto kernel = ell_sgd_stream_kernel<J>;
  const size_t smem = stream_smem_bytes(K, stages, crows);
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<R, kStreamThreads, smem, stream>>>(vals, idx, y, W, P, n, K, d, mb,
                                              task, scale, tail_scale, stages,
                                              crows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ell_sgd_stream_kernel: a ring of `stages` fills of at most `crows` rows
// (kernels/glm_sgd_sparse/ops.py:stream_plan checks that it fits, and that
// K <= 8,192); the copy warps ask L2 for each fill's model lines.  vals,
// idx, y contiguous [R, n, K] fp32, [R, n, K] int32 and
// [R, n] fp32; W [R, d] updated in place; P an fp32 scratch of R * mb floats
// (the pulls of a batch longer than a fill).
extern "C" int ell_sgd_epoch_stream(const void* vals, const void* idx,
                                    const void* y, void* W, void* P, int R,
                                    int n, int K, int d, int mb, int task,
                                    float scale, float tail_scale, int stages,
                                    int crows, void* stream) {
  if (stages < 2 || crows < 1 || crows > kStreamRows)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* vf = static_cast<const float*>(vals);
  const auto* ix = static_cast<const int*>(idx);
  const auto* yf = static_cast<const float*>(y);
  auto* Wf = static_cast<float*>(W);
  auto* Pf = static_cast<float*>(P);
  const int cn = (K + kStreamChain - 1) / kStreamChain;
#define REPRO_STREAM_CASE(c)                                                 \
  if (cn <= c)                                                               \
    return launch_stream<c>(vf, ix, yf, Wf, Pf, R, n, K, d, mb, task, scale, \
                            tail_scale, stages, crows, s);
  REPRO_STREAM_CASE(1)
  REPRO_STREAM_CASE(2)
  REPRO_STREAM_CASE(3)
  REPRO_STREAM_CASE(4)
  REPRO_STREAM_CASE(6)
  REPRO_STREAM_CASE(8)
  REPRO_STREAM_CASE(12)
  REPRO_STREAM_CASE(16)
#undef REPRO_STREAM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ell_sgd_global_kernel: vals, idx, y contiguous [R, n, K] fp32, [R, n, K]
// int32 and [R, n] fp32; W [R, d] updated in place; P an fp32 scratch of
// R * mb floats.
extern "C" int ell_sgd_epoch_global(const void* vals, const void* idx,
                                    const void* y, void* W, void* P, int R,
                                    int n, int K, int d, int mb, int task,
                                    float scale, float tail_scale,
                                    void* stream) {
  ell_sgd_global_kernel<<<R, kGlobalThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(y), static_cast<float*>(W),
      static_cast<float*>(P), n, K, d, mb, task, scale, tail_scale);
  return static_cast<int>(cudaGetLastError());
}

// stages > 1: ell_sgd_warp_kernel with a ring of that many stages of `group`
// micro-batches each (the wrapper checks K <= 512 and that the ring fits:
// ops.py:warp_plan); stages == 0: the shared-memory kernel.  vals, idx, y
// contiguous [R, n, K] fp32, [R, n, K] int32 and [R, n] fp32; W [R, d]
// updated in place.
extern "C" int ell_sgd_epoch(const void* vals, const void* idx, const void* y,
                             void* W, int R, int n, int K, int d, int mb,
                             int task, float scale, float tail_scale,
                             int stages, int group, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* vf = static_cast<const float*>(vals);
  const auto* ix = static_cast<const int*>(idx);
  const auto* yf = static_cast<const float*>(y);
  auto* Wf = static_cast<float*>(W);
  if (stages > 1 && group > 0)
    return warp_path(vf, ix, yf, Wf, R, n, K, d, mb, task, scale, tail_scale,
                     stages, group, s);
  if (stages != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(d + mb) * sizeof(float);
  cudaError_t err = repro::allow_smem(ell_sgd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ell_sgd_kernel<<<R, 256, smem, s>>>(vf, ix, yf, Wf, n, K, d, mb, task, scale,
                                      tail_scale);
  return static_cast<int>(cudaGetLastError());
}
