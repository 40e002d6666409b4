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
//   once before its first launch.  Six kernels, chosen by
//   kernels/glm_sgd_sparse/ops.py:variant(d, K, micro_batch); the wrapper
//   passes the warp kernel's ring as `stages` and `group`
//   (ops.py:warp_plan), and stages = 0 for the shared-memory kernel; the
//   stream, global-memory and live-prefix kernels have their own entry
//   points (ell_sgd_epoch_stream, ell_sgd_epoch_global, ell_sgd_epoch_live):
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
//
// ell_sgd_live_smem_kernel and ell_sgd_live_global_kernel (rows past the
//   warp kernel's 512 entries with the model in shared memory, ops.py:
//   live_plan: real-sim's Table 3 width, K = 3,484; rows past the stream
//   kernel's 8,192 with the model in global memory: news's K = 16,423).
//   Replace ell_sgd_kernel and ell_sgd_global_kernel there, which walk
//   every padded entry from HBM on one SM a replica, twice a batch, with
//   no prefetch: at these widths 96-98% of a row is padding (real-sim about
//   71 live entries of 3,484, news about 630 of 16,423).  Here:
//   - ell_live_length_kernel first reads every value once, a warp a row
//     over every SM at 16 bytes a lane, and writes the position after each
//     row's last nonzero (a value-0 entry before it still counts: the
//     chain skips it, as every variant does);
//   - one producer warp a replica stages only those live prefixes, values
//     and indices as they lie in memory (ring.cuh's up to 3 words of
//     alignment; news's odd K starts rows at any word), into a ring of
//     stages sized in entries, not rows: a fill is a batch's rows while
//     they fit, placed 32 at a time by a warp scan of their footprints
//     (a lane copies each of many short rows, a warp each of a few long
//     ones), a row longer than the room left split into pieces; a batch
//     that fits one fill is staged once (margins and scatter), a longer one
//     twice (margins, then scatter), its margins summed piece by piece in
//     the batch's pulls in shared memory;
//   - the chain reads each staged entry once for the margin and once for
//     the scatter, from shared memory.  With the model in shared memory (8
//     chain warps) a fill also takes the whole batches of up to 32 rows
//     that follow while they fit (real-sim at micro-batch 1: about 28 a
//     fill); a one-row batch is warp 0's alone, with no block barrier; a
//     longer one is a piece a warp, one warp_sum a piece, then the scatter
//     by shared-memory atomicAdd.  With the model in global memory (16
//     chain warps, 3c's chain) every chain thread takes entries of each
//     piece, its gathers issued four at a time from L2, the partial margins
//     meet in shared memory, and the scatter is RED.ADD.F32 in L2.
//   Named barriers over the chain warps order a batch's margins before its
//   scatter and its scatter before the next batch's gathers; a ring wait
//   past 4 s traps (a launch error, not a hang:
//   cluster.cuh:mbar_wait_or_trap).  Bound: the length pass's bytes (every
//   value) plus the chain's dependent updates; at real-sim's rows the
//   scatter's compare-and-swap loops on the draw's repeated popular
//   features take most of an update.
#include <cstdint>

#include "cluster.cuh"  // ring.cuh, and mbar_wait_or_trap

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

// ---------------------------------------------------------------------------
// The live-prefix kernels: each row read up to its last nonzero
// ---------------------------------------------------------------------------

constexpr int kLiveLengthWarps = 8;  // rows a block of the length pass
constexpr int kLivePieces = 32;      // most row pieces a fill holds
constexpr int kLiveSmemChain = 8;    // chain warps, model in shared memory
constexpr int kLiveGlobalChain = 16;  // chain warps, model in global memory
// a fill's pass: a batch's margins, its scatter, both, or the end
constexpr int kPassMargins = 0, kPassScatter = 1, kPassBoth = 2, kPassDone = 3;
// a piece holds its row's first entries, its last; its batch is the ragged
// tail
constexpr int kFirst = 1, kLast = 2, kTail = 4;

// Entries [e0, e0 + count) of row `row` of batch `batch`, staged at words
// vofs (values) and iofs (indices) of its fill.
struct Piece {
  int batch;
  int row;
  int count;
  int vofs;
  int iofs;
  float y;
  int flags;
};

// A stage: a header (pieces, pass, 0, 0), the pieces, then `words` words of
// values and `words` of indices, each piece's run at the offset from a
// 16-byte boundary it has in memory.
// kernels/glm_sgd_sparse/ops.py:live_smem_bytes computes the same layout:
// [2 * stages mbarriers][the model: pad4(d) floats | the chain's partials]
// [pad4(mb) pulls][stages x stage]
__host__ __device__ constexpr size_t live_stage_bytes(int words) {
  return 16 + sizeof(Piece) * kLivePieces + 8 * static_cast<size_t>(words);
}
size_t live_smem_bytes(int d, int mb, int stages, int words, bool smem_model) {
  const size_t fixed = smem_model
                           ? 4 * static_cast<size_t>(pad4(d))
                           : 4 * static_cast<size_t>(kLivePieces) *
                                 kLiveGlobalChain;
  return 16 * static_cast<size_t>(stages) + fixed +
         4 * static_cast<size_t>(pad4(mb)) + stages * live_stage_bytes(words);
}

// The position after each row's last nonzero value (0 for a row of
// padding), a warp a row over every SM: every value is read once, 16 bytes
// a lane, four loads in flight before any is used.
__global__ void __launch_bounds__(32 * kLiveLengthWarps)
ell_live_length_kernel(const float* __restrict__ vals,  // [rows, K]
                       int rows, int K, int* __restrict__ len) {
  const int row = blockIdx.x * kLiveLengthWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* v = vals + static_cast<size_t>(row) * K;
  const int head = min((4 - misalign(v)) & 3, K);
  const int runs = (K - head) >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  int last = lane < head && v[lane] != 0.0f ? lane : -1;
  // a lane's entries grow with e, so each hit is its largest so far
  for (int e0 = lane; e0 < runs; e0 += 4 * 32) {
    float4 q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = e0 + 32 * c;
      q[c] = e < runs ? __ldcs(v4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = head + 4 * (e0 + 32 * c);
      if (q[c].w != 0.0f) last = k + 3;
      else if (q[c].z != 0.0f) last = k + 2;
      else if (q[c].y != 0.0f) last = k + 1;
      else if (q[c].x != 0.0f) last = k;
    }
  }
  const int tail = head + 4 * runs + lane;  // at most 3 entries
  if (tail < K && v[tail] != 0.0f) last = max(last, tail);
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(repro::kFullMask, last, o));
  if (lane == 0) len[row] = last + 1;
}

// One thread copies `count` 4-byte words from src to dst (dst at src's
// offset from a 16-byte boundary): copy_words' pattern for one lane.
__device__ __forceinline__ void copy_run(uint32_t* dst, const uint32_t* src,
                                         int count) {
  const int head = min((4 - misalign(src)) & 3, count);
  const int runs = (count - head) >> 2;
  for (int e = 0; e < head; ++e) copy4(dst + e, src + e);
  for (int e = 0; e < runs; ++e)
    copy16(dst + head + 4 * e, src + head + 4 * e);
  for (int e = head + 4 * runs; e < count; ++e) copy4(dst + e, src + e);
}

// The producer's window onto the live lengths and labels of one replica:
// lane l holds rows base + l and base + 32 + l, the second loaded a window
// ahead of the walk.
struct LiveRows {
  const int* len;
  const float* y;
  int n, base, l0, l1;
  float y0, y1;

  __device__ __forceinline__ void load(int b, int lane) {
    base = b;
    l0 = b + lane < n ? len[b + lane] : 0;
    y0 = b + lane < n ? y[b + lane] : 0.0f;
    l1 = b + 32 + lane < n ? len[b + 32 + lane] : 0;
    y1 = b + 32 + lane < n ? y[b + 32 + lane] : 0.0f;
  }
  // Until row pos lies in the first half of the window.
  __device__ __forceinline__ void reach(int pos, int lane) {
    if (pos >= base + 64) {
      load(pos, lane);
      return;
    }
    if (pos >= base + 32) {
      base += 32;
      l0 = l1;
      y0 = y1;
      const int r = base + 32 + lane;
      l1 = r < n ? len[r] : 0;
      y1 = r < n ? y[r] : 0.0f;
    }
  }
  // Row base + i (0 <= i < 64, any i on each lane).
  __device__ __forceinline__ int length(int i) const {
    const int a = __shfl_sync(repro::kFullMask, l0, i & 31);
    const int b = __shfl_sync(repro::kFullMask, l1, i & 31);
    return i < 32 ? a : b;
  }
  __device__ __forceinline__ float label(int i) const {
    const float a = __shfl_sync(repro::kFullMask, y0, i & 31);
    const float b = __shfl_sync(repro::kFullMask, y1, i & 31);
    return i < 32 ? a : b;
  }
};

// Stage the pieces of a batch's rows [pos, b1) that fit a fill, from entry
// `done` of row pos: whole rows while they fit (placed 32 at a time by a
// scan of their footprints), then as much of the next row as the fill has
// room for.  Rows of padding take no piece.  Moves pos, done and the fill's
// `free` words and `pieces` past what it placed.
__device__ void live_fill(unsigned char* st, const float* Vr, const int* Ir,
                          LiveRows& rows, int K, int mb, int b0, int b1,
                          int tail, int words, int& pos, int& done,
                          int& free, int& pieces, int lane) {
  Piece* pc = reinterpret_cast<Piece*>(st + 16);
  float* sv = reinterpret_cast<float*>(pc + kLivePieces);
  int* si = reinterpret_cast<int*>(sv + words);
  const int batch = b0 / mb;
  while (pos < b1 && pieces < kLivePieces && free >= 4) {
    rows.reach(pos, lane);
    const int r = pos + lane;
    const int e0 = lane == 0 ? done : 0;
    const int whole = rows.length(r - rows.base);
    const float yl = rows.label(r - rows.base);
    const int left = r < b1 ? max(whole - e0, 0) : 0;
    const int need = left > 0 ? pad4(left + 3) : 0;
    int words_to = need, pieces_to = left > 0;  // inclusive scans
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(repro::kFullMask, words_to, o);
      const int b = __shfl_up_sync(repro::kFullMask, pieces_to, o);
      if (lane >= o) {
        words_to += a;
        pieces_to += b;
      }
    }
    const bool fit =
        r < b1 && words_to <= free && pieces_to <= kLivePieces - pieces;
    const unsigned miss = __ballot_sync(repro::kFullMask, !fit);
    const int k = miss ? __ffs(miss) - 1 : 32;  // rows placed whole
    const bool mine = lane < k && left > 0;
    const size_t src = static_cast<size_t>(r) * K + e0;
    const int at = words - free + words_to - need;
    const int vo = at + misalign(Vr + src), io = at + misalign(Ir + src);
    if (mine)
      pc[pieces + pieces_to - 1] =
          Piece{batch, r - b0, left, vo, io, yl,
                (e0 == 0 ? kFirst : 0) | kLast | tail};
    // a few long rows: a warp copies each; many short ones: a lane each
    const unsigned placed = __ballot_sync(repro::kFullMask, mine);
    if (__popc(placed) <= 2) {
      for (unsigned m = placed; m; m &= m - 1) {
        const int l = __ffs(m) - 1;
        const int rl = __shfl_sync(repro::kFullMask, r, l);
        const int el = __shfl_sync(repro::kFullMask, e0, l);
        const int cl = __shfl_sync(repro::kFullMask, left, l);
        const int vl = __shfl_sync(repro::kFullMask, vo, l);
        const int il = __shfl_sync(repro::kFullMask, io, l);
        const size_t sl = static_cast<size_t>(rl) * K + el;
        copy_words(reinterpret_cast<uint32_t*>(sv + vl),
                   reinterpret_cast<const uint32_t*>(Vr + sl), cl, lane);
        copy_words(reinterpret_cast<uint32_t*>(si + il),
                   reinterpret_cast<const uint32_t*>(Ir + sl), cl, lane);
      }
    } else if (mine) {
      copy_run(reinterpret_cast<uint32_t*>(sv + vo),
               reinterpret_cast<const uint32_t*>(Vr + src), left);
      copy_run(reinterpret_cast<uint32_t*>(si + io),
               reinterpret_cast<const uint32_t*>(Ir + src), left);
    }
    if (k > 0) {
      free -= __shfl_sync(repro::kFullMask, words_to, k - 1);
      pieces += __shfl_sync(repro::kFullMask, pieces_to, k - 1);
      pos += k;
      done = 0;
    }
    if (k == 32) continue;
    // row pos (lane k's) does not fit whole, or the batch has ended: the
    // part of it the fill has room for, and the fill is full
    if (pos < b1 && pieces < kLivePieces && free >= 4) {
      const float yk = __shfl_sync(repro::kFullMask, yl, k);
      const int c = free - 3;  // fewer than left: pad4(left + 3) > free
      const size_t sp = static_cast<size_t>(pos) * K + done;
      const int at = words - free;
      const int vp = at + misalign(Vr + sp), ip = at + misalign(Ir + sp);
      if (lane == 0)
        pc[pieces] = Piece{batch, pos - b0, c,  vp,
                           ip,    yk,       (done == 0 ? kFirst : 0) | tail};
      copy_words(reinterpret_cast<uint32_t*>(sv + vp),
                 reinterpret_cast<const uint32_t*>(Vr + sp), c, lane);
      copy_words(reinterpret_cast<uint32_t*>(si + ip),
                 reinterpret_cast<const uint32_t*>(Ir + sp), c, lane);
      ++pieces;
      done += c;
      free = 0;
    }
    break;
  }
}

// Stage whole batches of at most 32 rows from row pos (a batch's first) on
// while they fit the fill's room, 32 rows a scan: the rows that fit, cut
// back to the last batch they complete.  Returns the end of the last batch
// placed.
__device__ int live_group(unsigned char* st, const float* Vr, const int* Ir,
                          LiveRows& rows, int n, int K, int mb, int words,
                          int pos, int& free, int& pieces, int lane) {
  Piece* pc = reinterpret_cast<Piece*>(st + 16);
  float* sv = reinterpret_cast<float*>(pc + kLivePieces);
  int* si = reinterpret_cast<int*>(sv + words);
  const int tail_batch = n % mb ? n / mb : -1;
  while (pos < n && pieces < kLivePieces && free >= 4) {
    rows.reach(pos, lane);
    const int r = pos + lane;
    const int whole = rows.length(r - rows.base);  // on every lane: shuffles
    const float yl = rows.label(r - rows.base);
    const int left = r < n ? whole : 0;
    const int need = left > 0 ? pad4(left + 3) : 0;
    int words_to = need, pieces_to = left > 0;  // inclusive scans
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(repro::kFullMask, words_to, o);
      const int b = __shfl_up_sync(repro::kFullMask, pieces_to, o);
      if (lane >= o) {
        words_to += a;
        pieces_to += b;
      }
    }
    const bool fit =
        r < n && words_to <= free && pieces_to <= kLivePieces - pieces;
    const unsigned miss = __ballot_sync(repro::kFullMask, !fit);
    const int k = miss ? __ffs(miss) - 1 : 32;  // rows that fit
    // ... cut back to the end of the last batch they complete
    const unsigned ends = __ballot_sync(
        repro::kFullMask, lane < k && ((r + 1) % mb == 0 || r == n - 1));
    if (!ends) break;
    const int kk = 32 - __clz(ends);
    const bool mine = lane < kk && left > 0;
    const size_t src = static_cast<size_t>(r) * K;
    const int at = words - free + words_to - need;
    const int vo = at + misalign(Vr + src), io = at + misalign(Ir + src);
    const int batch = r / mb;
    if (mine)
      pc[pieces + pieces_to - 1] =
          Piece{batch, r - batch * mb, left, vo, io, yl,
                kFirst | kLast | (batch == tail_batch ? kTail : 0)};
    if (mine) {
      copy_run(reinterpret_cast<uint32_t*>(sv + vo),
               reinterpret_cast<const uint32_t*>(Vr + src), left);
      copy_run(reinterpret_cast<uint32_t*>(si + io),
               reinterpret_cast<const uint32_t*>(Ir + src), left);
    }
    free -= __shfl_sync(repro::kFullMask, words_to, kk - 1);
    pieces += __shfl_sync(repro::kFullMask, pieces_to, kk - 1);
    pos += kk;
    if (kk < 32) break;  // the next batch does not fit
  }
  return pos;
}

// The producer warp: every batch of the replica as fills of the ring, in
// order.  A batch whose pieces fit one fill is one fill (pass both), and
// with `group` the whole batches of at most 32 rows after it that fit join
// it (live_group); a longer batch is its fills twice, first for its
// margins, then, walked again from its first row, for its scatter.  A last
// fill marks the end.  Each fill completes on its full mbarrier once its
// copies have landed and each lane's stores of the pieces are released
// (32 + 32 arrivals).
__device__ void live_produce(const float* Vr, const int* Ir, LiveRows& rows,
                             int n, int K, int mb, bool group,
                             unsigned char* ring, uint64_t* full,
                             uint64_t* empty, int stages, int words,
                             int lane) {
  const size_t sb = live_stage_bytes(words);
  int f = 0;  // fills published
  auto begin = [&]() {
    const int s = f % stages, use = f / stages;
    if (use > 0) mbar_wait_or_trap(&empty[s], (use - 1) & 1);
    return ring + s * sb;
  };
  auto publish = [&](unsigned char* st, int pieces, int pass) {
    if (lane == 0) *reinterpret_cast<int4*>(st) = make_int4(pieces, pass, 0, 0);
    mbar_arrive_on_copies(&full[f % stages]);
    mbar_arrive(&full[f % stages]);
    ++f;
  };
  rows.load(0, lane);
  for (int b0 = 0; b0 < n;) {
    const int b1 = min(n, b0 + mb), tail = b1 - b0 < mb ? kTail : 0;
    int pos = b0, done = 0, free = words, pieces = 0;
    unsigned char* st = begin();
    live_fill(st, Vr, Ir, rows, K, mb, b0, b1, tail, words, pos, done, free,
              pieces, lane);
    if (pos >= b1) {
      b0 = group && mb <= 32 ? live_group(st, Vr, Ir, rows, n, K, mb, words,
                                          b1, free, pieces, lane)
                             : b1;
      __syncwarp();  // every lane's pieces before the arrivals
      publish(st, pieces, kPassBoth);
      continue;
    }
    publish(st, pieces, kPassMargins);
    while (pos < b1) {
      st = begin();
      free = words;
      pieces = 0;
      live_fill(st, Vr, Ir, rows, K, mb, b0, b1, tail, words, pos, done, free,
                pieces, lane);
      publish(st, pieces, kPassMargins);
    }
    rows.load(b0, lane);
    pos = b0;
    done = 0;
    while (pos < b1) {
      st = begin();
      free = words;
      pieces = 0;
      live_fill(st, Vr, Ir, rows, K, mb, b0, b1, tail, words, pos, done, free,
                pieces, lane);
      publish(st, pieces, kPassScatter);
    }
    b0 = b1;
  }
  publish(begin(), 0, kPassDone);
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The chain warps' barrier (the producer warp does not take part).
template <int CW>
__device__ __forceinline__ void live_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * CW) : "memory");
}

__device__ __forceinline__ void live_init(uint64_t* full, uint64_t* empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 64);  // the producer's 32 copy and 32 plain arrivals
      mbar_init(&empty[s], 1);  // the chain's, after its last barrier
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// A piece's scatter, w[j] += g * v for its nonzero entries: a
// shared-memory atomicAdd an entry (a compare-and-swap loop), four passes'
// values and indices loaded before the first.  Grouping a pass's lanes by
// feature (__match_any_sync) or issuing a lane's compare-and-swaps together
// (add_row) both measured slower here: the draw's rows repeat their
// Zipf-popular features (about 7 copies of the hottest in a real-sim row).
__device__ __forceinline__ void live_scatter(float* w, const float* sv,
                                             const int* si, const Piece& q,
                                             float g, int lane) {
  for (int k0 = lane; k0 < q.count; k0 += 4 * 32) {
    float v[4];
    int j[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + 32 * c;
      v[c] = k < q.count ? sv[q.vofs + k] : 0.0f;
      j[c] = k < q.count ? si[q.iofs + k] : 0;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (v[c] != 0.0f) atomicAdd(&w[j[c]], g * v[c]);
  }
}

// A piece's margin against the model in shared memory, on every lane: four
// passes' values and indices loaded before any gather, so a row of up to
// 128 entries costs one round of dependent loads.
__device__ __forceinline__ float live_margin(const float* w, const float* sv,
                                            const int* si, const Piece& q,
                                            int lane) {
  float acc = 0.0f;
  for (int k0 = lane; k0 < q.count; k0 += 4 * 32) {
    float v[4];
    int j[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + 32 * c;
      v[c] = k < q.count ? sv[q.vofs + k] : 0.0f;
      j[c] = k < q.count ? si[q.iofs + k] : 0;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc = fmaf(v[c], v[c] != 0.0f ? w[j[c]] : 0.0f, acc);
  }
  return repro::warp_sum(acc);
}

// The model in shared memory (real-sim's rows past the warp kernel's 512
// entries).  A fill holds whole batches one after another (or part of one
// batch); a batch of one row is warp 0's alone, its margin, pull and
// scatter with no block barrier; a longer batch is a piece a chain warp,
// its margins, a barrier, its scatter, a barrier (live_scatter).
__global__ void __launch_bounds__(32 * (kLiveSmemChain + 1), 1)
ell_sgd_live_smem_kernel(const float* __restrict__ vals,  // [R, n, K]
                         const int* __restrict__ idx,     // [R, n, K]
                         const float* __restrict__ y,     // [R, n]
                         float* __restrict__ W,           // [R, d] in/out
                         const int* __restrict__ len,     // [R, n]
                         int n, int K, int d, int mb, int task, float scale,
                         float tail_scale, int stages, int words) {
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);
  uint64_t* empty = full + stages;
  float* w = reinterpret_cast<float*>(empty + stages);  // [pad4(d)]
  float* pl = w + pad4(d);  // [pad4(mb)]: a batch's margins, then pulls
  unsigned char* ring = reinterpret_cast<unsigned char*>(pl + pad4(mb));
  const size_t sb = live_stage_bytes(words);

  const int r = blockIdx.x;
  const float* Vr = vals + static_cast<size_t>(r) * n * K;
  const int* Ir = idx + static_cast<size_t>(r) * n * K;
  float* Wr = W + static_cast<size_t>(r) * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  live_init(full, empty, stages);
  for (int j = threadIdx.x; j < d; j += blockDim.x) w[j] = Wr[j];
  __syncthreads();

  if (warp == kLiveSmemChain) {
    LiveRows rows{len + static_cast<size_t>(r) * n,
                  y + static_cast<size_t>(r) * n, n};
    live_produce(Vr, Ir, rows, n, K, mb, true, ring, full, empty, stages,
                 words, lane);
  } else {
    int s = 0;
    uint32_t parity = 0;
    for (;;) {
      mbar_wait_or_trap(&full[s], parity);
      const unsigned char* st = ring + s * sb;
      const int4 h = *reinterpret_cast<const int4*>(st);
      if (h.y == kPassDone) break;
      const Piece* pc = reinterpret_cast<const Piece*>(st + 16);
      const float* sv = reinterpret_cast<const float*>(pc + kLivePieces);
      const int* si = reinterpret_cast<const int*>(sv + words);
      // the chain's last step was a barrier (as every fill's is)
      bool synced = true;
      for (int p0 = 0; p0 < h.x;) {
        // the batch's pieces [p0, p1): up to the first of another batch
        const int id = p0 + lane < h.x ? pc[p0 + lane].batch : -1;
        const unsigned other = __ballot_sync(
            repro::kFullMask, id != __shfl_sync(repro::kFullMask, id, 0));
        // (lanes past h.x differ; all 32 of one batch: the fill's end)
        const int p1 = other ? p0 + __ffs(other) - 1 : h.x;
        const float step = pc[p0].flags & kTail ? tail_scale : scale;
        if (p1 - p0 == 1 && h.y == kPassBoth) {
          if (warp == 0) {
            const Piece q = pc[p0];
            const float m = live_margin(w, sv, si, q, lane);
            const float g = -step * repro::pull(task, q.y * m, q.y);
            if (g != 0.0f) live_scatter(w, sv, si, q, g, lane);
            __syncwarp();  // the scatter before the next batch's gathers
          }
          synced = false;
        } else {
          if (!synced) live_sync<kLiveSmemChain>();  // warp 0's batches land
          if (h.y != kPassScatter) {
            for (int p = p0 + warp; p < p1; p += kLiveSmemChain) {
              const Piece q = pc[p];
              const float acc = live_margin(w, sv, si, q, lane);
              if (lane == 0) {
                const float m = (q.flags & kFirst ? 0.0f : pl[q.row]) + acc;
                pl[q.row] = q.flags & kLast
                                ? -step * repro::pull(task, q.y * m, q.y)
                                : m;
              }
            }
            live_sync<kLiveSmemChain>();  // every margin before any scatter
          }
          if (h.y != kPassMargins) {
            for (int p = p0 + warp; p < p1; p += kLiveSmemChain) {
              const Piece q = pc[p];
              const float g = pl[q.row];
              if (g != 0.0f) live_scatter(w, sv, si, q, g, lane);
            }
            live_sync<kLiveSmemChain>();  // the scatter before the next gathers
          }
          synced = true;
        }
        p0 = p1;
      }
      if (!synced) live_sync<kLiveSmemChain>();  // every warp is done with it
      if (threadIdx.x == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) Wr[j] = w[j];
}

// Entries a chain thread of the global-memory kernel gathers before it
// uses any: one trip to L2 for up to this many of a piece's entries.
constexpr int kLiveGather = 4;

// The model in global memory (news): every chain thread takes entries t,
// t + 512, ... of each piece, gathers them from L2 (__ldcg: L1 does not see
// the scatter's atomics), the pieces' partial margins meet in shared
// memory, every warp sums them in warp order (lane p: piece p), and the
// scatter is RED.ADD.F32 in L2.
__global__ void __launch_bounds__(32 * (kLiveGlobalChain + 1), 1)
ell_sgd_live_global_kernel(const float* __restrict__ vals,  // [R, n, K]
                           const int* __restrict__ idx,     // [R, n, K]
                           const float* __restrict__ y,     // [R, n]
                           float* __restrict__ W,           // [R, d] in/out
                           const int* __restrict__ len,     // [R, n]
                           int n, int K, int d, int mb, int task, float scale,
                           float tail_scale, int stages, int words) {
  constexpr int T = 32 * kLiveGlobalChain;
  extern __shared__ __align__(16) unsigned char raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);
  uint64_t* empty = full + stages;
  float* part = reinterpret_cast<float*>(empty + stages);  // [32][16]
  float* pl = part + kLivePieces * kLiveGlobalChain;        // [pad4(mb)]
  unsigned char* ring = reinterpret_cast<unsigned char*>(pl + pad4(mb));
  const size_t sb = live_stage_bytes(words);

  const int r = blockIdx.x;
  const float* Vr = vals + static_cast<size_t>(r) * n * K;
  const int* Ir = idx + static_cast<size_t>(r) * n * K;
  float* Wr = W + static_cast<size_t>(r) * d;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;

  live_init(full, empty, stages);
  __syncthreads();

  if (warp == kLiveGlobalChain) {
    LiveRows rows{len + static_cast<size_t>(r) * n,
                  y + static_cast<size_t>(r) * n, n};
    live_produce(Vr, Ir, rows, n, K, mb, false, ring, full, empty, stages,
                 words, lane);
    return;
  }
  int s = 0;
  uint32_t parity = 0;
  for (;;) {
    mbar_wait_or_trap(&full[s], parity);
    const unsigned char* st = ring + s * sb;
    const int4 h = *reinterpret_cast<const int4*>(st);
    if (h.y == kPassDone) break;
    const Piece* pc = reinterpret_cast<const Piece*>(st + 16);
    const float* sv = reinterpret_cast<const float*>(pc + kLivePieces);
    const int* si = reinterpret_cast<const int*>(sv + words);
    // a fill holds one batch, or part of one
    const float step = h.x && pc[0].flags & kTail ? tail_scale : scale;
    float g = 0.0f;  // lane p: -step * the pull of piece p (a row's last)
    if (h.y != kPassScatter) {
      for (int p = 0; p < h.x; ++p) {
        const Piece q = pc[p];
        float acc = 0.0f;
        for (int k0 = t; k0 < q.count; k0 += kLiveGather * T) {
          float v[kLiveGather], wv[kLiveGather];
          int j[kLiveGather];
#pragma unroll
          for (int c = 0; c < kLiveGather; ++c) {
            const int k = k0 + c * T;
            v[c] = k < q.count ? sv[q.vofs + k] : 0.0f;
            j[c] = k < q.count ? si[q.iofs + k] : 0;
          }
#pragma unroll
          for (int c = 0; c < kLiveGather; ++c)
            wv[c] = v[c] != 0.0f ? __ldcg(Wr + j[c]) : 0.0f;
#pragma unroll
          for (int c = 0; c < kLiveGather; ++c) acc = fmaf(v[c], wv[c], acc);
        }
        acc = repro::warp_sum(acc);
        if (lane == 0) part[p * kLiveGlobalChain + warp] = acc;
      }
      live_sync<kLiveGlobalChain>();
      // a fill of whole rows: every warp sums every piece (lane p) and
      // keeps its pull; a batch's margins over several fills: warp 0 adds
      // them up in the batch's pulls
      if (lane < h.x && (h.y == kPassBoth || warp == 0)) {
        const Piece q = pc[lane];
        float m = q.flags & kFirst ? 0.0f : pl[q.row];
#pragma unroll
        for (int c = 0; c < kLiveGlobalChain; ++c)
          m += part[lane * kLiveGlobalChain + c];
        if (q.flags & kLast) g = -step * repro::pull(task, q.y * m, q.y);
        if (h.y == kPassMargins) pl[q.row] = q.flags & kLast ? g : m;
      }
    }
    if (h.y != kPassMargins) {
      for (int p = 0; p < h.x; ++p) {
        const float gp = h.y == kPassBoth
                             ? __shfl_sync(repro::kFullMask, g, p)
                             : pl[pc[p].row];
        if (gp == 0.0f) continue;
        const Piece q = pc[p];
        for (int k = t; k < q.count; k += T) {
          const float v = sv[q.vofs + k];
          if (v != 0.0f) atomicAdd(Wr + si[q.iofs + k], gp * v);
        }
      }
    }
    // the scatter lands before the next gathers; the partials and the
    // stage are free again
    live_sync<kLiveGlobalChain>();
    if (t == 0) mbar_arrive(&empty[s]);
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
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

// ell_live_length_kernel alone: len[i] = 1 + the position of row i's last
// nonzero value (0 for a row of padding); vals contiguous [rows, K] fp32,
// len int32 [rows].
extern "C" int ell_live_lengths(const void* vals, int rows, int K, void* len,
                                void* stream) {
  if (rows < 1) return static_cast<int>(cudaSuccess);
  ell_live_length_kernel<<<(rows + kLiveLengthWarps - 1) / kLiveLengthWarps,
                           32 * kLiveLengthWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), rows, K, static_cast<int*>(len));
  return static_cast<int>(cudaGetLastError());
}

// The live-prefix epoch: the length pass over every row of every replica
// into `len` (int32 [R, n] scratch), then ell_sgd_live_smem_kernel
// (smem_model != 0: the model and the batch's pulls in shared memory) or
// ell_sgd_live_global_kernel, with a ring of `stages` stages of `words`
// words (kernels/glm_sgd_sparse/ops.py:live_plan checks that it fits).
// vals, idx, y contiguous [R, n, K] fp32, [R, n, K] int32 and [R, n] fp32;
// W [R, d] updated in place.
extern "C" int ell_sgd_epoch_live(const void* vals, const void* idx,
                                  const void* y, void* W, void* len, int R,
                                  int n, int K, int d, int mb, int task,
                                  float scale, float tail_scale, int stages,
                                  int words, int smem_model, void* stream) {
  if (stages < 2 || words < 4 || words % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int code = ell_live_lengths(vals, R * n, K, len, stream);
  if (code != 0) return code;
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = smem_model ? ell_sgd_live_smem_kernel
                           : ell_sgd_live_global_kernel;
  const int threads =
      32 * ((smem_model ? kLiveSmemChain : kLiveGlobalChain) + 1);
  const size_t smem = live_smem_bytes(d, mb, stages, words, smem_model);
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<R, threads, smem, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(y), static_cast<float*>(W),
      static_cast<const int*>(len), n, K, d, mb, task, scale, tail_scale,
      stages, words);
  return static_cast<int>(cudaGetLastError());
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
