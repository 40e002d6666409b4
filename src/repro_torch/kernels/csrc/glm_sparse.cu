// glm_sparse: the sum gradient on padded-ELL data, for R replicas.
//
// Replaces: ell_glm_grad_pallas (src/repro/kernels/glm_sparse/kernel.py:108,
//   body _kernel l.46), a two-phase sequential grid (margins over d-blocks,
//   then pull and one-hot scatter) that keeps its gather and scatter on the
//   MXU because a TPU core has no fast random access into VMEM.
//
// What bounds it on the H100: bytes.  The ELL values are read once and the
//   index of each nonzero once (w8a: 64,700 x 69 values and 754k indices,
//   21 MB, about 6.3 us at 3.35 TB/s); the model is small and stays in L1.
//
// Three kernels, chosen by kernels/glm_sparse/ops.py:variant(d, K, R):
//
// ell_grad_smem_kernel (a model of up to about 29,000 features: at least two
//   warps' copies of the gradient fit a block's shared memory).  Partial
//   gradients in shared memory, no atomics:
//   - persistent blocks, up to 4 a SM (ops.py:smem_plan), each walking a
//     contiguous run of its replica's rows; the replica axis is the grid's
//     second, so replicas keep separate partials;
//   - a group of G lanes owns a row (G of 4, 8, 16 or 32: the one that
//     leaves the fewest padded slots, the wider on a tie, ops.py:smem_lanes;
//     w8a's K = 69 runs 9 passes of 8 lanes, 72 slots, not 3 of 32 whose
//     last has 5 live), so a warp takes 32 / G rows at a time; a lane loads
//     its row's values 12 at a time, then the indices of the nonzeros, then
//     the model entries, each batch of loads issued together; value-0
//     entries (the padding) load no index;
//   - each warp adds x_ij * pull_i into its own copy of the gradient in
//     shared memory.  A row may repeat a feature, and the rows of a warp
//     share the popular ones: __match_any_sync groups the lanes of a pass
//     that hold the same feature, and the group's lowest lane adds their
//     contributions in lane order; a __syncwarp between passes orders the
//     passes' writes;
//   - the block adds its warps' copies in warp order and writes one partial
//     row; ell_grad_reduce_kernel sums a replica's partials in a fixed
//     order.  So every call gives the same bits.
//
// ell_grad_kernel (the first port; a wider model that the hot kernel does
//   not take: rows past its HOT_MAX_K entries).  A warp per row
//   gathers w[idx] from global memory, sums the margin with shuffles,
//   applies the pull, and atomicAdds vals * pull into the zeroed gradient
//   the caller passes (one atomic per nonzero, in an order that changes
//   from run to run).
//
// ell_grad_hot_kernel (past the smem kernel's width, rows of up to
//   ops.py:HOT_MAX_K entries: rcv1, d = 47,236, and news, d = 1,355,191;
//   it replaces ell_grad_kernel there, which read every value and nonzero
//   index twice, once for the margin and once for the scatter, and whose
//   global atomics on the Zipf-popular features queued at L2):
//   - one pass: a warp a row (a row of these widths has hundreds of
//     entries), 32 warps a block, one block a SM; lane l holds entries
//     l + 32 e (e < E) of its row in registers, values and the indices of
//     its nonzeros, from the margin to the scatter, so the data is read
//     once; value-0 entries (the padding, wherever it lies in the row) load
//     no index and add nothing.  Entries past the registers are read in
//     chunks of 256 for the margin, and a lane marks each chunk that held a
//     nonzero of its own; the scatter reads again only the marked chunks
//     (news's rows of up to 2,729 entries, most of them padding, are read
//     once).  A row whose pull is 0 (an SVM margin past 1) scatters
//     nothing;
//   - the gradient in global memory (L2 holds news's 5.4 MB), zeroed by the
//     caller, under RED.ADD.F32, except its `hot` most frequent features
//     (ops.py:hot_features, counted once an operand), which each block adds
//     into its own copy in shared memory with atomicAdd and writes as one
//     partial row; ell_grad_hot_sum_kernel adds a replica's partials in a
//     fixed order into the gradient's hot entries, which took no global
//     add.  Without it a Zipfian feature takes a global atomic from a large
//     share of the rows (news's hottest: about 7% of the entries), and
//     those queue at L2 (PERF.md, tools/wide_sweep.py).
//   A cluster-resident gradient (a thread-block cluster's shared memory
//   holding all of d, each add sent to the owner block with
//   red.shared::cluster.add.f32 or a compare-and-swap loop) was built and
//   measured slower than this at rcv1's and w8a's shapes, and was removed.
//
// All: indices are not range-checked here (the wrapper has checked the
//   operand once before its first launch); the replica axis is blockIdx.y,
//   for the async full-partition path.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void ell_grad_kernel(const float* __restrict__ vals,  // [R, n, K]
                                const int* __restrict__ idx,     // [R, n, K]
                                const float* __restrict__ y,     // [R, n]
                                const float* __restrict__ W,     // [R, d]
                                float* __restrict__ G,           // [R, d], zeroed
                                int n, int K, int d, int task) {
  const int r = blockIdx.y;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warp leaves together

  const size_t off = (static_cast<size_t>(r) * n + row) * K;
  const float* wr = W + static_cast<size_t>(r) * d;
  float* gr = G + static_cast<size_t>(r) * d;
  float acc = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float v = vals[off + k];
    const int j = idx[off + k];
    if (v != 0.0f) acc += v * wr[j];
  }
  acc = repro::warp_sum(acc);
  const float yi = y[static_cast<size_t>(r) * n + row];
  const float p = repro::pull(task, yi * acc, yi);
  for (int k = lane; k < K; k += 32) {
    const float v = vals[off + k];
    const int j = idx[off + k];
    if (v != 0.0f) atomicAdd(&gr[j], v * p);
  }
}

// ---------------------------------------------------------------------------
// The shared-memory kernel
// ---------------------------------------------------------------------------

constexpr int kChunk = 12;  // a row's entries a lane loads at once
constexpr int kBlocksPerSM = 4;  // the register budget the kernel keeps to

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// Loads entries k0 + c * G + gl (c < kChunk) of a row: values, then the
// index of each nonzero (0 elsewhere).
template <int G>
__device__ __forceinline__ void load_chunk(const float* __restrict__ v_row,
                                           const int* __restrict__ i_row,
                                           int k0, int gl, int K, bool live,
                                           float (&v)[kChunk],
                                           int (&j)[kChunk]) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int k = k0 + c * G + gl;
    v[c] = live && k < K ? __ldg(v_row + k) : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kChunk; ++c)
    j[c] = v[c] != 0.0f ? __ldg(i_row + k0 + c * G + gl) : 0;
}

// G lanes a row; blockDim.x = 32 * warps; per_block rows a block
template <int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ell_grad_smem_kernel(const float* __restrict__ vals,  // [R, n, K]
                     const int* __restrict__ idx,     // [R, n, K]
                     const float* __restrict__ y,     // [R, n]
                     const float* __restrict__ W,     // [R, d]
                     float* __restrict__ partial,     // [R, gridDim.x, d]
                     int n, int K, int d, int task, int per_block) {
  extern __shared__ float gs[];  // [warps][pad4(d)] copies, [warps][32] scratch
  const int warps = blockDim.x / 32, dp = pad4(d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gl = lane % G, slot = lane / G;
  constexpr int kRows = 32 / G;  // rows a warp takes at a time
  const int r = blockIdx.y;
  const float* vr = vals + static_cast<size_t>(r) * n * K;
  const int* ir = idx + static_cast<size_t>(r) * n * K;
  const float* yr = y + static_cast<size_t>(r) * n;
  const float* wr = W + static_cast<size_t>(r) * d;
  float* gw = gs + warp * dp;
  float* sc = gs + warps * dp + warp * 32;

  for (int e = tid; e < warps * dp; e += blockDim.x) gs[e] = 0.0f;
  __syncthreads();

  const int start = blockIdx.x * per_block, end = min(n, start + per_block);
  for (int base = start + warp * kRows; base < end; base += warps * kRows) {
    const int row = base + slot;
    const bool live = row < end;
    const size_t off = static_cast<size_t>(live ? row : start) * K;
    float v[kChunk];
    int j[kChunk];
    float acc = 0.0f;
    for (int k0 = 0; k0 < K; k0 += G * kChunk) {
      load_chunk<G>(vr + off, ir + off, k0, gl, K, live, v, j);
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (v[c] != 0.0f) acc = fmaf(v[c], __ldg(wr + j[c]), acc);
    }
    // every lane of the warp reaches the shuffles; xor offsets below G stay
    // inside the row's group
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(repro::kFullMask, acc, o);
    const float yi = live ? yr[row] : 0.0f;
    const float p = live ? repro::pull(task, yi * acc, yi) : 0.0f;

    // scatter, a pass of G entries a row at a time, every lane in step
    for (int k0 = 0; k0 < K; k0 += G * kChunk) {
      load_chunk<G>(vr + off, ir + off, k0, gl, K, live && p != 0.0f, v, j);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const bool on = v[c] != 0.0f;
        if (!__any_sync(repro::kFullMask, on)) continue;
        // lanes with nothing to add get a key no other lane holds
        const int key = on ? j[c] : -1 - lane;
        const unsigned same = __match_any_sync(repro::kFullMask, key);
        const bool grouped = on && same != (1u << lane);
        const float add = v[c] * p;
        if (grouped) sc[lane] = add;
        __syncwarp();
        if (on && lane == __ffs(same) - 1) {
          float sum = add;
          if (grouped) {
            sum = 0.0f;
            for (unsigned m = same; m; m &= m - 1) sum += sc[__ffs(m) - 1];
          }
          gw[key] += sum;
        }
        __syncwarp();  // this pass's adds land before the next pass reads
      }
    }
  }
  __syncthreads();

  float* out = partial + (static_cast<size_t>(r) * gridDim.x + blockIdx.x) * d;
  for (int f = tid; f < d; f += blockDim.x) {
    float sum = 0.0f;
    for (int q = 0; q < warps; ++q) sum += gs[q * dp + f];
    out[f] = sum;
  }
}

// G[r, f] = sum over p of partial[r, p, f]: a block per (feature, replica),
// a fixed order
__global__ void ell_grad_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ G, int nparts,
                                       int d) {
  __shared__ float red[kThreads];
  const int f = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const float* pr = partial + static_cast<size_t>(r) * nparts * d;
  float acc = 0.0f;
  for (int p = tid; p < nparts; p += kThreads) acc += pr[static_cast<size_t>(p) * d + f];
  red[tid] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) G[static_cast<size_t>(r) * d + f] = red[0];
}

template <int G>
int launch_smem(const float* vals, const int* idx, const float* y,
                const float* W, float* partial, int R, int n, int K, int d,
                int task, int warps, int per_block, int blocks,
                cudaStream_t stream) {
  auto kernel = ell_grad_smem_kernel<G>;
  const size_t smem = 4 * static_cast<size_t>(warps) * (pad4(d) + 32);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks, R), 32 * warps, smem, stream>>>(
      vals, idx, y, W, partial, n, K, d, task, per_block);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The hot kernel
// ---------------------------------------------------------------------------

constexpr int kHotWarps = 32;
constexpr int kHotThreads = 32 * kHotWarps;
// entries a lane reads at once past its registers' (E, at most 8: fewer
// registers live beside the row's held entries), in chunks of 32 of them,
// each marked by a bit of a 64-bit word
constexpr int kRestE = 8;
constexpr int kMarkedChunks = 64;
constexpr size_t kMaxSmemBytes = 232448;  // a Hopper block's opt-in limit

// Entries k0 + lane + 32 e (e < E) of a row: values (0 past K), then the
// index of each nonzero (0 elsewhere); whether any of them is nonzero.
template <int E>
__device__ __forceinline__ bool load_entries(const float* __restrict__ v_row,
                                             const int* __restrict__ i_row,
                                             int k0, int lane, int K,
                                             float (&v)[E], int (&j)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = k0 + lane + 32 * e;
    v[e] = k < K ? __ldcs(v_row + k) : 0.0f;
  }
  bool any = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    any |= v[e] != 0.0f;
    j[e] = v[e] != 0.0f ? __ldcs(i_row + k0 + lane + 32 * e) : 0;
  }
  return any;
}

// E: entries of a row a lane holds in registers.  G [R, d] zeroed by the
// caller; its `hot` features (slot[j] >= 0: j's place among them) go to the
// block's shared copy, written into hot_out [R, blocks, hot].  The grid is
// (blocks, R); block b walks rows [b * per_block, (b + 1) * per_block), a
// warp every 32nd.
template <int E>
__global__ void __launch_bounds__(kHotThreads, 1)
ell_grad_hot_kernel(const float* __restrict__ vals,  // [R, n, K]
                    const int* __restrict__ idx,     // [R, n, K]
                    const float* __restrict__ y,     // [R, n]
                    const float* __restrict__ W,     // [R, d]
                    float* __restrict__ G,           // [R, d], zeroed
                    const int* __restrict__ slot,    // [d]
                    float* __restrict__ hot_out, int hot, int n, int K,
                    int d, int task, int per_block) {
  extern __shared__ float gs[];  // [hot]
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* vr = vals + static_cast<size_t>(r) * n * K;
  const int* ir = idx + static_cast<size_t>(r) * n * K;
  const float* yr = y + static_cast<size_t>(r) * n;
  const float* wr = W + static_cast<size_t>(r) * d;
  float* gr = G + static_cast<size_t>(r) * d;
  for (int f = threadIdx.x; f < hot; f += kHotThreads) gs[f] = 0.0f;
  __syncthreads();
  auto add = [&](int j, float v) {
    const int s = __ldg(slot + j);
    if (s >= 0) atomicAdd(gs + s, v);
    else atomicAdd(gr + j, v);
  };

  const int start = blockIdx.x * per_block, end = min(n, start + per_block);
  for (int row = start + warp; row < end; row += kHotWarps) {
    const float* v_row = vr + static_cast<size_t>(row) * K;
    const int* i_row = ir + static_cast<size_t>(row) * K;
    float v[E];
    int j[E];
    load_entries<E>(v_row, i_row, 0, lane, K, v, j);
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (v[e] != 0.0f) acc = fmaf(v[e], __ldg(wr + j[e]), acc);
    // bit c: chunk c past the registers held a nonzero of this lane
    unsigned long long marked = 0;
    constexpr int kR = E < kRestE ? E : kRestE;
    for (int c = 0, k0 = 32 * E; k0 < K; ++c, k0 += 32 * kR) {
      float u[kR];
      int q[kR];
      if (load_entries<kR>(v_row, i_row, k0, lane, K, u, q))
        marked |= 1ull << c;
#pragma unroll
      for (int e = 0; e < kR; ++e)
        if (u[e] != 0.0f) acc = fmaf(u[e], __ldg(wr + q[e]), acc);
    }
    acc = repro::warp_sum(acc);  // the same bits on every lane
    const float yi = yr[row];
    const float p = repro::pull(task, yi * acc, yi);
    if (p == 0.0f) continue;  // the whole warp: nothing to add
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (v[e] != 0.0f) add(j[e], v[e] * p);
    for (int c = 0, k0 = 32 * E; c < kMarkedChunks && (marked >> c);
         ++c, k0 += 32 * kR) {
      if (!((marked >> c) & 1ull)) continue;
      float u[kR];
      int q[kR];
      load_entries<kR>(v_row, i_row, k0, lane, K, u, q);
#pragma unroll
      for (int e = 0; e < kR; ++e)
        if (u[e] != 0.0f) add(q[e], u[e] * p);
    }
  }
  __syncthreads();
  float* po = hot_out + (static_cast<size_t>(r) * gridDim.x + blockIdx.x) * hot;
  for (int f = threadIdx.x; f < hot; f += kHotThreads) po[f] = gs[f];
}

// G[r, hot_list[s]] = sum over b of hot_out[r, b, s], b in order (the hot
// features took no global add, so this writes their whole gradient)
__global__ void ell_grad_hot_sum_kernel(const float* __restrict__ hot_out,
                                        const int* __restrict__ hot_list,
                                        float* __restrict__ G, int nparts,
                                        int hot, int d) {
  const int s = blockIdx.x * kThreads + threadIdx.x, r = blockIdx.y;
  if (s >= hot) return;
  const float* pr = hot_out + static_cast<size_t>(r) * nparts * hot + s;
  float acc = 0.0f;
  for (int p = 0; p < nparts; ++p)
    acc += __ldcs(pr + static_cast<size_t>(p) * hot);
  G[static_cast<size_t>(r) * d + hot_list[s]] = acc;
}

template <int E>
int launch_hot(const float* vals, const int* idx, const float* y,
               const float* W, float* G, const int* slot, float* hot_out,
               int hot, int R, int n, int K, int d, int task, int blocks,
               int per_block, cudaStream_t stream) {
  auto kernel = ell_grad_hot_kernel<E>;
  const size_t smem = 4 * static_cast<size_t>(hot);
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks, R), kHotThreads, smem, stream>>>(
      vals, idx, y, W, G, slot, hot_out, hot, n, K, d, task, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ell_grad_hot_kernel (ops.py:hot_plan): `blocks` blocks a replica of
// `per_block` rows scattering into G, which the caller zeroed, the `hot`
// features of hot_list (slot[j]: j's place in it, or -1; 1 to 58,112 of
// them) in each block's shared memory, then ell_grad_hot_sum_kernel adds
// them into G through hot_out [R, blocks, hot].
extern "C" int ell_glm_grad_hot(const void* vals, const void* idx,
                                const void* y, const void* W, void* G,
                                const void* slot, const void* hot_list,
                                void* hot_out, int hot, int R, int n, int K,
                                int d, int task, int blocks, int per_block,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* i = static_cast<const int*>(idx);
  const auto* yf = static_cast<const float*>(y);
  const auto* Wf = static_cast<const float*>(W);
  auto* Gf = static_cast<float*>(G);
  const auto* sl = static_cast<const int*>(slot);
  auto* ho = static_cast<float*>(hot_out);
  if (blocks < 1 || per_block < 1 || hot < 1 || hot > d ||
      4 * static_cast<size_t>(hot) > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (K <= 32 * 4)
    err = launch_hot<4>(v, i, yf, Wf, Gf, sl, ho, hot, R, n, K, d, task,
                        blocks, per_block, s);
  else if (K <= 32 * 8)
    err = launch_hot<8>(v, i, yf, Wf, Gf, sl, ho, hot, R, n, K, d, task,
                        blocks, per_block, s);
  else if (K <= 32 * (16 + kRestE * kMarkedChunks))
    err = launch_hot<16>(v, i, yf, Wf, Gf, sl, ho, hot, R, n, K, d, task,
                         blocks, per_block, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return err;
  ell_grad_hot_sum_kernel<<<dim3((hot + kThreads - 1) / kThreads, R),
                            kThreads, 0, s>>>(
      ho, static_cast<const int*>(hot_list), Gf, blocks, hot, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ell_glm_grad(const void* vals, const void* idx, const void* y,
                            const void* W, void* G, int R, int n, int K, int d,
                            int task, void* stream) {
  const dim3 grid((n + kThreads / 32 - 1) / (kThreads / 32), R);
  ell_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(y), static_cast<const float*>(W),
      static_cast<float*>(G), n, K, d, task);
  return static_cast<int>(cudaGetLastError());
}

// ell_grad_smem_kernel with G lanes a row (4, 8, 16 or 32), `warps` warps
// (1 to 8) and `blocks` blocks of `per_block` rows a replica
// (ops.py:smem_plan) into partial [R, blocks, d], then the reduce into G.
extern "C" int ell_glm_grad_smem(const void* vals, const void* idx,
                                 const void* y, const void* W, void* partial,
                                 void* G, int R, int n, int K, int d, int task,
                                 int lanes, int warps, int per_block,
                                 int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* i = static_cast<const int*>(idx);
  const auto* yf = static_cast<const float*>(y);
  const auto* Wf = static_cast<const float*>(W);
  auto* pf = static_cast<float*>(partial);
  if (warps < 1 || warps > kThreads / 32 || per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (lanes) {
    case 4: err = launch_smem<4>(v, i, yf, Wf, pf, R, n, K, d, task, warps, per_block, blocks, s); break;
    case 8: err = launch_smem<8>(v, i, yf, Wf, pf, R, n, K, d, task, warps, per_block, blocks, s); break;
    case 16: err = launch_smem<16>(v, i, yf, Wf, pf, R, n, K, d, task, warps, per_block, blocks, s); break;
    case 32: err = launch_smem<32>(v, i, yf, Wf, pf, R, n, K, d, task, warps, per_block, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return err;
  ell_grad_reduce_kernel<<<dim3(d, R), kThreads, 0, s>>>(
      pf, static_cast<float*>(G), blocks, d);
  return static_cast<int>(cudaGetLastError());
}
