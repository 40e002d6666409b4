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
// Two kernels, chosen by kernels/glm_sparse/ops.py:variant(d, K, R):
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
// ell_grad_kernel (any wider model: news, d = 1,355,191).  A warp per row
//   gathers w[idx] from global memory, sums the margin with shuffles,
//   applies the pull, and atomicAdds vals * pull into the zeroed gradient
//   the caller passes (one atomic per nonzero, in an order that changes
//   from run to run).
//
// Both: indices are not range-checked here (the wrapper has checked the
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

}  // namespace

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
