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
//   11 us at 3.35 TB/s.
//
// Design: one block per replica (blockIdx.x), the model in dynamic shared
//   memory.  Per micro-batch a warp per row gathers w[idx] straight from
//   shared memory and sums the margin with shuffles; after a barrier (all
//   margins of the batch see the same w — the semantics of
//   sparse.minibatch_epoch) the block scatters -(alpha/|B|) * vals * pull
//   with shared-memory atomicAdd.  Entries whose value is 0 are skipped:
//   they are the index-0 padding, and would otherwise pile atomics onto
//   w[0].  Indices are not range-checked here: the wrapper has checked
//   the operand once before its first launch.  The model must fit in shared memory next to the pulls: d up to
//   about 58,000 (rcv1's 47,236 fits, news' 1,355,191 does not; the caller
//   raises before launch).
#include "common.cuh"

namespace {

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

}  // namespace

extern "C" int ell_sgd_epoch(const void* vals, const void* idx, const void* y,
                             void* W, int R, int n, int K, int d, int mb, int task,
                             float scale, float tail_scale, void* stream) {
  const size_t smem = static_cast<size_t>(d + mb) * sizeof(float);
  cudaError_t err = repro::allow_smem(ell_sgd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ell_sgd_kernel<<<R, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(y), static_cast<float*>(W), n, K, d, mb, task,
      scale, tail_scale);
  return static_cast<int>(cudaGetLastError());
}
