// glm_sgd: one fused mini-batch SGD epoch on dense data, for R replicas.
//
// Replaces: glm_sgd_pallas (src/repro/kernels/glm_sgd/kernel.py:73, body
//   _kernel l.39) — for each [MB, d] tile in order, m = y * (X_k w), then
//   w -= (alpha/MB) * X_k^T pull(m), the model resident for the whole epoch.
//
// What bounds it on the H100: not bytes and not operations but the chain of
//   dependent updates.  Each micro-batch reads the model its predecessor
//   wrote, so one replica's epoch is ceil(n/MB) steps in sequence, each a
//   global-memory load of an [MB, d] tile, a reduction and two block
//   barriers.  covtype at MB=16 is 36,314 steps on one SM; the bytes alone
//   (125.5 MB of X) would take about 38 us at 3.35 TB/s.
//
// Design: one block per replica (blockIdx.x; R = 1 for SyncSGD), the model
//   in dynamic shared memory for the whole epoch and written back once.  Per
//   micro-batch a warp per row computes the margin with a shuffle sum and
//   writes the pull into shared memory; after a barrier each thread updates
//   its features with the tile's X^T pull.  A ragged tail is one final
//   smaller batch at its own scale alpha/|tail| (glm_sgd/ref.py).  The step
//   arrives as a runtime float (scale = alpha/MB computed by the caller).
#include "common.cuh"

namespace {

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

}  // namespace

extern "C" int glm_sgd_epoch(const void* X, const void* y, void* W, int R, int n,
                             int d, int mb, int task, float scale,
                             float tail_scale, void* stream) {
  const size_t smem = static_cast<size_t>(d + mb) * sizeof(float);
  cudaError_t err = repro::allow_smem(glm_sgd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  glm_sgd_kernel<<<R, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<float*>(W), n, d, mb, task, scale, tail_scale);
  return static_cast<int>(cudaGetLastError());
}
