// glm_sparse: the sum gradient on padded-ELL data, for R replicas.
//
// Replaces: ell_glm_grad_pallas (src/repro/kernels/glm_sparse/kernel.py:108,
//   body _kernel l.46), a two-phase sequential grid (margins over d-blocks,
//   then pull and one-hot scatter) that keeps its gather and scatter on the
//   MXU because a TPU core has no fast random access into VMEM.
//
// What bounds it on the H100: bytes, as long as the atomics keep up.  The
//   ELL arrays are read once (w8a: 64,700 x 69 values and indices, 35.7 MB,
//   about 11 us at 3.35 TB/s); the scatter is one atomic per nonzero, and a
//   Zipf-popular feature takes a sizeable share of them on one address.
//
// Design: one launch.  A warp per row gathers w[idx] from global memory
//   (the model is small and stays in L1/L2), sums the margin with shuffles,
//   applies the pull, and atomicAdds vals * pull into the zeroed gradient
//   the caller passes.  Entries whose value is 0 (the padding) are skipped.
//   Indices are not range-checked here: the wrapper has checked the
//   operand once before its first launch.
//   The replica axis is blockIdx.y, for the async full-partition path.
//   The model lives in global memory, so d has no limit but device memory
//   (news runs).
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
