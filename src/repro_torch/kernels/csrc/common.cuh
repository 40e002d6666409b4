// Helpers shared by the GLM kernels: the per-example pull, warp sums and the
// C-side launch status.  Included by every csrc/*.cu; each source is built
// into its own shared library (kernels/_build.py).
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kTaskLR = 0;   // logistic regression
constexpr int kTaskSVM = 1;  // linear SVM (hinge)
constexpr unsigned kFullMask = 0xffffffffu;

// Sum over the 32 lanes of a warp; every lane receives the total.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The scalar that multiplies x_i in the gradient, from the margin
// m = y * x.w: LR -y * sigmoid(-m), SVM -y * [m < 1]
// (repro_torch/core/glm.py PULLS).
__device__ __forceinline__ float pull(int task, float margin, float y) {
  if (task == kTaskLR) return -y * (1.0f / (1.0f + expf(margin)));
  return margin < 1.0f ? -y : 0.0f;
}

// Opt a kernel into `bytes` of dynamic shared memory (needed above 48 KB).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
