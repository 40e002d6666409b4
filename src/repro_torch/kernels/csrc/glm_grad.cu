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
//   allocates, and a second launch (glm_grad_reduce) sums the partials of
//   each feature in a fixed order, so the result is deterministic.
//   * row: X is [N, d]; a block takes 256 rows, a warp per row computes the
//     margin and pull into shared memory, then the block's threads split
//     the rows into groups, each thread summing one feature over its group,
//     and the groups are added in order: one partial row per block.
//   * col: X is [d, N] (the transpose materialised up front, the paper's
//     Fig. 8 access path); a thread per example walks the columns, so the
//     loads of a warp are contiguous along N.  Each warp sums x_ij * pull_i
//     over its 32 examples with shuffles: one partial row per warp.
//   Rows past N are masked, where the TPU kernel padded y with 1.0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;  // rows of a row-layout block

__global__ void glm_grad_row_kernel(const float* __restrict__ X,  // [n, d]
                                    const float* __restrict__ y,  // [n]
                                    const float* __restrict__ w,  // [d]
                                    float* __restrict__ partial,  // [nblocks, d]
                                    int n, int d, int task) {
  extern __shared__ float smem[];
  float* ws = smem;                // [d]
  float* pl = ws + d;              // [kTileRows]
  float* red = pl + kTileRows;     // [kThreads]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int start = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, n - start);
  const float* Xb = X + static_cast<size_t>(start) * d;

  for (int j = tid; j < d; j += blockDim.x) ws[j] = w[j];
  __syncthreads();

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

extern "C" int glm_grad_tile_rows() { return kTileRows; }

extern "C" int glm_grad_col_rows() { return kThreads; }

extern "C" int glm_grad_row(const void* X, const void* y, const void* w,
                            void* partial, int n, int d, int task, void* stream) {
  const size_t smem = static_cast<size_t>(d + kTileRows + kThreads) * sizeof(float);
  cudaError_t err = repro::allow_smem(glm_grad_row_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kTileRows - 1) / kTileRows;
  glm_grad_row_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<float*>(partial), n, d, task);
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
