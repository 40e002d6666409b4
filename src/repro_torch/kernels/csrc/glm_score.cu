// glm_score: served scores of a padded-ELL batch, link(sum_k v * w[idx]).
//
// Replaces: glm_score_pallas (src/repro/kernels/glm_score/kernel.py:72,
//   body _kernel l.42), which pins the model in VMEM and gathers w[idx] as
//   a one-hot [TB*K, d] MXU product, because a TPU core has no fast random
//   access into VMEM; its VMEM budget for that one-hot routed wide models
//   (news) to the oracle.
//
// What bounds it on the H100: bytes.  The values and indices are read once
//   (N*K*8 bytes), the scores written once (N*4), plus the model entries
//   the batch touches.  All of w8a, 64,700 x 69, is 35.7 MB, about 10.7 us
//   at 3.35 TB/s.  A 128-row serving batch at K=69 is about 71 KB, so a
//   single serving launch is set by launch latency, not bytes: this kernel
//   does nothing about that (batching requests is the engine's job).
//
// Design: one launch, no atomics and no second pass, since rows are
//   independent.  A group of G lanes owns a row: G is the smallest power of
//   two >= K, from 4 up to a full warp of 32, so a narrow row does not
//   leave most of a warp idle.  The group reads its row's values and
//   indices coalesced, gathers w[idx] straight from global memory (the
//   model is at most a few MB and stays in L2), skips value-0 entries (the
//   padding), sums the margin with shuffles inside the group, and writes
//   link(margin).  A ragged N needs no padding: the last block's surplus
//   groups add nothing and write nothing.  An all-zero filler row sums to
//   exactly 0 and scores exactly 0.5 (LR, 1/(1+expf(-0)) in IEEE single
//   precision; the build uses no fast-math) or 0.0 (SVM).  Indices are not
//   range-checked here: the wrapper, or the engine at admission, has.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void glm_score_kernel(const float* __restrict__ vals,  // [n, K]
                                 const int* __restrict__ idx,     // [n, K]
                                 const float* __restrict__ w,     // [d]
                                 float* __restrict__ out,         // [n]
                                 int n, int K, int task) {
  const int lane = threadIdx.x % G;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  float acc = 0.0f;
  if (row < n) {
    const size_t off = static_cast<size_t>(row) * K;
    for (int k = lane; k < K; k += G) {
      const float v = vals[off + k];
      if (v != 0.0f) acc += v * __ldg(&w[idx[off + k]]);
    }
  }
  // every lane of the warp reaches the shuffles; xor offsets below G stay
  // inside the group
  for (int o = G / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(repro::kFullMask, acc, o);
  if (row < n && lane == 0)
    out[row] = task == repro::kTaskLR ? 1.0f / (1.0f + expf(-acc)) : acc;
}

template <int G>
void launch(const float* vals, const int* idx, const float* w, float* out,
            int n, int K, int task, cudaStream_t stream) {
  constexpr int rows = kThreads / G;
  const dim3 grid((n + rows - 1) / rows);
  glm_score_kernel<G><<<grid, kThreads, 0, stream>>>(vals, idx, w, out, n, K,
                                                     task);
}

}  // namespace

extern "C" int glm_score(const void* vals, const void* idx, const void* w,
                         void* out, int n, int K, int task, void* stream) {
  const auto* v = static_cast<const float*>(vals);
  const auto* i = static_cast<const int*>(idx);
  const auto* wp = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (K <= 4)
    launch<4>(v, i, wp, o, n, K, task, s);
  else if (K <= 8)
    launch<8>(v, i, wp, o, n, K, task, s);
  else if (K <= 16)
    launch<16>(v, i, wp, o, n, K, task, s);
  else
    launch<32>(v, i, wp, o, n, K, task, s);
  return static_cast<int>(cudaGetLastError());
}
