// glm_score: served scores of a padded-ELL batch, link(sum_k v * w[idx]).
//
// Replaces: glm_score_pallas (src/repro/kernels/glm_score/kernel.py:72,
//   body _kernel l.42), which pins the model in VMEM and gathers w[idx] as
//   a one-hot [TB*K, d] MXU product, because a TPU core has no fast random
//   access into VMEM; its VMEM budget for that one-hot routed wide models
//   (news) to the oracle.
//
// What bounds it on the H100: bytes.  The values are read once (N*K*4
//   bytes), the index of each nonzero once, the scores written once (N*4),
//   plus the model entries the batch touches.  All of w8a, 64,700 x 69, is
//   about 21 MB of that, 6.3 us at 3.35 TB/s.  A serving batch of 128 rows
//   at K=69 is 36 KB, so a single serving launch is set by latency: the
//   launch, then the round trips from a row's first load to its score.
//
// Two kernels, picked by the wrapper (glm_score/ops.py variant()):
//
// glm_score_flat_kernel (the rule): a block owns a run of whole rows,
//   rows r0..r1, whose values and indices lie in one span [r0*K, r1*K) of
//   each operand; ops.score_plan sizes the runs: a batch spread over the
//   SMs (a serving batch of up to 132 rows is a row a block), runs of at
//   most 4,096 words.  The span is cut into 16-byte chunks
//   from the 16-byte boundary at or before its start; thread t takes
//   chunks t, t + T, ..., V of them (V a template constant, so the loads
//   unroll into registers), loading a chunk inside the span as one 16-byte
//   vector and the words of the first and last chunk one by one.  Every
//   thread issues all its loads, then all its gathers of w[idx] (through
//   __ldg: the model is L2-resident at every width served, 5.4 MB for
//   news), so a row costs one round trip for its operand and one for its
//   model entries, not one pair per pass.  Gathers skip value-0 entries
//   (the padding); in the gated form (kGated, which the plan picks where
//   the runs outnumber the SMs) so do the index loads of a chunk whose
//   four values are all 0, so the padding's indices are never read, at the
//   price of a round trip that the other blocks' loads hide.  A run of one
//   row is summed by the whole block: each thread adds its products, each
//   warp its threads' (a shuffle tree), thread 0 the warps'.  A run of
//   several rows puts its products in shared memory at their flat
//   position; after one barrier 2^lg lanes (ops.row_lanes) sum each row,
//   lane l taking the row's elements l, l + 2^lg, ..., then a shuffle
//   tree.  Either order is fixed by the shape: the same bits on every
//   call.
//
// glm_score_kernel (the first port): a group of G lanes a row striding
//   over it, G the smallest power of two >= K up to 32; each pass's gather
//   waits for that pass's loads.  It takes rows longer than a flat run
//   holds (ops.FLAT_MAX_K), since it streams a row of any length.
//
// Both: one launch, no atomics and no second pass, since rows are
//   independent.  A ragged N needs no padding.  An all-zero filler row sums
//   to exactly +0 and scores exactly 0.5 (LR, 1/(1+expf(-0)) in IEEE single
//   precision; the build uses no fast-math) or 0.0 (SVM).  Indices are not
//   range-checked here: the wrapper, or the engine at admission, has.
#include "common.cuh"
#include "ring.cuh"  // misalign

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float score_link(int task, float margin) {
  return task == repro::kTaskLR ? 1.0f / (1.0f + expf(-margin)) : margin;
}

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
  if (row < n && lane == 0) out[row] = score_link(task, acc);
}

template <int G>
void launch(const float* vals, const int* idx, const float* w, float* out,
            int n, int K, int task, cudaStream_t stream) {
  constexpr int rows = kThreads / G;
  const dim3 grid((n + rows - 1) / rows);
  glm_score_kernel<G><<<grid, kThreads, 0, stream>>>(vals, idx, w, out, n, K,
                                                     task);
}

// Word q of an operand if it lies in the span [s, e), else 0.
template <typename T>
__device__ __forceinline__ T word(const T* __restrict__ p, long long q,
                                  long long s, long long e) {
  return q >= s && q < e ? __ldg(p + q) : T(0);
}

__device__ __forceinline__ bool any_nonzero(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

// v * w[i], or 0 for a padding entry (v = 0) without reading w.
__device__ __forceinline__ float gather(const float* __restrict__ w, float v,
                                        int i) {
  return v != 0.0f ? v * __ldg(w + i) : 0.0f;
}

// Block b scores the run of rows [b * rows, min(n, (b + 1) * rows)):
// blockDim.x threads (a multiple of 32) of V chunks of 16 bytes; a run of
// several rows is summed by 2^lg lanes a row.
template <int V, bool kGated>
__global__ void __launch_bounds__(kThreads)
    glm_score_flat_kernel(const float* __restrict__ vals,  // [n, K]
                          const int* __restrict__ idx,     // [n, K]
                          const float* __restrict__ w,     // [d]
                          float* __restrict__ out,         // [n]
                          int n, int K, int rows, int lg, int task) {
  extern __shared__ float4 prod[];  // [blockDim.x * V]: the run's products
  const int T = blockDim.x, t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const int nrows =
      static_cast<int>(min(static_cast<long long>(rows), n - r0));
  const long long s = r0 * K, e = s + static_cast<long long>(nrows) * K;
  // chunk c holds words [s - head + 4c, s - head + 4c + 4), head being the
  // values' words past a 16-byte boundary at s; the indices share that
  // offset unless the wrapper was given operands at different offsets from
  // one, and are then read word by word
  const int head = repro::misalign(vals + s);
  const long long origin = s - head;
  const bool idx_vectors = repro::misalign(idx + s) == head;

  float4 v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long p = origin + 4LL * (t + j * T);
    if (p >= s && p + 4 <= e)
      v[j] = __ldg(reinterpret_cast<const float4*>(vals + p));
    else
      v[j] = make_float4(word(vals, p, s, e), word(vals, p + 1, s, e),
                         word(vals, p + 2, s, e), word(vals, p + 3, s, e));
  }
  int4 ix[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long p = origin + 4LL * (t + j * T);
    if (kGated && !any_nonzero(v[j]))  // padding: no index to read
      ix[j] = make_int4(0, 0, 0, 0);
    else if (idx_vectors && p >= s && p + 4 <= e)
      ix[j] = __ldg(reinterpret_cast<const int4*>(idx + p));
    else
      ix[j] = make_int4(word(idx, p, s, e), word(idx, p + 1, s, e),
                        word(idx, p + 2, s, e), word(idx, p + 3, s, e));
  }
  // every gather is issued before the first product is used
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = make_float4(gather(w, v[j].x, ix[j].x), gather(w, v[j].y, ix[j].y),
                       gather(w, v[j].z, ix[j].z), gather(w, v[j].w, ix[j].w));

  if (rows == 1) {
    // every product of the block belongs to the row: each thread adds its
    // own, each warp its threads', thread 0 the warps' (in warp order)
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc += ((v[j].x + v[j].y) + v[j].z) + v[j].w;
    acc = repro::warp_sum(acc);
    float* warps = reinterpret_cast<float*>(prod);
    if (T > 32) {
      if ((t & 31) == 0) warps[t >> 5] = acc;
      __syncthreads();
      if (t == 0)
        for (int i = 1; i < T >> 5; ++i) acc += warps[i];
    }
    if (t == 0) out[r0] = score_link(task, acc);
    return;
  }
  // products at their flat position, then 2^lg lanes a row: lane l adds
  // the row's elements l, l + 2^lg, ..., then a shuffle tree
#pragma unroll
  for (int j = 0; j < V; ++j) prod[t + j * T] = v[j];
  __syncthreads();
  const float* flat = reinterpret_cast<const float*>(prod) + head;
  const int G = 1 << lg;
  const int lane = t & (G - 1);
  // the trip count is the block's, so every lane of a warp reaches the
  // shuffles; xor offsets below G stay inside the group
  for (int base = 0; base < nrows; base += T >> lg) {
    const int row = base + (t >> lg);
    float acc = 0.0f;
    if (row < nrows)
      for (int k = lane; k < K; k += G) acc += flat[row * K + k];
    for (int o = G >> 1; o > 0; o >>= 1)
      acc += __shfl_xor_sync(repro::kFullMask, acc, o);
    if (row < nrows && lane == 0) out[r0 + row] = score_link(task, acc);
  }
}

template <int V>
void launch_flat(const float* vals, const int* idx, const float* w,
                 float* out, int n, int K, int task, int rows, int threads,
                 int lg, bool gated, cudaStream_t stream) {
  const dim3 grid((n + rows - 1) / rows);
  const size_t smem = sizeof(float4) * threads * V;
  if (gated)
    glm_score_flat_kernel<V, true><<<grid, threads, smem, stream>>>(
        vals, idx, w, out, n, K, rows, lg, task);
  else
    glm_score_flat_kernel<V, false><<<grid, threads, smem, stream>>>(
        vals, idx, w, out, n, K, rows, lg, task);
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

// The flat kernel at ops.score_plan's (rows, threads, vectors, lanes,
// gated): threads a multiple of 32 up to 256, vectors one of 1, 2, 4,
// threads * vectors * 4 >= rows * K + 3 (a run and its head), lanes a
// power of two up to 32.
extern "C" int glm_score_flat(const void* vals, const void* idx,
                              const void* w, void* out, int n, int K,
                              int task, int rows, int threads, int vectors,
                              int lanes, int gated, void* stream) {
  const auto* v = static_cast<const float*>(vals);
  const auto* i = static_cast<const int*>(idx);
  const auto* wp = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  int lg = 0;
  while ((1 << lg) < lanes) ++lg;
  switch (vectors) {
    case 1:
      launch_flat<1>(v, i, wp, o, n, K, task, rows, threads, lg, gated, s);
      break;
    case 2:
      launch_flat<2>(v, i, wp, o, n, K, task, rows, threads, lg, gated, s);
      break;
    case 4:
      launch_flat<4>(v, i, wp, o, n, K, task, rows, threads, lg, gated, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
