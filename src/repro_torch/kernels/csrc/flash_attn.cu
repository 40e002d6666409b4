// flash_attn: blocked online-softmax attention with GQA, causal and
// sliding-window masks, queries end-aligned with keys.
//
// Replaces: flash_attention_pallas (src/repro/kernels/flash_attn/kernel.py:91,
//   body _kernel l.27), which keeps a [TQ, hd] query tile in VMEM while
//   [TK, hd] key/value tiles stream through, carries the running max,
//   normaliser and accumulator in VMEM scratch across the sequential k axis
//   of its grid, and skips key tiles no query of the tile can see.  Its
//   scores, m, l, accumulator and P.V are fp32; only the output is cast to
//   the input's dtype.  This kernel computes the same function: query i
//   (at position i + Sk - Sq) sees key j iff j <= i + Sk - Sq (causal) and
//   i + Sk - Sq - j < window (when a window is set); scale 1/sqrt(hd);
//   out = acc / l, or acc / 1 where l == 0 (a row that sees no key gives 0).
//
// What bounds it on the H100: prefill (Sq = Sk) is bound by operations:
//   4 * hd bf16 flops per visible (query, key) pair, at 989 TFLOP/s on the
//   tensor cores; with danube's window of 4096 a query sees at most 4096
//   keys, so prefill costs O(S * window), not O(S^2).  Decode (Sq = 1) is
//   bound by bytes: the K/V rows it reads, at 3.35 TB/s.
//
// Design (simple first; fp32 everywhere inside, as the Pallas kernel):
// - One block per (batch, kv head, tile of query rows).  A row is a (query
//   position i, query head of the kv head's group) pair, the head fastest,
//   so the rep = Hq / Hkv query heads that read one kv head share every K/V
//   tile the block stages: query head h reads kv head h / rep (the
//   reference's jnp.repeat), and the repeat is never materialised.
// - Four warps; each owns RPW rows.  The tile height follows the work:
//   RPW = 1 when the block's rows fit one per warp (decode: Sq = 1 gives
//   rep rows, so a block per (batch, kv head) with no idle row slots), else
//   RPW = 8 (32 rows a block).
// - The block loads only the keys its rows can see: [k_begin, k_end) from
//   the causal and window bounds of its first and last row (the Pallas
//   kernel's tile skipping, at key granularity).  32-key K and V tiles are
//   staged in shared memory as fp32, rows padded to hd + 4 floats so the
//   lanes' 16-byte reads of 8 different rows hit distinct banks.
// - Scores: lane j owns key k0 + j and dots it with the warp's rows (query
//   rows are read from shared memory as broadcasts).  The online softmax
//   takes the tile max with warp shuffles; each lane keeps a partial l,
//   summed once at the end.  P goes to shared memory; P.V then has lane c
//   own output columns c, c + 32, ... (up to hd <= 128), accumulated in
//   registers across tiles.
// - Any Sq <= Sk and any Sk: ragged key tiles are masked by their length,
//   ragged row tiles by the row count; nothing is padded.
// Left for later: tensor cores (wgmma, or mma.sync), TMA loads into a ring
//   of tiles, and a split over keys for decode (a decode block walks all of
//   its keys alone, and B * Hkv blocks do not fill 132 SMs).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;  // keys per staged tile: one per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(repro::kFullMask, v, o));
  return v;
}

// One 16-byte vector of T (4 fp32 or 8 bf16) into fp32 shared memory.
template <typename T>
__device__ __forceinline__ void store_vec(float* dst, const uint4& raw) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
  } else {
    const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; u += 4)
      *reinterpret_cast<float4*>(dst + u) =
          make_float4(to_float(h[u]), to_float(h[u + 1]), to_float(h[u + 2]),
                      to_float(h[u + 3]));
  }
}

// `rows` consecutive rows of hd elements (one contiguous run) into shared
// memory with row stride ld floats.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, int rows, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = hd / kVec;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row;
    store_vec<T>(dst + r * ld + (e - r * per_row) * kVec, s[e]);
  }
}

template <typename T, int RPW, int C>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q,    // [B, Hq, Sq, hd]
                  const T* __restrict__ k,    // [B, Hkv] heads of [Sk, hd]
                  const T* __restrict__ v,    // same layout as k
                  T* __restrict__ out,        // [B, Hq, Sq, hd]
                  int Hq, int Hkv, int Sq, int Sk, int hd,
                  long long kv_head_stride, int causal, int window,
                  float scale) {
  constexpr int kRows = kWarps * RPW;
  extern __shared__ float smem[];
  const int ld = hd + 4;
  float* qs = smem;                  // [kRows][ld]
  float* ks = qs + kRows * ld;       // [kTileK][ld]
  float* vs = ks + kTileK * ld;      // [kTileK][ld]
  float* ps = vs + kTileK * ld;      // [kRows][kTileK]

  const int rep = Hq / Hkv;
  const int bkv = blockIdx.y;  // b * Hkv + kv head
  const int b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int total = Sq * rep;
  const int r0 = blockIdx.x * kRows;
  const int off = Sk - Sq;

  // query rows: row r is (position (r0 + r) / rep, head hkv * rep + (r0 + r) % rep)
  {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = hd / kVec;
    for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) * kVec;
      const int R = r0 + r;
      if (R >= total) continue;
      const int i = R / rep, h = hkv * rep + R % rep;
      const T* src = q + ((static_cast<long long>(b) * Hq + h) * Sq + i) * hd + c;
      store_vec<T>(qs + r * ld + c, *reinterpret_cast<const uint4*>(src));
    }
  }

  // the keys some row of this block can see
  const int i_lo = r0 / rep;
  const int i_hi = (min(r0 + kRows, total) - 1) / rep;
  const int k_end = causal ? min(Sk, i_hi + off + 1) : Sk;
  const int k_begin = window > 0 ? max(0, i_lo + off - window + 1) : 0;
  const T* kb = k + bkv * kv_head_stride;
  const T* vb = v + bkv * kv_head_stride;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m[RPW], l[RPW], acc[RPW][C];
  int qpos[RPW];
  bool live[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int R = r0 + warp * RPW + r;
    live[r] = R < total;
    qpos[r] = R / rep + off;
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  }
  const float* qw = qs + warp * RPW * ld;
  float* pw = ps + warp * RPW * kTileK;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int n = min(kTileK, k_end - k0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<T>(ks, ld, kb + static_cast<long long>(k0) * hd, n, hd);
    load_rows<T>(vs, ld, vb + static_cast<long long>(k0) * hd, n, hd);
    for (int e = n * ld + threadIdx.x; e < kTileK * ld; e += kThreads)
      vs[e] = 0.0f;  // a ragged tile's missing rows: P is 0 there
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.0f;
    const float* krow = ks + lane * ld;
    for (int d = 0; d < hd; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * ld + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float p = 0.0f;
      if (live[r]) {  // the same for every lane of the warp
        const bool vis = lane < n && (!causal || j <= qpos[r]) &&
                         (window <= 0 || qpos[r] - j < window);
        const float sc = vis ? s[r] * scale : -INFINITY;
        const float mn = fmaxf(m[r], warp_max(sc));
        p = vis ? expf(sc - mn) : 0.0f;
        // before the row's first visible key, l and acc are 0
        const float corr = m[r] == -INFINITY ? 0.0f : expf(m[r] - mn);
        m[r] = mn;
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] *= corr;
      }
      pw[r * kTileK + lane] = p;
    }
    __syncwarp();

    // P.V: lane owns output columns lane, lane + 32, ...
    for (int jj = 0; jj < kTileK; jj += 4) {
      float4 pv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        pv[r] = *reinterpret_cast<const float4*>(pw + r * kTileK + jj);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col >= hd) break;
        const float* vc = vs + jj * ld + col;
        const float v0 = vc[0], v1 = vc[ld], v2 = vc[2 * ld], v3 = vc[3 * ld];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          float a = acc[r][c];
          a = fmaf(pv[r].x, v0, a);
          a = fmaf(pv[r].y, v1, a);
          a = fmaf(pv[r].z, v2, a);
          a = fmaf(pv[r].w, v3, a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();  // P of this tile is read before the next tile writes it
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!live[r]) continue;  // the same for every lane of the warp
    const float lt = repro::warp_sum(l[r]);
    const float div = lt == 0.0f ? 1.0f : lt;
    const int R = r0 + warp * RPW + r;
    const int i = R / rep, h = hkv * rep + R % rep;
    T* dst = out + ((static_cast<long long>(b) * Hq + h) * Sq + i) * hd;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) dst[col] = from_float<T>(acc[r][c] / div);
    }
  }
}

template <typename T, int RPW, int C>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int hd, long long kv_head_stride,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int kRows = kWarps * RPW;
  const size_t smem =
      sizeof(float) * ((kRows + 2 * kTileK) * static_cast<size_t>(hd + 4) +
                       kRows * kTileK);
  auto kernel = flash_attn_kernel<T, RPW, C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = repro::allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq * (Hq / Hkv) + kRows - 1) / kRows, B * Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Sk, hd,
      kv_head_stride, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RPW>
int by_columns(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Sq, int Sk, int hd,
               long long kv_head_stride, int causal, int window, float scale,
               cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1:
      return launch<T, RPW, 1>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
    case 2:
      return launch<T, RPW, 2>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
    case 3:
      return launch<T, RPW, 3>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
    default:
      return launch<T, RPW, 4>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
  }
}

template <typename T>
int by_rows(const void* q, const void* k, const void* v, void* out, int B,
            int Hq, int Hkv, int Sq, int Sk, int hd, long long kv_head_stride,
            int causal, int window, float scale, cudaStream_t s) {
  if (Sq * (Hq / Hkv) <= kWarps)
    return by_columns<T, 1>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd,
                            kv_head_stride, causal, window, scale, s);
  return by_columns<T, 8>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd,
                          kv_head_stride, causal, window, scale, s);
}

}  // namespace

// q, out: contiguous [B, Hq, Sq, hd]; k, v: B * Hkv heads of Sk contiguous
// rows of hd, kv_head_stride elements apart (a prefix of a longer cache
// passes its own stride).  hd a multiple of 8 up to 128, every pointer and
// head 16-byte aligned, Hq a multiple of Hkv, 1 <= Sq <= Sk: the wrapper
// checks.  window <= 0 means none.  bf16 != 0: bf16 operands, else fp32.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                          int hd, long long kv_head_stride, int causal,
                          int window, float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_rows<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd,
                                  kv_head_stride, causal, window, scale, s);
  return by_rows<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, kv_head_stride,
                        causal, window, scale, s);
}
