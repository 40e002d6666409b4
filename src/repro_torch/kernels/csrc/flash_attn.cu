// flash_attn: blocked online-softmax attention with GQA, causal and
// sliding-window masks, queries end-aligned with keys.
//
// Replaces: flash_attention_pallas (src/repro/kernels/flash_attn/kernel.py:91,
//   body _kernel l.27, pallas_call l.110), which keeps a [TQ, hd] query tile
//   in VMEM while [TK, hd] key/value tiles stream through, carries the
//   running max, normaliser and accumulator in VMEM scratch across the
//   sequential k axis of its grid, and skips key tiles no query of the tile
//   can see.  Its QK^T takes the operands' dtype into fp32 (l.65); scores,
//   m, l, the accumulator and P (fp32 into jnp.dot(p, v), l.81) are fp32;
//   only the output is cast to the input's dtype.  The kernels here compute
//   the same function: query i (at position i + Sk - Sq) sees key j iff
//   j <= i + Sk - Sq (causal) and i + Sk - Sq - j < window (when a window is
//   set); scale 1/sqrt(hd); out = acc / l, or acc / 1 where l == 0 (a row
//   that sees no key gives 0).
//
// Rows (the mma, decode and fp32 kernels; a wgmma block serves one query
//   head): a row is a (query position i, query head of the kv head's group)
//   pair, the head fastest, so the rep = Hq / Hkv query heads that read one
//   kv head share every K/V row a block reads: query head h reads kv head
//   h / rep (the reference's jnp.repeat), never materialised.  A block serves
//   one (batch, kv head) and a tile of rows, and loads only the keys its rows
//   can see, [k_begin, k_end) from the causal and window bounds of its first
//   and last row (the Pallas kernel's tile skipping, at key granularity).
//
// Five kernels, chosen by kernels/flash_attn/ops.py:variant(dtype, Sq, rep,
// hd) and passed in as `variant` (the decode kernel has its own entry point):
//
// flash_attn_wgmma_kernel (bf16 operands at hd 64, 80, 96, 112 or 128 and
//   Sq >= ops.py:WGMMA_MIN_QUERIES: prefill, training, the cross call).
//   Bound like the mma kernel by bf16 operations on the tensor cores; the
//   function's 2 products, 3 as P is kept fp32-grade.  FlashAttention-3's
//   forward with the Pallas kernel's precision:
//   - a block is one query head's 128-query tile (grid B * Hq x tiles,
//     heads fastest so that a kv head's rep query heads read its K/V tiles
//     from L2 together, the longest walks first) and walks the keys its
//     rows see (ops.py:bwd_k_range), 64 at a time: the backward's dQ-pass
//     geometry;
//   - a producer warpgroup (one thread issues TMA loads of 64 x 16 boxes in
//     the 32-byte swizzle, hopper.cuh, Q once and the K/V tiles into a ring
//     of three stages completed by mbarriers; it gives its registers to the
//     consumers by setmaxnreg) and two consumer warpgroups of 64 rows;
//   - S = Q K^T by wgmma from shared memory (K-major); the online softmax
//     in fp32 on the accumulator registers; P split into bf16 hi + lo A
//     operands straight from the accumulator layout, and O += P_hi V +
//     P_lo V by wgmma with V read MN-major: 3 products a pair, as the mma
//     kernel runs;
//   - the consumers take turns at the tensor cores: a turn issues the last
//     tile's P V and this tile's S together, and one consumer's softmax
//     runs under the other's products;
//   - only a tile on a causal, window or ragged edge masks elementwise;
//     TMA reads keys past Sk as zeros, whose score 0 the mask turns into
//     -inf.  hd 80 and 112 rows are 5 and 7 slabs of 16 columns, so no
//     depth is padded.  No atomics: every call gives the same bits.
//   The mma kernel keeps the other bf16 head dims and the short query
//   chunks, where the 128-row tile of one query head would sit mostly idle
//   (ops.py:WGMMA_MIN_QUERIES, from a same-call sweep on the card).
//
// flash_attn_mma_kernel (bf16 operands and Sq * rep >= 16 rows that the
//   wgmma kernel does not take: other head dims, short query chunks; the
//   first tensor-core design, for every prefill).  Bound on the H100 by bf16 operations:
//   4 * hd flops per visible (query, key) pair at 989 TFLOP/s on the tensor
//   cores;
//   with danube's window of 4096 a query sees at most 4096 keys, so prefill
//   costs O(S * window).  Design:
//   - mma.sync.m16n8k16 with bf16 operands and fp32 accumulators; 4 warps of
//     16 rows each, so a block has 64 rows.  Q's A fragments are loaded once
//     with ldmatrix and stay in registers; K's B fragments come from
//     ldmatrix, V's from ldmatrix.trans.
//   - The S accumulator of QK^T is reused in registers as P.V's A fragment
//     (FlashAttention-2), so P never goes to shared memory.  P stays
//     fp32-grade: each fp32 P fragment is split into hi = bf16(P) and
//     lo = bf16(P - hi), and both go through an MMA against the same V
//     fragment (V is exact in bf16, the sum fp32): P's error is near 2^-17
//     of its value, where one bf16 P would add up to 2^-9 of |v| and eat the
//     output's one-bf16-step tolerance.  The split costs 1.5x the MMAs of a
//     plain bf16 kernel: the price of computing what the TPU kernel does.
//   - K and V tiles of 64 keys stay bf16 in shared memory, in a ring of two
//     stages filled by cp.async (16 bytes a thread), so the next tile's copy
//     overlaps this tile's MMAs; rows are padded by 16 bytes, which keeps
//     ldmatrix free of bank conflicts.  Keys past k_end are zero-filled.
//   - Only tiles that straddle a causal, window or ragged edge apply the
//     elementwise mask; masked scores are -inf, so p = 0 exactly, and a
//     row's first visible key resets m and l.  Softmax in base 2, log2(e)
//     folded into the scale.
//   - Head dims: any multiple of 8 up to 128; for hd % 16 == 8 the QK^T
//     depth is zero-padded to the next 16 in shared memory (exact: the zeros
//     add nothing); P.V steps by 8 columns and stores only the first hd.
//
// flash_attn_decode_kernel (bf16 operands and Sq * rep < 16 rows: decode,
//   Sq = 1 over a cache prefix read in place).  Bound by bytes: every K and
//   V row once at 3.35 TB/s (danube, B=4, Sk=4096: 42 MB, 12.5 us), and at
//   serving sizes by the launch and one or two memory round trips.  B * Hkv
//   blocks (32 at B=4) cannot fill 132 SMs, so the keys are split:
//   - the grid is (splits, B * Hkv, row groups); ops.py:decode_plan gives
//     `splits` from B * Hkv alone (two blocks an SM, so the grid does not
//     change as the cache grows) and chunks of `chunk` keys, a multiple of
//     128; the blocks past the last key return at once;
//   - a block's 4 warps take 32-key tiles of its chunk in turn, each warp
//     with its own m, l and accumulator.  QK^T: lane j owns key j of the
//     tile and reads its row with 16-byte loads of bf16 straight into
//     registers; the rows' queries (up to 8, pre-scaled fp32) are read from
//     shared memory as broadcasts.  Every K/V row is read once for all the
//     rows of the group: GQA without a repeat;
//   - a tile's K and V loads issue together, one memory round trip a tile
//     (a version that streamed each warp's tiles through a two-stage
//     cp.async ring in shared memory measured slower on the H100; PERF.md).
//     P.V: lane (slot, c) owns the 8 columns c of every (32 / (hd / 8))-th
//     key of the tile (3 keys at a time at hd 80, so 30 of 32 lanes work),
//     takes P by shuffle and sums fp32;
//   - the warps' states merge through shared memory (each row's weights
//     and 1 / l once, then a thread per 8 output columns and one 16-byte
//     store: the merge and the output were 40% of a decode call at
//     Sk = 128 when every element took its own pass); with one chunk the
//     block writes the output.  Otherwise it writes its unnormalised state
//     (m, l, acc in fp32) to scratch, and the last block of its (batch, kv
//     head, row group) to arrive -- a ticket from an atomic counter --
//     merges every chunk's state in chunk order (so the result does not
//     depend on the order the blocks ran) and resets the counter for the
//     next call.  A chunk or a row that sees no key has m = -inf and l = 0,
//     weighs 0 in the merge, and a row with l == 0 gives 0.
//   Left for later: reading the cache length from the card (a CUDA graph
//   over the decode step).
//
// flash_attn_tiled_kernel (fp32 operands with Sq >= ops.py:
//   TILED_MIN_QUERIES: training, prefill and the fp32 benches).  Bound by
//   fp32 operations outside the tensor cores: 4 * hd flops a visible pair
//   at 67 TFLOP/s (no TF32: the 1e-5 tolerance needs fp32 products).  The
//   dQ pass of flash_attn_bwd's "simt_tiled" with two products in place of
//   three, on its helpers (attn.cuh):
//   - a block is one query head's 64 queries (grid B * Hq x tiles, heads
//     fastest so a kv head's rep query heads read its K/V tiles from L2
//     together, the longest walks first); Q stays in shared memory and the
//     64-key K/V tiles of ops.py:bwd_k_range stream through a two-stage
//     cp.async ring, so the next tile's copy overlaps this tile's products;
//   - 256 threads each own a 4 x 4 micro-tile of S (float4 operands, 8
//     FMAs a shared-memory load, where flash_attn_kernel re-reads Q every 4
//     FMAs); the online softmax in base 2 (scale * log2 e folded in, exp2f)
//     takes a row's max and its rescale once every 64 keys, by 4 shuffles
//     among the row's 16 lanes (flash_attn_kernel: 5 shuffles and a
//     rescale every 32), and each lane keeps a partial row sum;
//   - P goes to shared memory, then O += P V as 4 rows x hd / 16 columns
//     micro-tiles (columns past hd skipped: every hd that is a multiple of
//     8), each tile's sum taken apart and then added (one running sum
//     drifted 4e-5 from the plain version in the backward);
//   - only a tile on a causal, window or ragged edge masks elementwise;
//     rows past Sq and keys past the range read zeros.  It writes the
//     log-sum-exp as flash_attn_kernel does (base 2, +inf for a row that
//     sees no key), the statistics the fp32 backward reads.  No atomics:
//     every call gives the same bits.  Shared memory: Q, two stages of K
//     and V, and P, 186,368 bytes at hd 128 (opted in above 48 KB).
//   flash_attn_kernel keeps decode, where a 64-row tile of one query head
//   would hold one row (ops.py:TILED_MIN_QUERIES, from a same-call sweep
//   on the card).
//
// flash_attn_kernel (fp32 operands with fewer than TILED_MIN_QUERIES
//   queries; the first port).  fp32 on the CUDA cores.  Design:
//   - Four warps; each owns RPW rows.  The tile height follows the work:
//     RPW = 1 when the block's rows fit one per warp (decode: Sq = 1 gives
//     rep rows, so a block per (batch, kv head) with no idle row slots),
//     else RPW = 8 (32 rows a block).
//   - 32-key K and V tiles are staged in shared memory as fp32, rows padded
//     to hd + 4 floats so the lanes' 16-byte reads of 8 different rows hit
//     distinct banks.
//   - Scores: lane j owns key k0 + j and dots it with the warp's rows (query
//     rows are read from shared memory as broadcasts).  The online softmax
//     takes the tile max with warp shuffles; each lane keeps a partial l,
//     summed once at the end.  P goes to shared memory; P.V then has lane c
//     own output columns c, c + 32, ... (up to hd <= 128), accumulated in
//     registers across tiles.
//   - Ragged key tiles are masked by their length, ragged row tiles by the
//     row count; nothing is padded.
#include <cuda_bf16.h>

#include <cstdint>

#include "attn.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::bits;
using repro::copies_commit;
using repro::copies_wait;
using repro::copy16;
using repro::kLog2e;
using repro::ldsm4;
using repro::ldsm4_t;
using repro::mma;
using repro::warp_max;

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
                  float* __restrict__ lse,    // [B, Hq, Sq] or null
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
    const long long row = (static_cast<long long>(b) * Hq + h) * Sq + i;
    T* dst = out + row * hd;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) dst[col] = from_float<T>(acc[r][c] / div);
    }
    if (lse != nullptr && lane == 0)  // base 2, as the backward reads it
      lse[row] = lt == 0.0f ? INFINITY : fmaf(m[r], kLog2e, log2f(lt));
  }
}

template <typename T, int RPW, int C>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, int hd,
           long long kv_head_stride, int causal, int window, float scale,
           cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Sq, Sk,
      hd, kv_head_stride, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RPW>
int by_columns(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
               long long kv_head_stride, int causal, int window, float scale,
               cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1:
      return launch<T, RPW, 1>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
    case 2:
      return launch<T, RPW, 2>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
    case 3:
      return launch<T, RPW, 3>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
    default:
      return launch<T, RPW, 4>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,
                               kv_head_stride, causal, window, scale, s);
  }
}

template <typename T>
int by_rows(const void* q, const void* k, const void* v, void* out, float* lse,
            int B, int Hq, int Hkv, int Sq, int Sk, int hd,
            long long kv_head_stride, int causal, int window, float scale,
            cudaStream_t s) {
  if (Sq * (Hq / Hkv) <= kWarps)
    return by_columns<T, 1>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,
                            kv_head_stride, causal, window, scale, s);
  return by_columns<T, 8>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,
                          kv_head_stride, causal, window, scale, s);
}

// ---------------------------------------------------------------------------
// flash_attn_tiled_kernel: fp32 register-tiled on the CUDA cores
// ---------------------------------------------------------------------------

using repro::kPLd;
using repro::kTile;
using repro::kTileThreads;

// Q's tile, two stages of K and V, and the P tile (fp32; rows of hd + 4
// floats): 186,368 bytes at hd 128 (ops.py:fwd_tiled_smem mirrors it)
__host__ __device__ constexpr size_t tiled_smem(int hd) {
  return sizeof(float) * (5 * kTile * (hd + 4) + kTile * kPLd);
}

// the max (max) or sum over the 16 lanes that share a row of micro-tiles
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(repro::kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(repro::kFullMask, v, o);
  return v;
}

// Grid: (B * Hq, Sq / 64 rounded up), the last query tiles first (a
// causal walk is longest there).  A block keeps one query head's 64 rows
// of Q in shared memory and walks the 64-key tiles of its kv head that its
// rows see (ops.py:bwd_k_range), double-buffered by cp.async: S = Q K^T as
// 4 x 4 micro-tiles a thread (rows ty + 16 a, keys tx + 16 c), the online
// softmax in base 2 on its registers (a row's max by shuffles among its 16
// lanes; each lane keeps a partial l, summed at the end), P to shared
// memory, then O += P V as 4 rows x NC columns micro-tiles, each tile's
// sum taken apart and then added (micro_product).  Only a tile on a
// causal, window or ragged edge masks elementwise.  out = O / l (0 where
// l == 0); lse (or null) the row's log2-sum-exp2 of the scaled scores,
// +inf for a row that sees no key.
template <int NC>
__global__ void __launch_bounds__(kTileThreads)
flash_attn_tiled_kernel(const float* __restrict__ q,  // [B, Hq, Sq, hd]
                        const float* __restrict__ k,  // [B, Hkv] heads
                        const float* __restrict__ v,  // as k
                        float* __restrict__ out,      // [B, Hq, Sq, hd]
                        float* __restrict__ lse,      // [B, Hq, Sq] or null
                        int Hq, int Hkv, int Sq, int Sk, int hd,
                        long long kv_head_stride, int causal, int window,
                        float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* qs = smem;                  // [64][ld]
  float* kvs = qs + kTile * ld;      // [stage][K, V][64][ld]
  float* ps = kvs + 4 * kTile * ld;  // [64][kPLd]: P

  const int bh = blockIdx.x;  // b * Hq + query head
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_base =
      (static_cast<long long>(b) * Hkv + h / (Hq / Hkv)) * kv_head_stride;
  const long long row_base = static_cast<long long>(bh) * Sq;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // last first
  const int off = Sk - Sq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i_hi = min(i0 + kTile, Sq) - 1;
  int k_begin, k_end;
  repro::key_range(i0, i_hi, off, Sk, causal, window, k_begin, k_end);
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile : 0;

  repro::stage_rows(qs, ld, q + row_base * hd, i0, Sq, hd);
  auto load_tile = [&](int t) {
    float* kd = kvs + (t % 2) * 2 * kTile * ld;
    const int k0 = k_begin + t * kTile;
    repro::stage_rows(kd, ld, k + kv_base, k0, k_end, hd);
    repro::stage_rows(kd + kTile * ld, ld, v + kv_base, k0, k_end, hd);
  };
  if (ntiles > 0) load_tile(0);
  copies_commit();

  float m[4], l[4], acc[4][NC];
  int qpos[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    qpos[a] = i0 + ty + 16 * a + off;
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    copies_commit();
    copies_wait<1>();  // all but the newest group: this tile (and Q)
    __syncthreads();
    const float* kt = kvs + (t % 2) * 2 * kTile * ld;
    const float* vt = kt + kTile * ld;
    const int k0 = k_begin + t * kTile;
    float s[4][4];
    repro::micro_dot(s, qs, kt, ld, hd, ty, tx);
    const bool edge = k0 + kTile > k_end ||
                      (causal && k0 + kTile - 1 > i0 + off) ||
                      (window > 0 && k0 <= i_hi + off - window);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float top = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool vis =
            !edge || (j < k_end && repro::visible(qpos[a], j, causal, window));
        s[a][c] = vis ? s[a][c] * scale_log2 : -INFINITY;
        top = fmaxf(top, s[a][c]);
      }
      const float mn = fmaxf(m[a], row_max16(top));
      // a row that has seen no key yet keeps l and acc at 0: its p are 0
      const float base = mn == -INFINITY ? 0.0f : mn;
      const float corr = exp2f(m[a] - base);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[a][c] - base);
        sum += p;
        ps[(ty + 16 * a) * kPLd + tx + 16 * c] = p;
      }
      m[a] = mn;
      l[a] = fmaf(l[a], corr, sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();
    repro::micro_product<NC>(acc, ps, vt, ld, hd, ty, tx);
    __syncthreads();  // the stage and the P tile are read before reuse
  }
  copies_wait<0>();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float lt = row_sum16(l[a]);  // every lane of the row takes part
    const int i = i0 + ty + 16 * a;
    if (i >= Sq) continue;
    const float div = lt == 0.0f ? 1.0f : lt;
    float* dst = out + (row_base + i) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) dst[col] = acc[a][c] / div;
    }
    if (lse != nullptr && tx == 0)  // base 2, as the backward reads it
      lse[row_base + i] = lt == 0.0f ? INFINITY : m[a] + log2f(lt);
  }
}

template <int NC>
int launch_tiled(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                 long long kv_head_stride, int causal, int window,
                 float scale, cudaStream_t stream) {
  const size_t smem = tiled_smem(hd);
  auto kernel = flash_attn_tiled_kernel<NC>;
  const cudaError_t e = repro::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(B * Hq, (Sq + kTile - 1) / kTile), kTileThreads, smem,
           stream>>>(static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out),
                     lse, Hq, Hkv, Sq, Sk, hd, kv_head_stride, causal, window,
                     scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int tiled_by_columns(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                     int hd, long long kv_head_stride, int causal, int window,
                     float scale, cudaStream_t s) {
#define REPRO_TILED_CASE(n)                                                  \
  case n:                                                                    \
    return launch_tiled<n>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,        \
                           kv_head_stride, causal, window, scale, s);
  switch ((hd + 15) / 16) {  // a thread's columns
    REPRO_TILED_CASE(1)
    REPRO_TILED_CASE(2)
    REPRO_TILED_CASE(3)
    REPRO_TILED_CASE(4)
    REPRO_TILED_CASE(5)
    REPRO_TILED_CASE(6)
    REPRO_TILED_CASE(7)
    default:
      return launch_tiled<8>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd,
                             kv_head_stride, causal, window, scale, s);
  }
#undef REPRO_TILED_CASE
}

// ---------------------------------------------------------------------------
// flash_attn_mma_kernel: bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaRows = kWarps * 16;  // rows a block: 16 per warp
constexpr int kMmaKeys = 64;           // keys a staged tile
constexpr int kStages = 2;             // K/V tiles in the cp.async ring
// (a, b) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), the lower
// column in the lower half
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// HDP: hd rounded up to 16, the depth of QK^T.  Per thread: rows g and
// g + 8 of its warp's 16 (g = lane / 4), and columns 2 (lane % 4) + {0, 1}
// of every 8-wide n-tile (the m16n8 accumulator layout).
template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_attn_mma_kernel(const bf16* __restrict__ q,   // [B, Hq, Sq, hd]
                      const bf16* __restrict__ k,   // [B, Hkv] heads of [Sk, hd]
                      const bf16* __restrict__ v,   // same layout as k
                      bf16* __restrict__ out,       // [B, Hq, Sq, hd]
                      float* __restrict__ lse,      // [B, Hq, Sq] or null
                      bf16* __restrict__ out_lo,    // as out, or null
                      int Hq, int Hkv, int Sq, int Sk, int hd,
                      long long kv_head_stride, int causal, int window,
                      float scale_log2) {
  constexpr int LD = HDP + 8;      // row stride (bf16): 16 bytes of padding
  constexpr int KSTEPS = HDP / 16;  // QK^T depth steps
  constexpr int NT = HDP / 8;       // P.V output n-tiles
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* qs = reinterpret_cast<bf16*>(raw);  // [kMmaRows][LD]
  bf16* ks = qs + kMmaRows * LD;            // [kStages][kMmaKeys][LD]
  bf16* vs = ks + kStages * kMmaKeys * LD;  // [kStages][kMmaKeys][LD]

  const int rep = Hq / Hkv;
  const int bkv = blockIdx.y;  // b * Hkv + kv head
  const int b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int total = Sq * rep;
  const int r0 = blockIdx.x * kMmaRows;
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = hd / 8;  // 16-byte chunks a row

  // the depth padding [hd, HDP) of every staged row, once: copies never
  // write it
  if (HDP != hd)
    for (int r = tid; r < kMmaRows + 2 * kStages * kMmaKeys; r += kThreads)
      *reinterpret_cast<uint4*>(qs + r * LD + hd) = make_uint4(0, 0, 0, 0);

  // query rows (zeros past the last row): in the first copy group
  for (int e = tid; e < kMmaRows * chunks; e += kThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 8;
    const int R = r0 + r;
    const bool live = R < total;
    const int i = live ? R / rep : 0, h = hkv * rep + (live ? R % rep : 0);
    copy16(qs + r * LD + c,
           q + ((static_cast<long long>(b) * Hq + h) * Sq + i) * hd + c, live);
  }

  // the keys some row of this block can see
  const int i_lo = r0 / rep;
  const int i_hi = (min(r0 + kMmaRows, total) - 1) / rep;
  const int k_end = causal ? min(Sk, i_hi + off + 1) : Sk;
  const int k_begin = window > 0 ? max(0, i_lo + off - window + 1) : 0;
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + kMmaKeys - 1) / kMmaKeys : 0;
  const bf16* kb = k + bkv * kv_head_stride;
  const bf16* vb = v + bkv * kv_head_stride;

  auto load_tile = [&](int t) {
    const int k0 = k_begin + t * kMmaKeys;
    bf16* kd = ks + (t % kStages) * kMmaKeys * LD;
    bf16* vd = vs + (t % kStages) * kMmaKeys * LD;
    for (int e = tid; e < kMmaKeys * chunks; e += kThreads) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      const bool in = k0 + r < k_end;
      const long long o = static_cast<long long>(in ? k0 + r : 0) * hd + c;
      copy16(kd + r * LD + c, kb + o, in);
      copy16(vd + r * LD + c, vb + o, in);
    }
  };
  if (ntiles > 0) load_tile(0);
  copies_commit();

  const int g = lane / 4, t4 = lane % 4;
  const int qrow = warp * 16 + g;  // this thread's first row in the block
  int qpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) qpos[h2] = (r0 + qrow + 8 * h2) / rep + off;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int lrow = lane % 8, lmat = lane / 8;

  uint32_t qf[KSTEPS][4];
  float o[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    copies_commit();
    copies_wait<1>();  // all but the newest group: tile t (and the queries)
    __syncthreads();
    if (t == 0) {
      // A fragments: matrices (rows 0-7, 8-15) x (depth 0-7, 8-15)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm4(qf[kk], qs + (warp * 16 + (lmat % 2) * 8 + lrow) * LD + kk * 16 +
                          (lmat / 2) * 8);
    }
    const bf16* kt = ks + (t % kStages) * kMmaKeys * LD;
    const bf16* vt = vs + (t % kStages) * kMmaKeys * LD;
    const int k0 = k_begin + t * kMmaKeys;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        // matrices (keys 0-7, 8-15 of the pair) x (depth 0-7, 8-15)
        uint32_t bk[4];
        ldsm4(bk, kt + (np * 16 + (lmat / 2) * 8 + lrow) * LD + kk * 16 +
                      (lmat % 2) * 8);
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // the elementwise mask, only on a tile that straddles an edge
    const bool edge = k0 + kMmaKeys > k_end ||
                      (causal && k0 + kMmaKeys - 1 > i_lo + off) ||
                      (window > 0 && k0 <= i_hi + off - window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qp = qpos[e / 2];
          const bool vis = j < k_end && (!causal || j <= qp) &&
                           (window <= 0 || qp - j < window);
          if (!vis) s[nt][e] = -INFINITY;
        }
    }

    // online softmax in base 2, rows g (h2 = 0) and g + 8 (h2 = 1); the
    // four lanes of a quad share a row
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h2], s[nt][2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 2));
      const float mn = fmaxf(m[h2], mx * scale_log2);
      // before the row's first visible key m stays -inf, and p and the
      // correction are 0 (no -inf - -inf)
      const float mu = mn == -INFINITY ? 0.0f : mn;
      const float corr = exp2f(m[h2] - mu);
      m[h2] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * h2; e < 2 * h2 + 2; ++e) {
          const float p = exp2f(fmaf(s[nt][e], scale_log2, -mu));
          s[nt][e] = p;
          sum += p;
        }
      l[h2] = l[h2] * corr + sum;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * h2] *= corr;
        o[nt][2 * h2 + 1] *= corr;
      }
    }

    // O += P V, P as bf16 hi + lo from the S registers; 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // matrices (keys 0-7, 8-15) x (columns 0-7, 8-15), transposed
        uint32_t bv[4];
        ldsm4_t(bv, vt + (kk * 16 + (lmat % 2) * 8 + lrow) * LD + np * 16 +
                        (lmat / 2) * 8);
        mma(o[2 * np], ph, bv[0], bv[1]);
        mma(o[2 * np], pl, bv[0], bv[1]);
        mma(o[2 * np + 1], ph, bv[2], bv[3]);
        mma(o[2 * np + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is read before a later copy refills it
  }
  copies_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(repro::kFullMask, lt, 1);
    lt += __shfl_xor_sync(repro::kFullMask, lt, 2);
    const float div = lt == 0.0f ? 1.0f : lt;
    const int R = r0 + qrow + 8 * h2;
    if (R >= total) continue;
    const int i = R / rep, h = hkv * rep + R % rep;
    const long long row = (static_cast<long long>(b) * Hq + h) * Sq + i;
    bf16* dst = out + row * hd;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (col >= hd) continue;
      uint32_t hi, lo;  // the output's bf16 and its rounding residual
      split(o[nt][2 * h2] / div, o[nt][2 * h2 + 1] / div, hi, lo);
      *reinterpret_cast<uint32_t*>(dst + col) = hi;
      if (out_lo != nullptr)
        *reinterpret_cast<uint32_t*>(out_lo + row * hd + col) = lo;
    }
    // the row's log2-sum-exp2 of the scaled scores (m is in base 2)
    if (lse != nullptr && t4 == 0)
      lse[row] = lt == 0.0f ? INFINITY : m[h2] + log2f(lt);
  }
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, void* out_lo, int B, int Hq, int Hkv, int Sq,
               int Sk, int hd,
               long long kv_head_stride, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (kMmaRows + 2 * kStages * kMmaKeys) *
                      static_cast<size_t>(HDP + 8);
  auto kernel = flash_attn_mma_kernel<HDP>;
  const cudaError_t e = repro::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq * (Hq / Hkv) + kMmaRows - 1) / kMmaRows, B * Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse,
      static_cast<bf16*>(out_lo), Hq, Hkv, Sq, Sk, hd, kv_head_stride, causal,
      window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int mma_by_depth(const void* q, const void* k, const void* v, void* out,
                 float* lse, void* out_lo, int B, int Hq, int Hkv, int Sq,
                 int Sk, int hd,
                 long long kv_head_stride, int causal, int window, float scale,
                 cudaStream_t s) {
#define REPRO_MMA_CASE(n)                                                    \
  case n:                                                                    \
    return launch_mma<16 * n>(q, k, v, out, lse, out_lo, B, Hq, Hkv, Sq, Sk, \
                              hd, kv_head_stride, causal, window, scale, s);
  switch ((hd + 15) / 16) {
    REPRO_MMA_CASE(1)
    REPRO_MMA_CASE(2)
    REPRO_MMA_CASE(3)
    REPRO_MMA_CASE(4)
    REPRO_MMA_CASE(5)
    REPRO_MMA_CASE(6)
    REPRO_MMA_CASE(7)
    REPRO_MMA_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MMA_CASE
}

// ---------------------------------------------------------------------------
// flash_attn_wgmma_kernel: bf16 on Hopper's warpgroups
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // a producer warpgroup and two consumers
constexpr int kWgStages = 3;     // K/V tiles in the TMA ring
constexpr int kWgRows = 128;     // query rows a block, 64 a consumer
constexpr int kWgKeys = 64;      // keys a staged tile

using repro::kmajor;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_wait;
using repro::mnmajor;
using repro::my_turn;
using repro::slab;
using repro::tma_load_3d;
using repro::your_turn;

// the shared memory a block asks for: Q and the ring from a 1,024-byte
// boundary, then the barriers
__host__ __device__ constexpr size_t wg_smem(int hd) {
  return 1024 + kWgRows * hd * 2 + kWgStages * 2 * kWgKeys * hd * 2 +
         (1 + 2 * kWgStages) * 8;
}

// O += P V for one staged tile: P as bf16 hi and lo register A operands
// (16 keys a step), V's rows read MN-major
template <int HD>
__device__ __forceinline__ void wg_pv(float (&acc)[HD / 2],
                                      const uint32_t (&ph)[4][4],
                                      const uint32_t (&pl)[4][4],
                                      const bf16* vt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    repro::wgmma_rs<HD>(acc, ph[kk],
                        mnmajor(vt + slab(0, kWgKeys, 16 * kk), kWgKeys));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    repro::wgmma_rs<HD>(acc, pl[kk],
                        mnmajor(vt + slab(0, kWgKeys, 16 * kk), kWgKeys));
}

// Grid: (B * Hq, Sq / 128 rounded up), the heads fastest (the rep query
// heads of a kv head read its K/V tiles from L2 together) and the last
// query tiles (under a causal mask, the longest walks) first.  Warpgroup
// 0's first thread loads the block's 128 Q rows once, then the K and V
// tiles of its key range (ops.py:bwd_k_range, rows=128) into the ring;
// each consumer warpgroup takes 64 rows.  A consumer's turn at the tensor
// cores issues the previous tile's O += P V and this tile's S = Q K^T
// together; out of its turn it masks (a tile on an edge only), runs the
// online softmax on the S accumulator and splits P into the bf16 hi + lo
// A operands of the next turn's P V.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ out,     // [B, Hq, Sq, hd]
                        float* __restrict__ lse,    // [B, Hq, Sq] or null
                        bf16* __restrict__ out_lo,  // as out, or null
                        int Hq, int Hkv, int Sq, int Sk, int causal,
                        int window, float scale_log2) {
  constexpr int SLABS = HD / 16;
  constexpr uint32_t kRowsBytes = kWgRows * HD * 2;  // Q of the block
  constexpr uint32_t kTileBytes = kWgKeys * HD * 2;  // a K (V) tile
  extern __shared__ unsigned char raw[];
  unsigned char* sm = repro::aligned_1024(raw);
  bf16* qs = reinterpret_cast<bf16*>(sm);
  unsigned char* ring = sm + kRowsBytes;  // [stage]: K tile, V tile
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + kWgStages * 2 * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWgStages;

  const int bh = blockIdx.x;  // b * Hq + query head
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const long long row_base = static_cast<long long>(bh) * Sq;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;  // last first
  const int off = Sk - Sq;
  int k_begin, k_end;
  repro::key_range(i0, min(i0 + kWgRows, Sq) - 1, off, Sk, causal, window,
                   k_begin, k_end);
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + kWgKeys - 1) / kWgKeys : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 2 * 128);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer
    repro::regs_dec<repro::kProducerRegs>();
    if (tid != 0) return;
    mbar_expect_tx(q_full, kRowsBytes);
    for (int s = 0; s < SLABS; ++s)
      for (int r = 0; r < kWgRows; r += repro::kTmaBox)
        tma_load_3d(qs + slab(s, kWgRows, r), &tq, q_full, 16 * s, i0 + r, bh);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kWgStages;
      mbar_wait(&empty[st], ((t / kWgStages) & 1) ^ 1);
      bf16* kd = reinterpret_cast<bf16*>(ring + st * 2 * kTileBytes);
      bf16* vd = kd + kWgKeys * HD;
      const int k0 = k_begin + t * kWgKeys;
      mbar_expect_tx(&full[st], 2 * kTileBytes);
      for (int s = 0; s < SLABS; ++s) {
        tma_load_3d(kd + slab(s, kWgKeys, 0), &tk, &full[st], 16 * s, k0, bkv);
        tma_load_3d(vd + slab(s, kWgKeys, 0), &tv, &full[st], 16 * s, k0, bkv);
      }
    }
    return;
  }
  repro::regs_inc<repro::kConsumerRegs>();
  // the consumer, rows [64 wg, 64 wg + 64), read through a shuffle so that
  // the compiler knows it is the same on every lane: the branches below
  // that depend on it are uniform, and no wgmma sits in a divergent path
  // (ptxas would serialize them all)
  const int wg = __shfl_sync(repro::kFullMask, tid / 128 - 1, 0);
  const int t128 = tid % 128, warp = t128 / 32, lane = t128 % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = wg * 64;

  // rows g and g + 8 of the warp's 16; columns 2 t4 + {0, 1} of every
  // 8-wide n-tile (hopper.cuh's accumulator layout)
  int qpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
    qpos[h2] = i0 + r0 + warp * 16 + g + 8 * h2 + off;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;
  // the last tile's P for the next turn's P V: 0 before the first tile
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) ph[kk][j] = pl[kk][j] = 0u;

  const int iw_lo = i0 + r0, iw_hi = min(iw_lo + 63, Sq - 1);
  mbar_wait(q_full, 0);
  if (wg == 1) your_turn(wg);  // consumer 0 goes first
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kWgStages;
    const int last = (t + kWgStages - 1) % kWgStages;  // the last tile's
    mbar_wait(&full[st], (t / kWgStages) & 1);
    const int k0 = k_begin + t * kWgKeys;
    const bf16* kt = reinterpret_cast<const bf16*>(ring + st * 2 * kTileBytes);
    // the turn: this tile's S, then the last tile's P V (P = 0 on the
    // first tile, whose own V stands in), issued behind the other
    // consumer's products and handed over at once: the tensor cores run
    // them in issue order.  Both are issued on every tile, so that no
    // wgmma sits behind a branch
    float s[32];
    my_turn(wg);
    repro::wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl)
      repro::wgmma_ss_n64(s, kmajor(qs + slab(sl, kWgRows, r0)),
                          kmajor(kt + slab(sl, kWgKeys, 0)), sl > 0);
    repro::wgmma_commit();
    wg_pv<HD>(acc, ph, pl,
              reinterpret_cast<const bf16*>(ring + (t > 0 ? last : st) * 2 *
                                                       kTileBytes) +
                  kWgKeys * HD);
    repro::wgmma_commit();
    your_turn(wg);
    repro::wgmma_wait<1>();  // S; the P V may still run
    repro::keep(s);

    // a tile no row of this warpgroup sees (or no row at all) counts as
    // masked everywhere: p = 0, m and l as they were
    const bool skip = iw_lo >= Sq || (causal && k0 > iw_hi + off) ||
                      (window > 0 && iw_lo + off - (k0 + kWgKeys - 1) >= window);
    // the elementwise mask, only on a tile that straddles an edge
    if (skip || k0 + kWgKeys > k_end ||
        (causal && k0 + kWgKeys - 1 > iw_lo + off) ||
        (window > 0 && k0 <= iw_hi + off - window)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = k0 + (e / 4) * 8 + 2 * t4 + (e & 1);
        if (skip || !(j < k_end && repro::visible(qpos[(e / 2) % 2], j,
                                                  causal, window)))
          s[e] = -INFINITY;
      }
    }
    // online softmax in base 2; the four lanes of a quad share a row
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * h2], s[4 * nt + 2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 2));
      const float mn = fmaxf(m[h2], mx * scale_log2);
      // before the row's first visible key m stays -inf, and p and the
      // correction are 0 (no -inf - -inf)
      const float mu = mn == -INFINITY ? 0.0f : mn;
      corr[h2] = repro::fast_exp2(m[h2] - mu);
      m[h2] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 4 * nt + 2 * h2; e < 4 * nt + 2 * h2 + 2; ++e) {
          const float p = repro::fast_exp2(fmaf(s[e], scale_log2, -mu));
          s[e] = p;
          sum += p;
        }
      l[h2] = l[h2] * corr[h2] + sum;
    }
    repro::wgmma_wait<0>();  // the last tile's P V
    repro::keep(acc);
    if (t > 0) mbar_arrive(&empty[last]);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * nt + e] *= corr[e / 2];
    // P as the A operands of 16-key steps (n-tiles 2 kk and 2 kk + 1), each
    // split into hi = bf16(P) and lo = bf16(P - hi)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph[kk][j], pl[kk][j]);
  }
  if (ntiles > 0) {  // the last tile's P V (the same on the whole block)
    repro::wgmma_fence();
    wg_pv<HD>(acc, ph, pl,
              reinterpret_cast<const bf16*>(
                  ring + ((ntiles - 1) % kWgStages) * 2 * kTileBytes) +
                  kWgKeys * HD);
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::keep(acc);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(repro::kFullMask, lt, 1);
    lt += __shfl_xor_sync(repro::kFullMask, lt, 2);
    const float div = lt == 0.0f ? 1.0f : lt;
    const int i = qpos[h2] - off;
    if (i >= Sq) continue;
    const long long row = row_base + i;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      uint32_t hi, lo;  // the output's bf16 and its rounding residual
      split(acc[4 * nt + 2 * h2] / div, acc[4 * nt + 2 * h2 + 1] / div, hi, lo);
      *reinterpret_cast<uint32_t*>(out + row * HD + col) = hi;
      if (out_lo != nullptr)
        *reinterpret_cast<uint32_t*>(out_lo + row * HD + col) = lo;
    }
    // the row's log2-sum-exp2 of the scaled scores (m is in base 2)
    if (lse != nullptr && t4 == 0)
      lse[row] = lt == 0.0f ? INFINITY : m[h2] + log2f(lt);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, void* out_lo, int B, int Hq, int Hkv, int Sq,
                 int Sk, long long kv_head_stride, int causal, int window,
                 float scale, cudaStream_t stream) {
  const int tiles = (Sq + kWgRows - 1) / kWgRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!repro::rows_map(&tq, q, B * Hq, Sq, HD,
                       static_cast<long long>(Sq) * HD) ||
      !repro::rows_map(&tk, k, B * Hkv, Sk, HD, kv_head_stride) ||
      !repro::rows_map(&tv, v, B * Hkv, Sk, HD, kv_head_stride))
    return static_cast<int>(cudaErrorNotSupported);
  auto kernel = flash_attn_wgmma_kernel<HD>;
  const cudaError_t e = repro::allow_smem(kernel, wg_smem(HD));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(B * Hq, tiles), kWgThreads, wg_smem(HD), stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, static_cast<bf16*>(out_lo),
      Hq, Hkv, Sq, Sk, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int wgmma_by_depth(const void* q, const void* k, const void* v, void* out,
                   float* lse, void* out_lo, int B, int Hq, int Hkv, int Sq,
                   int Sk, int hd, long long kv_head_stride, int causal,
                   int window, float scale, cudaStream_t s) {
#define REPRO_WGMMA_CASE(n)                                                  \
  case n:                                                                    \
    return launch_wgmma<n>(q, k, v, out, lse, out_lo, B, Hq, Hkv, Sq, Sk,    \
                           kv_head_stride, causal, window, scale, s);
  switch (hd) {
    REPRO_WGMMA_CASE(64)
    REPRO_WGMMA_CASE(80)
    REPRO_WGMMA_CASE(96)
    REPRO_WGMMA_CASE(112)
    REPRO_WGMMA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_WGMMA_CASE
}

// ---------------------------------------------------------------------------
// flash_attn_decode_kernel: bf16 rows < 16, the keys split across blocks
// ---------------------------------------------------------------------------

constexpr int kDecKeys = 32;         // keys a warp's tile holds: one a lane
constexpr int kDecChunks = 16;       // 16-byte chunks of a row: hd <= 128
constexpr int kDecMaxRows = 8;       // rows a block serves (a row group)
constexpr int kDecMaxSplits = 264;   // ops.py:DECODE_TARGET_BLOCKS

// Eight bf16 values (16 bytes) as fp32.
__device__ __forceinline__ void bf16x8(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    f[2 * u] = __uint_as_float(w[u] << 16);
    f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}

// a[0..8) * scale as eight bf16 values, one 16-byte store.
__device__ __forceinline__ void store_bf16x8(bf16* dst, const float (&a)[8],
                                             float scale) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    w[u] = bits(__floats2bfloat162_rn(a[2 * u] * scale, a[2 * u + 1] * scale));
  *reinterpret_cast<uint4*>(dst) = raw;
}

constexpr int kDecSlotFloats = 256;  // (32 / (hd / 8)) * hd <= 256

// One decode tile's loads into registers: lane j the K row of key k0 + j
// (NC 16-byte chunks), and lane (slot, c) chunk c of V rows k0 + slot,
// k0 + slot + kpi, ... (iters of them); nothing past ke.
__device__ __forceinline__ void decode_tile_loads(
    uint4 (&kr)[kDecChunks], uint4 (&vr)[kDecChunks], const bf16* kh,
    const bf16* vh, int k0, int ke, int hd, int NC, int lane, int slot,
    int kpi, int iters, int cc, bool pv_lane) {
  if (k0 + lane < ke) {
    const uint4* src =
        reinterpret_cast<const uint4*>(kh + static_cast<long long>(k0 + lane) * hd);
#pragma unroll
    for (int c = 0; c < kDecChunks; ++c)
      if (c < NC) kr[c] = src[c];
  }
#pragma unroll
  for (int it = 0; it < kDecChunks; ++it) {
    const int jj = slot + kpi * it;
    if (it < iters && pv_lane && jj < kDecKeys && k0 + jj < ke)
      vr[it] = *reinterpret_cast<const uint4*>(
          vh + static_cast<long long>(k0 + jj) * hd + 8 * cc);
  }
}

// RM: rows a block serves, a power of two up to kDecMaxRows (the row group).
// Scratch (splits > 1): part_ml [B * Hkv * G][splits][RM][2] (m, l) and
// part_acc [B * Hkv * G][splits][RM][hd]; tickets [B * Hkv * G], zero
// between calls.
template <int RM>
__global__ void __launch_bounds__(kThreads)
flash_attn_decode_kernel(const bf16* __restrict__ q,   // [B, Hq, Sq, hd]
                         const bf16* __restrict__ k,   // [B, Hkv] heads of [Sk, hd]
                         const bf16* __restrict__ v,   // same layout as k
                         bf16* __restrict__ out,       // [B, Hq, Sq, hd]
                         float* __restrict__ part_ml, float* __restrict__ part_acc,
                         int* __restrict__ tickets, int Hq, int Hkv, int Sq,
                         int Sk, int hd, long long kv_head_stride, int causal,
                         int window, float scale_log2, int chunk) {
  __shared__ __align__(16) float qs[RM * kDecChunks * 8];  // [RM][hd]
  // [warp][slot][RM][hd] partial accumulators; reused by the final merge
  // as its [split][RM] weights
  __shared__ __align__(16) float accs[kWarps * kDecSlotFloats * RM];
  __shared__ float ms[kWarps][RM], ls[kWarps][RM];
  __shared__ float wts[kWarps][RM], inv[RM];  // merge weights, 1 / l
  __shared__ int last;

  const int split = blockIdx.x, splits = gridDim.x;
  const int used = (Sk + chunk - 1) / chunk;  // chunks that hold a key
  if (split >= used) return;
  const int bkv = blockIdx.y, grp = blockIdx.z;
  const int b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int rep = Hq / Hkv, total = Sq * rep, off = Sk - Sq;
  const int r0 = grp * RM, rows = min(RM, total - r0);
  const int NC = hd / 8;  // 16-byte chunks a row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the chunk's keys that some row of the group can see
  const int i_lo = r0 / rep, i_hi = (r0 + rows - 1) / rep;
  const int vis_end = causal ? min(Sk, i_hi + off + 1) : Sk;
  const int vis_begin = window > 0 ? max(0, i_lo + off - window + 1) : 0;
  const int kb = max(split * chunk, vis_begin);
  const int ke = min(min(split * chunk + chunk, Sk), vis_end);
  const int ntiles = ke > kb ? (ke - kb + kDecKeys - 1) / kDecKeys : 0;
  const bf16* kh = k + bkv * kv_head_stride;
  const bf16* vh = v + bkv * kv_head_stride;

  int qpos[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) qpos[r] = (r0 + r) / rep + off;

  // P.V's lane layout: lane (slot, c) owns columns 8c .. 8c + 7 of keys
  // slot, slot + kpi, ... of a tile
  const int kpi = kDecKeys / NC, slot = lane / NC, cc = lane - slot * NC;
  const bool pv_lane = slot < kpi;
  const int iters = (kDecKeys + kpi - 1) / kpi;

  // a tile's K rows (lane j: key j, all of its row) and V pieces (lane
  // (slot, c): columns 8c.. of its keys), both in flight at once; the warp's
  // first tile loads while the queries are staged
  uint4 kr[kDecChunks], vr[kDecChunks];
  if (warp < ntiles)
    decode_tile_loads(kr, vr, kh, vh, kb + warp * kDecKeys, ke, hd, NC, lane,
                      slot, kpi, iters, cc, pv_lane);

  // the group's query rows as fp32, scaled by scale * log2(e); zeros past
  // its last row
  for (int e = tid; e < RM * NC; e += kThreads) {
    const int r = e / NC, c = e - r * NC;
    float f[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (r < rows) {
      const int R = r0 + r, i = R / rep, h = hkv * rep + R % rep;
      bf16x8(*reinterpret_cast<const uint4*>(
                 q + ((static_cast<long long>(b) * Hq + h) * Sq + i) * hd + 8 * c),
             f);
    }
    float4* dst = reinterpret_cast<float4*>(qs + r * hd + 8 * c);
    dst[0] = make_float4(f[0] * scale_log2, f[1] * scale_log2,
                         f[2] * scale_log2, f[3] * scale_log2);
    dst[1] = make_float4(f[4] * scale_log2, f[5] * scale_log2,
                         f[6] * scale_log2, f[7] * scale_log2);
  }
  __syncthreads();

  float m[RM], l[RM], acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  }

  for (int t = warp; t < ntiles; t += kWarps) {
    if (t != warp)
      decode_tile_loads(kr, vr, kh, vh, kb + t * kDecKeys, ke, hd, NC, lane,
                        slot, kpi, iters, cc, pv_lane);
    const int k0 = kb + t * kDecKeys, j = k0 + lane;
    const bool in = j < ke;

    // scores of key j against the group's rows (base 2)
    float s[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) s[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDecChunks; ++c) {
      if (c >= NC || !in) break;
      float kf[8];
      bf16x8(kr[c], kf);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(qs + r * hd + 8 * c);
        const float4 bq =
            *reinterpret_cast<const float4*>(qs + r * hd + 8 * c + 4);
        float x = s[r];
        x = fmaf(a.x, kf[0], x);
        x = fmaf(a.y, kf[1], x);
        x = fmaf(a.z, kf[2], x);
        x = fmaf(a.w, kf[3], x);
        x = fmaf(bq.x, kf[4], x);
        x = fmaf(bq.y, kf[5], x);
        x = fmaf(bq.z, kf[6], x);
        x = fmaf(bq.w, kf[7], x);
        s[r] = x;
      }
    }

    // online softmax over the tile; m is the same on every lane
    float p[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const bool vis = in && r < rows && (!causal || j <= qpos[r]) &&
                       (window <= 0 || qpos[r] - j < window);
      const float sc = vis ? s[r] : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(sc));
      // before the row's first visible key m stays -inf, and p and the
      // correction are 0 (no -inf - -inf)
      const float mu = mn == -INFINITY ? 0.0f : mn;
      const float corr = exp2f(m[r] - mu);
      p[r] = exp2f(sc - mu);
      l[r] = l[r] * corr + p[r];
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
    }

    // P.V: P of key jj from lane jj
#pragma unroll
    for (int it = 0; it < kDecChunks; ++it) {
      if (it >= iters) break;  // the same on every lane
      const int jj = slot + kpi * it;
      const bool ok = pv_lane && jj < kDecKeys && k0 + jj < ke;
      float pj[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        pj[r] = __shfl_sync(repro::kFullMask, p[r], ok ? jj : 0);
      if (ok) {
        float vf[8];
        bf16x8(vr[it], vf);
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pj[r], vf[e], acc[r][e]);
      }
    }
  }

  // the warps' states into shared memory, then the block's state
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float lt = repro::warp_sum(l[r]);
    if (lane == 0) {
      ms[warp][r] = m[r];
      ls[warp][r] = lt;
    }
  }
  if (pv_lane) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float4* dst = reinterpret_cast<float4*>(
          accs + ((warp * kpi + slot) * RM + r) * hd + 8 * cc);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();

  // each row's merge weights over the warps, 2^(m_w - M) (0 where M =
  // -inf), its l and its 1 / l (1 where l = 0: the row gives 0)
  if (tid < rows) {
    const int r = tid;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ms[w][r]);
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = M == -INFINITY ? 0.0f : exp2f(ms[w][r] - M);
      wts[w][r] = wt;
      L = fmaf(wt, ls[w][r], L);
    }
    ms[0][r] = M;
    ls[0][r] = L;
    inv[r] = 1.0f / (L == 0.0f ? 1.0f : L);
  }
  __syncthreads();

  // the block's state, a thread per (row, 8 columns): the output itself
  // with one chunk, else the chunk's state in the scratch
  const long long rec = (static_cast<long long>(bkv) * gridDim.z + grp) * splits;
  for (int e = tid; e < rows * NC; e += kThreads) {
    const int r = e / NC, c = e - r * NC;
    float A[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = wts[w][r];
      for (int sl = 0; sl < kpi; ++sl) {
        const float4* src = reinterpret_cast<const float4*>(
            accs + ((w * kpi + sl) * RM + r) * hd + 8 * c);
        const float4 x = src[0], y = src[1];
        A[0] = fmaf(wt, x.x, A[0]);
        A[1] = fmaf(wt, x.y, A[1]);
        A[2] = fmaf(wt, x.z, A[2]);
        A[3] = fmaf(wt, x.w, A[3]);
        A[4] = fmaf(wt, y.x, A[4]);
        A[5] = fmaf(wt, y.y, A[5]);
        A[6] = fmaf(wt, y.z, A[6]);
        A[7] = fmaf(wt, y.w, A[7]);
      }
    }
    if (used == 1) {
      const int R = r0 + r, i = R / rep, h = hkv * rep + R % rep;
      store_bf16x8(out + ((static_cast<long long>(b) * Hq + h) * Sq + i) * hd +
                       8 * c,
                   A, inv[r]);
    } else {
      float4* dst = reinterpret_cast<float4*>(
          part_acc + ((rec + split) * RM + r) * hd + 8 * c);
      dst[0] = make_float4(A[0], A[1], A[2], A[3]);
      dst[1] = make_float4(A[4], A[5], A[6], A[7]);
      if (c == 0) {
        part_ml[((rec + split) * RM + r) * 2] = ms[0][r];
        part_ml[((rec + split) * RM + r) * 2 + 1] = ls[0][r];
      }
    }
  }
  if (used == 1) return;

  // the last block of the (batch, kv head, row group) to arrive merges
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&tickets[bkv * gridDim.z + grp], 1) == used - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // every chunk's (m, l) at once, then each row's weights and 1 / l, then
  // a thread per output element, the chunks summed in chunk order (so the
  // result does not depend on which block came last)
  float* wsplit = accs;                           // [used][RM]: m, then weights
  float* lsplit = accs + kDecMaxSplits * RM;      // [used][RM]: l
  for (int e = tid; e < used * rows; e += kThreads) {
    const int sp = e / rows, r = e - sp * rows;
    const float* ml = part_ml + ((rec + sp) * RM + r) * 2;
    wsplit[sp * RM + r] = __ldcg(ml);
    lsplit[sp * RM + r] = __ldcg(ml + 1);
  }
  __syncthreads();
  if (tid < rows) {
    const int r = tid;
    float M = -INFINITY;
    for (int sp = 0; sp < used; ++sp) M = fmaxf(M, wsplit[sp * RM + r]);
    float L = 0.0f;
    for (int sp = 0; sp < used; ++sp) {
      const float wt = M == -INFINITY ? 0.0f : exp2f(wsplit[sp * RM + r] - M);
      wsplit[sp * RM + r] = wt;
      L = fmaf(wt, lsplit[sp * RM + r], L);
    }
    inv[r] = 1.0f / (L == 0.0f ? 1.0f : L);
  }
  __syncthreads();
  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd, col = e - r * hd;
    float A = 0.0f;
    for (int sp = 0; sp < used; ++sp)
      A = fmaf(wsplit[sp * RM + r],
               __ldcg(part_acc + ((rec + sp) * RM + r) * hd + col), A);
    const int R = r0 + r, i = R / rep, h = hkv * rep + R % rep;
    out[((static_cast<long long>(b) * Hq + h) * Sq + i) * hd + col] =
        __float2bfloat16(A * inv[r]);
  }
  if (tid == 0) tickets[bkv * gridDim.z + grp] = 0;  // for the next call
}

template <int RM>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  float* part, int* tickets, int B, int Hq, int Hkv, int Sq,
                  int Sk, int hd, long long kv_head_stride, int causal,
                  int window, float scale, int splits, int chunk, int groups,
                  cudaStream_t stream) {
  // part_ml, then part_acc from the next 16-byte boundary
  float* part_ml = part;
  float* part_acc =
      part + ((static_cast<size_t>(B) * Hkv * groups * splits * RM * 2 + 3) &
              ~static_cast<size_t>(3));
  const dim3 grid(splits, B * Hkv, groups);
  flash_attn_decode_kernel<RM><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), part_ml, part_acc,
      tickets, Hq, Hkv, Sq, Sk, hd, kv_head_stride, causal, window,
      scale * kLog2e, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: contiguous [B, Hq, Sq, hd]; k, v: B * Hkv heads of Sk contiguous
// rows of hd, kv_head_stride elements apart (a prefix of a longer cache
// passes its own stride).  hd a multiple of 8 up to 128, every pointer and
// head 16-byte aligned, Hq a multiple of Hkv: the wrapper checks, and takes
// 1 <= Sq <= Sk, or any Sq when causal == 0 and window <= 0 (every query
// sees every key: cross-attention; under a mask with Sq > Sk the first
// queries would sit before key 0 and see nothing: 0).  window <= 0 means
// none.  bf16 != 0: bf16 operands, else
// fp32.  variant (ops.py:VARIANTS): 0 flash_attn_kernel (fp32 only), 1
// flash_attn_mma_kernel (bf16 only), 3 flash_attn_wgmma_kernel (bf16 at hd
// 64, 80, 96, 112 or 128; cudaErrorNotSupported where a tensor map does not
// encode), 4 flash_attn_tiled_kernel (fp32 only); bf16 decode has its own
// entry point, flash_attn_decode.
// lse: null, or fp32 [B, Hq, Sq] that gets each row's log-sum-exp of the
// scaled scores in base 2 (+inf for a row that sees no key), the
// statistics flash_attn_bwd's "wgmma" and "simt_tiled" kernels read.
// out_lo (bf16 only): null, or as out, that gets the rounding residual
// bf16(o - bf16(o)) of each fp32 output o, so that out + out_lo is the
// output to 16 bits (the "wgmma" backward's D = rowsum(dO o O)).
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, void* lse, void* out_lo, int B, int Hq,
                          int Hkv, int Sq, int Sk, int hd,
                          long long kv_head_stride,
                          int causal, int window, float scale, int bf16,
                          int variant, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ls = static_cast<float*>(lse);
  if (variant == 1 || variant == 3) {
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    return (variant == 1 ? mma_by_depth : wgmma_by_depth)(
        q, k, v, out, ls, out_lo, B, Hq, Hkv, Sq, Sk, hd, kv_head_stride,
        causal, window, scale, s);
  }
  if ((variant != 0 && variant != 4) || bf16 || out_lo != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 4)
    return tiled_by_columns(q, k, v, out, ls, B, Hq, Hkv, Sq, Sk, hd,
                            kv_head_stride, causal, window, scale, s);
  return by_rows<float>(q, k, v, out, ls, B, Hq, Hkv, Sq, Sk, hd,
                        kv_head_stride, causal, window, scale, s);
}

// The decode variant (bf16, Sq * Hq / Hkv < 16 rows; the wrapper checks):
// q, k, v, out and kv_head_stride as flash_attn takes them; splits and chunk
// from ops.py:decode_plan (splits <= 264, chunk a multiple of 128 with
// splits * chunk >= Sk).  With splits > 1, `part` is 16-byte aligned fp32
// scratch of B * Hkv * G * splits * RM * (hd + 2) + 4 floats and `tickets`
// B * Hkv * G ints that are zero, and are left zero (RM: rows rounded up to
// a power of two, at most 8; G: row groups of RM).
extern "C" int flash_attn_decode(const void* q, const void* k, const void* v,
                                 void* out, void* part, void* tickets, int B,
                                 int Hq, int Hkv, int Sq, int Sk, int hd,
                                 long long kv_head_stride, int causal,
                                 int window, float scale, int splits,
                                 int chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int rows = Sq * (Hq / Hkv);
  if (rows >= 16 || hd % 8 || hd > 8 * kDecChunks || splits < 1 ||
      splits > kDecMaxSplits || chunk % kDecKeys ||
      static_cast<long long>(splits) * chunk < Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* pf = static_cast<float*>(part);
  auto* tk = static_cast<int*>(tickets);
  const int groups = (rows + kDecMaxRows - 1) / kDecMaxRows;
#define REPRO_DECODE_CASE(n)                                                 \
  return launch_decode<n>(q, k, v, out, pf, tk, B, Hq, Hkv, Sq, Sk, hd,      \
                          kv_head_stride, causal, window, scale, splits,     \
                          chunk, groups, s);
  if (rows <= 1) REPRO_DECODE_CASE(1)
  if (rows <= 2) REPRO_DECODE_CASE(2)
  if (rows <= 4) REPRO_DECODE_CASE(4)
  REPRO_DECODE_CASE(8)
#undef REPRO_DECODE_CASE
}
