// flash_attn_bwd: the gradient of flash_attn (dq, dk, dv from q, k, v and
// the output's gradient do), GQA, causal and sliding-window masks, queries
// end-aligned with keys.
//
// Replaces no TPU kernel: the reference has no Pallas backward and
// differentiates its XLA chunked_attention (src/repro/nn/attention.py:49)
// instead.  It takes the place of the plain PyTorch backward
// (kernels/flash_attn/ref.py:attention_bwd_ref) on the card, and computes
// the same function: query i (at position i + Sk - Sq) sees key j iff
// j <= i + Sk - Sq (causal) and i + Sk - Sq - j < window (when a window is
// set); query head h reads kv head h / rep (rep = Hq / Hkv), and dk, dv sum
// the rep query heads of a kv head; scale 1/sqrt(hd).  With P the softmax
// of the scaled scores S = QK^T, dP = dO V^T and D = rowsum(P o dP):
//   dV = P^T dO,  dS = P o (dP - D),  dQ = scale dS K,  dK = scale dS^T Q.
//
// Bound on the H100 by bf16 operations: the function's 5 products of
// 2 * hd operations a visible (query, key) pair (the operator's flop
// formula) at 989 TFLOP/s.  Three variants, picked by
// kernels/flash_attn/ops.py:bwd_variant(dtype, hd), two passes a call, two
// kernels (three for "simt_tiled" under GQA), launched in order on one
// stream; no output is summed by atomics, so every call gives the same bits.
//
// "wgmma" (flash_attn_bwd_{dq,dkv}_wgmma_kernel; bf16, hd 64, 80, 96, 112,
//   128: every family's).  FlashAttention-3's backward made deterministic,
//   on the forward's statistics: the forward (flash_attn.cu) saves each
//   row's log-sum-exp, so a pass walks its tiles once and the design runs
//   7 products a pair (QK^T and dO V^T once in each pass, and the three
//   gradient products) and 2 exponentials.  A block is a producer
//   warpgroup (one thread issues TMA loads of 64 x 16 boxes in the 32-byte
//   swizzle, hopper.cuh, into a ring of three stages completed by
//   mbarriers; it gives its registers to the consumers by setmaxnreg) and
//   two consumer warpgroups of 64 rows running wgmma from shared memory,
//   taking turns at the tensor cores (one's exponentials under the other's
//   products); the grids put the heads fastest and the longest walks first:
//   1. the dQ pass (grid: B * Hq x 128-query tiles): D = rowsum(dO o O) of
//      its rows from the output as the forward had it in fp32 (the bf16
//      output plus its rounding residual, both flash_attn's; to dsum), then
//      over the keys its rows see,
//      in tiles of 64: S = Q K^T, dP = dO V^T, P = 2^(S scale log2 e - lse),
//      and dQ += (scale dS) K with scale dS as the register A operand;
//   2. the dK/dV pass (grid: B * Hkv x 128-key tiles): K and V of its keys
//      once, then the 64-query tiles (with their lse and D) of all rep query
//      heads that see one of its keys: S^T = K Q^T, dP^T = V dO^T, and
//      dV += P^T dO, dK += (scale dS)^T Q with P^T and scale dS^T as
//      register A operands and dO, Q read MN-major.  dK and dV stay in
//      registers; GQA sums in the block.
//   A tile a consumer's rows cannot see is skipped; only a tile on an edge
//   applies the elementwise mask.  hd 80 and 112 rows (160 and 224 bytes)
//   are 5 and 7 slabs of 16 columns, so no depth is padded.  Rounding as
//   the plain version: bf16 operands into every product, P and scale dS
//   rounded to bf16 from the accumulators, the softmax and its VJP in fp32,
//   S and dP fp32 (the plain version rounds them).  Left for later: a
//   consumer's exponentials overlapping its own next products, Q's and
//   dO's (K's and V's) A fragments held in registers, a one-pass dQ.
// "simt_tiled" (flash_attn_bwd_{dq,dkv}_tiled_kernel,
//   flash_attn_bwd_sum_kernel; fp32, every hd).  Bound by fp32 operations
//   outside the tensor cores (67 TFLOP/s); no TF32.  The same two passes on
//   the forward's statistics, 64 x 64 tiles double-buffered by cp.async,
//   256 threads a block that each own 4 x 4 micro-tiles of S and dP (rows
//   ty + 16 a, columns tx + 16 b: a warp's rows are broadcasts, its columns
//   16 consecutive rows of shared memory, every operand a float4: 8 FMAs a
//   load) and 4 rows x hd / 16 columns of the outputs (P or dS a float4 of
//   4 keys or queries, the other operand's 16 consecutive columns: 4
//   FMAs a load; at hd 80 a 4-column micro-tile would leave a fifth of the
//   tile to a quarter of the threads).  Grids put the heads fastest and
//   the longest walks first.  The dK/dV pass takes one query head a block
//   (the causal triangle's first keys see every query: a block a kv head
//   made the longest block rep times longer), so with GQA its dK, dV are
//   parts [B, Hq, Sk, hd] that flash_attn_bwd_sum_kernel adds in head
//   order.
// "mma": the first bf16 design, described below.  It makes its own
//   statistics: the dQ pass walks its keys twice, once for each row's
//   softmax state and D (the running sum of P o dP), 9 products a pair.
//   It keeps the bf16 head dims "wgmma" does not take (hd < 64 and
//   hd % 16 == 8).
//
// The first design's two passes:
//
// 1. The dQ pass (grid: q tiles x B * Hq).  A block serves one query head's
//    tile of rows and walks the keys its rows can see twice (the forward's
//    key range, ops.py:bwd_k_range).  The first walk recomputes each row's
//    softmax state (max m and normaliser l, online) and D as the running
//    sum of P o dP, rescaled with l: the same D as rowsum(dO o O) without
//    an O accumulator, and the way the plain version takes it
//    (_softmax_backward_data).  The row's log-sum-exp and D go to fp32
//    scratch [B, Hq, Sq].  The second walk recomputes S and dP, forms P from
//    the log-sum-exp and accumulates dQ += (scale dS) K.
// 2. The dK/dV pass (grid: key tiles x B * Hkv).  A block keeps its keys'
//    K and V in shared memory and walks the query tiles of all rep query
//    heads of its kv head that can see one of its keys (ops.py:bwd_q_range):
//    it recomputes S^T = K Q^T and dP^T = V dO^T, forms P^T and dS^T from
//    the scratch, and accumulates dV += P^T dO and dK += (scale dS)^T Q in
//    registers, GQA summed inside the block.
//
// flash_attn_bwd_{dq,dkv}_mma_kernel (bf16 operands): mma.sync.m16n8k16 with
//   bf16 operands and fp32 accumulators, 4 warps of 16 rows (queries in the
//   dQ pass, keys in the dK/dV pass).  Rounding as the plain version rounds:
//   bf16 operands into every product, P rounded to bf16 for dV and scale dS
//   rounded to bf16 for dQ and dK, both straight from the accumulator
//   registers as the A operand (FlashAttention-2); the softmax and its VJP
//   in fp32; S and dP stay fp32 (the plain version rounds them to bf16).
//   Tiles are staged by cp.async in a ring of two stages, rows padded by 16
//   bytes (ldmatrix without bank conflicts); the dQ pass's two walks run as
//   one ring over 2 x its key tiles.  The depth of a hd % 16 == 8 head is
//   zero-padded to the next 16 in shared memory, as the forward does.
//   Register pressure: the dK/dV pass holds a 16-key warp slice's dK and
//   dV accumulators (2 x hd / 2 fp32 a thread: 128 at hd 128), so its
//   query tiles are 32 wide (S^T and dP^T: 32 more) and its A fragments
//   of K and V are read from shared memory for every tile instead of held.
#include <cuda.h>
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
using repro::key_range;
using repro::kLog2e;
using repro::kMaxSmem;
using repro::kPLd;
using repro::kTile;
using repro::kTileThreads;
using repro::ldsm4;
using repro::ldsm4_t;
using repro::micro_dots;
using repro::micro_product;
using repro::mma;
using repro::stage_rows;
using repro::visible;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// the query tiles of `tile` rows with a query that can see a key of
// [j_lo, j_hi]: [t_lo, t_lo + count) (ops.py:bwd_q_range)
__device__ __forceinline__ void query_tiles(int j_lo, int j_hi, int off,
                                            int Sq, int causal, int window,
                                            int tile, int& t_lo, int& count) {
  const int i_lo = causal ? max(0, j_lo - off) : 0;
  const int i_hi = window > 0 ? min(Sq - 1, j_hi + window - 1 - off) : Sq - 1;
  t_lo = i_lo / tile;
  count = i_hi >= i_lo ? i_hi / tile - t_lo + 1 : 0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaRows = kWarps * 16;  // query rows a dQ block
constexpr int kMmaKeys = 64;           // keys a staged tile; keys a dK/dV block
constexpr int kMmaQTile = 32;          // queries a staged dK/dV tile
constexpr int kStages = 2;             // tiles in a cp.async ring

__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));
}

// The A fragment of a 16-deep step from two m16n8 accumulators (the keys or
// queries 0-7 and 8-15 of the step), rounded to bf16.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// HDP: hd rounded up to 16.  Per thread: rows g and g + 8 of its warp's 16
// (g = lane / 4) and columns 2 (lane % 4) + {0, 1} of every 8-wide n-tile.
// lse: log2-sum-exp2 of the scaled scores (+inf for a row that sees no
// key), dsum: D; both [B, Hq, Sq].
template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_mma_kernel(const bf16* __restrict__ q,     // [B, Hq, Sq, hd]
                             const bf16* __restrict__ k,     // [B, Hkv, Sk, hd]
                             const bf16* __restrict__ v,     // [B, Hkv, Sk, hd]
                             const bf16* __restrict__ dout,  // [B, Hq, Sq, hd]
                             bf16* __restrict__ dq,          // [B, Hq, Sq, hd]
                             float* __restrict__ lse, float* __restrict__ dsum,
                             int Hq, int Hkv, int Sq, int Sk, int hd,
                             int causal, int window, float scale_log2,
                             float scale) {
  constexpr int LD = HDP + 8;       // row stride (bf16): 16 bytes of padding
  constexpr int KSTEPS = HDP / 16;  // depth steps of QK^T and dO V^T
  constexpr int NT = HDP / 8;       // dQ's n-tiles
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* qs = reinterpret_cast<bf16*>(raw);  // [kMmaRows][LD]
  bf16* dos = qs + kMmaRows * LD;           // [kMmaRows][LD]
  bf16* ks = dos + kMmaRows * LD;           // [kStages][kMmaKeys][LD]
  bf16* vs = ks + kStages * kMmaKeys * LD;  // [kStages][kMmaKeys][LD]

  const int bh = blockIdx.y;  // b * Hq + query head
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_base =
      (static_cast<long long>(b) * Hkv + h / (Hq / Hkv)) * Sk * hd;
  const long long row_base = static_cast<long long>(bh) * Sq;
  const int i0 = blockIdx.x * kMmaRows;
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = hd / 8;  // 16-byte chunks a row

  if (HDP != hd)  // the depth padding of every staged row: copies skip it
    for (int r = tid; r < 2 * kMmaRows + 2 * kStages * kMmaKeys; r += kThreads)
      *reinterpret_cast<uint4*>(qs + r * LD + hd) = make_uint4(0, 0, 0, 0);

  // the query and dO rows (zeros past the last row): the first copy group
  for (int e = tid; e < kMmaRows * chunks; e += kThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 8;
    const bool live = i0 + r < Sq;
    const long long o = (row_base + (live ? i0 + r : 0)) * hd + c;
    copy16(qs + r * LD + c, q + o, live);
    copy16(dos + r * LD + c, dout + o, live);
  }

  const int i_hi = min(i0 + kMmaRows, Sq) - 1;
  int k_begin, k_end;
  key_range(i0, i_hi, off, Sk, causal, window, k_begin, k_end);
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + kMmaKeys - 1) / kMmaKeys : 0;

  // ring slot `it` holds key tile it % ntiles: the two walks are one ring
  auto load_tile = [&](int it) {
    const int k0 = k_begin + (it % ntiles) * kMmaKeys;
    bf16* kd = ks + (it % kStages) * kMmaKeys * LD;
    bf16* vd = vs + (it % kStages) * kMmaKeys * LD;
    for (int e = tid; e < kMmaKeys * chunks; e += kThreads) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      const bool in = k0 + r < k_end;
      const long long o = kv_base + static_cast<long long>(in ? k0 + r : 0) * hd + c;
      copy16(kd + r * LD + c, k + o, in);
      copy16(vd + r * LD + c, v + o, in);
    }
  };
  if (ntiles > 0) load_tile(0);
  copies_commit();

  const int g = lane / 4, t4 = lane % 4;
  const int lrow = lane % 8, lmat = lane / 8;
  int qpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) qpos[h2] = i0 + warp * 16 + g + 8 * h2 + off;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float dd[2] = {0.0f, 0.0f};  // running sum of p * dP, rescaled as l
  float lse2[2], dval[2];
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  // each row's log2-sum-exp2 and D, from the first walk's state
  auto finish_stats = [&]() {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float lt = l[h2], dt = dd[h2];
      lt += __shfl_xor_sync(repro::kFullMask, lt, 1);
      lt += __shfl_xor_sync(repro::kFullMask, lt, 2);
      dt += __shfl_xor_sync(repro::kFullMask, dt, 1);
      dt += __shfl_xor_sync(repro::kFullMask, dt, 2);
      lse2[h2] = lt == 0.0f ? INFINITY : m[h2] + log2f(lt);
      dval[h2] = lt == 0.0f ? 0.0f : dt / lt;
      const int i = qpos[h2] - off;
      if (t4 == 0 && i < Sq) {
        lse[row_base + i] = lse2[h2];
        dsum[row_base + i] = dval[h2];
      }
    }
  };
  if (ntiles == 0) finish_stats();

  for (int it = 0; it < 2 * ntiles; ++it) {
    if (it + 1 < 2 * ntiles) load_tile(it + 1);
    copies_commit();
    copies_wait<1>();  // all but the newest group: this tile (and the rows)
    __syncthreads();
    const bf16* kt = ks + (it % kStages) * kMmaKeys * LD;
    const bf16* vt = vs + (it % kStages) * kMmaKeys * LD;
    const int k0 = k_begin + (it % ntiles) * kMmaKeys;

    // S = Q K^T and dP = dO V^T: 8 n-tiles of 8 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // A: matrices (rows 0-7, 8-15) x (depth 0-7, 8-15)
      uint32_t qa[4], da[4];
      const int arow = (warp * 16 + (lmat % 2) * 8 + lrow) * LD + kk * 16 +
                       (lmat / 2) * 8;
      ldsm4(qa, qs + arow);
      ldsm4(da, dos + arow);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // B: matrices (keys 0-7, 8-15 of the pair) x (depth 0-7, 8-15)
        uint32_t bk[4], bv[4];
        const int brow =
            (np * 16 + (lmat / 2) * 8 + lrow) * LD + kk * 16 + (lmat % 2) * 8;
        ldsm4(bk, kt + brow);
        ldsm4(bv, vt + brow);
        mma(s[2 * np], qa, bk[0], bk[1]);
        mma(s[2 * np + 1], qa, bk[2], bk[3]);
        mma(dp[2 * np], da, bv[0], bv[1]);
        mma(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    // the elementwise mask, only on a tile that straddles an edge
    const bool edge = k0 + kMmaKeys > k_end ||
                      (causal && k0 + kMmaKeys - 1 > i0 + off) ||
                      (window > 0 && k0 <= i_hi + off - window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + nt * 8 + 2 * t4 + (e & 1);
          if (!(j < k_end && visible(qpos[e / 2], j, causal, window)))
            s[nt][e] = -INFINITY;
        }
    }

    if (it < ntiles) {
      // first walk: online softmax state in base 2, and D's running sum
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
        float sum = 0.0f, dsm = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 2 * h2; e < 2 * h2 + 2; ++e) {
            const float p = exp2f(fmaf(s[nt][e], scale_log2, -mu));
            sum += p;
            dsm = fmaf(p, dp[nt][e], dsm);
          }
        l[h2] = l[h2] * corr + sum;
        dd[h2] = dd[h2] * corr + dsm;
      }
      if (it == ntiles - 1) finish_stats();
    } else {
      // second walk: scale dS = scale P (dP - D), then dQ += (scale dS) K
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[nt][e], scale_log2, -lse2[e / 2]));
          s[nt][e] = p * (dp[nt][e] - dval[e / 2]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
        uint32_t a[4];
        a_frag(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          // B: matrices (keys 0-7, 8-15) x (columns 0-7, 8-15), transposed
          uint32_t bk[4];
          ldsm4_t(bk, kt + (kk * 16 + (lmat % 2) * 8 + lrow) * LD + np * 16 +
                          (lmat / 2) * 8);
          mma(acc[2 * np], a, bk[0], bk[1]);
          mma(acc[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // the stage is read before a later copy refills it
  }
  copies_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = qpos[h2] - off;
    if (i >= Sq) continue;
    bf16* dst = dq + (row_base + i) * hd;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              bf16* __restrict__ dk,  // [B, Hkv, Sk, hd]
                              bf16* __restrict__ dv,  // [B, Hkv, Sk, hd]
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum, int Hq, int Hkv,
                              int Sq, int Sk, int hd, int causal, int window,
                              float scale_log2, float scale) {
  constexpr int LD = HDP + 8;
  constexpr int KSTEPS = HDP / 16;  // depth steps of K Q^T and V dO^T
  constexpr int NT = HDP / 8;       // dK's and dV's n-tiles
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* ks = reinterpret_cast<bf16*>(raw);    // [kMmaKeys][LD]
  bf16* vs = ks + kMmaKeys * LD;              // [kMmaKeys][LD]
  bf16* qs = vs + kMmaKeys * LD;              // [kStages][kMmaQTile][LD]
  bf16* dos = qs + kStages * kMmaQTile * LD;  // [kStages][kMmaQTile][LD]

  const int rep = Hq / Hkv;
  const int bkv = blockIdx.y;  // b * Hkv + kv head
  const int b = bkv / Hkv, hkv = bkv - b * Hkv;
  const long long kv_base = static_cast<long long>(bkv) * Sk * hd;
  const int j0 = blockIdx.x * kMmaKeys;
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = hd / 8;

  if (HDP != hd)
    for (int r = tid; r < 2 * kMmaKeys + 2 * kStages * kMmaQTile; r += kThreads)
      *reinterpret_cast<uint4*>(ks + r * LD + hd) = make_uint4(0, 0, 0, 0);

  // this block's K and V rows (zeros past the last key)
  for (int e = tid; e < kMmaKeys * chunks; e += kThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 8;
    const bool in = j0 + r < Sk;
    const long long o = kv_base + static_cast<long long>(in ? j0 + r : 0) * hd + c;
    copy16(ks + r * LD + c, k + o, in);
    copy16(vs + r * LD + c, v + o, in);
  }

  int t_lo, ntq;
  query_tiles(j0, min(j0 + kMmaKeys, Sk) - 1, off, Sq, causal, window,
              kMmaQTile, t_lo, ntq);
  const int total = rep * ntq;  // (query head, query tile) pairs

  auto rows_of = [&](int it) {  // the first row of pair `it` in [B, Hq, Sq]
    const int hh = it / ntq;
    return (static_cast<long long>(b) * Hq + hkv * rep + hh) * Sq;
  };
  auto load_tile = [&](int it) {
    const int i0 = (t_lo + it % ntq) * kMmaQTile;
    const long long base = rows_of(it);
    bf16* qd = qs + (it % kStages) * kMmaQTile * LD;
    bf16* dd = dos + (it % kStages) * kMmaQTile * LD;
    for (int e = tid; e < kMmaQTile * chunks; e += kThreads) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      const bool live = i0 + r < Sq;
      const long long o = (base + (live ? i0 + r : 0)) * hd + c;
      copy16(qd + r * LD + c, q + o, live);
      copy16(dd + r * LD + c, dout + o, live);
    }
  };
  if (total > 0) load_tile(0);
  copies_commit();  // with K and V

  const int g = lane / 4, t4 = lane % 4;
  const int lrow = lane % 8, lmat = lane / 8;
  int key[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) key[h2] = j0 + warp * 16 + g + 8 * h2;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.0f;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load_tile(it + 1);
    copies_commit();
    copies_wait<1>();
    __syncthreads();
    const bf16* qt = qs + (it % kStages) * kMmaQTile * LD;
    const bf16* dt = dos + (it % kStages) * kMmaQTile * LD;
    const int i0 = (t_lo + it % ntq) * kMmaQTile;
    const long long base = rows_of(it);

    // S^T = K Q^T and dP^T = V dO^T: 4 n-tiles of 8 queries each
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      const int arow = (warp * 16 + (lmat % 2) * 8 + lrow) * LD + kk * 16 +
                       (lmat / 2) * 8;
      ldsm4(ka, ks + arow);
      ldsm4(va, vs + arow);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bd[4];
        const int brow =
            (np * 16 + (lmat / 2) * 8 + lrow) * LD + kk * 16 + (lmat % 2) * 8;
        ldsm4(bq, qt + brow);
        ldsm4(bd, dt + brow);
        mma(st[2 * np], ka, bq[0], bq[1]);
        mma(st[2 * np + 1], ka, bq[2], bq[3]);
        mma(dpt[2 * np], va, bd[0], bd[1]);
        mma(dpt[2 * np + 1], va, bd[2], bd[3]);
      }
    }

    // P^T from the scratch's log-sum-exp, scale dS^T = scale P^T (dP^T - D)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int i = i0 + nt * 8 + 2 * t4 + c2;
        const bool live = i < Sq;
        const float L = live ? lse[base + i] : INFINITY;
        const float D = live ? dsum[base + i] : 0.0f;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int e = 2 * h2 + c2;
          const bool vis = live && key[h2] < Sk &&
                           visible(i + off, key[h2], causal, window);
          const float p =
              vis ? exp2f(fmaf(st[nt][e], scale_log2, -L)) : 0.0f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - D) * scale;
        }
      }

    // dV += P^T dO and dK += (scale dS)^T Q: 16 queries a step
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4], sa[4];
      a_frag(pa, st[2 * kk], st[2 * kk + 1]);
      a_frag(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // B: matrices (queries 0-7, 8-15) x (columns 0-7, 8-15), transposed
        uint32_t bd[4], bq[4];
        const int brow = (kk * 16 + (lmat % 2) * 8 + lrow) * LD + np * 16 +
                         (lmat / 2) * 8;
        ldsm4_t(bd, dt + brow);
        ldsm4_t(bq, qt + brow);
        mma(dva[2 * np], pa, bd[0], bd[1]);
        mma(dva[2 * np + 1], pa, bd[2], bd[3]);
        mma(dka[2 * np], sa, bq[0], bq[1]);
        mma(dka[2 * np + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  copies_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (key[h2] >= Sk) continue;
    const long long o = kv_base + static_cast<long long>(key[h2]) * hd;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + o + col) =
            __floats2bfloat162_rn(dka[nt][2 * h2], dka[nt][2 * h2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o + col) =
            __floats2bfloat162_rn(dva[nt][2 * h2], dva[nt][2 * h2 + 1]);
      }
    }
  }
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* lse, float* dsum, int B,
               int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t kRow = sizeof(bf16) * (HDP + 8);
  const size_t smem_dq = kRow * (2 * kMmaRows + 2 * kStages * kMmaKeys);
  const size_t smem_dkv = kRow * (2 * kMmaKeys + 2 * kStages * kMmaQTile);
  auto dq_kernel = flash_attn_bwd_dq_mma_kernel<HDP>;
  auto dkv_kernel = flash_attn_bwd_dkv_mma_kernel<HDP>;
  cudaError_t e = repro::allow_smem(dq_kernel, smem_dq);
  if (e == cudaSuccess) e = repro::allow_smem(dkv_kernel, smem_dkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * kLog2e;
  dq_kernel<<<dim3((Sq + kMmaRows - 1) / kMmaRows, B * Hq), kThreads, smem_dq,
              stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), lse, dsum, Hq, Hkv, Sq, Sk, hd, causal, window,
      scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((Sk + kMmaKeys - 1) / kMmaKeys, B * Hkv), kThreads,
               smem_dkv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, dsum, Hq, Hkv, Sq,
      Sk, hd, causal, window, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on Hopper's warpgroups: "wgmma"
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // a producer warpgroup and two consumers
constexpr int kWgStages = 3;     // tiles in the TMA ring
constexpr int kWgRows = 128;     // dQ pass: query rows a block, 64 a consumer
constexpr int kWgKeys = 64;      // dQ pass: keys a staged tile
constexpr int kWgKvKeys = 128;   // dK/dV pass: keys a block, 64 a consumer
constexpr int kWgQTile = 64;     // dK/dV pass: queries a staged tile

using repro::kConsumerRegs;
using repro::kmajor;
using repro::kProducerRegs;
using repro::kTmaBox;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_wait;
using repro::mnmajor;
using repro::my_turn;
using repro::rows_map;
using repro::slab;
using repro::tma_load_3d;
using repro::your_turn;

// the dot of eight bf16 pairs, fp32
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y) {
  const auto* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const auto* c = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 fa = __bfloat1622float2(a[u]), fc = __bfloat1622float2(c[u]);
    s = fmaf(fa.x, fc.x, s);
    s = fmaf(fa.y, fc.y, s);
  }
  return s;
}

// The A fragments (16-deep steps) of a 64 x 64 accumulator rounded to bf16:
// step kk from n-tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void a_frags(uint32_t (&a)[4][4],
                                        const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack(d[8 * kk + 2 * j],
                                                d[8 * kk + 2 * j + 1]);
}

// the shared memory a block asks for: the tiles from a 1,024-byte boundary
__host__ __device__ constexpr size_t wg_smem_dq(int hd) {
  return 1024 + 2 * kWgRows * hd * 2 + kWgStages * 2 * kWgKeys * hd * 2 +
         kWgRows * 4 + (1 + 2 * kWgStages) * 8;
}
__host__ __device__ constexpr size_t wg_smem_dkv(int hd) {
  return 1024 + 2 * kWgKvKeys * hd * 2 +
         kWgStages * (2 * kWgQTile * hd * 2 + 1024) + (1 + 2 * kWgStages) * 8;
}

// The dQ pass.  Grid: (B * Hq, Sq / 128 rounded up), the heads fastest and
// the last query tiles (under a causal mask, the longest walks) first.  Warpgroup 0's first
// thread loads the block's 128 Q and dO rows, then the K and V tiles of its
// key range into the ring; each consumer warpgroup takes 64 rows: D =
// rowsum(dO o O) from the output (to dsum for the dK/dV pass), then per
// tile S = Q K^T, dP = dO V^T (K-major operands from shared memory),
// P = 2^(S scale log2 e - lse), scale dS = scale P (dP - D) rounded to bf16
// as the register A operand of dQ += (scale dS) K (K read MN-major).
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const bf16* __restrict__ out,   // [B, Hq, Sq, hd]
                               const bf16* __restrict__ out_lo,
                               const bf16* __restrict__ dout,  // [B, Hq, Sq, hd]
                               const float* __restrict__ lse,  // [B, Hq, Sq]
                               float* __restrict__ dsum,       // [B, Hq, Sq]
                               bf16* __restrict__ dq,          // [B, Hq, Sq, hd]
                               int Hq, int Hkv, int Sq, int Sk, int causal,
                               int window, float scale_log2, float scale) {
  constexpr int SLABS = HD / 16;
  constexpr uint32_t kRowsBytes = kWgRows * HD * 2;  // Q (dO) of the block
  constexpr uint32_t kTileBytes = kWgKeys * HD * 2;  // a K (V) tile
  extern __shared__ unsigned char raw[];
  unsigned char* sm = repro::aligned_1024(raw);
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* dos = reinterpret_cast<bf16*>(sm + kRowsBytes);
  unsigned char* ring = sm + 2 * kRowsBytes;  // [stage]: K tile, V tile
  float* ds = reinterpret_cast<float*>(ring + kWgStages * 2 * kTileBytes);
  uint64_t* rows_full = reinterpret_cast<uint64_t*>(ds + kWgRows);
  uint64_t* full = rows_full + 1;
  uint64_t* empty = full + kWgStages;

  const int bh = blockIdx.x;  // b * Hq + query head
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const long long row_base = static_cast<long long>(bh) * Sq;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;  // last first
  const int off = Sk - Sq;
  int k_begin, k_end;
  key_range(i0, min(i0 + kWgRows, Sq) - 1, off, Sk, causal, window, k_begin,
            k_end);
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + kWgKeys - 1) / kWgKeys : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    repro::mbar_init(rows_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 2 * 128);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer
    repro::regs_dec<kProducerRegs>();
    if (tid != 0) return;
    mbar_expect_tx(rows_full, 2 * kRowsBytes);
    for (int s = 0; s < SLABS; ++s)
      for (int r = 0; r < kWgRows; r += kTmaBox) {
        tma_load_3d(qs + slab(s, kWgRows, r), &tq, rows_full, 16 * s, i0 + r,
                    bh);
        tma_load_3d(dos + slab(s, kWgRows, r), &tdo, rows_full, 16 * s,
                    i0 + r, bh);
      }
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
  repro::regs_inc<kConsumerRegs>();
  const int wg = tid / 128 - 1;  // the consumer: rows [64 wg, 64 wg + 64)
  const int t128 = tid % 128, warp = t128 / 32, lane = t128 % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = wg * 64;

  {  // D of the consumer's rows, two threads a row, while the rows load:
     // the output as the forward had it in fp32, out + out_lo (D from the
     // bf16 output alone moves dS by P (dO . the rounding) and doubled
     // dK's largest error on the card)
    const int r = t128 / 2, half = t128 % 2;
    const int i = i0 + r0 + r;
    float d = 0.0f;
    if (i < Sq) {
      const long long o = (row_base + i) * HD + half * (HD / 2);
      const uint4* o4 = reinterpret_cast<const uint4*>(out + o);
      const uint4* l4 = reinterpret_cast<const uint4*>(out_lo + o);
      const uint4* d4 = reinterpret_cast<const uint4*>(dout + o);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const uint4 dd = __ldg(d4 + c);
        d += dot8(__ldg(o4 + c), dd) + dot8(__ldg(l4 + c), dd);
      }
    }
    d += __shfl_xor_sync(repro::kFullMask, d, 1);
    if (half == 0) {
      ds[r0 + r] = d;
      if (i < Sq) dsum[row_base + i] = d;
    }
  }
  repro::named_sync(1 + wg, 128);

  int qpos[2];
  float L[2], D[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = r0 + warp * 16 + g + 8 * h2, i = i0 + row;
    qpos[h2] = i + off;
    L[h2] = i < Sq ? lse[row_base + i] : INFINITY;  // p = 0 past the rows
    D[h2] = ds[row];
  }
  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;

  const int iw_lo = i0 + r0, iw_hi = min(iw_lo + 63, Sq - 1);
  mbar_wait(rows_full, 0);
  if (wg == 1) your_turn(wg);  // consumer 0 goes first
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kWgStages;
    mbar_wait(&full[st], (t / kWgStages) & 1);
    const int k0 = k_begin + t * kWgKeys;
    // a tile no row of this warpgroup sees (or no row at all)
    const bool skip = iw_lo >= Sq || (causal && k0 > iw_hi + off) ||
                      (window > 0 && iw_lo + off - (k0 + kWgKeys - 1) >= window);
    my_turn(wg);
    if (skip) {
      your_turn(wg);
    } else {
      const bf16* kt = reinterpret_cast<const bf16*>(ring + st * 2 * kTileBytes);
      const bf16* vt = kt + kWgKeys * HD;
      float s[32], dp[32];
      repro::wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
        repro::wgmma_ss_n64(s, kmajor(qs + slab(sl, kWgRows, r0)),
                            kmajor(kt + slab(sl, kWgKeys, 0)), sl > 0);
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
        repro::wgmma_ss_n64(dp, kmajor(dos + slab(sl, kWgRows, r0)),
                            kmajor(vt + slab(sl, kWgKeys, 0)), sl > 0);
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::keep(s);
      repro::keep(dp);
      your_turn(wg);

      // the elementwise mask, only on a tile that straddles an edge
      const bool edge = k0 + kWgKeys > k_end ||
                        (causal && k0 + kWgKeys - 1 > iw_lo + off) ||
                        (window > 0 && k0 <= iw_hi + off - window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h2 = (e / 2) % 2;
        const int j = k0 + (e / 4) * 8 + 2 * t4 + (e & 1);
        const bool vis =
            !edge || (j < k_end && visible(qpos[h2], j, causal, window));
        const float p =
            vis ? repro::fast_exp2(fmaf(s[e], scale_log2, -L[h2])) : 0.0f;
        s[e] = p * (dp[e] - D[h2]) * scale;
      }
      uint32_t a[4][4];
      a_frags(a, s);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 keys a step: the tile's rows
        repro::wgmma_rs<HD>(acc, a[kk],
                            mnmajor(kt + slab(0, kWgKeys, 16 * kk), kWgKeys));
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::keep(acc);
    }
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = qpos[h2] - off;
    if (i >= Sq) continue;
    bf16* dst = dq + (row_base + i) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * nt + 2 * h2], acc[4 * nt + 2 * h2 + 1]);
  }
}

// The dK/dV pass.  Grid: (B * Hkv, Sk / 128 rounded up), the heads fastest
// and the first key tiles (under a causal mask, the longest walks) first.  The producer
// warp loads the block's 128 K and V rows once, then, for each query head
// of the kv head and each 64-query tile with a query that sees one of the
// block's keys, the Q and dO tile (TMA) and the tile's lse and D (its 32
// lanes, +inf and 0 past the last query) into the ring.  Each consumer
// warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T (K, V, Q, dO
// K-major), P^T and scale dS^T as bf16 register A operands of dV += P^T dO
// and dK += (scale dS)^T Q (dO, Q read MN-major); dK and dV stay in
// registers over every query head (GQA summed in the block).
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const float* __restrict__ lse,
                                const float* __restrict__ dsum,
                                bf16* __restrict__ dk,  // [B, Hkv, Sk, hd]
                                bf16* __restrict__ dv,  // [B, Hkv, Sk, hd]
                                int Hq, int Hkv, int Sq, int Sk, int causal,
                                int window, float scale_log2, float scale) {
  constexpr int SLABS = HD / 16;
  constexpr uint32_t kKeysBytes = kWgKvKeys * HD * 2;  // K (V) of the block
  constexpr uint32_t kTileBytes = kWgQTile * HD * 2;   // a Q (dO) tile
  constexpr uint32_t kStageBytes = 2 * kTileBytes + 1024;  // + lse, D
  extern __shared__ unsigned char raw[];
  unsigned char* sm = repro::aligned_1024(raw);
  bf16* ks = reinterpret_cast<bf16*>(sm);
  bf16* vs = reinterpret_cast<bf16*>(sm + kKeysBytes);
  unsigned char* ring = sm + 2 * kKeysBytes;  // [stage]: Q, dO, lse, D
  uint64_t* keys_full = reinterpret_cast<uint64_t*>(ring + kWgStages * kStageBytes);
  uint64_t* full = keys_full + 1;
  uint64_t* empty = full + kWgStages;

  const int rep = Hq / Hkv;
  const int bkv = blockIdx.x;  // b * Hkv + kv head
  const int b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int j0 = blockIdx.y * kWgKvKeys;
  const int off = Sk - Sq;
  int t_lo, ntq;
  query_tiles(j0, min(j0 + kWgKvKeys, Sk) - 1, off, Sq, causal, window,
              kWgQTile, t_lo, ntq);
  const int total = rep * ntq;  // (query head, query tile) pairs
  const int tid = threadIdx.x;

  if (tid == 0) {
    repro::mbar_init(keys_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      repro::mbar_init(&full[s], 32);  // the producer warp's lanes
      repro::mbar_init(&empty[s], 2 * 128);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer
    repro::regs_dec<kProducerRegs>();
    if (tid >= 32) return;
    if (tid == 0) {
      mbar_expect_tx(keys_full, 2 * kKeysBytes);
      for (int s = 0; s < SLABS; ++s)
        for (int r = 0; r < kWgKvKeys; r += kTmaBox) {
          tma_load_3d(ks + slab(s, kWgKvKeys, r), &tk, keys_full, 16 * s,
                      j0 + r, bkv);
          tma_load_3d(vs + slab(s, kWgKvKeys, r), &tv, keys_full, 16 * s,
                      j0 + r, bkv);
        }
    }
    for (int it = 0; it < total; ++it) {
      const int st = it % kWgStages;
      const int bhq = b * Hq + hkv * rep + it / ntq;
      const int i0 = (t_lo + it % ntq) * kWgQTile;
      // the tile's lse and D (two each a lane), read before the wait
      float2 ld[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + tid + 32 * u;
        const long long o = static_cast<long long>(bhq) * Sq + i;
        ld[u] = i < Sq ? make_float2(lse[o], dsum[o])
                       : make_float2(INFINITY, 0.0f);
      }
      mbar_wait(&empty[st], ((it / kWgStages) & 1) ^ 1);
      unsigned char* stage = ring + st * kStageBytes;
      float* ls = reinterpret_cast<float*>(stage + 2 * kTileBytes);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ls[tid + 32 * u] = ld[u].x;
        ls[kWgQTile + tid + 32 * u] = ld[u].y;
      }
      if (tid == 0) {
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        bf16* qd = reinterpret_cast<bf16*>(stage);
        bf16* dd = qd + kWgQTile * HD;
        for (int s = 0; s < SLABS; ++s) {
          tma_load_3d(qd + slab(s, kWgQTile, 0), &tq, &full[st], 16 * s, i0,
                      bhq);
          tma_load_3d(dd + slab(s, kWgQTile, 0), &tdo, &full[st], 16 * s, i0,
                      bhq);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }
  repro::regs_inc<kConsumerRegs>();
  const int wg = tid / 128 - 1;  // the consumer: keys [64 wg, 64 wg + 64)
  const int t128 = tid % 128, warp = t128 / 32, lane = t128 % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw = wg * 64;
  const int jw_lo = j0 + kw, jw_hi = jw_lo + 63;
  int key[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) key[h2] = jw_lo + warp * 16 + g + 8 * h2;

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) dka[e] = dva[e] = 0.0f;

  mbar_wait(keys_full, 0);
  if (wg == 1) your_turn(wg);  // consumer 0 goes first
  for (int it = 0; it < total; ++it) {
    const int st = it % kWgStages;
    mbar_wait(&full[st], (it / kWgStages) & 1);
    const int i0 = (t_lo + it % ntq) * kWgQTile;
    const int i_last = min(i0 + kWgQTile, Sq) - 1;
    // a tile whose queries see none of this warpgroup's keys
    const bool skip = jw_lo >= Sk || (causal && jw_lo > i_last + off) ||
                      (window > 0 && i0 + off - min(jw_hi, Sk - 1) >= window);
    my_turn(wg);
    if (skip) {
      your_turn(wg);
    } else {
      const unsigned char* stage = ring + st * kStageBytes;
      const bf16* qt = reinterpret_cast<const bf16*>(stage);
      const bf16* dt = qt + kWgQTile * HD;
      const float* ls = reinterpret_cast<const float*>(stage + 2 * kTileBytes);
      float s[32], dp[32];
      repro::wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
        repro::wgmma_ss_n64(s, kmajor(ks + slab(sl, kWgKvKeys, kw)),
                            kmajor(qt + slab(sl, kWgQTile, 0)), sl > 0);
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
        repro::wgmma_ss_n64(dp, kmajor(vs + slab(sl, kWgKvKeys, kw)),
                            kmajor(dt + slab(sl, kWgQTile, 0)), sl > 0);
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::keep(s);
      repro::keep(dp);
      your_turn(wg);

      const bool edge = (causal && jw_hi > i0 + off) ||
                        (window > 0 && i0 + kWgQTile - 1 + off - jw_lo >= window);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // the n-tile's two queries: columns 8 nt + 2 t4 + {0, 1}
        const float2 Lq = *reinterpret_cast<const float2*>(ls + 8 * nt + 2 * t4);
        const float2 Dq =
            *reinterpret_cast<const float2*>(ls + kWgQTile + 8 * nt + 2 * t4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * nt + u, c = 8 * nt + 2 * t4 + (u & 1);
          const bool vis =
              !edge || visible(i0 + c + off, key[u / 2], causal, window);
          const float p = vis ? repro::fast_exp2(fmaf(
                                    s[e], scale_log2, (u & 1) ? -Lq.y : -Lq.x))
                              : 0.0f;
          s[e] = p;
          dp[e] = p * (dp[e] - ((u & 1) ? Dq.y : Dq.x)) * scale;
        }
      }
      uint32_t pa[4][4], sa[4][4];
      a_frags(pa, s);
      a_frags(sa, dp);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 queries a step
        repro::wgmma_rs<HD>(dva, pa[kk],
                            mnmajor(dt + slab(0, kWgQTile, 16 * kk), kWgQTile));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        repro::wgmma_rs<HD>(dka, sa[kk],
                            mnmajor(qt + slab(0, kWgQTile, 16 * kk), kWgQTile));
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::keep(dva);
      repro::keep(dka);
    }
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (key[h2] >= Sk) continue;
    const long long o = (static_cast<long long>(bkv) * Sk + key[h2]) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk + o + col) =
          __floats2bfloat162_rn(dka[4 * nt + 2 * h2], dka[4 * nt + 2 * h2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + col) =
          __floats2bfloat162_rn(dva[4 * nt + 2 * h2], dva[4 * nt + 2 * h2 + 1]);
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* out,
                 const void* out_lo, const void* dout, const float* lse,
                 float* dsum, void* dq, void* dk, void* dv, int B, int Hq,
                 int Hkv, int Sq, int Sk, int causal, int window, float scale,
                 cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  const long long q_stride = static_cast<long long>(Sq) * HD;
  const long long k_stride = static_cast<long long>(Sk) * HD;
  if (!rows_map(&tq, q, B * Hq, Sq, HD, q_stride) ||
      !rows_map(&tdo, dout, B * Hq, Sq, HD, q_stride) ||
      !rows_map(&tk, k, B * Hkv, Sk, HD, k_stride) ||
      !rows_map(&tv, v, B * Hkv, Sk, HD, k_stride))
    return static_cast<int>(cudaErrorNotSupported);
  auto dq_kernel = flash_attn_bwd_dq_wgmma_kernel<HD>;
  auto dkv_kernel = flash_attn_bwd_dkv_wgmma_kernel<HD>;
  cudaError_t e = repro::allow_smem(dq_kernel, wg_smem_dq(HD));
  if (e == cudaSuccess) e = repro::allow_smem(dkv_kernel, wg_smem_dkv(HD));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * kLog2e;
  dq_kernel<<<dim3(B * Hq, (Sq + kWgRows - 1) / kWgRows), kWgThreads,
              wg_smem_dq(HD), stream>>>(
      tq, tdo, tk, tv, static_cast<const bf16*>(out),
      static_cast<const bf16*>(out_lo), static_cast<const bf16*>(dout), lse,
      dsum, static_cast<bf16*>(dq), Hq, Hkv, Sq, Sk, causal, window,
      scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3(B * Hkv, (Sk + kWgKvKeys - 1) / kWgKvKeys), kWgThreads,
               wg_smem_dkv(HD), stream>>>(
      tq, tdo, tk, tv, lse, dsum, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Hq, Hkv, Sq, Sk, causal, window, scale_log2,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 register-tiled on the CUDA cores: "simt_tiled"
// ---------------------------------------------------------------------------

// 4 bytes global -> shared
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   repro::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__host__ __device__ constexpr size_t tiled_smem(int hd, int pd_tiles) {
  // six [64][hd + 4] tiles (the block's two, and two stages of two),
  // pd_tiles P / dS tiles, and 2 x 2 x 64 floats (dQ: D; dK/dV: each
  // stage's lse, D)
  return sizeof(float) *
         (6 * kTile * (hd + 4) + pd_tiles * kTile * kPLd + 4 * kTile);
}

// The dQ pass.  Grid: (B * Hq, Sq / 64 rounded up), the last query tiles
// first.  A block keeps 64 query
// rows' Q and dO, computes their D = rowsum(dO o O) (to dsum), and walks
// the 64-key tiles its rows see once, double-buffered by cp.async: S and dP
// as 4 x 4 micro-tiles a thread, P from the forward's lse, scale dS to
// shared memory, then dQ += (scale dS) K as 4 rows x NC columns micro-tiles.
template <int NC>
__global__ void __launch_bounds__(kTileThreads)
flash_attn_bwd_dq_tiled_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ out,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ dsum,
                               float* __restrict__ dq, int Hq, int Hkv,
                               int Sq, int Sk, int hd, int causal, int window,
                               float scale_log2, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* qs = smem;                    // [64][ld]
  float* dos = qs + kTile * ld;        // [64][ld]
  float* kvs = dos + kTile * ld;       // [stage][K, V][64][ld]
  float* ps = kvs + 4 * kTile * ld;    // [64][kPLd]: scale dS
  float* dd = ps + kTile * kPLd;       // [64]: D

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_base =
      (static_cast<long long>(b) * Hkv + h / (Hq / Hkv)) * Sk * hd;
  const long long row_base = static_cast<long long>(bh) * Sq;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // last first
  const int off = Sk - Sq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i_hi = min(i0 + kTile, Sq) - 1;
  int k_begin, k_end;
  key_range(i0, i_hi, off, Sk, causal, window, k_begin, k_end);
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile : 0;

  stage_rows(qs, ld, q + row_base * hd, i0, Sq, hd);
  stage_rows(dos, ld, dout + row_base * hd, i0, Sq, hd);
  auto load_tile = [&](int t) {
    float* kd = kvs + (t % 2) * 2 * kTile * ld;
    const int k0 = k_begin + t * kTile;
    stage_rows(kd, ld, k + kv_base, k0, k_end, hd);
    stage_rows(kd + kTile * ld, ld, v + kv_base, k0, k_end, hd);
  };
  if (ntiles > 0) load_tile(0);
  copies_commit();

  {  // D of the block's rows: four threads a row
    const int r = tid / 4, i = i0 + r;
    float d = 0.0f;
    if (i < Sq)
      for (int c = (tid % 4) * 4; c < hd; c += 16) {
        const float4 o = __ldg(reinterpret_cast<const float4*>(
            out + (row_base + i) * hd + c));
        const float4 g = __ldg(reinterpret_cast<const float4*>(
            dout + (row_base + i) * hd + c));
        d = fmaf(o.x, g.x, fmaf(o.y, g.y, fmaf(o.z, g.z, fmaf(o.w, g.w, d))));
      }
    d += __shfl_xor_sync(repro::kFullMask, d, 1);
    d += __shfl_xor_sync(repro::kFullMask, d, 2);
    if (tid % 4 == 0) {
      dd[r] = d;
      if (i < Sq) dsum[row_base + i] = d;
    }
  }
  __syncthreads();
  float L[4], D[4];
  int qpos[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    qpos[a] = i + off;
    L[a] = i < Sq ? lse[row_base + i] : INFINITY;
    D[a] = dd[ty + 16 * a];
  }
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    copies_commit();
    copies_wait<1>();  // all but the newest group: this tile (and the rows)
    __syncthreads();
    const float* kt = kvs + (t % 2) * 2 * kTile * ld;
    const float* vt = kt + kTile * ld;
    const int k0 = k_begin + t * kTile;
    float s[4][4], dp[4][4];
    micro_dots(s, dp, qs, kt, dos, vt, ld, hd, ty, tx);
    const bool edge = k0 + kTile > k_end || (causal && k0 + kTile - 1 > i0 + off) ||
                      (window > 0 && k0 <= i_hi + off - window);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool vis =
            !edge || (j < k_end && visible(qpos[a], j, causal, window));
        const float p =
            vis ? repro::fast_exp2(fmaf(s[a][c], scale_log2, -L[a])) : 0.0f;
        ps[(ty + 16 * a) * kPLd + tx + 16 * c] = p * (dp[a][c] - D[a]) * scale;
      }
    __syncthreads();
    micro_product<NC>(acc, ps, kt, ld, hd, ty, tx);
    __syncthreads();  // the stage and the dS tile are read before reuse
  }
  copies_wait<0>();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) dq[(row_base + i) * hd + col] = acc[a][c];
    }
  }
}

// The dK/dV pass.  Grid: (B * Hq, Sk / 64 rounded up): a block serves 64
// keys of one query head's kv head and walks the 64-query tiles of that
// head that see one of them (the causal triangle's keys see 16x more
// queries than the last: a block a query head keeps the longest block a
// rep-th of a kv head's), double-buffered by cp.async with each tile's lse
// and D.  S^T and dP^T as 4 x 4 micro-tiles, then P^T through shared memory
// and scale dS^T (two tiles of shared memory where they fit, else one in
// turn) into dV += P^T dO and dK += (scale dS)^T Q.  dk, dv: the query
// head's part [B, Hq, Sk, hd]; rep > 1 sums them in
// flash_attn_bwd_sum_kernel, in head order.
template <int NC>
__global__ void __launch_bounds__(kTileThreads)
flash_attn_bwd_dkv_tiled_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ dsum,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int Hq, int Hkv,
                                int Sq, int Sk, int hd, int causal, int window,
                                float scale_log2, float scale, int pd_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* ks = smem;                    // [64][ld]
  float* vs = ks + kTile * ld;         // [64][ld]
  float* qds = vs + kTile * ld;        // [stage][Q, dO][64][ld]
  float* ps = qds + 4 * kTile * ld;    // [64][kPLd]: P^T
  float* ss = ps + (pd_tiles - 1) * kTile * kPLd;  // scale dS^T (or in ps)
  float* lds = ss + kTile * kPLd;      // [stage][lse, D][64]

  const int bh = blockIdx.x;  // b * Hq + query head
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_base =
      (static_cast<long long>(b) * Hkv + h / (Hq / Hkv)) * Sk * hd;
  const long long row_base = static_cast<long long>(bh) * Sq;
  const int j0 = blockIdx.y * kTile;
  const int off = Sk - Sq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  int t_lo, ntq;
  query_tiles(j0, min(j0 + kTile, Sk) - 1, off, Sq, causal, window, kTile,
              t_lo, ntq);

  stage_rows(ks, ld, k + kv_base, j0, Sk, hd);
  stage_rows(vs, ld, v + kv_base, j0, Sk, hd);
  auto load_tile = [&](int t) {
    float* qd = qds + (t % 2) * 2 * kTile * ld;
    float* ld_ = lds + (t % 2) * 2 * kTile;
    const int i0 = (t_lo + t) * kTile;
    stage_rows(qd, ld, q + row_base * hd, i0, Sq, hd);
    stage_rows(qd + kTile * ld, ld, dout + row_base * hd, i0, Sq, hd);
    if (tid < 2 * kTile) {  // lse (+inf past the last query), then D (0)
      const int e = tid % kTile, i = i0 + e;
      const float* src = tid < kTile ? lse : dsum;
      if (i < Sq)
        copy4(ld_ + tid, src + row_base + i);
      else
        ld_[tid] = tid < kTile ? INFINITY : 0.0f;
    }
  };
  if (ntq > 0) load_tile(0);
  copies_commit();

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[a][c] = dva[a][c] = 0.0f;
  int key[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) key[a] = j0 + ty + 16 * a;

  for (int t = 0; t < ntq; ++t) {
    if (t + 1 < ntq) load_tile(t + 1);
    copies_commit();
    copies_wait<1>();
    __syncthreads();
    const float* qt = qds + (t % 2) * 2 * kTile * ld;
    const float* dt = qt + kTile * ld;
    const float* lt = lds + (t % 2) * 2 * kTile;
    const int i0 = (t_lo + t) * kTile;
    float s[4][4], dp[4][4];
    micro_dots(s, dp, ks, qt, vs, dt, ld, hd, ty, tx);
    const bool edge = (causal && j0 + kTile - 1 > i0 + off) ||
                      (window > 0 && i0 + kTile - 1 + off - j0 >= window);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = tx + 16 * c;  // the query in the tile
      const float Lq = lt[e], Dq = lt[kTile + e];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const bool vis =
            !edge || visible(i0 + e + off, key[a], causal, window);
        const float p =
            vis ? repro::fast_exp2(fmaf(s[a][c], scale_log2, -Lq)) : 0.0f;
        s[a][c] = p * (dp[a][c] - Dq) * scale;
        ps[(ty + 16 * a) * kPLd + e] = p;
      }
    }
    if (pd_tiles == 2) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ss[(ty + 16 * a) * kPLd + tx + 16 * c] = s[a][c];
    }
    __syncthreads();
    micro_product<NC>(dva, ps, dt, ld, hd, ty, tx);
    if (pd_tiles == 1) {
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ss[(ty + 16 * a) * kPLd + tx + 16 * c] = s[a][c];
      __syncthreads();
    }
    micro_product<NC>(dka, ss, qt, ld, hd, ty, tx);
    __syncthreads();  // the stage and the tiles are read before reuse
  }
  copies_wait<0>();

  const long long o_base = static_cast<long long>(bh) * Sk;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (key[a] >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        const long long o = (o_base + key[a]) * hd + col;
        dk[o] = dka[a][c];
        dv[o] = dva[a][c];
      }
    }
  }
}

// dk, dv [B, Hkv, Sk, hd] = the sum of each kv head's rep query heads'
// parts (part: [2][B, Hq, Sk, hd], dK's then dV's), in head order: the
// same bits every call.  A thread a float4.
__global__ void __launch_bounds__(256)
flash_attn_bwd_sum_kernel(const float4* __restrict__ part,
                          float4* __restrict__ dk, float4* __restrict__ dv,
                          long long n4, long long head4, int rep) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= n4) return;
  const long long bkv = e / head4, rest = e - bkv * head4;
  const float4* pk = part + bkv * rep * head4 + rest;
  const float4* pv = pk + n4 * rep;
  float4 sk = pk[0], sv = pv[0];
  for (int hh = 1; hh < rep; ++hh) {
    const float4 a = pk[hh * head4], c = pv[hh * head4];
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  dk[e] = sk;
  dv[e] = sv;
}

template <int NC>
int launch_tiled(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* dsum, float* part,
                 void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                 int Sk, int hd, int causal, int window, float scale,
                 cudaStream_t stream) {
  // dK/dV: P^T and scale dS^T in two tiles where they fit (hd <= 120)
  const int pd_tiles = tiled_smem(hd, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = tiled_smem(hd, 1), smem_dkv = tiled_smem(hd, pd_tiles);
  auto dq_kernel = flash_attn_bwd_dq_tiled_kernel<NC>;
  auto dkv_kernel = flash_attn_bwd_dkv_tiled_kernel<NC>;
  cudaError_t e = repro::allow_smem(dq_kernel, smem);
  if (e == cudaSuccess) e = repro::allow_smem(dkv_kernel, smem_dkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rep = Hq / Hkv;
  if (rep > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * kLog2e;
  dq_kernel<<<dim3(B * Hq, (Sq + kTile - 1) / kTile), kTileThreads, smem,
              stream>>>(static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(out),
                        static_cast<const float*>(dout), lse, dsum,
                        static_cast<float*>(dq), Hq, Hkv, Sq, Sk, hd, causal,
                        window, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(B) * Hkv * Sk * hd;
  float* pk = rep > 1 ? part : static_cast<float*>(dk);
  float* pv = rep > 1 ? part + n * rep : static_cast<float*>(dv);
  dkv_kernel<<<dim3(B * Hq, (Sk + kTile - 1) / kTile), kTileThreads,
               smem_dkv, stream>>>(static_cast<const float*>(q),
                                   static_cast<const float*>(k),
                                   static_cast<const float*>(v),
                                   static_cast<const float*>(dout), lse, dsum,
                                   pk, pv, Hq, Hkv, Sq, Sk, hd, causal, window,
                                   scale_log2, scale, pd_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess || rep == 1) return static_cast<int>(e);
  const long long n4 = n / 4;
  flash_attn_bwd_sum_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                              stream>>>(
      reinterpret_cast<const float4*>(part), static_cast<float4*>(dk),
      static_cast<float4*>(dv), n4, static_cast<long long>(Sk) * hd / 4, rep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out, out_lo, dout, dq: contiguous [B, Hq, Sq, hd]; k, v, dk, dv:
// contiguous [B, Hkv, Sk, hd]; lse, dsum: fp32 [B, Hq, Sq].  hd a multiple
// of 8 up to 128, every pointer 16-byte aligned, Hq a multiple of Hkv: the
// wrapper checks, and takes 1 <= Sq <= Sk, or any Sq when causal == 0 and
// window <= 0 (cross-attention: every query sees every key).  window <= 0
// means none.  variant (ops.py:BWD_VARIANTS):
//   0 "mma" (bf16): the first design; lse is scratch it fills with its own
//     statistics (out and out_lo unused);
//   1 "wgmma" (bf16, hd 64, 80, 96, 112 or 128), 2 "simt_tiled" (fp32):
//     lse is the forward's (flash_attn's, base 2), out its output; for
//     "wgmma" out_lo the bf16 output's rounding residual (flash_attn's), so
//     that D = rowsum(dO o (out + out_lo)) is the fp32 output's;
//     "simt_tiled" with Hq > Hkv takes `part`, fp32 scratch of
//     2 * B * Hq * Sk * hd.
// dsum is scratch for D.  Launches the dQ pass, then the dK/dV pass (and
// "simt_tiled"'s sum of the query heads' parts), on `stream`.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* out_lo,
                              const void* dout, void* lse, void* dsum,
                              void* part, void* dq, void* dk, void* dv, int B,
                              int Hq, int Hkv, int Sq, int Sk, int hd,
                              int causal, int window, float scale,
                              int variant, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (hd % 8 || hd < 8 || hd > 128 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ls = static_cast<float*>(lse);
  auto* ds = static_cast<float*>(dsum);
  if (variant == 1) {
    if (out_lo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_WGMMA_CASE(n)                                                  \
  case n:                                                                    \
    return launch_wgmma<n>(q, k, v, out, out_lo, dout, ls, ds, dq, dk, dv,   \
                           B, Hq, Hkv, Sq, Sk, causal, window, scale, s);
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
  if (variant == 2) {
    auto* pt = static_cast<float*>(part);
#define REPRO_TILED_CASE(n)                                                  \
  case n:                                                                    \
    return launch_tiled<n>(q, k, v, out, dout, ls, ds, pt, dq, dk, dv, B,    \
                           Hq, Hkv, Sq, Sk, hd, causal, window, scale, s);
    switch ((hd + 15) / 16) {  // a thread's columns
      REPRO_TILED_CASE(1)
      REPRO_TILED_CASE(2)
      REPRO_TILED_CASE(3)
      REPRO_TILED_CASE(4)
      REPRO_TILED_CASE(5)
      REPRO_TILED_CASE(6)
      REPRO_TILED_CASE(7)
      default:
        return launch_tiled<8>(q, k, v, out, dout, ls, ds, pt, dq, dk, dv, B,
                               Hq, Hkv, Sq, Sk, hd, causal, window, scale, s);
    }
#undef REPRO_TILED_CASE
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_BWD_ARGS                                                       \
  q, k, v, dout, dq, dk, dv, ls, ds, B, Hq, Hkv, Sq, Sk, hd, causal, window, \
      scale, s
  switch ((hd + 15) / 16) {
    case 1: return launch_mma<16>(REPRO_BWD_ARGS);
    case 2: return launch_mma<32>(REPRO_BWD_ARGS);
    case 3: return launch_mma<48>(REPRO_BWD_ARGS);
    case 4: return launch_mma<64>(REPRO_BWD_ARGS);
    case 5: return launch_mma<80>(REPRO_BWD_ARGS);
    case 6: return launch_mma<96>(REPRO_BWD_ARGS);
    case 7: return launch_mma<112>(REPRO_BWD_ARGS);
    default: return launch_mma<128>(REPRO_BWD_ARGS);
  }
#undef REPRO_BWD_ARGS
}
