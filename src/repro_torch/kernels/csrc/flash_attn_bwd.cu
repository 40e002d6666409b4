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
// formula) at 989 TFLOP/s; this design runs 9 (QK^T three times, dO V^T
// three times, and the three gradient products).
//
// Two passes a call, two kernels, launched in order on one stream; no
// output is summed by atomics, so every call gives the same bits:
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
// flash_attn_bwd_{dq,dkv}_kernel (fp32 operands): the same two passes on the
//   CUDA cores, tiles of 32 keys (dQ) and 32 queries (dK/dV) staged as
//   fp32 in shared memory; lane j owns key (query) j of a tile for the
//   scores, then output columns lane, lane + 32, ... for the products.  It
//   exists so that fp32 training reaches a kernel on the card; it is not
//   meant to be fast.
// Left for later: wgmma over 64-row warpgroups with TMA loads and warp
// specialisation; keeping S or P between the passes.
#include <cuda_bf16.h>

#include <cstdint>

#include "attn.cuh"
#include "common.cuh"

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
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ bool visible(int qpos, int j, int causal,
                                        int window) {
  return (!causal || j <= qpos) && (window <= 0 || qpos - j < window);
}

// the keys some query of [i_lo, i_hi] can see: [k_begin, k_end)
// (ops.py:bwd_k_range)
__device__ __forceinline__ void key_range(int i_lo, int i_hi, int off, int Sk,
                                          int causal, int window, int& k_begin,
                                          int& k_end) {
  k_end = causal ? min(Sk, i_hi + off + 1) : Sk;
  k_begin = window > 0 ? max(0, i_lo + off - window + 1) : 0;
}

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
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRpw = 8;                   // rows (keys) a warp
constexpr int kSimtRows = kWarps * kRpw;  // query rows (keys) a block
constexpr int kSimtTile = 32;             // keys (queries) a staged tile
static_assert(kSimtRows == kSimtTile, "stage() fills kSimtTile rows");

// `rows` of hd floats from `src` (row stride hd) into shared memory (row
// stride ld), zeros for the rows in [rows, kSimtTile)
__device__ void stage(float* dst, int ld, const float* src, int rows, int hd) {
  const int per_row = hd / 4;
  for (int e = threadIdx.x; e < kSimtTile * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        r < rows ? *reinterpret_cast<const float4*>(src + r * hd + c)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Dots of lane's row `x` (shared memory) with the warp's kRpw rows `w`
// (broadcasts): out[r] = w_r . x.
__device__ __forceinline__ void dots(float (&out)[kRpw], const float* w,
                                     const float* x, int ld, int hd) {
#pragma unroll
  for (int r = 0; r < kRpw; ++r) out[r] = 0.0f;
  for (int d = 0; d < hd; d += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + d);
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(w + r * ld + d);
      out[r] = fmaf(wv.x, xv.x, out[r]);
      out[r] = fmaf(wv.y, xv.y, out[r]);
      out[r] = fmaf(wv.z, xv.z, out[r]);
      out[r] = fmaf(wv.w, xv.w, out[r]);
    }
  }
}

// acc[r][c] += sum_j a[r][j] * x[j][lane + 32 c] over the tile's kSimtTile
// rows j of x (shared memory, stride ld); a: the warp's [kRpw][kSimtTile].
// The tile's sum is taken apart and then added: a key's dK and dV sum up
// to rep * window terms (16,384 at danube's shape), and one running sum of
// them all drifted 4e-5 from the plain version on the card
template <int C>
__device__ __forceinline__ void accumulate(float (&acc)[kRpw][C],
                                           const float* a, const float* x,
                                           int ld, int hd, int lane) {
  float part[kRpw][C];
#pragma unroll
  for (int r = 0; r < kRpw; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) part[r][c] = 0.0f;
  for (int jj = 0; jj < kSimtTile; jj += 4) {
    float4 av[kRpw];
#pragma unroll
    for (int r = 0; r < kRpw; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + r * kSimtTile + jj);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col >= hd) break;
      const float* xc = x + jj * ld + col;
      const float x0 = xc[0], x1 = xc[ld], x2 = xc[2 * ld], x3 = xc[3 * ld];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        float s = part[r][c];
        s = fmaf(av[r].x, x0, s);
        s = fmaf(av[r].y, x1, s);
        s = fmaf(av[r].z, x2, s);
        s = fmaf(av[r].w, x3, s);
        part[r][c] = s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRpw; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] += part[r][c];
}

// lse: natural log-sum-exp of the scaled scores (+inf for a row that sees
// no key); dsum: D.
template <int C>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ lse,
                         float* __restrict__ dsum, int Hq, int Hkv, int Sq,
                         int Sk, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 4;
  float* qs = smem;                     // [kSimtRows][ld]
  float* dos = qs + kSimtRows * ld;     // [kSimtRows][ld]
  float* ks = dos + kSimtRows * ld;     // [kSimtTile][ld]
  float* vs = ks + kSimtTile * ld;      // [kSimtTile][ld]
  float* ps = vs + kSimtTile * ld;      // [kSimtRows][kSimtTile]: scale dS

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kv_base =
      (static_cast<long long>(b) * Hkv + h / (Hq / Hkv)) * Sk * hd;
  const long long row_base = static_cast<long long>(bh) * Sq;
  const int i0 = blockIdx.x * kSimtRows;
  const int off = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_rows = min(kSimtRows, Sq - i0);

  stage(qs, ld, q + (row_base + i0) * hd, n_rows, hd);
  stage(dos, ld, dout + (row_base + i0) * hd, n_rows, hd);
  int k_begin, k_end;
  key_range(i0, i0 + n_rows - 1, off, Sk, causal, window, k_begin, k_end);

  float m[kRpw], l[kRpw], dd[kRpw], L[kRpw], D[kRpw], acc[kRpw][C];
  int qpos[kRpw];
  bool live[kRpw];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int i = i0 + warp * kRpw + r;
    live[r] = i < Sq;
    qpos[r] = i + off;
    m[r] = -INFINITY;
    l[r] = dd[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  }
  const float* qw = qs + warp * kRpw * ld;
  const float* dw = dos + warp * kRpw * ld;
  float* pw = ps + warp * kRpw * kSimtTile;

  for (int walk = 0; walk < 2; ++walk) {
    for (int k0 = k_begin; k0 < k_end; k0 += kSimtTile) {
      const int n = min(kSimtTile, k_end - k0);
      __syncthreads();  // the previous tile's readers are done
      stage(ks, ld, k + kv_base + static_cast<long long>(k0) * hd, n, hd);
      stage(vs, ld, v + kv_base + static_cast<long long>(k0) * hd, n, hd);
      __syncthreads();
      float s[kRpw], dp[kRpw];
      dots(s, qw, ks + lane * ld, ld, hd);
      dots(dp, dw, vs + lane * ld, ld, hd);
      const int j = k0 + lane;
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        if (!live[r]) {  // the same for every lane of the warp
          if (walk) pw[r * kSimtTile + lane] = 0.0f;
          continue;
        }
        const bool vis = lane < n && visible(qpos[r], j, causal, window);
        if (walk == 0) {
          const float sc = vis ? s[r] * scale : -INFINITY;
          const float mn = fmaxf(m[r], warp_max(sc));
          const float p = vis ? expf(sc - mn) : 0.0f;
          const float corr = m[r] == -INFINITY ? 0.0f : expf(m[r] - mn);
          m[r] = mn;
          l[r] = fmaf(l[r], corr, p);
          dd[r] = fmaf(dd[r], corr, p * dp[r]);
        } else {
          const float p = vis ? expf(fmaf(s[r], scale, -L[r])) : 0.0f;
          pw[r * kSimtTile + lane] = p * (dp[r] - D[r]) * scale;
        }
      }
      if (walk) {
        __syncwarp();
        accumulate<C>(acc, pw, ks, ld, hd, lane);
        __syncwarp();  // this tile's dS is read before the next tile's
      }
    }
    if (walk == 0) {
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const float lt = repro::warp_sum(l[r]);
        const float dt = repro::warp_sum(dd[r]);
        L[r] = lt == 0.0f ? INFINITY : m[r] + logf(lt);
        D[r] = lt == 0.0f ? 0.0f : dt / lt;
        if (lane == 0 && live[r]) {
          const long long i = row_base + i0 + warp * kRpw + r;
          lse[i] = L[r];
          dsum[i] = D[r];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    if (!live[r]) continue;
    float* dst = dq + (row_base + i0 + warp * kRpw + r) * hd;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) dst[col] = acc[r][c];
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum, int Hq, int Hkv,
                          int Sq, int Sk, int hd, int causal, int window,
                          float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 4;
  float* ks = smem;                        // [kSimtRows][ld]
  float* vs = ks + kSimtRows * ld;         // [kSimtRows][ld]
  float* qs = vs + kSimtRows * ld;         // [kSimtTile][ld]
  float* dos = qs + kSimtTile * ld;        // [kSimtTile][ld]
  float* pt = dos + kSimtTile * ld;        // [kSimtRows][kSimtTile]: P^T
  float* st = pt + kSimtRows * kSimtTile;  // [kSimtRows][kSimtTile]: scale dS^T
  float* ls = st + kSimtRows * kSimtTile;  // [kSimtTile]: the tile's lse
  float* ds = ls + kSimtTile;              // [kSimtTile]: the tile's D

  const int rep = Hq / Hkv;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hkv = bkv - b * Hkv;
  const long long kv_base = static_cast<long long>(bkv) * Sk * hd;
  const int j0 = blockIdx.x * kSimtRows;
  const int off = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_keys = min(kSimtRows, Sk - j0);

  stage(ks, ld, k + kv_base + static_cast<long long>(j0) * hd, n_keys, hd);
  stage(vs, ld, v + kv_base + static_cast<long long>(j0) * hd, n_keys, hd);
  int t_lo, ntq;
  query_tiles(j0, j0 + n_keys - 1, off, Sq, causal, window, kSimtTile, t_lo,
              ntq);

  float dka[kRpw][C], dva[kRpw][C];
  int key[kRpw];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    key[r] = j0 + warp * kRpw + r;
#pragma unroll
    for (int c = 0; c < C; ++c) dka[r][c] = dva[r][c] = 0.0f;
  }
  const float* kw = ks + warp * kRpw * ld;
  const float* vw = vs + warp * kRpw * ld;
  float* pw = pt + warp * kRpw * kSimtTile;
  float* sw = st + warp * kRpw * kSimtTile;

  for (int hh = 0; hh < rep; ++hh) {
    const long long base =
        (static_cast<long long>(b) * Hq + hkv * rep + hh) * Sq;
    for (int t = t_lo; t < t_lo + ntq; ++t) {
      const int i0 = t * kSimtTile;
      const int n = min(kSimtTile, Sq - i0);
      __syncthreads();
      stage(qs, ld, q + (base + i0) * hd, n, hd);
      stage(dos, ld, dout + (base + i0) * hd, n, hd);
      if (threadIdx.x < kSimtTile) {
        const bool in = static_cast<int>(threadIdx.x) < n;
        ls[threadIdx.x] = in ? lse[base + i0 + threadIdx.x] : INFINITY;
        ds[threadIdx.x] = in ? dsum[base + i0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      float s[kRpw], dp[kRpw];
      dots(s, kw, qs + lane * ld, ld, hd);
      dots(dp, vw, dos + lane * ld, ld, hd);
      const int i = i0 + lane;
      const float L = ls[lane], D = ds[lane];
#pragma unroll
      for (int r = 0; r < kRpw; ++r) {
        const bool vis = lane < n && key[r] < Sk &&
                         visible(i + off, key[r], causal, window);
        const float p = vis ? expf(fmaf(s[r], scale, -L)) : 0.0f;
        pw[r * kSimtTile + lane] = p;
        sw[r * kSimtTile + lane] = p * (dp[r] - D) * scale;
      }
      __syncwarp();
      accumulate<C>(dva, pw, dos, ld, hd, lane);
      accumulate<C>(dka, sw, qs, ld, hd, lane);
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    if (key[r] >= Sk) continue;
    const long long o = kv_base + static_cast<long long>(key[r]) * hd;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) {
        dk[o + col] = dka[r][c];
        dv[o + col] = dva[r][c];
      }
    }
  }
}

template <int C>
int launch_simt(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, float* lse, float* dsum, int B,
                int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int window,
                float scale, cudaStream_t stream) {
  const size_t ld = hd + 4;
  const size_t smem_dq =
      sizeof(float) * ((2 * kSimtRows + 2 * kSimtTile) * ld +
                       kSimtRows * kSimtTile);
  const size_t smem_dkv =
      sizeof(float) * ((2 * kSimtRows + 2 * kSimtTile) * ld +
                       2 * kSimtRows * kSimtTile + 2 * kSimtTile);
  auto dq_kernel = flash_attn_bwd_dq_kernel<C>;
  auto dkv_kernel = flash_attn_bwd_dkv_kernel<C>;
  cudaError_t e = repro::allow_smem(dq_kernel, smem_dq);
  if (e == cudaSuccess) e = repro::allow_smem(dkv_kernel, smem_dkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<dim3((Sq + kSimtRows - 1) / kSimtRows, B * Hq), kThreads,
              smem_dq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), lse, dsum, Hq, Hkv, Sq, Sk, hd, causal, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((Sk + kSimtRows - 1) / kSimtRows, B * Hkv), kThreads,
               smem_dkv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dk), static_cast<float*>(dv), lse, dsum, Hq, Hkv,
      Sq, Sk, hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq: contiguous [B, Hq, Sq, hd]; k, v, dk, dv: contiguous
// [B, Hkv, Sk, hd]; lse, dsum: fp32 scratch of B * Hq * Sq each.  hd a
// multiple of 8 up to 128, every pointer 16-byte aligned, Hq a multiple of
// Hkv: the wrapper checks, and takes 1 <= Sq <= Sk, or any Sq when
// causal == 0 and window <= 0 (cross-attention: every query sees every
// key).  window <= 0 means none.  variant: 0 the fp32 kernels (float
// operands), 1 the bf16 tensor-core kernels (__nv_bfloat16 operands).
// Launches the dQ pass, then the dK/dV pass, on `stream`.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* lse, void* dsum, int B, int Hq, int Hkv,
                              int Sq, int Sk, int hd, int causal, int window,
                              float scale, int variant, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (hd % 8 || hd < 8 || hd > 128 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ls = static_cast<float*>(lse);
  auto* ds = static_cast<float*>(dsum);
#define REPRO_BWD_ARGS                                                       \
  q, k, v, dout, dq, dk, dv, ls, ds, B, Hq, Hkv, Sq, Sk, hd, causal, window, \
      scale, s
  if (variant == 1) {
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
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch ((hd + 31) / 32) {
    case 1: return launch_simt<1>(REPRO_BWD_ARGS);
    case 2: return launch_simt<2>(REPRO_BWD_ARGS);
    case 3: return launch_simt<3>(REPRO_BWD_ARGS);
    default: return launch_simt<4>(REPRO_BWD_ARGS);
  }
#undef REPRO_BWD_ARGS
}
