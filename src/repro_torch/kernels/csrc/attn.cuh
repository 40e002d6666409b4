// Helpers shared by the attention kernels (flash_attn.cu, the forward, and
// flash_attn_bwd.cu, its gradient): the visibility of a (query, key) pair
// and a query tile's key range, cp.async copies, ldmatrix loads and the
// bf16 mma.sync.m16n8k16 product with fp32 accumulators, warp maxima, and
// the fp32 register-tiled kernels' 64 x 64 tiles and micro-products
// (flash_attn_tiled_kernel, flash_attn_bwd's "simt_tiled").
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr float kLog2e = 1.4426950408889634f;

// whether the query at position qpos sees key j
__device__ __forceinline__ bool visible(int qpos, int j, int causal,
                                        int window) {
  return (!causal || j <= qpos) && (window <= 0 || qpos - j < window);
}

// the keys some query of [i_lo, i_hi] can see: [k_begin, k_end), queries
// end-aligned on the keys (ops.py:bwd_k_range)
__device__ __forceinline__ void key_range(int i_lo, int i_hi, int off, int Sk,
                                          int causal, int window, int& k_begin,
                                          int& k_end) {
  k_end = causal ? min(Sk, i_hi + off + 1) : Sk;
  k_begin = window > 0 ? max(0, i_lo + off - window + 1) : 0;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros instead where `fill` is false
__device__ __forceinline__ void copy16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8m .. 8m + 7 give matrix m's row addresses
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4],
                                      const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// fp32 register-tiled on the CUDA cores: 64 x 64 tiles, 256 threads that
// each own a 4 x 4 micro-tile (rows ty + 16 a, columns tx + 16 b, with
// ty = thread / 16, tx = thread % 16)
// ---------------------------------------------------------------------------

constexpr int kTile = 64;            // rows, keys and queries of a tile
constexpr int kTileThreads = 256;    // 16 x 16, a 4 x 4 micro-tile each
constexpr int kPLd = kTile + 4;      // row stride of a P / dS tile
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory

// `kTile` rows of hd floats from row `first` of `src` (rows past `valid`
// read as zeros) into shared memory with row stride ld, by cp.async
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int first,
                                           int valid, int hd) {
  const int per_row = hd / 4;
  for (int e = threadIdx.x; e < kTile * per_row; e += kTileThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 4;
    const bool in = first + r < valid;
    const long long row = in ? first + r : 0;
    copy16(dst + r * ld + c, src + row * hd + c, in);
  }
}

// o[a][c] = sum over hd of x[ty + 16 a] . y[tx + 16 c], rows of shared
// memory (row stride ld): x's rows are a warp's broadcasts, y's 16
// consecutive rows (ld / 4 odd: no bank conflict); 8 FMAs a float4 load
__device__ __forceinline__ void micro_dot(float (&o)[4][4], const float* x,
                                          const float* y, int ld, int hd,
                                          int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 xa[4], ya[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      xa[a] = *reinterpret_cast<const float4*>(x + (ty + 16 * a) * ld + d);
      ya[a] = *reinterpret_cast<const float4*>(y + (tx + 16 * a) * ld + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = o[a][c];
        s = fmaf(xa[a].x, ya[c].x, s);
        s = fmaf(xa[a].y, ya[c].y, s);
        s = fmaf(xa[a].z, ya[c].z, s);
        s = fmaf(xa[a].w, ya[c].w, s);
        o[a][c] = s;
      }
  }
}

// micro_dot twice, interleaved: o1 from x1, y1 and o2 from x2, y2
__device__ __forceinline__ void micro_dots(float (&o1)[4][4],
                                           float (&o2)[4][4],
                                           const float* x1, const float* y1,
                                           const float* x2, const float* y2,
                                           int ld, int hd, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) o1[a][c] = o2[a][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 xa[4], xb[4], ya[4], yb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      xa[a] = *reinterpret_cast<const float4*>(x1 + (ty + 16 * a) * ld + d);
      xb[a] = *reinterpret_cast<const float4*>(x2 + (ty + 16 * a) * ld + d);
      ya[a] = *reinterpret_cast<const float4*>(y1 + (tx + 16 * a) * ld + d);
      yb[a] = *reinterpret_cast<const float4*>(y2 + (tx + 16 * a) * ld + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = o1[a][c], t = o2[a][c];
        s = fmaf(xa[a].x, ya[c].x, s);
        t = fmaf(xb[a].x, yb[c].x, t);
        s = fmaf(xa[a].y, ya[c].y, s);
        t = fmaf(xb[a].y, yb[c].y, t);
        s = fmaf(xa[a].z, ya[c].z, s);
        t = fmaf(xb[a].z, yb[c].z, t);
        s = fmaf(xa[a].w, ya[c].w, s);
        t = fmaf(xb[a].w, yb[c].w, t);
        o1[a][c] = s;
        o2[a][c] = t;
      }
  }
}

// acc[a][c] += sum over the tile's 64 j of w[ty + 16 a][j] * x[j][tx + 16 c]
// (the thread's columns under hd, c < NC = hd / 16 rounded up: every
// thread owns as many at a width of 16 k): w a P / dS tile (row stride
// kPLd, a warp's rows broadcast as float4), x rows of shared memory
// (stride ld, 16 consecutive columns).  The tile's sum is taken apart and
// then added: a key's dK and dV sum up to rep * window terms, and one
// running sum of them all drifted 4e-5 from the plain version on the card
template <int NC>
__device__ __forceinline__ void micro_product(float (&acc)[4][NC],
                                              const float* w, const float* x,
                                              int ld, int hd, int ty, int tx) {
  float part[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) part[a][c] = 0.0f;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 wa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      wa[a] = *reinterpret_cast<const float4*>(w + (ty + 16 * a) * kPLd + j);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col >= hd) break;
      const float* xc = x + j * ld + col;
      const float x0 = xc[0], x1 = xc[ld], x2 = xc[2 * ld], x3 = xc[3 * ld];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float t = part[a][c];
        t = fmaf(wa[a].x, x0, t);
        t = fmaf(wa[a].y, x1, t);
        t = fmaf(wa[a].z, x2, t);
        t = fmaf(wa[a].w, x3, t);
        part[a][c] = t;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] += part[a][c];
}

}  // namespace repro
