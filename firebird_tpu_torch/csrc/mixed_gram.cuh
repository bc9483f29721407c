// The mixed-precision Gram and correlations of the fitting kernels
// (FIREBIRD_MIXED_PRECISION), on Hopper's tensor cores: the mixed branch
// of pallas_ops._gram_cd_core (with _split_bf16).  Compiled into a kernel's
// mixed instance only (-DFB_MIXED=1, cuda_ops.MIXED_SOURCES); the f32
// instances never include it.
//
// Per pixel, with w its 0/1 window over time, y the int16 spectra of a
// band, XX[t, i, j] = X[t, i] * X[t, j] (f32) and n = max(sum w, 1):
//   G[i, j] = (XXh[:, i, j] . w + XXl[:, i, j] . w) / n
//   c[b, k] = ((th[:, k] . yh + th[:, k] . yl) + tl[:, k] . yh) / n
// where (xh, xl) is the round-to-nearest-even bf16 split of x (hi = bf16(x),
// lo = bf16(x - hi)), th/tl that of X, yh/yl that of y * w (exact: int16
// values split into two 8-bit significands).  The weights are 0/1, exact
// in bf16.  Each dot runs as mma.sync m16n8k16 (bf16 operands, f32
// accumulation): time on k in chunks of 16 steps from step 0, the rows on
// m, the design columns on n.  Each term keeps its own accumulator across
// the chunks; the terms are added in the order above after the last chunk.
//
// A row's result depends on its own window and values only: an output
// element of an mma is one row of A against one column of B, and a chunk
// in which a row has no weight adds exact zeros to its accumulator (a
// chunk in which no row of the warp has one is skipped).  So every layout
// of rows below gives a pixel the same sums, bit for bit, whichever
// pixels share its warp: dense_fit (the warp's four listed pixels) and
// init_pixel (detect_mega's warp-0 INIT, 32 pixels) agree, and the routes
// that fit a pixel in different kernels agree.  The tensor cores add a
// chunk's products in their own way (not a chain of rounded f32 adds), so
// the sums differ from the plain version's (cuda_ops.gram_plain) by more
// than an ulp; the fitted coefficients and RMSE are held to it within
// params.MIXED_ULP_BUDGET scaled ulps.
#pragma once

#include <climits>
#include <cuda_bf16.h>

#include "tile.cuh"

namespace fb {

constexpr uint32_t MMA_WARP = 0xFFFFFFFFu;

// One row of the mixed sums: a pixel's window bits (words at step 0,
// stride TILE, taken within steps [lo, hi]; no row when hi < lo), its
// values of one band at step 0 (stride P; unused by the Gram) and n.
struct MixedRow {
  const uint32_t* win = nullptr;
  const int16_t* y = nullptr;
  int lo = 1, hi = 0;
  float n = 1.f;
  __device__ bool on() const { return hi >= lo; }
};

// Lane src's row, read by every lane of the warp.
__device__ __forceinline__ MixedRow shfl_row(const MixedRow& r, int src) {
  MixedRow o;
  o.win = reinterpret_cast<const uint32_t*>(__shfl_sync(
      MMA_WARP, (unsigned long long)reinterpret_cast<uintptr_t>(r.win), src));
  o.y = reinterpret_cast<const int16_t*>(__shfl_sync(
      MMA_WARP, (unsigned long long)reinterpret_cast<uintptr_t>(r.y), src));
  o.lo = __shfl_sync(MMA_WARP, r.lo, src);
  o.hi = __shfl_sync(MMA_WARP, r.hi, src);
  o.n = __shfl_sync(MMA_WARP, r.n, src);
  return o;
}

// The row's window bits of chunk kc (steps 16 kc .. 16 kc + 15), bit e for
// step 16 kc + e.
__device__ __forceinline__ uint32_t chunk_bits(const MixedRow& r, int kc) {
  const int w = kc >> 1;
  if (!r.on() || w < (r.lo >> 5) || w > (r.hi >> 5)) return 0u;
  const uint32_t v = r.win[w * TILE] & ~below(w, r.lo) & below(w, r.hi + 1);
  return (v >> (16 * (kc & 1))) & 0xFFFFu;
}

// The bf16 split of x: hi = bf16(x) and lo = bf16(x - hi), both rounded to
// nearest even (x - hi is a plain f32 subtract: the build's -fmad=false).
__device__ __forceinline__ void split_bf16(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __bfloat162float(h)));
}

__device__ __forceinline__ uint32_t pack2(uint32_t lo16, uint32_t hi16) {
  return lo16 | (hi16 << 16);
}

// d += A B: A the 16x16 bf16 tile (a0..a3 the thread's fragment), B the
// 16x8 bf16 tile (b0, b1), d the thread's four f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One pass over the chunks of a 16-row tile, called by every lane of the
// warp.  This lane (group gr = lane / 4, column pair tc = lane % 4 of the
// mma fragments) holds rows gr (r0) and gr + 8 (r1) and steps 2tc, 2tc+1,
// 2tc+8, 2tc+9 of each chunk; Xa is the chip's design [T, K] at step 0.
//   CORR: A = the rows' y * w split (hi, lo), B = X[:, gr] split: acc[0]
//     th.yh, acc[1] th.yl, acc[2] tl.yh (NT = 1).
//   !CORR: A = the rows' 0/1 weights, B = XX[:, i0 + u, gr] split for the
//     NT n-tiles u: acc[0][u] XXh.w, acc[1][u] XXl.w.
// acc[.][u][0..1] are row r0's columns 2tc, 2tc+1, acc[.][u][2..3] r1's.
template <bool CORR, int NT>
__device__ __forceinline__ void mixed_pass(const MixedRow& r0,
                                           const MixedRow& r1,
                                           const float* Xa, int i0, int P,
                                           float (&acc)[CORR ? 3 : 2][NT][4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tc = lane & 3;
  int klo = INT_MAX, khi = -1;
  if (r0.on()) {
    klo = r0.lo >> 4;
    khi = r0.hi >> 4;
  }
  if (r1.on()) {
    klo = min(klo, r1.lo >> 4);
    khi = max(khi, r1.hi >> 4);
  }
  klo = __reduce_min_sync(MMA_WARP, klo);
  khi = __reduce_max_sync(MMA_WARP, khi);
  const int ks[4] = {2 * tc, 2 * tc + 1, 2 * tc + 8, 2 * tc + 9};
#pragma unroll 1
  for (int kc = klo; kc <= khi; ++kc) {
    const uint32_t m0 = chunk_bits(r0, kc), m1 = chunk_bits(r1, kc);
    const uint32_t any = __reduce_or_sync(MMA_WARP, m0 | m1);
    if (any == 0u) continue;
    const int t0 = 16 * kc;
    if constexpr (CORR) {
      uint32_t xh[4], xl[4], ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + ks[e];
        split_bf16((any >> ks[e]) & 1u ? Xa[t * K + gr] : 0.f, xh[e], xl[e]);
      }
      // a0/a2: row r0 at steps 2tc(+1) / 2tc+8(+9); a1/a3: row r1.
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const MixedRow& r = (e & 1) ? r1 : r0;
        const uint32_t m = (e & 1) ? m1 : m0;
        uint32_t h[2], l[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int s = ks[(e >> 1) * 2 + v];
          const float y =
              (m >> s) & 1u ? (float)r.y[(size_t)(t0 + s) * P] : 0.f;
          split_bf16(y, h[v], l[v]);
        }
        ah[e] = pack2(h[0], h[1]);
        al[e] = pack2(l[0], l[1]);
      }
      const uint32_t bh0 = pack2(xh[0], xh[1]), bh1 = pack2(xh[2], xh[3]);
      const uint32_t bl0 = pack2(xl[0], xl[1]), bl1 = pack2(xl[2], xl[3]);
      mma_bf16(acc[0][0], ah[0], ah[1], ah[2], ah[3], bh0, bh1);
      mma_bf16(acc[1][0], al[0], al[1], al[2], al[3], bh0, bh1);
      mma_bf16(acc[2][0], ah[0], ah[1], ah[2], ah[3], bl0, bl1);
    } else {
      constexpr uint32_t ONE = 0x3F80u;     // bf16 1.0
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t m = (e & 1) ? m1 : m0;
        const int s0 = ks[(e >> 1) * 2], s1 = ks[(e >> 1) * 2 + 1];
        a[e] = pack2((m >> s0) & 1u ? ONE : 0u, (m >> s1) & 1u ? ONE : 0u);
      }
      float xg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xg[e] = (any >> ks[e]) & 1u ? Xa[(t0 + ks[e]) * K + gr] : 0.f;
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        uint32_t xh[4], xl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xi =
              (any >> ks[e]) & 1u ? Xa[(t0 + ks[e]) * K + i0 + u] : 0.f;
          split_bf16(xi * xg[e], xh[e], xl[e]);
        }
        mma_bf16(acc[0][u], a[0], a[1], a[2], a[3], pack2(xh[0], xh[1]),
                 pack2(xh[2], xh[3]));
        mma_bf16(acc[1][u], a[0], a[1], a[2], a[3], pack2(xl[0], xl[1]),
                 pack2(xl[2], xl[3]));
      }
    }
  }
}

// The finished values of a pass's accumulators: the correlations
// ((th.yh + th.yl) + tl.yh) / n, the Gram (XXh.w + XXl.w) / n, for the
// thread's accumulator e of n-tile u (row r0 for e < 2, r1 else).
__device__ __forceinline__ float corr_value(const float (&acc)[3][1][4],
                                            int e, float n) {
  return ((acc[0][0][e] + acc[1][0][e]) + acc[2][0][e]) / n;
}

template <int NT>
__device__ __forceinline__ float gram_value(const float (&acc)[2][NT][4],
                                            int u, int e, float n) {
  return (acc[0][u][e] + acc[1][u][e]) / n;
}

// The stability fit's Gram of detect_mega's INIT (fb::init_pixel), the 32
// pixels of a warp at once, a pixel a lane; called by every lane.  Lane
// p's window is its alive words A at steps [i, j] where ``fit`` (no row
// otherwise), its spectra Yc (band stride TP, step stride P) read at the
// sensor's detection bands.  Correlation rows (detection band r / 32,
// pixel r % 32) and Gram rows (pixels), 16 a pass, go through ``stage``
// (2048 floats of shared memory); g receives the lane's Gram as
// Gram::finish leaves it (G divided by n and mirrored, c divided, n).
__device__ inline void mixed_init_gram(bool fit, const uint32_t* A, int i,
                                       int j, const int16_t* Yc,
                                       const float* Xc, const Roles& roles,
                                       size_t TP, int P, float* stage,
                                       Gram<NDET>& g) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tc = lane & 3;
  MixedRow mine;
  if (fit) {
    int cnt = 0;
    for (int w = i >> 5; w <= (j >> 5); ++w)
      cnt += __popc(A[w * TILE] & ~below(w, i) & below(w, j + 1));
    mine.win = A;
    mine.y = Yc;
    mine.lo = i;
    mine.hi = j;
    mine.n = fmaxf((float)cnt, 1.f);
  }
  if (!__any_sync(MMA_WARP, fit)) return;
#pragma unroll 1
  for (int mt = 0; mt < 2 * NDET; ++mt) {
    const int d = mt >> 1, p = 16 * (mt & 1) + gr;
    MixedRow r[2] = {shfl_row(mine, p), shfl_row(mine, p + 8)};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r[h].on()) r[h].y += (size_t)roles.det[d] * TP;
    float acc[3][1][4] = {};
    mixed_pass<true, 1>(r[0], r[1], Xc, 0, P, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      stage[(32 * d + p + 8 * (e >> 1)) * K + 2 * tc + (e & 1)] =
          corr_value(acc, e, r[e >> 1].n);
  }
  __syncwarp();
#pragma unroll
  for (int d = 0; d < NDET; ++d)
#pragma unroll
    for (int k = 0; k < K; ++k) g.c[d][k] = stage[(32 * d + lane) * K + k];
  __syncwarp();
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int p = 16 * mt + gr;
    const MixedRow r0 = shfl_row(mine, p), r1 = shfl_row(mine, p + 8);
#pragma unroll 1
    for (int i0 = 0; i0 < K; i0 += 2) {
      float acc[2][2][4] = {};
      mixed_pass<false, 2>(r0, r1, Xc, i0, P, acc);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          stage[(p + 8 * (e >> 1)) * K * K + (i0 + u) * K + 2 * tc +
                (e & 1)] = gram_value(acc, u, e, (e >> 1) ? r1.n : r0.n);
    }
  }
  __syncwarp();
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int b = a; b < K; ++b)
      g.G[a][b] = g.G[b][a] = stage[lane * K * K + a * K + b];
  g.n = mine.n;
  __syncwarp();
}

}  // namespace fb
