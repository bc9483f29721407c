// The Tmask IRLS screen of one pixel's window on one warp, shared by the
// init_window and tmask_bad kernels (detect_mega keeps the one-thread
// fb::tmask_screen of init_window.cuh).
//
// The same screen as tmask_screen — kernel._tmask_bad /
// pallas_ops._tmask_core: per Tmask band, TMASK_IRLS_ITERS Huber
// reweightings of a weighted 5x5 SPD solve, MAD sigma from masked medians,
// then a flag where a member's final residual exceeds TMASK_CONST x the
// band's variogram — scheduled over the 32 lanes of a warp, both bands at
// once (they are independent):
//   - slots: lane l holds window slots l, l + 32, ... (WMAX / 32 of them)
//     for the residuals, the Huber weights and the flags of both bands;
//   - sums: each of the 20 weighted sums (15 Gram entries, 5
//     correlations) belongs to one lane (lanes 0-19), which adds the member
//     slots one by one in slot order for both bands, as tmask_screen and
//     primitives.tmask_bad do, so every sum keeps its bits.  Every sum lane
//     runs one instruction sequence, acc + A[s] * (P[s] * Q[s]): a Gram
//     entry (a, b) takes P, Q = design columns a, b and A = the weights
//     (w * (x_a x_b)); a correlation takes P = column a, Q = ones and A =
//     y * w ((y w) * x_a, the product with 1 being exact);
//   - the 5x5 Cholesky (chol_solve5) of band 0 runs on lanes 0-15 and of
//     band 1 on lanes 16-31, from the sums gathered by shuffles;
//   - medians are exact order statistics: for the residuals' median each
//     lane counts the members below its value (on order-preserving integer
//     keys of the values), ties broken by slot, and the lanes holding the
//     two middle ranks hand their values over; the MAD is then selected
//     from the members so sorted, |r - median| falling and then rising
//     along them — fb::median's contract (0 for no member, NaN for any NaN
//     member, numpy's even-count average), so the same bits as its
//     insertion sort.
// The window's no-trend design rows are in the warp's area (TmaskArea);
// each lane passes its slots' Tmask-band values and weights (a slot of
// weight 0 is no member).
#pragma once

#include "init_window.cuh"
#include "tile.cuh"

namespace fb {

constexpr uint32_t FULL_WARP = 0xFFFFFFFFu;
constexpr int TM_GRAM = NT * (NT + 1) / 2;        // 15 Gram entries
constexpr int TM_SUMS = TM_GRAM + NT;             // and 5 correlations
constexpr int TM_ROWS = NT + 7;                   // TmaskArea's rows
constexpr int TM_SCRATCH = 16;                    // floats after the rows

// A warp's rows in shared memory (stride WMAX + 1, TM_ROWS of them, then
// TM_SCRATCH floats the caller may use): the design X (NT rows, by slot),
// the weights and weighted values of both bands, a row of ones, the order
// keys of the values being ranked, then the sorted values (both bands).
// The caller fills X; tmask_warp writes the others.
struct TmaskArea {
  float* X;
  float *wt0, *wt1, *yw0, *yw1, *ones, *v0, *v1;
  float* scratch;
  int R;
  __device__ TmaskArea(float* base, int wmax) : X(base), R(wmax + 1) {
    wt0 = base + NT * R;
    wt1 = wt0 + R;
    yw0 = wt1 + R;
    yw1 = yw0 + R;
    ones = yw1 + R;
    v0 = ones + R;
    v1 = v0 + R;
    scratch = v1 + R;
  }
};

// The value of the member whose rank (among val, ranks rank) is r, on
// every lane (0 when none has it).
template <int S>
__device__ __forceinline__ float rank_pick(const float (&val)[S],
                                           const int (&rank)[S],
                                           const uint32_t (&memb)[S], int r,
                                           int lane) {
  float out = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint32_t b =
        __ballot_sync(FULL_WARP, ((memb[k] >> lane) & 1u) && rank[k] == r);
    const float v = __shfl_sync(FULL_WARP, val[k], b ? __ffs(b) - 1 : 0);
    if (b) out = v;
  }
  return out;
}

// An order-preserving key of a float that is not NaN: a < b exactly when
// key(a) < key(b), with -0 and +0 one key (they compare equal).
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t b = __float_as_uint(x);
  b = b == 0x80000000u ? 0u : b;
  return (b >> 31) ? ~b : b | 0x80000000u;
}
// Past every key of a float (a slot that is no member).
constexpr uint32_t NO_KEY = 0xFFFFFFFFu;

// The members' medians of two value sets (both bands): lane holds val0[k],
// val1[k] of slot lane + 32k, memb[k] the warp's member ballot of its k-th
// slots, n the window's slots.  Each member's rank counts the members
// below it, ties broken by slot: the slots' order keys are read from the
// area's ranked rows (a broadcast load a slot and band), and slot u counts
// below slot s when key(u) < key(s) + (u < s), a non-member's key being
// past all.  The two middle ranks are picked by ballot.  NaN values (then
// the median is NaN) rank arbitrarily.  Returns the same pair on every
// lane.
template <int WMAX>
__device__ void warp_median2(const float (&val0)[WMAX / 32],
                             const float (&val1)[WMAX / 32],
                             const uint32_t (&memb)[WMAX / 32], int n,
                             const TmaskArea& A, int lane, float& med0,
                             float& med1) {
  constexpr int S = WMAX / 32;
  uint32_t* k0 = reinterpret_cast<uint32_t*>(A.v0);
  uint32_t* k1 = reinterpret_cast<uint32_t*>(A.v1);
  int m = 0;
  bool nan0 = false, nan1 = false;
  uint32_t key0[S], key1[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int s = lane + 32 * k;
    const bool mk = (memb[k] >> lane) & 1u;
    m += __popc(memb[k]);
    key0[k] = order_key(val0[k]);
    key1[k] = order_key(val1[k]);
    if (s < n) {
      k0[s] = mk ? key0[k] : NO_KEY;
      k1[s] = mk ? key1[k] : NO_KEY;
    }
    nan0 = nan0 || (mk && isnan(val0[k]));
    nan1 = nan1 || (mk && isnan(val1[k]));
  }
  nan0 = __any_sync(FULL_WARP, nan0);
  nan1 = __any_sync(FULL_WARP, nan1);
  __syncwarp();
  int rank0[S], rank1[S];
#pragma unroll
  for (int k = 0; k < S; ++k) rank0[k] = rank1[k] = 0;
#pragma unroll
  for (int ku = 0; ku < S; ++ku) {
    if (memb[ku] == 0) continue;
    const int nu = min(32, n - 32 * ku);
#pragma unroll 4
    for (int j = 0; j < nu; ++j) {
      const uint32_t x0 = k0[32 * ku + j], x1 = k1[32 * ku + j];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        // Slot 32 ku + j comes before slot lane + 32 k.
        const uint32_t tie = (ku < k || (ku == k && j < lane)) ? 1u : 0u;
        rank0[k] += x0 < key0[k] + tie ? 1 : 0;
        rank1[k] += x1 < key1[k] + tie ? 1 : 0;
      }
    }
  }
  // The ballots below follow every lane's last read of the ranked rows.
  const int lo = (m - 1) / 2, hi = m / 2;
  const float lo0 = rank_pick<S>(val0, rank0, memb, lo, lane);
  const float hi0 = rank_pick<S>(val0, rank0, memb, hi, lane);
  const float lo1 = rank_pick<S>(val1, rank1, memb, lo, lane);
  const float hi1 = rank_pick<S>(val1, rank1, memb, hi, lane);
  med0 = nan0 ? NAN : (m == 0 ? 0.f : 0.5f * (lo0 + hi0));
  med1 = nan1 ? NAN : (m == 0 ? 0.f : 0.5f * (lo1 + hi1));
  // The members in ascending order, for the MAD (warp_mad2).
#pragma unroll
  for (int k = 0; k < S; ++k)
    if ((memb[k] >> lane) & 1u) {
      A.v0[rank0[k]] = val0[k];
      A.v1[rank1[k]] = val1[k];
    }
  __syncwarp();
}

// The k-th smallest of |v - med| over a sorted row v of m values: the
// distances fall and then rise along v (float rounding is monotone), so
// the k + 1 smallest form a window of the row, and the k-th smallest is
// the least, over the windows of k + 1 values, of the larger distance at
// the window's two ends.  Every lane returns it.
template <int WMAX>
__device__ __forceinline__ float vee_select(const float* v, int m, int k,
                                            float med, int lane) {
  float best = INFINITY;
#pragma unroll
  for (int j = 0; j < WMAX / 32; ++j) {
    const int a = lane + 32 * j;
    if (a + k < m)
      best = fminf(best, fmaxf(fabsf(v[a] - med), fabsf(v[a + k] - med)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = fminf(best, __shfl_xor_sync(FULL_WARP, best, o));
  return best;
}

// The MADs of both bands — the medians of |r - med| over the members, m of
// them — from the sorted rows warp_median2 leaves (an exact order
// statistic is a value: any correct selection gives fb::median's bits);
// nan0 / nan1 whether some member's |r - med| is NaN.
template <int WMAX>
__device__ void warp_mad2(const TmaskArea& A, int m, float med0, float med1,
                          bool nan0, bool nan1, int lane, float& mad0,
                          float& mad1) {
  const int lo = (m - 1) / 2, hi = m / 2;
  const float lo0 = vee_select<WMAX>(A.v0, m, lo, med0, lane);
  const float hi0 = vee_select<WMAX>(A.v0, m, hi, med0, lane);
  const float lo1 = vee_select<WMAX>(A.v1, m, lo, med1, lane);
  const float hi1 = vee_select<WMAX>(A.v1, m, hi, med1, lane);
  mad0 = nan0 ? NAN : (m == 0 ? 0.f : 0.5f * (lo0 + hi0));
  mad1 = nan1 ? NAN : (m == 0 ? 0.f : 0.5f * (lo1 + hi1));
  __syncwarp();
}

// The prediction beta . x of slot s from the design rows.
__device__ __forceinline__ float tm_pred(const float (&beta)[NT],
                                         const float* X, int R, int s) {
  float pred = beta[0] * X[s];
#pragma unroll
  for (int c = 1; c < NT; ++c) pred = pred + beta[c] * X[c * R + s];
  return pred;
}

// The screen of a window of n slots (n <= WMAX), run by the whole warp
// with the same arguments: A.X holds the slots' design rows; lane passes
// y0/y1/w of its slots lane + 32k (any value past n); thr0 / thr1 are
// TMASK_CONST x the Tmask bands' variograms.  Returns this lane's flags:
// bit k for slot lane + 32k.
template <int WMAX>
__device__ uint32_t tmask_warp(const TmaskArea& A,
                               const float (&y0)[WMAX / 32],
                               const float (&y1)[WMAX / 32],
                               const float (&w)[WMAX / 32], int n, float thr0,
                               float thr1, int lane) {
  constexpr int S = WMAX / 32;
  const int R = A.R;
  uint32_t memb[S];
  int m = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int s = lane + 32 * k;
    memb[k] = __ballot_sync(FULL_WARP, s < n && w[k] > 0.f);
    m += __popc(memb[k]);
    A.ones[s] = 1.f;
  }
  // This lane's sum: Gram entry (a, b), b <= a, for lanes 0-14 (in the
  // order of the lower triangle's rows), correlation a for lanes 15-19.
  int a = 0, b = 0;
  const float *P, *Q, *A0, *A1;
  if (lane < TM_GRAM) {
    while ((a + 1) * (a + 2) / 2 <= lane) ++a;
    b = lane - a * (a + 1) / 2;
    P = A.X + a * R;
    Q = A.X + b * R;
    A0 = A.wt0;
    A1 = A.wt1;
  } else {
    a = min(lane - TM_GRAM, NT - 1);
    P = A.X + a * R;
    Q = A.ones;
    A0 = A.yw0;
    A1 = A.yw1;
  }
  const bool band1 = lane >= 16;        // this lane's half solves band 1
  float beta[NT];
#pragma unroll 1
  for (int it = 0; it <= TM_ITERS; ++it) {
    if (it == 0) {
#pragma unroll
      for (int k = 0; k < S; ++k)
        if ((memb[k] >> lane) & 1u) {
          const int s = lane + 32 * k;
          A.wt0[s] = A.wt1[s] = w[k];
          A.yw0[s] = y0[k] * w[k];
          A.yw1[s] = y1[k] * w[k];
        }
    } else {
      // Huber weights from the previous solves' residuals; MAD sigma from
      // the members' medians.
      float b0[NT], b1[NT];
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        b0[c] = __shfl_sync(FULL_WARP, beta[c], 0);
        b1[c] = __shfl_sync(FULL_WARP, beta[c], 16);
      }
      float r0[S], r1[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int s = lane + 32 * k;
        r0[k] = r1[k] = 0.f;
        if ((memb[k] >> lane) & 1u) {
          r0[k] = y0[k] - tm_pred(b0, A.X, R, s);
          r1[k] = y1[k] - tm_pred(b1, A.X, R, s);
        }
      }
      float med0, med1, mad0, mad1;
      warp_median2<WMAX>(r0, r1, memb, n, A, lane, med0, med1);
      bool dnan0 = false, dnan1 = false;
#pragma unroll
      for (int k = 0; k < S; ++k)
        if ((memb[k] >> lane) & 1u) {
          dnan0 = dnan0 || isnan(fabsf(r0[k] - med0));
          dnan1 = dnan1 || isnan(fabsf(r1[k] - med1));
        }
      warp_mad2<WMAX>(A, m, med0, med1, __any_sync(FULL_WARP, dnan0),
                      __any_sync(FULL_WARP, dnan1), lane, mad0, mad1);
      const float sigma0 = pmax(mad0 / 0.6745f, 1e-6f);
      const float sigma1 = pmax(mad1 / 0.6745f, 1e-6f);
#pragma unroll
      for (int k = 0; k < S; ++k)
        if ((memb[k] >> lane) & 1u) {
          const int s = lane + 32 * k;
          const float a0 = fabsf(r0[k]) / (HUBER_K * sigma0);
          const float a1 = fabsf(r1[k]) / (HUBER_K * sigma1);
          const float h0 = (a0 <= 1.f) ? 1.f : 1.f / pmax(a0, 1e-12f);
          const float h1 = (a1 <= 1.f) ? 1.f : 1.f / pmax(a1, 1e-12f);
          const float w0 = w[k] * h0, w1 = w[k] * h1;
          A.wt0[s] = w0;
          A.wt1[s] = w1;
          A.yw0[s] = y0[k] * w0;
          A.yw1[s] = y1[k] * w1;
        }
    }
    __syncwarp();
    // Weighted 5x5 normal equations of both bands: one sum a lane, member
    // slot by member slot.
    float acc0 = 0.f, acc1 = 0.f;
    if (lane < TM_SUMS) {
#pragma unroll
      for (int k = 0; k < S; ++k)
        for (uint32_t m = memb[k]; m; m &= m - 1u) {
          const int s = 32 * k + __ffs(m) - 1;
          const float u = P[s] * Q[s];
          acc0 = acc0 + A0[s] * u;
          acc1 = acc1 + A1[s] * u;
        }
    }
    float G[NT][NT], cc[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const float g0 = __shfl_sync(FULL_WARP, acc0, i * (i + 1) / 2 + j);
        const float g1 = __shfl_sync(FULL_WARP, acc1, i * (i + 1) / 2 + j);
        G[i][j] = band1 ? g1 : g0;
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float c0 = __shfl_sync(FULL_WARP, acc0, TM_GRAM + i);
      const float c1 = __shfl_sync(FULL_WARP, acc1, TM_GRAM + i);
      cc[i] = band1 ? c1 : c0;
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) G[i][i] = G[i][i] + 1e-9f;
    chol_solve5(G, cc, beta);
    __syncwarp();
  }
  float b0[NT], b1[NT];
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    b0[c] = __shfl_sync(FULL_WARP, beta[c], 0);
    b1[c] = __shfl_sync(FULL_WARP, beta[c], 16);
  }
  uint32_t bad = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int s = lane + 32 * k;
    if ((memb[k] >> lane) & 1u) {
      const bool f0 = fabsf(y0[k] - tm_pred(b0, A.X, R, s)) > thr0;
      const bool f1 = fabsf(y1[k] - tm_pred(b1, A.X, R, s)) > thr1;
      if (f0 || f1) bad |= 1u << k;
    }
  }
  return bad;
}

}  // namespace fb
