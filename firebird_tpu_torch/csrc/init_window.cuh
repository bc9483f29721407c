// The INIT round's one-thread per-pixel body and its Tmask screen, run by
// detect_mega's INIT (warp 0 of its tile).  The init_window and tmask_bad
// kernels run the warp-cooperative screen of tmask_warp.cuh on the same
// constants and Cholesky (chol_solve5), and give init_pixel's results bit
// for bit.
//
// init_pixel, per pixel (pallas_ops._init_logic, with _tmask_core and
// _gram_cd_core inlined):
//   1. the initialization window: from the first alive observation i at or
//      after the cursor, the first alive j with at least MEOW_SIZE alive
//      observations in [i, j] spanning INIT_DAYS;
//   2. the window's members (at most W, the host's window_cap) gathered by
//      position into per-thread arrays;
//   3. the Tmask screen (tmask_screen): TMASK_IRLS_ITERS Huber reweightings
//      of a 5x5 SPD solve (unrolled Cholesky, NaN on a non-positive pivot
//      so that nothing is flagged), masked medians by insertion sort, a
//      flag where the residual exceeds TMASK_CONST x the variogram;
//   4. the 4-coefficient stability fit of the detection bands over the
//      window (the lasso_fit Gram/CD core) and the STABILITY_FACTOR test;
//   5. the cursor advances and the w_stab / alive_init columns.
// The window arrays are sized by the template's WMAX and live in local
// memory (-Xptxas -v reports the stack frame).
// A mixed-precision instance (FB_MIXED) sums the stability fit's Gram and
// correlations on the tensor cores, the warp's 32 pixels at once
// (mixed_gram.cuh's mixed_init_gram): every lane of the warp calls
// init_pixel, and the pixels' sums are dense_fit's, bit for bit.
#pragma once

#include "ccd_common.cuh"
#if FB_MIXED
#include "mixed_gram.cuh"
#endif

namespace fb {

constexpr int MEOW = 12;                             // params.MEOW_SIZE
constexpr float INIT_DAYS = 365.25f;
constexpr int TM_ITERS = 5;                          // TMASK_IRLS_ITERS
constexpr float HUBER_K = 1.345f;
constexpr float TMASK_CONST = 4.89f;
constexpr float STAB = 3.0f;                         // STABILITY_FACTOR

// Solve G beta = c for the 5x5 SPD G (lower half filled) by unrolled
// Cholesky — kernel._chol_solve_small.  A pivot that is not > 0 makes
// the whole solution NaN.
__device__ inline void chol_solve5(float G[NT][NT], const float c[NT],
                                   float x[NT]) {
  float L[NT][NT];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = G[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) s = s - L[i][q] * L[j][q];
      if (i == j) {
        ok = ok && (s > 0.f);
        L[i][j] = sqrtf(pmax(s, 1e-30f));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  float y[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float s = c[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s = s - L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = NT - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < NT; ++q) s = s - L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < NT; ++i) x[i] = NAN;
  }
}

// The Tmask IRLS screen of one pixel's window — kernel._tmask_bad /
// pallas_ops._tmask_core.  ``win`` gives the window's n slots:
// win.x(s, k) the no-trend design column k of slot s, win.y(q, s) the
// slot's value in Tmask band q (0, 1), win.w(s) its weight (a slot with
// weight 0 is no member: it takes no part in the sums and medians and is
// never flagged).  thr[q] is TMASK_CONST x the band's variogram.  Every
// weighted sum runs slot by slot, in order, as primitives.tmask_bad's do.
// Sets bad[s] for the flagged slots and returns whether any was flagged.
template <int WMAX, class Win>
__device__ bool tmask_screen(const Win& win, int n, const float thr[2],
                             bool bad[WMAX]) {
  float wt[2][WMAX];
  float r[WMAX], tmp[WMAX];
  float beta[2][NT];
  for (int s = 0; s < n; ++s) {
    bad[s] = false;
    wt[0][s] = wt[1][s] = win.w(s);
  }
  for (int it = 0; it <= TM_ITERS; ++it) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (it > 0) {
        // Huber weights from the previous solve's residuals; MAD sigma
        // from the members' medians.
        int m = 0;
        for (int s = 0; s < n; ++s) {
          if (!(win.w(s) > 0.f)) continue;
          float pred = beta[q][0] * win.x(s, 0);
#pragma unroll
          for (int k = 1; k < NT; ++k) pred = pred + beta[q][k] * win.x(s, k);
          r[s] = win.y(q, s) - pred;
          tmp[m++] = r[s];
        }
        const float med = median<WMAX>(tmp, m);
        m = 0;
        for (int s = 0; s < n; ++s)
          if (win.w(s) > 0.f) tmp[m++] = fabsf(r[s] - med);
        const float mad = median<WMAX>(tmp, m);
        const float sigma = pmax(mad / 0.6745f, 1e-6f);
        for (int s = 0; s < n; ++s) {
          if (!(win.w(s) > 0.f)) continue;
          const float a = fabsf(r[s]) / (HUBER_K * sigma);
          const float h = (a <= 1.f) ? 1.f : 1.f / pmax(a, 1e-12f);
          wt[q][s] = win.w(s) * h;
        }
      }
      // Weighted 5x5 normal equations, summed slot by slot.
      float G[NT][NT], cc[NT];
#pragma unroll
      for (int a = 0; a < NT; ++a) {
        cc[a] = 0.f;
#pragma unroll
        for (int b = 0; b < NT; ++b) G[a][b] = 0.f;
      }
      for (int s = 0; s < n; ++s) {
        if (!(win.w(s) > 0.f)) continue;
        float x[NT];
#pragma unroll
        for (int k = 0; k < NT; ++k) x[k] = win.x(s, k);
        const float w = wt[q][s];
        const float yw = win.y(q, s) * w;
#pragma unroll
        for (int a = 0; a < NT; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b) G[a][b] = G[a][b] + w * (x[a] * x[b]);
          cc[a] = cc[a] + yw * x[a];
        }
      }
#pragma unroll
      for (int a = 0; a < NT; ++a) G[a][a] = G[a][a] + 1e-9f;
      chol_solve5(G, cc, beta[q]);
    }
  }
  bool any = false;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    for (int s = 0; s < n; ++s) {
      if (!(win.w(s) > 0.f)) continue;
      float pred = beta[q][0] * win.x(s, 0);
#pragma unroll
      for (int k = 1; k < NT; ++k) pred = pred + beta[q][k] * win.x(s, k);
      if (fabsf(win.y(q, s) - pred) > thr[q]) {
        bad[s] = true;
        any = true;
      }
    }
  }
  return any;
}

// The INIT body's window as tmask_screen reads it: the Tmask bands of the
// gathered detection-band values (tm: their positions among the detection
// bands), the design rows at the members' positions, weight 1 for every
// member.
template <int WMAX, class Col>
struct InitWindow {
  const float (*Y)[WMAX];       // [NDET][WMAX] detection-band values
  const short* pos;             // member positions
  const float* Xtc;             // the chip's no-trend design [T, NT]
  int tm[NTM];
  __device__ float x(int s, int k) const { return Col::ld(Xtc + pos[s] * NT + k); }
  __device__ float y(int q, int s) const { return Y[tm[q]][s]; }
  __device__ float w(int) const { return 1.f; }
};

// kernel._init_block's per-pixel outputs.
struct InitOut {
  int nowin, tm, ok, bad, has_adv, i_next_tm, i_adv, j, n_ok;
};

// One pixel's INIT round.  col holds its alive column in and its w_stab
// and alive_init columns out (col.alive(t), col.put(t, alive_init, w_stab):
// each step's alive flag is read before its outputs are written, as
// detect_mega's WordColumns does); Yc (the spectra
// [NB, T, P]) is offset to the pixel, strided by P; tc [T], Xc [T, K] and
// Xtc [T, NT] are the chip's days and designs (read through Col::ld),
// vrow [NB] the pixel's variogram, roles the sensor's detection and Tmask
// bands.  ci is the cursor, init whether the pixel initializes (a pixel
// that does not gets an empty window's outputs).  The mixed instance's
// stage is 2048 floats of shared memory for the warp (mixed_init_gram).
template <int WMAX, class Col>
__device__ InitOut init_pixel(Col& col, int ci, bool init, const float* tc,
                              const float* Xc, const float* Xtc,
                              const int16_t* Yc, const float* vrow,
                              const Roles& roles, int T, int P, int W,
                              float* stage = nullptr) {
  // 1. i: first alive at or after the cursor (0 when none).
  int i = 0;
  bool has_i = false;
  for (int t = 0; t < T; ++t) {
    if (col.alive(t) && t >= ci) {
      i = t;
      has_i = true;
      break;
    }
  }
  //    j: first alive with MEOW_SIZE alive obs in [i, j] spanning INIT_DAYS
  //    (0 when none); the alive obs of [i, j] are the window's members.
  const float t_i = tc[i];
  int j = 0, cnt = 0, n_win = 0;
  bool has_w_raw = false;
  short pos[WMAX];
  for (int t = i; t < T; ++t) {
    if (!col.alive(t)) continue;
    if (cnt < WMAX) pos[cnt] = (short)t;
    ++cnt;
    if (cnt >= MEOW && tc[t] - t_i >= INIT_DAYS) {
      j = t;
      has_w_raw = true;
      break;
    }
  }
  const bool has_w = has_i && has_w_raw;
  const bool work = init && has_w;
  if (work) n_win = min(cnt, min(W, WMAX));

  // 2-4. Window members, Tmask screen, stability.
  bool bad[WMAX];
  bool tm_removed = false, stable = false;
#if FB_MIXED
  float Y[NDET][WMAX];
  if (work) {
    for (int s = 0; s < n_win; ++s) {
#pragma unroll
      for (int d = 0; d < NDET; ++d)
        Y[d][s] = (float)Yc[((size_t)roles.det[d] * T + pos[s]) * P];
    }
    const float thr[2] = {TMASK_CONST * vrow[roles.det[roles.tm[0]]],
                          TMASK_CONST * vrow[roles.det[roles.tm[1]]]};
    tm_removed = tmask_screen<WMAX>(
        InitWindow<WMAX, Col>{Y, pos, Xtc, {roles.tm[0], roles.tm[1]}},
        n_win, thr, bad);
  }
  // The Gram of every alive observation of [i, j], the warp's lanes
  // together.  (Each branch opens the two blocks that the stability test
  // after it closes.)
  Gram<NDET> g;
  mixed_init_gram(work && !tm_removed, col.A, i, j, Yc, Xc, roles,
                  (size_t)T * P, P, stage, g);
  if (work && !tm_removed) {
    const int n = n_win;
    {
      bool m4[K];
#pragma unroll
      for (int k = 0; k < K; ++k) m4[k] = k < 4;
      float c4[NDET][K];
      lasso_cd<NDET>(g, m4, c4);
      const float span = tc[j] - t_i;
#else
  if (work) {
    const int n = n_win;
    float Y[NDET][WMAX];
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int d = 0; d < NDET; ++d)
        Y[d][s] = (float)Yc[((size_t)roles.det[d] * T + pos[s]) * P];
    }

    // 3. Tmask IRLS on the two Tmask bands.
    const float thr[2] = {TMASK_CONST * vrow[roles.det[roles.tm[0]]],
                          TMASK_CONST * vrow[roles.det[roles.tm[1]]]};
    tm_removed = tmask_screen<WMAX>(
        InitWindow<WMAX, Col>{Y, pos, Xtc, {roles.tm[0], roles.tm[1]}}, n, thr,
        bad);

    // 4. Stability: 4-coefficient fit of the detection bands over the
    //    window, then the slope / first / last residual tests.
    if (!tm_removed) {
      // The fit runs over every alive observation of [i, j] (the window
      // holds more than W members only if W is below window_cap).
      Gram<NDET> g;
      g.zero();
      for (int t = i; t <= j; ++t) {
        if (!col.alive(t)) continue;
        float x[K], y[NDET];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = Col::ld(Xc + t * K + k);
#pragma unroll
        for (int d = 0; d < NDET; ++d)
          y[d] = (float)Yc[((size_t)roles.det[d] * T + t) * P];
        g.add(x, y, 1.f);
      }
      g.finish();
      bool m4[K];
#pragma unroll
      for (int k = 0; k < K; ++k) m4[k] = k < 4;
      float c4[NDET][K];
      lasso_cd<NDET>(g, m4, c4);
      const float span = tc[j] - t_i;
#endif
      const float n4 = fmaxf((float)n, 1.f);
      stable = true;
#pragma unroll
      for (int d = 0; d < NDET; ++d) {
        float acc = 0.f, r_first = 0.f, r_last = 0.f;
        for (int s = 0; s < n; ++s) {
          float x[K];
#pragma unroll
          for (int k = 0; k < K; ++k) x[k] = Col::ld(Xc + pos[s] * K + k);
          float pred = c4[d][0] * x[0];
#pragma unroll
          for (int k = 1; k < K; ++k) pred = pred + c4[d][k] * x[k];
          const float rr = Y[d][s] - pred;
          acc = acc + rr * rr * 1.f;
          if (s == 0) r_first = rr;
          if (s == cnt - 1) r_last = rr;    // 0 when the last member is past W
        }
        const float r4 = sqrtf(pmax(acc / n4, 0.f));
        const float denom = STAB * pmax(r4, vrow[roles.det[d]]);
        const float slope_day = c4[d][1] / 365.25f;
        const bool ok = (fabsf(slope_day * span) <= denom) &&
                        (fabsf(r_first) <= denom) && (fabsf(r_last) <= denom);
        stable = stable && ok;
      }
    }
  }

  // 5. Cursor advances and the output columns.
  const bool keep = work && !tm_removed;         // w_stab's pixel gate
  int i_next = T, i_adv = 0, q = 0;
  bool has_adv = false, found_next = false;
  for (int t = 0; t < T; ++t) {
    const bool a = col.alive(t);
    bool b = false;
    if (work && q < n_win && pos[q] == t) {
      b = bad[q];
      ++q;
    }
    const bool a_out = a && !b;
    col.put(t, a_out, keep && a && t >= i && t <= j);
    if (!found_next && a_out && t >= i) {
      found_next = true;
      i_next = t;
    }
    if (!has_adv && a && t >= i + 1) {
      has_adv = true;
      i_adv = t;
    }
  }

  InitOut o;
  o.nowin = init && !has_w;
  o.tm = work && tm_removed;
  o.ok = work && !tm_removed && stable;
  o.bad = work && !tm_removed && !stable;
  o.has_adv = has_adv;
  o.i_next_tm = i_next;
  o.i_adv = i_adv;
  o.j = j;
  o.n_ok = keep ? cnt : 0;
  return o;
}

}  // namespace fb
