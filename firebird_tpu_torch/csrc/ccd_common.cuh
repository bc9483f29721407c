// Shared device routines of the CCD kernels (firebird_tpu_torch/csrc).
//
// One thread owns one pixel of one chip.  Planes are laid out with the
// pixel axis fastest ([C, T, P], spectra [C, B, T, P]) so the 32 threads of
// a warp read 32 neighbouring addresses at every time step.
//
// Every kernel here is compiled with -fmad=false: each product and sum is
// rounded on its own, in the order the plain PyTorch versions in
// ccd/cuda_ops.py take them, so kernel and plain version agree bit for bit
// wherever they share an order.  Maxima propagate NaN (pmax), as
// jnp.maximum / torch.maximum do: the Tmask screen's NaN-on-non-PD
// contract depends on it.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace fb {

constexpr int K = 8;            // harmonic design columns (params.MAX_COEFS)
constexpr int NT = 5;           // Tmask design columns (params.TMASK_COEFS)
constexpr int BLOCK = 128;      // threads (pixels) per block
constexpr int LASSO_ITERS = 50;
constexpr float LASSO_ALPHA = 1.0f;
constexpr int PEEK = 6;         // params.PEEK_SIZE
constexpr int NUM_OBS_FACTOR = 3;
constexpr int MID_COEFS = 6;
constexpr int NBAND = 7;        // Landsat bands, the layout the kernels take
constexpr int NDET = 5;         // its detection bands, 1..5
// The event loop's phase codes (ccd/round_state.py).
constexpr int PHASE_INIT = 0;
constexpr int PHASE_MONITOR = 1;
constexpr int PHASE_DONE = 2;

__device__ __forceinline__ float pmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float fsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// Median of v[0..n) — numpy's even-count average, 0 when n == 0, NaN
// when any value is NaN (the min/max sorting network's contract).
// Insertion sort into a local array of NMAX slots.
template <int NMAX>
__device__ float median(const float* v, int n) {
  if (n == 0) return 0.f;
  float s[NMAX];
  for (int a = 0; a < n; ++a) {
    const float x = v[a];
    if (isnan(x)) return NAN;
    int b = a;
    while (b > 0 && s[b - 1] > x) {
      s[b] = s[b - 1];
      --b;
    }
    s[b] = x;
  }
  return 0.5f * (s[(n - 1) / 2] + s[n / 2]);
}

// The allowed coefficients for a fit over n observations: 4, 6 or 8
// columns by NUM_OBS_FACTOR per coefficient — kernel._coefmask_for.
__device__ __forceinline__ void coef_mask(int n, bool mask[K]) {
  const int nc = n >= K * NUM_OBS_FACTOR ? K
                 : (n >= MID_COEFS * NUM_OBS_FACTOR ? MID_COEFS : 4);
#pragma unroll
  for (int k = 0; k < K; ++k) mask[k] = k < nc;
}

// A [T, P] float weight plane read at pixel p (chip base pointer).
struct PlaneWeight {
  const float* w;
  int P, p;
  __device__ float operator()(int t) const { return w[(size_t)t * P + p]; }
};

// Weighted Gram X^T diag(w) X and correlations X^T diag(w) y_b of one
// pixel, accumulated one observation at a time — the accumulation half of
// pallas_ops._gram_cd_core (the same per-term products: w * (x_i x_j) and
// (y w) x_k).
template <int NB>
struct Gram {
  float G[K][K];
  float c[NB][K];
  float n;

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) G[i][j] = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int k = 0; k < K; ++k) c[b][k] = 0.f;
    n = 0.f;
  }

  // One observation: design row x, band values y, weight w (nonzero; a
  // zero weight would add exact zeros, so callers skip it).
  __device__ void add(const float x[K], const float y[NB], float w) {
    n = n + w;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = i; j < K; ++j) G[i][j] = G[i][j] + w * (x[i] * x[j]);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float yw = y[b] * w;
#pragma unroll
      for (int k = 0; k < K; ++k) c[b][k] = c[b][k] + yw * x[k];
    }
  }

  // Divide by the window count max(sum w, 1) and mirror the Gram.
  __device__ void finish() {
    n = fmaxf(n, 1.f);
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = i; j < K; ++j) {
        G[i][j] = G[i][j] / n;
        G[j][i] = G[i][j];
      }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int k = 0; k < K; ++k) c[b][k] = c[b][k] / n;
  }
};

// Cyclic coordinate-descent Lasso on a normalised Gram G, correlations c
// and floored diagonal diag: LASSO_ITERS sweeps, soft threshold
// LASSO_ALPHA, intercept (column 0) unpenalized, coordinates with mask[j]
// false held at zero — kernel._lasso_cd_lax's update, in the column order
// of pallas_ops._gram_cd_core.  The lasso_cd kernel runs it on a Gram
// computed outside; lasso_cd below on a Gram accumulated here.
template <int NB>
__device__ void cd_loop(const float G[K][K], const float c[NB][K],
                        const float diag[K], const bool mask[K],
                        float beta[NB][K]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float bb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) bb[k] = 0.f;
#pragma unroll 1
    for (int it = 0; it < LASSO_ITERS; ++it) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float acc = G[j][0] * bb[0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + G[j][k] * bb[k];
        const float rho = c[b][j] - acc + diag[j] * bb[j];
        float bj;
        if (j == 0) {
          bj = rho / diag[0];
        } else {
          bj = fsign(rho) * pmax(fabsf(rho) - LASSO_ALPHA, 0.f) / diag[j];
        }
        bb[j] = mask[j] ? bj : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) beta[b][k] = bb[k];
  }
}

// cd_loop on a finished Gram, its diagonal floored at 1e-12 (the floor
// kernel._fit_lasso_coefs applies before the CD loop).
template <int NB>
__device__ void lasso_cd(const Gram<NB>& g, const bool mask[K],
                         float beta[NB][K]) {
  float diag[K];
#pragma unroll
  for (int j = 0; j < K; ++j) diag[j] = pmax(g.G[j][j], 1e-12f);
  cd_loop<NB>(g.G, g.c, diag, mask, beta);
}

// One pixel's weighted Lasso fit of every band and its windowed RMSE —
// the body of lasso_fit, shared with the fused round kernels so that a
// fit runs the same instructions in all three (the fused routes' results
// equal the per-component route's only because of this).  wt(t) is the
// window weight of time step t, zero outside the window; zero steps are
// skipped in both passes.  Yc is the chip's [NB, T, P] spectra, Xc its
// [T, K] design.  Writes coef_out [NB*K] and rmse_out [NB] (zeros when
// !with_rmse).
template <int NB, class Weight>
__device__ void fit_window(const int16_t* Yc, const float* Xc,
                           const Weight& wt, int T, int P, int p,
                           const bool mask[K], float* coef_out,
                           float* rmse_out, bool with_rmse) {
  Gram<NB> g;
  g.zero();
  for (int t = 0; t < T; ++t) {
    const float w = wt(t);
    if (w == 0.f) continue;
    float x[K], y[NB];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = __ldg(Xc + t * K + k);
#pragma unroll
    for (int b = 0; b < NB; ++b) y[b] = (float)Yc[((size_t)b * T + t) * P + p];
    g.add(x, y, w);
  }
  g.finish();
  float beta[NB][K];
  lasso_cd<NB>(g, mask, beta);
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k = 0; k < K; ++k) coef_out[b * K + k] = beta[b][k];

  if (!with_rmse) {
#pragma unroll
    for (int b = 0; b < NB; ++b) rmse_out[b] = 0.f;
    return;
  }
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float w = wt(t);
    if (w == 0.f) continue;
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = __ldg(Xc + t * K + k);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float pred = beta[b][0] * x[0];
#pragma unroll
      for (int k = 1; k < K; ++k) pred = pred + beta[b][k] * x[k];
      const float r = (float)Yc[((size_t)b * T + t) * P + p] - pred;
      acc[b] = acc[b] + r * r * w;
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) rmse_out[b] = sqrtf(pmax(acc[b] / g.n, 0.f));
}

}  // namespace fb
