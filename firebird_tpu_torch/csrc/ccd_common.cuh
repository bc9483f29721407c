// Shared device routines of the CCD kernels (firebird_tpu_torch/csrc).
//
// Planes are laid out with the pixel axis fastest ([C, T, P], spectra
// [C, B, T, P]) so the 32 threads of a warp read 32 neighbouring addresses
// at every time step.
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
#include <type_traits>
#include <cuda_runtime.h>

namespace fb {

constexpr int K = 8;            // harmonic design columns (params.MAX_COEFS)
constexpr int NT = 5;           // Tmask design columns (params.TMASK_COEFS)
constexpr int LASSO_ITERS = 50;
constexpr float LASSO_ALPHA = 1.0f;
constexpr int PEEK = 6;         // params.PEEK_SIZE
constexpr int NUM_OBS_FACTOR = 3;
constexpr int MID_COEFS = 6;
constexpr int NDET = 5;         // detection bands of every sensor layout
constexpr int NTM = 2;          // Tmask bands, a subset of the detection bands
// The event loop's phase codes (ccd/round_state.py).
constexpr int PHASE_INIT = 0;
constexpr int PHASE_MONITOR = 1;
constexpr int PHASE_DONE = 2;

// A sensor's band roles (cuda_ops.band_roles builds them from its Sensor):
// det[d] the spectra index of detection band d, tm[q] the position of Tmask
// band q among the detection bands.  Kernels take them by value.
struct Roles {
  int det[NDET];
  int tm[NTM];
};

// The Roles from the host array of NDET + NTM ints a C entry receives.
inline Roles roles_from(const void* host) {
  const int* r = static_cast<const int*>(host);
  Roles o;
  for (int d = 0; d < NDET; ++d) o.det[d] = r[d];
  for (int q = 0; q < NTM; ++q) o.tm[q] = r[NDET + q];
  return o;
}

// The band counts the kernels are instantiated for: Landsat ARD's 7 and
// Sentinel-2's 12 (cuda_ops.NB_CHOICES).  f(std::integral_constant<int,
// NB>) for the instance of nb; an nb outside them is refused.
template <class F>
int with_nb(int nb, F&& f) {
  switch (nb) {
    case 7:
      return f(std::integral_constant<int, 7>{});
    case 12:
      return f(std::integral_constant<int, 12>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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

}  // namespace fb
