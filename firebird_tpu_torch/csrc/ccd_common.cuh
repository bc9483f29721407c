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

__device__ __forceinline__ float pmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float fsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
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

// Cyclic coordinate-descent Lasso on a finished Gram: LASSO_ITERS sweeps,
// soft threshold LASSO_ALPHA, intercept (column 0) unpenalized,
// coordinates with mask[j] false held at zero — kernel._lasso_cd_lax's
// update, in the column order of pallas_ops._gram_cd_core.
template <int NB>
__device__ void lasso_cd(const Gram<NB>& g, const bool mask[K],
                         float beta[NB][K]) {
  float diag[K];
#pragma unroll
  for (int j = 0; j < K; ++j) diag[j] = pmax(g.G[j][j], 1e-12f);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float bb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) bb[k] = 0.f;
#pragma unroll 1
    for (int it = 0; it < LASSO_ITERS; ++it) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float acc = g.G[j][0] * bb[0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + g.G[j][k] * bb[k];
        const float rho = g.c[b][j] - acc + diag[j] * bb[j];
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

}  // namespace fb
