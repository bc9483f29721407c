// lasso_fit: per-pixel weighted Lasso fit of every band, plus its RMSE.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::lasso_fit
// (body _fit_block, core _gram_cd_core).  Per pixel: the weighted Gram
// X^T diag(w) X and correlations X^T diag(w) y_b over the whole time axis,
// both divided by the window count; LASSO_ITERS cyclic coordinate-descent
// sweeps restricted by the 4/6/8 coefficient mask; then the windowed RMSE.
//
// Bound: bytes and operations about even.  The int16 spectra ([B,T,P],
// 2 B per value) and the f32 weight plane are the only large inputs; each
// thread walks its own pixel column with neighbouring threads on
// neighbouring addresses.  The Gram takes ~100 flops per weighted
// observation and the CD loop ~50*8*B*16 per pixel, on register-resident
// state.  This first version reads the spectra of the window twice (Gram
// pass, RMSE pass) and skips the zero-weight steps of both.
#include "ccd_common.cuh"

namespace {

constexpr int B = 7;

__global__ void __launch_bounds__(fb::BLOCK)
lasso_fit_kernel(const int16_t* __restrict__ Yt, const float* __restrict__ w,
                 const float* __restrict__ X, const uint8_t* __restrict__ mask,
                 float* __restrict__ coefs, float* __restrict__ rmse, int T,
                 int P, int with_rmse) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int16_t* Yc = Yt + (size_t)c * B * T * P;
  const float* wc = w + (size_t)c * T * P;
  const float* Xc = X + (size_t)c * T * K;

  Gram<B> g;
  g.zero();
  for (int t = 0; t < T; ++t) {
    const float wt = wc[(size_t)t * P + p];
    if (wt == 0.f) continue;
    float x[K], y[B];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = __ldg(Xc + t * K + k);
#pragma unroll
    for (int b = 0; b < B; ++b) y[b] = (float)Yc[((size_t)b * T + t) * P + p];
    g.add(x, y, wt);
  }
  g.finish();
  bool m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = mask[((size_t)c * P + p) * K + k] != 0;
  float beta[B][K];
  lasso_cd<B>(g, m, beta);

  float* out = coefs + ((size_t)c * P + p) * B * K;
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int k = 0; k < K; ++k) out[b * K + k] = beta[b][k];

  float* rout = rmse + ((size_t)c * P + p) * B;
  if (!with_rmse) {
#pragma unroll
    for (int b = 0; b < B; ++b) rout[b] = 0.f;
    return;
  }
  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float wt = wc[(size_t)t * P + p];
    if (wt == 0.f) continue;
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = __ldg(Xc + t * K + k);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float pred = beta[b][0] * x[0];
#pragma unroll
      for (int k = 1; k < K; ++k) pred = pred + beta[b][k] * x[k];
      const float r = (float)Yc[((size_t)b * T + t) * P + p] - pred;
      acc[b] = acc[b] + r * r * wt;
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) rout[b] = sqrtf(pmax(acc[b] / g.n, 0.f));
}

}  // namespace

// Yt [C,B,T,P] int16, w [C,T,P] f32 0/1, X [C,T,8] f32, mask [C,P,8] bool
// -> coefs [C,P,B,8] f32, rmse [C,P,B] f32 (zeros when !with_rmse).
extern "C" int fb_lasso_fit(const void* Yt, const void* w, const void* X,
                            const void* mask, void* coefs, void* rmse, int C,
                            int nb, int T, int P, int with_rmse,
                            void* stream) {
  if (nb != B) return (int)cudaErrorInvalidValue;
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  lasso_fit_kernel<<<grid, fb::BLOCK, 0, (cudaStream_t)stream>>>(
      (const int16_t*)Yt, (const float*)w, (const float*)X,
      (const uint8_t*)mask, (float*)coefs, (float*)rmse, T, P, with_rmse);
  return (int)cudaGetLastError();
}
