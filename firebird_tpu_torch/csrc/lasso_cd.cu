// lasso_cd: the Lasso coordinate-descent loop on precomputed Gram systems,
// per pixel.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::lasso_cd
// (_cd_block), which serves the JAX package's FIREBIRD_PALLAS=lasso route:
// there XLA computes the normalised Gram, the correlations and the floored
// diagonal, the kernel runs LASSO_ITERS cyclic sweeps on them (soft
// threshold LASSO_ALPHA, intercept unpenalized, coordinates outside the
// mask held at zero), and XLA computes the RMSE.  The per-pixel body is
// fb::cd_loop (ccd_common.cuh), the very loop lasso_fit and the fused
// kernels run after accumulating their own Gram.
//
// Bound: operations.  A pixel reads 64 + 8*B + 8 floats and 8 mask bytes
// and writes 8*B floats (~0.8 KB) but runs 50 sweeps of 8 coordinates per
// band, each a dot of 8 plus the soft threshold (~20 flops): ~56 000 flops
// a pixel at B=7.  Everything stays in registers; each thread reads its own
// pixel's rows, which lie contiguous.
#include "ccd_common.cuh"

namespace {

constexpr int B = 7;

__global__ void __launch_bounds__(fb::BLOCK)
lasso_cd_kernel(const float* __restrict__ G, const float* __restrict__ c,
                const float* __restrict__ diag,
                const uint8_t* __restrict__ mask, float* __restrict__ beta,
                int N) {
  using namespace fb;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float g[K][K], cc[B][K], d[K];
  bool m[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) g[j][k] = G[((size_t)i * K + j) * K + k];
    d[j] = diag[(size_t)i * K + j];
    m[j] = mask[(size_t)i * K + j] != 0;
  }
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int k = 0; k < K; ++k) cc[b][k] = c[((size_t)i * B + b) * K + k];
  float out[B][K];
  cd_loop<B>(g, cc, d, m, out);
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int k = 0; k < K; ++k) beta[((size_t)i * B + b) * K + k] = out[b][k];
}

}  // namespace

// G [N,8,8], c [N,B,8], diag [N,8] f32, mask [N,8] u8 -> beta [N,B,8] f32,
// N the flattened chip x pixel count.
extern "C" int fb_lasso_cd(const void* G, const void* c, const void* diag,
                           const void* mask, void* beta, int N, int nb,
                           void* stream) {
  if (nb != B) return (int)cudaErrorInvalidValue;
  lasso_cd_kernel<<<(N + fb::BLOCK - 1) / fb::BLOCK, fb::BLOCK, 0,
                    (cudaStream_t)stream>>>(
      (const float*)G, (const float*)c, (const float*)diag,
      (const uint8_t*)mask, (float*)beta, N);
  return (int)cudaGetLastError();
}
