// lasso_fit: per-pixel weighted Lasso fit of every band, plus its RMSE.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::lasso_fit
// (body _fit_block, core _gram_cd_core).  Per pixel: the weighted Gram
// X^T diag(w) X and correlations X^T diag(w) y_b over the whole time axis,
// both divided by the window count; LASSO_ITERS cyclic coordinate-descent
// sweeps restricted by the 4/6/8 coefficient mask; then the windowed RMSE.
//
// Bound: operations on the main path's data (the CD loop, ~50*8*B*20 flops
// a fitting pixel), bytes close behind (the window's int16 spectra, the
// f32 weight plane).  The design, as fused_round's fit (tile.cuh's layout):
//   0. The block stages its chip's design X [T,8] in shared memory and
//      turns its TILE pixels' weight columns into 32-step bit words (the
//      weights are 0/1), TILE_Q threads a pixel.
//   1. Warp 0 lists the pixels with any weight by ballot; a pixel with no
//      weight costs no walk: its fit is exactly zero (a zero Gram floored
//      at 1e-12 gives zero coefficients and a zero RMSE), written directly.
//   2. The listed pixels are fitted densely, TILE_Q lanes a pixel
//      (fb::dense_fit, the code of fused_round's refit): the Gram and
//      correlation sums split over the lanes by sum, never by time, so the
//      coefficients and RMSE are the one-thread fit's bit for bit.
#include "dense_fit.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int Q = fb::TILE_Q;
// 32 warps an SM at 64 registers: the walks wait on their loads, and the
// extra warps hide more of it than the 116 bytes of spills cost (24 warps
// at 80 registers ran 11 % slower on an H100, 40 at 48 registers 34 %).
constexpr int MIN_BLOCKS = 4;

// Dynamic shared memory of a block for T time steps, in 4-byte words: X,
// the Grams, the weight words, the fit list, the listed flags and count.
// cuda_ops.lasso_fit_smem_bytes computes the same.
size_t smem_words(int T) {
  const int W = (T + 31) / 32;
  return (size_t)8 * T + TILE * fb::GSTRIDE + (size_t)W * TILE + 2 * TILE + 4;
}

template <int B>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
lasso_fit_kernel(const int16_t* __restrict__ Yt, const float* __restrict__ w,
                 const float* __restrict__ X, const uint8_t* __restrict__ mask,
                 float* __restrict__ coefs, float* __restrict__ rmse, int T,
                 int P, int with_rmse) {
  using namespace fb;
  extern __shared__ __align__(16) float smem[];
  const int W = (T + 31) / 32;
  float* Xs = smem;
  float* Gs = Xs + T * K;
  uint32_t* mW = reinterpret_cast<uint32_t*>(Gs + TILE * GSTRIDE);
  int* flist = reinterpret_cast<int*>(mW + W * TILE);
  int* listed = flist + TILE;
  int* nfit = listed + TILE;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t TP = (size_t)T * P;
  const int p0 = blockIdx.x * TILE;
  const int16_t* Yc = Yt + (size_t)c * B * TP;

  // 0. Stage the design; the weight words, thread (q, i): pixel i, words q,
  // q+Q, ...
  stage(Xs, X + (size_t)c * T * K, T * K);
  const int i = tid % TILE;
  const int p = p0 + i;
  const bool valid = p < P;
  for (int v = tid / TILE; v < W; v += Q)
    mW[v * TILE + i] =
        valid ? column_word(w + (size_t)c * TP + p, P, v, T) : 0u;
  __syncthreads();

  // 1. The pixels with any weight, listed.
  if (tid < TILE) {
    uint32_t any = 0;
    for (int v = 0; v < W; ++v) any |= mW[v * TILE + i];
    const int slot = list_pixels(any != 0, i, nfit);
    if (any) flist[slot] = i;
    listed[i] = any != 0;
  }
  __syncthreads();
  // The others' zero fit: the tile's rows are contiguous.
  const int n_px = min(TILE, P - p0);
  float* co = coefs + ((size_t)c * P + p0) * B * K;
  float* ro = rmse + ((size_t)c * P + p0) * B;
  for (int k = tid; k < n_px * B * K; k += THREADS)
    if (!listed[k / (B * K)]) co[k] = 0.f;
  for (int k = tid; k < n_px * B; k += THREADS)
    if (!listed[k / B]) ro[k] = 0.f;

  // 2. Fit: group g fits listed pixel g.
  const int g = tid / Q, l = tid % Q;
  const bool fits = g < *nfit;
  const int fi = fits ? flist[g] : 0;
  const size_t fcp = (size_t)c * P + p0 + fi;
  bool m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = fits && mask[fcp * K + k] != 0;
  dense_fit<B>(fits, l, mW + fi, W, Yc + p0 + fi, TP, P, Xs,
               Gs + g * GSTRIDE, m, with_rmse != 0, coefs + fcp * B * K,
               rmse + fcp * B);
}

}  // namespace

// Yt [C,nb,T,P] int16, w [C,T,P] f32 0/1, X [C,T,8] f32, mask [C,P,8] bool
// -> coefs [C,P,nb,8] f32, rmse [C,P,nb] f32 (zeros when !with_rmse); nb
// one of fb::with_nb's band counts.
extern "C" int fb_lasso_fit(const void* Yt, const void* w, const void* X,
                            const void* mask, void* coefs, void* rmse, int C,
                            int nb, int T, int P, int with_rmse,
                            void* stream) {
  const size_t smem = smem_words(T) * 4;
  return fb::with_nb(nb, [&](auto nbc) {
    constexpr int B = decltype(nbc)::value;
    cudaError_t e = cudaFuncSetAttribute(
        lasso_fit_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((P + TILE - 1) / TILE, C);
    lasso_fit_kernel<B><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int16_t*)Yt, (const float*)w, (const float*)X,
        (const uint8_t*)mask, (float*)coefs, (float*)rmse, T, P, with_rmse);
    return (int)cudaGetLastError();
  });
}
