// tmask_bad: the Tmask IRLS outlier screen on gathered windows, per pixel.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::tmask_bad
// (_tmask_block, _tmask_core), which serves the JAX package's
// FIREBIRD_PALLAS=tmask route: there XLA gathers each initializing pixel's
// window members (their no-trend design rows, their Tmask-band values and a
// 0/1 slot validity) and the kernel runs the screen.  Per pixel:
// TMASK_IRLS_ITERS Huber reweightings of a weighted 5x5 SPD solve per band
// (unrolled Cholesky, NaN on a non-positive pivot so that nothing is
// flagged), MAD sigma from masked medians, and a flag where the final
// residual exceeds TMASK_CONST x the band's variogram — fb::tmask_screen
// (init_window.cuh), the very screen init_window and detect_mega run.
//
// Layout: the wrapper hands the window planes over with the pixel axis
// fastest (Xtw [NT, W, N], Y2 [2, W, N], w [W, N]) so a warp reads 32
// neighbouring addresses for each slot; the thread copies its two bands
// and weights into local arrays once and reads the design per use.
//
// Bound: operations.  A pixel reads (NT + 3) x W floats and writes W
// bytes, but runs 6 solves per band, each a W-slot weighted Gram (~20 flops
// a slot) and a 5x5 Cholesky, and 10 insertion-sort medians of W values.
#include "init_window.cuh"

namespace {

// One pixel's window in the pixel-fastest planes, its bands and weights
// copied to local arrays.
template <int WMAX>
struct PlaneWindow {
  const float* xt;              // [NT, W, N] at this pixel
  const float (*yv)[WMAX];      // the two Tmask bands [2][WMAX]
  const float* wv;              // the slot weights [WMAX]
  int W, N;
  __device__ float x(int s, int k) const {
    return xt[((size_t)k * W + s) * N];
  }
  __device__ float y(int q, int s) const { return yv[q][s]; }
  __device__ float w(int s) const { return wv[s]; }
};

template <int WMAX>
__global__ void __launch_bounds__(fb::BLOCK)
tmask_kernel(const float* __restrict__ xt, const float* __restrict__ y2,
             const float* __restrict__ w, const float* __restrict__ vario2,
             uint8_t* __restrict__ bad_out, int N, int W) {
  using namespace fb;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t WN = (size_t)W * N;
  float y[2][WMAX], wv[WMAX];
  for (int s = 0; s < W; ++s) {
    y[0][s] = y2[s * (size_t)N + i];
    y[1][s] = y2[WN + s * (size_t)N + i];
    wv[s] = w[s * (size_t)N + i];
  }
  const PlaneWindow<WMAX> win{xt + i, y, wv, W, N};
  const float thr[2] = {TMASK_CONST * vario2[(size_t)i * 2],
                        TMASK_CONST * vario2[(size_t)i * 2 + 1]};
  bool bad[WMAX];
  tmask_screen<WMAX>(win, W, thr, bad);
  for (int s = 0; s < W; ++s)
    bad_out[s * (size_t)N + i] = bad[s];
}

template <int WMAX>
int launch(const void* xt, const void* y2, const void* w, const void* vario2,
           void* bad, int N, int W, cudaStream_t stream) {
  tmask_kernel<WMAX><<<(N + fb::BLOCK - 1) / fb::BLOCK, fb::BLOCK, 0,
                       stream>>>((const float*)xt, (const float*)y2,
                                 (const float*)w, (const float*)vario2,
                                 (uint8_t*)bad, N, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Xtw [5,W,N], Y2 [2,W,N], w [W,N] f32 (pixel axis fastest), vario2 [N,2]
// f32 -> bad [W,N] u8.  N is the flattened chip x pixel count, w_max the
// instance (32, 64 or 128) that holds W.
extern "C" int fb_tmask_bad(const void* xt, const void* y2, const void* w,
                            const void* vario2, void* bad, int N, int W,
                            int w_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > w_max) return (int)cudaErrorInvalidValue;
  switch (w_max) {
    case 32:
      return launch<32>(xt, y2, w, vario2, bad, N, W, s);
    case 64:
      return launch<64>(xt, y2, w, vario2, bad, N, W, s);
    case 128:
      return launch<128>(xt, y2, w, vario2, bad, N, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
