// fused_fit_close: one round's segment close and shared Lasso refit, a
// tile of pixels a block, in one launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::fused_fit_close
// (_fused_fit_close_block).  Per pixel:
//   1. a closing pixel (tail or break) appends its segment — meta row,
//      the closing model's rmse and coefficients, the break magnitudes that
//      arrive precomputed (kernel._close_mags, the same program as the
//      unfused route) — at slot nseg of the result buffers, in place;
//   2. a fitting pixel (init-ok or refit) gets a new Lasso fit over its
//      window; the others keep their model.
// Because the fit runs lasso_fit's instructions (fb::dense_fit) and every
// close value is a select, an integer or a carried input, the route's
// results are byte-identical to the per-component route's.
//
// Bound: bytes (the fitting pixels' window spectra and f32 weight columns,
// the closing pixels' included columns, the model in and out); the CD
// loop's serial chain (50 sweeps x 8 coordinates a band) bounds a block's
// latency.  The design, lasso_fit's and fused_round's (tile.cuh's layout):
//   0. The block stages its chip's design X [T,8] and days t [T] in shared
//      memory, and turns its fitting pixels' weight columns (0/1) and its
//      closing pixels' included columns into 32-step words, TILE_Q threads
//      a pixel; the other pixels' columns are not read.
//   1. The event thread of a closing pixel appends its segment
//      (fb::close_write, from the included words); warp 0 lists the
//      fitting pixels by ballot; the pixels that do not fit copy their
//      model, the tile's rows at once.
//   2. The listed pixels are fitted densely, TILE_Q lanes a pixel
//      (fb::dense_fit).
// A tile with no closing and no fitting pixel writes only its segment
// counts and the copied model (pallas_ops._fused_fit_close_block's skip).
// With ``active`` (that skip's guard, the compacted loop's do_fit | close),
// a tile with no active pixel writes just that and stages nothing
// (fb::tile_active): the buffers are not touched.
#include "dense_fit.cuh"
#include "segment_close.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int Q = fb::TILE_Q;
constexpr int MIN_BLOCKS = 4;         // 32 warps an SM (64 registers)

// Dynamic shared memory of a block for T time steps, in 4-byte words: X
// and t, the Grams, the weight and included words, the fit list, the
// fitting flags, the fit counts and the listed count (padded to 4).
// cuda_ops.fused_fit_close_smem_bytes computes the same.
size_t smem_words(int T) {
  const int W = (T + 31) / 32;
  return (size_t)9 * T + TILE * fb::GSTRIDE + (size_t)2 * W * TILE +
         3 * TILE + 4;
}

template <int B>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_fit_close_kernel(
    const int16_t* __restrict__ Yt, const float* __restrict__ X,
    const float* __restrict__ tt, const float* __restrict__ w,
    const uint8_t* __restrict__ do_fit, const int* __restrict__ n_full,
    const uint8_t* __restrict__ incm, const float* __restrict__ coefs,
    const float* __restrict__ rmse, const float* __restrict__ mags,
    const uint8_t* __restrict__ is_tail, const uint8_t* __restrict__ is_brk,
    const int* __restrict__ pos_ev, const int* __restrict__ n_exceed,
    const uint8_t* __restrict__ first_seg, const int* __restrict__ nseg,
    fb::SegBufs bufs, int* __restrict__ nseg_out,
    float* __restrict__ coefs_out, float* __restrict__ rmse_out,
    const uint8_t* __restrict__ active, int T, int P) {
  using namespace fb;
  extern __shared__ __align__(16) float smem[];
  const int W = (T + 31) / 32;
  float* Xs = smem;
  float* ts = Xs + T * K;
  float* Gs = ts + T;
  uint32_t* mW = reinterpret_cast<uint32_t*>(Gs + TILE * GSTRIDE);
  uint32_t* mI = mW + W * TILE;
  int* flist = reinterpret_cast<int*>(mI + W * TILE);
  int* fitting = flist + TILE;
  int* fnfull = fitting + TILE;
  int* nfit = fnfull + TILE;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t TP = (size_t)T * P;
  const int p0 = blockIdx.x * TILE;
  const int16_t* Yc = Yt + (size_t)c * B * TP;
  const int n_px = min(TILE, P - p0);
  const size_t row0 = (size_t)c * P + p0;

  // The guard: a tile with no active pixel passes its segment counts and
  // model through (its rows are contiguous).
  if (!tile_active(active, row0, n_px)) {
    if (tid < n_px) nseg_out[row0 + tid] = nseg[row0 + tid];
    for (int k = tid; k < n_px * B * K; k += THREADS)
      coefs_out[row0 * B * K + k] = coefs[row0 * B * K + k];
    for (int k = tid; k < n_px * B; k += THREADS)
      rmse_out[row0 * B + k] = rmse[row0 * B + k];
    return;
  }

  // 0. Stage; the words, thread (q, i): pixel i, words q, q + TILE_Q, ...
  stage(Xs, X + (size_t)c * T * K, T * K);
  stage(ts, tt + (size_t)c * T, T);
  const int i = tid % TILE;
  const int p = p0 + i;
  const bool valid = p < P;
  const size_t cp = (size_t)c * P + (valid ? p : 0);
  const bool fit = valid && do_fit[cp] != 0;
  const bool brk = valid && is_brk[cp] != 0;
  const bool close = brk || (valid && is_tail[cp] != 0);
  for (int v = tid / TILE; v < W; v += Q) {
    mW[v * TILE + i] = fit ? column_word(w + c * TP + p, P, v, T) : 0u;
    mI[v * TILE + i] = close ? column_word(incm + c * TP + p, P, v, T) : 0u;
  }
  __syncthreads();

  // 1. Close, segment counts, the fit list.
  if (tid < TILE) {
    if (valid) {
      const int ns = nseg[cp];
      if (close) {
        int first = -1, last = T - 1, n_obs = 0;
        for (int v = 0; v < W; ++v) {
          const uint32_t b = mI[v * TILE + i];
          if (!b) continue;
          if (first < 0) first = 32 * v + __ffs(b) - 1;
          last = 32 * v + 31 - __clz(b);
          n_obs += __popc(b);
        }
        if (first < 0) first = 0;
        close_write<B>(ts, first, last, n_obs, cp, brk, pos_ev[cp],
                       n_exceed[cp], first_seg[cp] != 0, ns, rmse + cp * B,
                       brk ? mags + cp * B : nullptr, coefs + cp * B * K,
                       bufs);
      }
      nseg_out[cp] = ns + close;
    }
    const int slot = list_pixels(fit, i, nfit);
    if (fit) {
      flist[slot] = i;
      fnfull[slot] = n_full[cp];
    }
    fitting[i] = fit;
  }
  __syncthreads();
  // The model of the pixels that do not fit.
  for (int k = tid; k < n_px * B * K; k += THREADS)
    if (!fitting[k / (B * K)])
      coefs_out[row0 * B * K + k] = coefs[row0 * B * K + k];
  for (int k = tid; k < n_px * B; k += THREADS)
    if (!fitting[k / B]) rmse_out[row0 * B + k] = rmse[row0 * B + k];

  // 2. Fit: group g fits listed pixel g over its weight words.
  const int g = tid / Q, l = tid % Q;
  const bool fits = g < *nfit;
  const int fi = fits ? flist[g] : 0;
  const size_t fcp = row0 + fi;
  bool m[K];
  coef_mask(fits ? fnfull[g] : 0, m);
  dense_fit<B>(fits, l, mW + fi, W, Yc + p0 + fi, TP, P, Xs,
               Gs + g * GSTRIDE, m, true, coefs_out + fcp * B * K,
               rmse_out + fcp * B);
}

template <int B>
int launch(const void* const* a, const fb::SegBufs& bufs, void* nseg_out,
           void* coefs_out, void* rmse_out, const void* active, int C, int T,
           int P, cudaStream_t stream) {
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fused_fit_close_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  fused_fit_close_kernel<B><<<grid, THREADS, smem, stream>>>(
      (const int16_t*)a[0], (const float*)a[1], (const float*)a[2],
      (const float*)a[3], (const uint8_t*)a[4], (const int*)a[5],
      (const uint8_t*)a[6], (const float*)a[7], (const float*)a[8],
      (const float*)a[9], (const uint8_t*)a[10], (const uint8_t*)a[11],
      (const int*)a[12], (const int*)a[13], (const uint8_t*)a[14],
      (const int*)a[15], bufs, (int*)nseg_out, (float*)coefs_out,
      (float*)rmse_out, (const uint8_t*)active, T, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Yt [C,nb,T,P] int16, X [C,T,8], t [C,T], w [C,T,P] f32 0/1, do_fit
// [C,P] u8, n_full [C,P] i32, incm [C,T,P] u8, coefs [C,P,nb,8],
// rmse/mags [C,P,nb] f32, is_tail/is_brk [C,P] u8, pos_ev/n_exceed [C,P]
// i32, first_seg [C,P] u8, nseg [C,P] i32; buffers meta [C,P,S,6],
// rmse_b/mag_b [C,P,S,nb], coef_b [C,P,S,nb,8] f32 (updated in place)
// active [C,P] u8 or null
// -> nseg_out [C,P] i32, coefs_out [C,P,nb,8], rmse_out [C,P,nb] f32 (on a
// tile with no active pixel nseg, coefs and rmse, the buffers untouched);
// nb one of fb::with_nb's band counts.
extern "C" int fb_fused_fit_close(
    const void* Yt, const void* X, const void* t, const void* w,
    const void* do_fit, const void* n_full, const void* incm,
    const void* coefs, const void* rmse, const void* mags,
    const void* is_tail, const void* is_brk, const void* pos_ev,
    const void* n_exceed, const void* first_seg, const void* nseg,
    void* meta_b, void* rmse_b, void* mag_b, void* coef_b, void* nseg_out,
    void* coefs_out, void* rmse_out, const void* active, int C, int nb,
    int T, int P, int S, void* stream) {
  const void* a[] = {Yt,   X,      t,       w,      do_fit,   n_full,
                     incm, coefs,  rmse,    mags,   is_tail,  is_brk,
                     pos_ev, n_exceed, first_seg, nseg};
  const fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                         (float*)coef_b, S};
  return fb::with_nb(nb, [&](auto nbc) {
    return launch<decltype(nbc)::value>(a, bufs, nseg_out, coefs_out,
                                        rmse_out, active, C, T, P,
                                        (cudaStream_t)stream);
  });
}

// The launch geometry of the nb-band instance at T: out[0] the dynamic
// shared memory bytes, out[1] the blocks resident on one SM, out[2]
// registers a thread, out[3] local (stack and spill) bytes a thread.
extern "C" int fb_fused_fit_close_geometry(int nb, int T, int* out) {
  return fb::with_nb(nb, [&](auto nbc) {
    const auto kern = fused_fit_close_kernel<decltype(nbc)::value>;
    const size_t smem = smem_words(T) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kern, THREADS,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    out[0] = (int)smem;
    out[2] = fa.numRegs;
    out[3] = (int)fa.localSizeBytes;
    return (int)e;
  });
}
