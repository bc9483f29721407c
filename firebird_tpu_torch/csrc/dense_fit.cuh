// The dense fit of a tile's listed pixels, shared by the lasso_fit,
// fused_fit_close, fused_round and detect_mega kernels (tile.cuh's block
// layout).
//
// Group g (TILE_Q lanes) fits listed pixel g: the weighted Gram and the
// correlations of a one-thread fit (fb::Gram, one observation at a time in
// time order), split over the lanes by sum and never by time.  Lane l owns Gram row l and the correlations of bands l, l + TILE_Q,
// ... below NB (7 bands: lane l < 7 band l; 12 bands: lanes 0-3 bands l and
// l + 8, lanes 4-7 band l), each sum taken over the window's set bits in
// time order with Gram::add's operations at weight 1 (a product with the
// weight 1 is exact, so it is left out).  Then each lane runs
// its bands' coordinate descent (fb::cd_loop on the Gram in shared memory)
// and their RMSE pass.  The coefficients and RMSE are those of the
// one-thread fit over a 0/1 window, bit for bit, and every kernel that fits
// runs this code: a pixel's result is the same on every route that fits
// it.
//
// Each lane reads its bands' int16 values at its pixel's window steps
// straight from device memory, FIT_BATCH steps in flight at once.  The
// fitted bands are the spectra's first NB (AllBands) unless the caller maps
// them (init_window fits a sensor's detection bands: InitBands).  (A
// version staging each 32-step word of the whole tile in shared memory,
// loads coalesced, ran slower on an H100: its barriers serialise load and
// compute, and at 80 registers its staging spills.)
//
// A kernel's mixed-precision instance (FB_MIXED, cuda_ops.MIXED_SOURCES)
// takes the Gram and correlations from the tensor cores instead
// (mixed_gram.cuh): each warp sums its four groups' pixels at once, then
// hands every lane its bands' correlations and writes each Gram to its
// group's G.  The coordinate descent and the RMSE pass are the same code.
#pragma once

#include "tile.cuh"
#if FB_MIXED
#include "mixed_gram.cuh"
#endif

namespace fb {

constexpr int GSTRIDE = K * K + 1;    // a pixel's Gram in shared memory

// The set bits of a pixel's window mask (W words, stride TILE) in time
// order, FIT_BATCH at a time (the caller loads a batch's values together,
// so their loads are in flight at once; the sums still run in order).
constexpr int FIT_BATCH = 4;

struct BitWalk {
  const uint32_t* m;
  int W;
  int w = -1;
  uint32_t r = 0;

  __device__ bool done() {
    while (r == 0 && w + 1 < W) r = m[++w * TILE];
    return r == 0;
  }
  // The next FIT_BATCH steps, -1 past the last.
  __device__ void take(int* tq) {
#pragma unroll
    for (int u = 0; u < FIT_BATCH; ++u) {
      if (done()) {
        tq[u] = -1;
      } else {
        tq[u] = 32 * w + __ffs(r) - 1;
        r &= r - 1u;
      }
    }
  }
};

// The spectra band of fit band b: b itself.
struct AllBands {
  __device__ int operator()(int b) const { return b; }
};

// The values of lane l's bands (l + TILE_Q * s below NB) at a batch of
// time steps tq (0 past the last step or the last band); Yp is the chip's
// spectra at the pixel, band stride TP, fit band b its spectra band
// bands(b).
template <int NB, int NBL, class Bands>
__device__ __forceinline__ void load_batch(const int* tq, int l,
                                           const int16_t* Yp, size_t TP,
                                           int P, const Bands& bands,
                                           float yq[][NBL]) {
#pragma unroll
  for (int u = 0; u < FIT_BATCH; ++u)
#pragma unroll
    for (int s = 0; s < NBL; ++s) {
      const int b = l + TILE_Q * s;
      yq[u][s] = (b < NB && tq[u] >= 0)
                     ? (float)Yp[(size_t)bands(b) * TP + (size_t)tq[u] * P]
                     : 0.f;
    }
}

// Called by every thread of the block (it synchronises once).  ``fits``:
// this thread's group has a listed pixel; win its window words (W of them,
// stride TILE), Yp the chip's spectra [NB, T, P] at the pixel (band stride
// TP), Xs the chip's design [T, K] in shared memory, G the group's Gram
// (GSTRIDE floats of shared memory), mask the allowed coefficients (read
// by lanes with a band), coef [NB*K] and rmse [NB] the pixel's output rows
// (rmse zeros when !with_rmse), bands the spectra band of each fit band.
// win, Yp and Xs start at step 32 w0 (the mixed instance's chunks of 16
// steps count from step 0).  Each group's G lies GSTRIDE floats after the
// previous group's.
template <int NB, class Bands = AllBands>
__device__ void dense_fit(bool fits, int l, const uint32_t* win, int W,
                          const int16_t* Yp, size_t TP, int P,
                          const float* Xs, float* G, const bool mask[K],
                          bool with_rmse, float* coef, float* rmse,
                          const Bands& bands = Bands(), int w0 = 0) {
  constexpr int NBL = (NB + TILE_Q - 1) / TILE_Q;   // band slots a lane
  float nw = 0.f;
  float cb[NBL][K];
#if FB_MIXED
  {
    // The warp's four groups: correlation rows (pixel r % 4, band r / 4),
    // 16 a pass, staged in the warp's Grams and read by the lanes of their
    // bands; then the Gram rows (pixels 0-3 of 16), two n-tiles a pass,
    // written to each group's G.
    static_assert(32 / TILE_Q == 4, "a warp holds four groups");
    const int lane = threadIdx.x & 31, gr = lane >> 2, tc = lane & 3;
    const int gw = lane / TILE_Q;
    float* Gw = G - gw * GSTRIDE;
    MixedRow mine;
    if (fits) {
      int cnt = 0;
      for (int w = 0; w < W; ++w) cnt += __popc(win[w * TILE]);
      nw = fmaxf((float)cnt, 1.f);
      mine.win = win - w0 * TILE;
      mine.y = Yp - (size_t)32 * w0 * P;
      mine.lo = 32 * w0;
      mine.hi = 32 * (w0 + W) - 1;
      mine.n = nw;
    }
    const float* Xa = Xs - (size_t)32 * w0 * K;
    if (__any_sync(MMA_WARP, fits)) {
      const MixedRow px = shfl_row(mine, TILE_Q * (gr & 3));
#pragma unroll 1
      for (int mt = 0; mt < (4 * NB + 15) / 16; ++mt) {
        MixedRow r[2] = {px, px};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = 4 * mt + 2 * h + (gr >> 2);
          if (b < NB && px.on())
            r[h].y = px.y + (size_t)bands(b) * TP;
          else
            r[h] = MixedRow{};
        }
        float acc[3][1][4] = {};
        mixed_pass<true, 1>(r[0], r[1], Xa, 0, P, acc);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Gw[(gr + 8 * (e >> 1)) * K + 2 * tc + (e & 1)] =
              corr_value(acc, e, r[e >> 1].n);
        __syncwarp();
#pragma unroll
        for (int s = 0; s < NBL; ++s) {
          const int b = l + TILE_Q * s;
          if (fits && b < NB && b / 4 == mt)
#pragma unroll
            for (int k = 0; k < K; ++k)
              cb[s][k] = Gw[(4 * (b % 4) + gw) * K + k];
        }
        __syncwarp();
      }
      const MixedRow g0 = gr < 4 ? px : MixedRow{};
#pragma unroll 1
      for (int i0 = 0; i0 < K; i0 += 2) {
        float acc[2][2][4] = {};
        mixed_pass<false, 2>(g0, MixedRow{}, Xa, i0, P, acc);
        if (g0.on())
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              Gw[gr * GSTRIDE + (i0 + u) * K + 2 * tc + e] =
                  gram_value(acc, u, e, g0.n);
      }
    }
  }
#else
  if (fits) {
    float grow[K];
#pragma unroll
    for (int k = 0; k < K; ++k) grow[k] = 0.f;
#pragma unroll
    for (int s = 0; s < NBL; ++s)
#pragma unroll
      for (int k = 0; k < K; ++k) cb[s][k] = 0.f;
    for (BitWalk it{win, W}; !it.done();) {
      int tq[FIT_BATCH];
      it.take(tq);
      float yq[FIT_BATCH][NBL];
      load_batch<NB, NBL>(tq, l, Yp, TP, P, bands, yq);
#pragma unroll
      for (int u = 0; u < FIT_BATCH; ++u) {
        if (tq[u] < 0) break;
        const int t = tq[u];
        float x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = Xs[t * K + k];
        const float xl = Xs[t * K + l];
        nw = nw + 1.f;
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j >= l) grow[j] = grow[j] + xl * x[j];
#pragma unroll
        for (int s = 0; s < NBL; ++s)
          if (l + TILE_Q * s < NB) {
#pragma unroll
            for (int k = 0; k < K; ++k) cb[s][k] = cb[s][k] + yq[u][s] * x[k];
          }
      }
    }
    // Gram::finish.
    nw = fmaxf(nw, 1.f);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j >= l) {
        const float v = grow[j] / nw;
        G[l * K + j] = v;
        G[j * K + l] = v;
      }
#pragma unroll
    for (int s = 0; s < NBL; ++s)
#pragma unroll
      for (int k = 0; k < K; ++k) cb[s][k] = cb[s][k] / nw;
  }
#endif
  __syncthreads();
  if (!fits || l >= NB) return;

  // fb::lasso_cd for each of the lane's bands, then their RMSE pass.  The Gram's 36 distinct values are held in
  // registers for the CD loop (its 400 coordinate updates a band would
  // otherwise read 8 of them from shared memory each).
  float Gr[K][K], diag[K], beta[NBL][K];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int k = j; k < K; ++k) Gr[j][k] = Gr[k][j] = G[j * K + k];
#pragma unroll
  for (int j = 0; j < K; ++j) diag[j] = pmax(Gr[j][j], 1e-12f);
#pragma unroll
  for (int s = 0; s < NBL; ++s) {
    const int b = l + TILE_Q * s;
    if (b >= NB) break;
    cd_loop<1>(Gr, &cb[s], diag, mask, &beta[s]);
#pragma unroll
    for (int k = 0; k < K; ++k) coef[b * K + k] = beta[s][k];
  }
  float acc[NBL];
#pragma unroll
  for (int s = 0; s < NBL; ++s) acc[s] = 0.f;
  if (with_rmse) {
    for (BitWalk it{win, W}; !it.done();) {
      int tq[FIT_BATCH];
      it.take(tq);
      float yq[FIT_BATCH][NBL];
      load_batch<NB, NBL>(tq, l, Yp, TP, P, bands, yq);
#pragma unroll
      for (int u = 0; u < FIT_BATCH; ++u) {
        if (tq[u] < 0) break;
        const int t = tq[u];
        float x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = Xs[t * K + k];
#pragma unroll
        for (int s = 0; s < NBL; ++s)
          if (l + TILE_Q * s < NB) {
            float pred = beta[s][0] * x[0];
#pragma unroll
            for (int k = 1; k < K; ++k) pred = pred + beta[s][k] * x[k];
            const float res = yq[u][s] - pred;
            acc[s] = acc[s] + res * res;
          }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NBL; ++s) {
    const int b = l + TILE_Q * s;
    if (b >= NB) break;
    rmse[b] = with_rmse ? sqrtf(pmax(acc[s] / nw, 0.f)) : 0.f;
  }
}

}  // namespace fb
