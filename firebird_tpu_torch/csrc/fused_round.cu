// fused_round: the whole post-INIT round of the event loop — monitor chain,
// segment close and shared Lasso refit — for a tile of pixels, in one
// launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::fused_round
// (_fused_round_block, with _mon_scored_logic, _close_logic and
// _gram_cd_core), scheduled for this card:
//
//   0. The block stages its chip's design X [T,8] and days t [T] in shared
//      memory (dynamic, sized from T; fused_round_smem_bytes).
//   1-5. The tile round (fb::tile_round, tile_round.cuh, which detect_mega
//      runs too): the alive, included and w_stab byte columns become 32-step
//      words as every eligible monitoring observation is scored once into
//      two bits (word_monitor.cuh, TILE_Q threads a pixel); passes 1-3 by one
//      thread a pixel with popcounts; the include / remove partition a word
//      at a time, every thread writing its words' rows of included_mon and
//      alive_mon; the close of a tail or a break by the event thread; the
//      fitting pixels (init-ok or refit) listed with a warp ballot and
//      fitted densely, TILE_Q lanes a pixel (fb::dense_fit, the code of
//      lasso_fit): the coefficients and RMSE are lasso_fit's, bit for
//      bit.
//
// With ``active`` (pallas_ops._fused_round_block's skip guard, the
// compacted loop's in_mon | init_ok), a tile with no active pixel passes
// through (fb::tile_active): its segment counts, model, included and alive
// planes copied, its events zero, the buffers untouched, nothing staged.
// The detection bands are the sensor's (fb::Roles); NB bands a pixel.
// Bound: bytes (the monitoring pixels' detection bands at the observations
// scored, the fitting pixels' windows, the planes in and out); the CD loop's
// serial chain (50 sweeps x 8 coordinates a band) bounds a block's latency.
#include "tile_round.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int MIN_BLOCKS = 3;         // 24 warps an SM (80 registers)

// Dynamic shared memory of a block for T time steps, in 4-byte words:
// X and t, then the tile round's (the Grams, the five masks, the per-pixel
// ints and the fit count).  cuda_ops.fused_round_smem_bytes computes the
// same.
size_t smem_words(int T) {
  return (size_t)9 * T + fb::tile_round_words((T + 31) / 32);
}

template <int B>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_round_kernel(
    const int16_t* __restrict__ Yt, const float* __restrict__ X,
    const float* __restrict__ tt, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ included, const int* __restrict__ cur_k,
    const int* __restrict__ nlast, const uint8_t* __restrict__ in_mon,
    const float* __restrict__ coefs, const float* __restrict__ rmse,
    const float* __restrict__ vario, const uint8_t* __restrict__ init_ok,
    const uint8_t* __restrict__ w_stab, const int* __restrict__ n_ok,
    const uint8_t* __restrict__ first_seg, const int* __restrict__ nseg,
    fb::SegBufs bufs, int* __restrict__ nseg_out,
    float* __restrict__ coefs_out, float* __restrict__ rmse_out,
    int* __restrict__ ev, uint8_t* __restrict__ incm_out,
    uint8_t* __restrict__ alm_out, const uint8_t* __restrict__ active,
    fb::Roles roles, int C, int T, int P, float change_thr,
    float outlier_thr) {
  using namespace fb;
  constexpr int ND = NDET;
  extern __shared__ __align__(16) float smem[];
  const int W = (T + 31) / 32;
  float* Xs = smem;
  float* ts = Xs + T * K;
  const TileMem m = carve_tile(Xs, ts, ts + T, W);

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t TP = (size_t)T * P;
  const int16_t* Yc = Yt + (size_t)c * B * TP;
  const int p0 = blockIdx.x * TILE;
  const int n_px = min(TILE, P - p0);
  const size_t row0 = (size_t)c * P + p0;

  // The guard: a tile with no active pixel passes through.
  if (!tile_active(active, row0, n_px)) {
    if (tid < n_px) {
      nseg_out[row0 + tid] = nseg[row0 + tid];
      for (int k = 0; k < 6; ++k) ev[k * (size_t)C * P + row0 + tid] = 0;
    }
    for (int k = tid; k < n_px * B * K; k += THREADS)
      coefs_out[row0 * B * K + k] = coefs[row0 * B * K + k];
    for (int k = tid; k < n_px * B; k += THREADS)
      rmse_out[row0 * B + k] = rmse[row0 * B + k];
    fill_plane(incm_out + c * TP, included + c * TP, T, P, p0, n_px);
    fill_plane(alm_out + c * TP, alive + c * TP, T, P, p0, n_px);
    return;
  }

  // 0. Stage the design and the days.
  stage(Xs, X + (size_t)c * T * K, T * K);
  stage(ts, tt + (size_t)c * T, T);
  __syncthreads();

  // Thread (q, i): pixel i, words q, q + TILE_Q, ...
  TilePixel px;
  px.i = tid % TILE;
  px.q = tid / TILE;
  px.p = p0 + px.i;
  px.valid = px.p < P;
  px.cp = (size_t)c * P + (px.valid ? px.p : 0);
  px.cp0 = row0;
  px.mon = px.valid && in_mon[px.cp] != 0;
  px.ck = px.valid ? cur_k[px.cp] : 0;
  const size_t cp = px.cp;
  const int p = px.p;
  const bool iok = px.valid && init_ok[cp] != 0;

  tile_round<B>(
      m, px, Yc, T, P, coefs, rmse, vario, coefs_out, rmse_out, roles, bufs,
      change_thr, outlier_thr,
      [&] {
        return TileState{nlast[cp], iok, iok ? n_ok[cp] : 0,
                         first_seg[cp] != 0, nseg[cp]};
      },
      // w_stab's words only where the pixel's INIT block fitted (else 0).
      [&](const float (&coef)[ND][K], const float (&dden)[ND]) {
        score_words<ND>(px.q, px.valid, px.mon, px.ck, alive + c * TP + p,
                        included + c * TP + p,
                        iok ? w_stab + c * TP + p : nullptr, Yc + p,
                        roles.det, TP, T, P, Xs, coef, dden, change_thr,
                        outlier_thr, m.mA + px.i, m.mO + px.i, m.mE + px.i,
                        m.mI + px.i, m.mS + px.i);
      },
      [&](int w, uint32_t incm, uint32_t alm) {
        if (px.valid) {
          write_word(incm_out + c * TP + p, P, w, T, incm);
          write_word(alm_out + c * TP + p, P, w, T, alm);
        }
      },
      [&](const MonitorEvent& e, bool close, bool do_fit, int n_full) {
        nseg_out[cp] = nseg[cp] + close;
        const size_t CP = (size_t)C * P;
        ev[0 * CP + cp] = e.is_tail;
        ev[1 * CP + cp] = e.is_brk;
        ev[2 * CP + cp] = e.is_refit;
        ev[3 * CP + cp] = e.pos_ev;
        ev[4 * CP + cp] = do_fit;
        ev[5 * CP + cp] = n_full;
        if (!do_fit) {
          for (int k = 0; k < B * K; ++k)
            coefs_out[cp * B * K + k] = coefs[cp * B * K + k];
          for (int b = 0; b < B; ++b) rmse_out[cp * B + b] = rmse[cp * B + b];
        }
      });
}

template <int B>
int launch(const void* const* a, void* const* o, const fb::SegBufs& bufs,
           const void* active, const fb::Roles& roles, int C, int T, int P,
           float change_thr, float outlier_thr, cudaStream_t stream) {
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fused_round_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  fused_round_kernel<B><<<grid, THREADS, smem, stream>>>(
      (const int16_t*)a[0], (const float*)a[1], (const float*)a[2],
      (const uint8_t*)a[3], (const uint8_t*)a[4], (const int*)a[5],
      (const int*)a[6], (const uint8_t*)a[7], (const float*)a[8],
      (const float*)a[9], (const float*)a[10], (const uint8_t*)a[11],
      (const uint8_t*)a[12], (const int*)a[13], (const uint8_t*)a[14],
      (const int*)a[15], bufs, (int*)o[0], (float*)o[1], (float*)o[2],
      (int*)o[3], (uint8_t*)o[4], (uint8_t*)o[5], (const uint8_t*)active,
      roles, C, T, P, change_thr, outlier_thr);
  return (int)cudaGetLastError();
}

}  // namespace

// Yt [C,nb,T,P] int16, X [C,T,8], t [C,T] f32, alive/included [C,T,P] u8,
// cur_k/nlast [C,P] i32, in_mon [C,P] u8, coefs [C,P,nb,8], rmse/vario
// [C,P,nb] f32, init_ok [C,P] u8, w_stab [C,T,P] u8, n_ok [C,P] i32,
// first_seg [C,P] u8, nseg [C,P] i32; buffers meta [C,P,S,6], rmse_b/mag_b
// [C,P,S,nb], coef_b [C,P,S,nb,8] f32 (updated in place); roles the host
// array of the sensor's band roles (fb::roles_from); active [C,P] u8 or null
// -> nseg_out [C,P] i32, coefs_out [C,P,nb,8], rmse_out [C,P,nb] f32,
//    ev [6,C,P] i32 (is_tail, is_brk, is_refit, pos_ev, do_fit, n_full),
//    incm/alm [C,T,P] u8 (included_mon, alive_mon); a tile with no active
//    pixel passes nseg, the model, included and alive through with zero
//    events.  nb is one of fb::with_nb's band counts.
extern "C" int fb_fused_round(
    const void* Yt, const void* X, const void* t, const void* alive,
    const void* included, const void* cur_k, const void* nlast,
    const void* in_mon, const void* coefs, const void* rmse,
    const void* vario, const void* init_ok, const void* w_stab,
    const void* n_ok, const void* first_seg, const void* nseg, void* meta_b,
    void* rmse_b, void* mag_b, void* coef_b, void* nseg_out,
    void* coefs_out, void* rmse_out, void* ev, void* incm, void* alm,
    const void* roles_h, const void* active, int C, int nb, int T, int P,
    int S, float change_thr, float outlier_thr, void* stream) {
  const void* a[] = {Yt,     X,      t,     alive, included, cur_k,
                     nlast,  in_mon, coefs, rmse,  vario,    init_ok,
                     w_stab, n_ok,   first_seg, nseg};
  void* o[] = {nseg_out, coefs_out, rmse_out, ev, incm, alm};
  const fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                         (float*)coef_b, S};
  const fb::Roles roles = fb::roles_from(roles_h);
  return fb::with_nb(nb, [&](auto nbc) {
    return launch<decltype(nbc)::value>(a, o, bufs, active, roles, C, T, P,
                                        change_thr, outlier_thr,
                                        (cudaStream_t)stream);
  });
}

// The launch geometry of the nb-band instance at T: out[0] the dynamic
// shared memory bytes, out[1] the blocks resident on one SM, out[2]
// registers a thread, out[3] local (stack and spill) bytes a thread.
extern "C" int fb_fused_round_geometry(int nb, int T, int* out) {
  return fb::with_nb(nb, [&](auto nbc) {
    const auto kern = fused_round_kernel<decltype(nbc)::value>;
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
