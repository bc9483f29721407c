// fused_round: the whole post-INIT round of the event loop — monitor chain,
// segment close and shared Lasso refit — per pixel, in one launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::fused_round
// (_fused_round_block, with _mon_scored_logic, _close_logic and
// _gram_cd_core).  Per pixel:
//   1. a monitoring pixel runs the event chain (fb::monitor_chain, the code
//      of monitor_chain_scored) on the detection bands, its score
//      denominators max(rmse, vario) taken here; it writes the round's
//      included / alive planes.  Other pixels copy their planes and have
//      no event (kernel._mon_zeros);
//   2. a closing pixel appends its segment at slot nseg of the result
//      buffers, in place; a break's magnitudes are the PEEK run's median
//      residuals, found by one scan over T (fb::peek_run_mags);
//   3. a fitting pixel (init-ok from the INIT block, or refit) gets a new
//      Lasso fit over its window (fb::fit_window, the code of lasso_fit):
//      w_stab for init-ok, the included plane for a refit.
// A pixel's result depends on no other pixel: the Pallas kernel's per-block
// gates (any monitoring / closing / fitting lane) only skip work whose
// result the pixel discards.
//
// Bound: bytes.  The detection-band spectra are read three times by the
// monitor (the score is recomputed per scan), the fitting pixels' windows
// twice more; the alive / included planes in and the two planes out
// dominate the rest.  The buffers are touched only at the closing pixels'
// slot.
#include "monitor_chain.cuh"
#include "segment_close.cuh"

namespace {

constexpr int B = 7;
constexpr int ND = 5;     // detection bands 1..5 of the Landsat layout

// Writes the round's included / alive planes from the monitor's
// include / remove partition (a monitoring pixel's).
struct RoundPlanesSink {
  const uint8_t* al;
  const uint8_t* inc;
  uint8_t* incm;
  uint8_t* alm;
  int P, p;
  __device__ void operator()(int t, bool in_q, bool rm_q) const {
    const size_t i = (size_t)t * P + p;
    incm[i] = inc[i] != 0 || in_q;
    alm[i] = al[i] != 0 && !rm_q;
  }
};

// The refit window: w_stab for an init-ok pixel, else the round's
// included plane (the pixel refits).
struct RoundWeight {
  const uint8_t* w_stab;
  const uint8_t* incm;
  bool init_ok;
  int P, p;
  __device__ float operator()(int t) const {
    const size_t i = (size_t)t * P + p;
    return (init_ok ? w_stab[i] : incm[i]) != 0 ? 1.f : 0.f;
  }
};

__global__ void __launch_bounds__(fb::BLOCK)
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
    int* __restrict__ ev, uint8_t* incm_out, uint8_t* __restrict__ alm_out,
    int C, int T, int P, float change_thr, float outlier_thr) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const size_t TP = (size_t)T * P;
  const int16_t* Yc = Yt + (size_t)c * B * TP;
  const float* Xc = X + (size_t)c * T * K;
  const uint8_t* al = alive + c * TP;
  const uint8_t* inc = included + c * TP;
  // Written here and read back by this thread (close, refit window).
  uint8_t* incm = incm_out + c * TP;
  uint8_t* alm = alm_out + c * TP;
  const float* coef_row = coefs + cp * B * K;
  const float* rmse_row = rmse + cp * B;

  // 1. MONITOR.
  MonitorEvent e{};
  if (in_mon[cp] != 0) {
    Scorer<ND> score;
    score.Y = Yc + TP;                  // band 1, the first detection band
    score.X = Xc;
    score.T = T;
    score.P = P;
    score.p = p;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      score.dden[d] = pmax(rmse_row[d + 1], vario[cp * B + d + 1]);
#pragma unroll
      for (int k = 0; k < K; ++k) score.coef[d][k] = coef_row[(d + 1) * K + k];
    }
    RoundPlanesSink sink{al, inc, incm, alm, P, p};
    e = monitor_chain<ND>(score, al, inc, T, P, p, cur_k[cp], nlast[cp], true,
                          change_thr, outlier_thr, sink);
  } else {
    for (int t = 0; t < T; ++t) {
      const size_t i = (size_t)t * P + p;
      incm[i] = inc[i];
      alm[i] = al[i];
    }
  }

  // 2. CLOSE.
  const bool close = e.is_tail || e.is_brk;
  const int ns = nseg[cp];
  if (close) {
    float mags[B];
    if (e.is_brk)
      peek_run_mags<B>(Yc, Xc, al, coef_row, T, P, p, e.ev_rank, e.m, mags);
    close_segment<B>(incm, tt + (size_t)c * T, T, P, p, cp, e.is_brk,
                     e.pos_ev, e.n_exceed, first_seg[cp] != 0, ns, rmse_row,
                     e.is_brk ? mags : nullptr, coef_row, bufs);
  }
  nseg_out[cp] = ns + close;

  // 3. Shared refit.
  const bool iok = init_ok[cp] != 0;
  const bool do_fit = iok || e.is_refit;
  const int n_full = iok ? n_ok[cp] : e.n_rf;
  float* co = coefs_out + cp * B * K;
  float* ro = rmse_out + cp * B;
  if (do_fit) {
    bool m[K];
    coef_mask(n_full, m);
    fit_window<B>(Yc, Xc, RoundWeight{w_stab + c * TP, incm, iok, P, p}, T,
                  P, p, m, co, ro, true);
  } else {
    for (int i = 0; i < B * K; ++i) co[i] = coef_row[i];
    for (int b = 0; b < B; ++b) ro[b] = rmse_row[b];
  }

  const size_t CP = (size_t)C * P;
  ev[0 * CP + cp] = e.is_tail;
  ev[1 * CP + cp] = e.is_brk;
  ev[2 * CP + cp] = e.is_refit;
  ev[3 * CP + cp] = e.pos_ev;
  ev[4 * CP + cp] = do_fit;
  ev[5 * CP + cp] = n_full;
}

}  // namespace

// Yt [C,7,T,P] int16, X [C,T,8], t [C,T] f32, alive/included [C,T,P] u8,
// cur_k/nlast [C,P] i32, in_mon [C,P] u8, coefs [C,P,7,8], rmse/vario
// [C,P,7] f32, init_ok [C,P] u8, w_stab [C,T,P] u8, n_ok [C,P] i32,
// first_seg [C,P] u8, nseg [C,P] i32; buffers meta [C,P,S,6], rmse_b/mag_b
// [C,P,S,7], coef_b [C,P,S,7,8] f32 (updated in place)
// -> nseg_out [C,P] i32, coefs_out [C,P,7,8], rmse_out [C,P,7] f32,
//    ev [6,C,P] i32 (is_tail, is_brk, is_refit, pos_ev, do_fit, n_full),
//    incm/alm [C,T,P] u8 (included_mon, alive_mon).
extern "C" int fb_fused_round(
    const void* Yt, const void* X, const void* t, const void* alive,
    const void* included, const void* cur_k, const void* nlast,
    const void* in_mon, const void* coefs, const void* rmse,
    const void* vario, const void* init_ok, const void* w_stab,
    const void* n_ok, const void* first_seg, const void* nseg, void* meta_b,
    void* rmse_b, void* mag_b, void* coef_b, void* nseg_out,
    void* coefs_out, void* rmse_out, void* ev, void* incm, void* alm, int C,
    int nb, int T, int P, int S, float change_thr, float outlier_thr,
    void* stream) {
  if (nb != B) return (int)cudaErrorInvalidValue;
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                   (float*)coef_b, S};
  fused_round_kernel<<<grid, fb::BLOCK, 0, (cudaStream_t)stream>>>(
      (const int16_t*)Yt, (const float*)X, (const float*)t,
      (const uint8_t*)alive, (const uint8_t*)included, (const int*)cur_k,
      (const int*)nlast, (const uint8_t*)in_mon, (const float*)coefs,
      (const float*)rmse, (const float*)vario, (const uint8_t*)init_ok,
      (const uint8_t*)w_stab, (const int*)n_ok, (const uint8_t*)first_seg,
      (const int*)nseg, bufs, (int*)nseg_out, (float*)coefs_out,
      (float*)rmse_out, (int*)ev, (uint8_t*)incm, (uint8_t*)alm, C, T, P,
      change_thr, outlier_thr);
  return (int)cudaGetLastError();
}
