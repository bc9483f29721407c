// The post-INIT round's per-pixel body — monitor chain, segment close and
// shared Lasso refit — shared by the fused_round and detect_mega kernels
// (pallas_ops._fused_round_block's per-lane work, with _mon_scored_logic,
// _close_logic and _gram_cd_core).
//
// Per pixel:
//   1. a monitoring pixel runs the event chain (fb::monitor_event, the code
//      of monitor_chain_scored) on the detection bands, its score
//      denominators max(rmse, vario) taken here; a break's magnitudes, the
//      PEEK run's median residuals (fb::peek_run_mags), are read from the
//      round-start alive column before the partition pass
//      (fb::monitor_partition) writes the round's included / alive columns.
//      Other pixels keep their columns and have no event
//      (kernel._mon_zeros);
//   2. a closing pixel appends its segment at slot nseg of the result
//      buffers, in place;
//   3. a fitting pixel (init-ok from the INIT block, or refit) gets a new
//      Lasso fit over its window (fb::fit_window, the code of lasso_fit):
//      w_stab for init-ok, the round's included column for a refit.
// A pixel's result depends on no other pixel.
#pragma once

#include "monitor_chain.cuh"
#include "segment_close.cuh"

namespace fb {

// A round's time planes, chip base pointers indexed t*P + p: the
// round-start alive and included planes, the included_mon / alive_mon
// planes the round writes (the same planes as al / inc when the caller
// updates its state in place) and the INIT block's w_stab.
struct RoundPlanes {
  const uint8_t* al;
  const uint8_t* inc;
  uint8_t* incm;
  uint8_t* alm;
  const uint8_t* w_stab;
};

// Writes the round's included / alive columns from the monitor's
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

// One pixel's round state in: the monitor's cursor and last fit count, the
// INIT block's handoff, the segment count and the current model (coef_row
// [NBAND*K], rmse_row [NBAND]; vrow [NBAND] the variogram).
struct RoundIn {
  bool in_mon;
  int cur_k, nlast;
  bool init_ok;
  int n_ok;
  bool first_seg;
  int nseg;
  const float* coef_row;
  const float* rmse_row;
  const float* vrow;
};

struct RoundOut {
  MonitorEvent e;
  bool close, do_fit;
  int n_full;
};

// One pixel's post-INIT round.  Yc is the chip's spectra [NBAND, T, P],
// Xc its design [T, K], tc its days [T]; cp = c*P + p addresses the
// result buffers.  The new model goes to co [NBAND*K] / ro [NBAND] (which
// may be the input rows: the close reads them before the fit writes).
__device__ inline RoundOut round_pixel(const int16_t* Yc, const float* Xc,
                                       const float* tc, const RoundPlanes& pl,
                                       int T, int P, int p, size_t cp,
                                       const RoundIn& in, const SegBufs& bufs,
                                       float* co, float* ro, float change_thr,
                                       float outlier_thr) {
  // 1. MONITOR.
  MonitorEvent e{};
  float mags[NBAND];
  if (in.in_mon) {
    Scorer<NDET> score;
    score.Y = Yc + (size_t)T * P;       // band 1, the first detection band
    score.X = Xc;
    score.T = T;
    score.P = P;
    score.p = p;
#pragma unroll
    for (int d = 0; d < NDET; ++d) {
      score.dden[d] = pmax(in.rmse_row[d + 1], in.vrow[d + 1]);
#pragma unroll
      for (int k = 0; k < K; ++k)
        score.coef[d][k] = in.coef_row[(d + 1) * K + k];
    }
    e = monitor_event(score, pl.al, pl.inc, T, P, p, in.cur_k, in.nlast, true,
                      change_thr, outlier_thr);
    if (e.is_brk)
      peek_run_mags<NBAND>(Yc, Xc, pl.al, in.coef_row, T, P, p, e.ev_rank,
                           e.m, mags);
    RoundPlanesSink sink{pl.al, pl.inc, pl.incm, pl.alm, P, p};
    e.n_exceed = monitor_partition(score, pl.al, T, P, p, e, change_thr,
                                   outlier_thr, sink);
  } else if (pl.incm != pl.inc) {
    for (int t = 0; t < T; ++t) {
      const size_t i = (size_t)t * P + p;
      pl.incm[i] = pl.inc[i];
      pl.alm[i] = pl.al[i];
    }
  }

  // 2. CLOSE.
  RoundOut o;
  o.e = e;
  o.close = e.is_tail || e.is_brk;
  if (o.close)
    close_segment<NBAND>(pl.incm, tc, T, P, p, cp, e.is_brk, e.pos_ev,
                         e.n_exceed, in.first_seg, in.nseg, in.rmse_row,
                         e.is_brk ? mags : nullptr, in.coef_row, bufs);

  // 3. Shared refit.
  o.do_fit = in.init_ok || e.is_refit;
  o.n_full = in.init_ok ? in.n_ok : e.n_rf;
  if (o.do_fit) {
    bool m[K];
    coef_mask(o.n_full, m);
    fit_window<NBAND>(Yc, Xc, RoundWeight{pl.w_stab, pl.incm, in.init_ok, P, p},
                      T, P, p, m, co, ro, true);
  } else if (co != in.coef_row) {
    for (int i = 0; i < NBAND * K; ++i) co[i] = in.coef_row[i];
    for (int b = 0; b < NBAND; ++b) ro[b] = in.rmse_row[b];
  }
  return o;
}

}  // namespace fb
