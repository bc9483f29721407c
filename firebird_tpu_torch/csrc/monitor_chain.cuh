// The MONITOR round's shared pieces: the chi-square score of one
// observation (score_obs), which every kernel that scores calls, and the
// per-pixel event (MonitorEvent).  The kernels run the event chain of
// pallas_ops._monitor_logic on 32-step bit words (word_monitor.cuh): the
// break search (a run of >= PEEK exceedances in the alive sequence), the
// refit search (the absorbed count crossing REFIT_FACTOR x the last fit's
// count), the tail/break/refit choice and the include/remove partition of
// the observations before the event.
#pragma once

#include "ccd_common.cuh"

namespace fb {

constexpr float REFIT_FACTOR = 1.33f;

// The chi-square score of one observation: design row x, the detection
// bands' model coef and score denominators dden; y(b) the observation of
// band b.  Every kernel that scores an observation calls this (the
// decisions of every route rest on the same floats).
template <int NB, class Obs>
__device__ __forceinline__ float score_obs(const float x[K],
                                           const float coef[NB][K],
                                           const float dden[NB],
                                           const Obs& y) {
  float s = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float pred = x[0] * coef[b][0];
#pragma unroll
    for (int k = 1; k < K; ++k) pred = pred + x[k] * coef[b][k];
    const float r = ((float)y(b) - pred) / dden[b];
    s = (b == 0) ? r * r : s + r * r;
  }
  return s;
}

// kernel._monitor_chain's per-pixel outputs, and the cursor rank kq and
// tail rank q_tail that the partition pass needs.
struct MonitorEvent {
  int m, is_tail, is_brk, is_refit, ev_rank, pos_ev, n_exceed, n_rf;
  int kq, q_tail;
};

}  // namespace fb
