// The MONITOR round's per-pixel event chain, one thread a pixel, as the
// monitor_chain kernel runs it on a precomputed score plane; the tile
// kernels (monitor_chain_scored, fused_round, detect_mega) run the same
// passes on bit words (word_monitor.cuh) from the same scores
// (score_obs).
//
// Per pixel: the score of every alive observation (a Score functor, here
// a precomputed plane, PlaneScore); the break search (a run of >= PEEK exceedances in the
// alive sequence, found by a backward scan that carries the next
// non-exceeding rank, as the reverse cummin does); the refit search
// (absorbed count crossing REFIT_FACTOR x the last fit's count, by a running
// sum); the tail/break/refit choice (monitor_event); and the include/remove
// partition of the observations before the event (monitor_partition) — the
// contract of pallas_ops._monitor_logic.
//
// The score is recomputed in each of three scans rather than staged: T
// floats a thread would not fit in registers.  (The tile kernels score each
// observation once and keep two bits of it: word_monitor.cuh.)
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

// A precomputed [T, P] score plane read at pixel p (chip base pointer).
struct PlaneScore {
  const float* s;
  int P, p;
  __device__ float operator()(int t) const { return s[(size_t)t * P + p]; }
};

// kernel._monitor_chain's per-pixel outputs, and the cursor rank kq and
// tail rank q_tail that the partition pass needs.
struct MonitorEvent {
  int m, is_tail, is_brk, is_refit, ev_rank, pos_ev, n_exceed, n_rf;
  int kq, q_tail;
};

// Passes 1-3 and the event choice of one pixel.  al / inc are the chip's
// alive / included planes [T, P]; ck the cursor, nl the last fit's count,
// mon whether the pixel monitors.  n_exceed is left 0 (monitor_partition
// counts it).
template <class Score>
__device__ MonitorEvent monitor_event(const Score& score, const uint8_t* al,
                                      const uint8_t* inc, int T, int P, int p,
                                      int ck, int nl, bool mon,
                                      float change_thr, float outlier_thr) {
  const int INF = T + 1;
  const float refit_thr = REFIT_FACTOR * (float)nl;

  // Pass 1: alive count m, cursor rank kq, included count n0.
  int m = 0, kq = 0, n0 = 0;
  for (int t = 0; t < T; ++t) {
    const bool a = al[(size_t)t * P + p] != 0;
    m += a;
    kq += (a && t < ck);
    n0 += inc[(size_t)t * P + p] != 0;
  }

  // Pass 2 (forward): refit crossing.  n_inc[t] = n0 + #absorbed <= t.
  int ninc = n0, ninc0 = n0, total_absq = 0;
  bool has_refit = false;
  int f_abs = 0, f_rank = 0, ninc_f = 0;
  int rank = -1;
  for (int t = 0; t < T; ++t) {
    if (al[(size_t)t * P + p] != 0) {
      ++rank;
      const float s = score(t);
      const bool absq = rank >= kq && !(s > outlier_thr);
      if (absq) {
        ++ninc;
        ++total_absq;
        if (!has_refit && (float)ninc >= refit_thr) {
          has_refit = true;
          f_abs = t;
          f_rank = rank;
          ninc_f = ninc;
        }
      }
    }
    if (t == 0) ninc0 = ninc;
  }

  // Pass 3 (backward): the first confirmed break.  nrr carries the rank of
  // the next alive non-exceeding observation (the reverse cummin).
  bool has_brk = false;
  int b_abs = 0, b_rank = 0, ninc_b = 0;
  int nrr = INF, after = 0, absq_after = 0;
  for (int t = T - 1; t >= 0; --t) {
    if (al[(size_t)t * P + p] == 0) continue;
    const int r = m - 1 - after;
    const float s = score(t);
    const bool ex = s > change_thr;
    if (!ex) nrr = min(nrr, r);
    const int runlen = min(nrr, m) - r;
    const bool elig = r >= kq;
    if (elig && ex && runlen >= PEEK) {
      has_brk = true;
      b_abs = t;
      b_rank = r;
      ninc_b = n0 + total_absq - absq_after;
    }
    absq_after += (elig && !(s > outlier_thr));
    ++after;
  }

  // The event choice (kernel._monitor_chain).
  MonitorEvent e;
  const int q_tail = max(m - (PEEK - 1), kq);
  const int b_ev = has_brk ? b_rank : INF;
  const int f_ev = has_refit ? f_rank : INF;
  const bool is_tail = mon && q_tail <= min(b_ev, f_ev);
  const bool is_brk = mon && !is_tail && has_brk && b_ev <= f_ev;
  const bool is_refit = mon && !is_tail && !is_brk && has_refit;
  e.m = m;
  e.is_tail = is_tail;
  e.is_brk = is_brk;
  e.is_refit = is_refit;
  e.ev_rank = is_tail ? q_tail : (is_brk ? b_ev : f_ev);
  e.pos_ev = is_brk ? b_abs : f_abs;
  // n_inc at pos_ev: f_abs defaults to 0 when no refit crossing exists.
  e.n_rf = is_brk ? ninc_b : (has_refit ? ninc_f : ninc0);
  e.n_exceed = 0;
  e.kq = kq;
  e.q_tail = q_tail;
  return e;
}

// Pass 4 (forward): the include/remove partition of one pixel's event.
// sink(t, in_q, rm_q) receives the partition of every time step, in
// order, after the step's alive flag was read (so a sink may update the
// alive and included planes in place).  Returns n_exceed.
template <class Score, class Sink>
__device__ int monitor_partition(const Score& score, const uint8_t* al,
                                 int T, int P, int p, const MonitorEvent& e,
                                 float change_thr, float outlier_thr,
                                 Sink& sink) {
  const int normal_hi = e.is_refit ? e.ev_rank + 1 : e.ev_rank;
  int n_exceed = 0;
  int rank = -1;
  for (int t = 0; t < T; ++t) {
    bool in_q = false, rm_q = false;
    if (al[(size_t)t * P + p] != 0) {
      ++rank;
      if (rank >= e.kq) {
        const float s = score(t);
        const bool o = s > outlier_thr;
        const bool normalq = rank < normal_hi;
        in_q = normalq && !o;
        rm_q = normalq && o;
        if (e.is_tail && rank >= e.q_tail) {
          const bool tail_ex = s > change_thr;
          in_q = in_q || !tail_ex;
          rm_q = rm_q || tail_ex;
          n_exceed += tail_ex;
        }
      }
    }
    sink(t, in_q, rm_q);
  }
  return n_exceed;
}

// One pixel's whole event chain: monitor_event, then monitor_partition.
template <class Score, class Sink>
__device__ MonitorEvent monitor_chain(const Score& score, const uint8_t* al,
                                      const uint8_t* inc, int T, int P, int p,
                                      int ck, int nl, bool mon,
                                      float change_thr, float outlier_thr,
                                      Sink& sink) {
  MonitorEvent e = monitor_event(score, al, inc, T, P, p, ck, nl, mon,
                                 change_thr, outlier_thr);
  e.n_exceed = monitor_partition(score, al, T, P, p, e, change_thr,
                                 outlier_thr, sink);
  return e;
}

}  // namespace fb
