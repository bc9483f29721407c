// The MONITOR round on bit words, shared by the monitor_chain_scored and
// fused_round kernels (tile.cuh's block layout), and by monitor_chain on a
// score plane: the decisions of pallas_ops._monitor_logic, scheduled for a
// block:
//
//   1. score_words: TILE_Q threads a pixel, each a set of 32-step words
//      (score_alive_words where the alive column is already words).
//      Every alive observation a monitoring pixel can use (t >= cur_k) is
//      scored once (fb::score_obs) and only two bits of the score are kept:
//      s > outlier and s > change.  The alive and included columns (and an
//      optional third, w_stab) become words too, in shared memory.
//   2. word_event: one thread a pixel runs passes 1-3 on the words with
//      popcounts: the alive count and cursor rank, the first refit crossing
//      (a prefix count of absorbed observations), the first run of >= PEEK
//      exceedances in rank order (runs may cross words), the tail / break /
//      refit choice, and pass 4's rank bounds as time steps.  Integer work
//      on the same bits, so the event is the same.
//   3. partition_word: the include / remove partition of pass 4, a word at
//      a time.
//
// For an alive step, rank >= the cursor rank exactly when t >= cur_k (a
// positional mask), and a PEEK run in rank order ignores dead steps, so the
// break search walks runs of exceeding bits between non-exceeding eligible
// ones, carried across words.
#pragma once

#include "monitor_chain.cuh"
#include "tile.cuh"

namespace fb {

// Scores the steps of word w whose bits r holds (fb::score_obs, two at a
// time: ten loads in flight) and sets their bits in o (score > outlier)
// and e (score > change).  Detection band d is read at Yp + band[d] * TP
// (Yp the chip's spectra at the pixel); Xs is the design [T, K].
template <int ND>
__device__ __forceinline__ void score_bits(uint32_t r, int w,
                                           const int16_t* Yp,
                                           const int band[ND], size_t TP,
                                           int P, const float* Xs,
                                           const float coef[ND][K],
                                           const float dden[ND],
                                           float change_thr,
                                           float outlier_thr, uint32_t& o,
                                           uint32_t& e) {
  while (r) {
    int js[2];
    int16_t ys[2][ND];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      js[u] = r ? __ffs(r) - 1 : -1;
      r &= r - 1u;
      if (js[u] >= 0) {
        const int16_t* y = Yp + (size_t)(32 * w + js[u]) * P;
#pragma unroll
        for (int b = 0; b < ND; ++b) ys[u][b] = y[(size_t)band[b] * TP];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (js[u] < 0) break;
      const int t = 32 * w + js[u];
      float x[K];
#pragma unroll
      for (int k = 0; k < K; ++k) x[k] = Xs[t * K + k];
      const float sc =
          score_obs<ND>(x, coef, dden, [&](int b) { return ys[u][b]; });
      o |= (uint32_t)(sc > outlier_thr) << js[u];
      e |= (uint32_t)(sc > change_thr) << js[u];
    }
  }
}

// The words of pixel i (this thread's part q: words q, q + TILE_Q, ...)
// into shared memory, each mask's word w at [w * TILE] from the pointer
// given (already offset to the pixel): A alive, O the scores above the
// outlier threshold, E above the change threshold, I included and, where
// S is given, the words of the column ws (0 where ws is null).  ``read``: the
// columns are read (else every word is 0); ``mon``: the pixel monitors,
// and its eligible alive steps (t >= ck) are scored against coef / dden,
// detection band d read at Yp + band[d] * TP (Yp the chip's spectra at the
// pixel).  al, inc and ws are the pixel's byte columns (stride P).
template <int ND>
__device__ void score_words(int q, bool read, bool mon, int ck,
                            const uint8_t* al, const uint8_t* inc,
                            const uint8_t* ws, const int16_t* Yp,
                            const int band[ND], size_t TP, int T, int P,
                            const float* Xs, const float coef[ND][K],
                            const float dden[ND], float change_thr,
                            float outlier_thr, uint32_t* A, uint32_t* O,
                            uint32_t* E, uint32_t* I, uint32_t* S) {
  const int W = (T + 31) / 32;
  for (int w = q; w < W; w += TILE_Q) {
    uint32_t a = 0, o = 0, e = 0, in = 0, s = 0;
    if (read) {
      // The column bytes first (independent loads), then the scores of the
      // eligible steps, two at a time (ten loads in flight).
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int t = 32 * w + j;
        if (t < T) {
          const size_t at = (size_t)t * P;
          a |= (uint32_t)(al[at] != 0) << j;
          in |= (uint32_t)(inc[at] != 0) << j;
          if (ws) s |= (uint32_t)(ws[at] != 0) << j;
        }
      }
      score_bits<ND>(mon ? a & ~below(w, ck) : 0u, w, Yp, band, TP, P, Xs,
                     coef, dden, change_thr, outlier_thr, o, e);
    }
    A[w * TILE] = a;
    O[w * TILE] = o;
    E[w * TILE] = e;
    I[w * TILE] = in;
    if (S) S[w * TILE] = s;
  }
}

// score_words for a pixel whose alive column is already words (A, stride
// TILE, this thread's words q, q + TILE_Q, ...): only the outlier and
// change words O and E are written (0 where the pixel does not monitor).
template <int ND>
__device__ void score_alive_words(int q, bool mon, int ck, const uint32_t* A,
                                  const int16_t* Yp, const int band[ND],
                                  size_t TP, int T, int P, const float* Xs,
                                  const float coef[ND][K],
                                  const float dden[ND], float change_thr,
                                  float outlier_thr, uint32_t* O,
                                  uint32_t* E) {
  const int W = (T + 31) / 32;
  for (int w = q; w < W; w += TILE_Q) {
    uint32_t o = 0, e = 0;
    score_bits<ND>(mon ? A[w * TILE] & ~below(w, ck) : 0u, w, Yp, band, TP,
                   P, Xs, coef, dden, change_thr, outlier_thr, o, e);
    O[w * TILE] = o;
    E[w * TILE] = e;
  }
}

// Passes 1-3 and the event choice of one monitoring pixel (cursor ck, last
// fit count nl) from its words A, O, E, I (W each, stride TILE), n_exceed
// included; n_pos and t_pos receive pass 4's bounds: the normal
// partition's end and the tail's start (T when there is no tail).
__device__ inline MonitorEvent word_event(const uint32_t* A,
                                          const uint32_t* O,
                                          const uint32_t* E,
                                          const uint32_t* I, int W, int T,
                                          int ck, int nl, int& n_pos,
                                          int& t_pos) {
  MonitorEvent e{};
  const int INF = T + 1;
  // Pass 1: the alive count, the cursor rank, the included count.
  int m = 0, kq = 0, n0 = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t a = A[w * TILE];
    m += __popc(a);
    kq += __popc(a & below(w, ck));
    n0 += __popc(I[w * TILE]);
  }
  // Pass 2: the refit crossing, n_inc = n0 + #absorbed so far.
  const float refit_thr = REFIT_FACTOR * (float)nl;
  bool has_refit = false;
  int f_abs = 0, f_rank = 0, ninc_f = 0, absq = 0, ninc0 = n0;
  for (int w = 0, before = 0; w < W; ++w) {
    const uint32_t a = A[w * TILE];
    const uint32_t ab = a & ~below(w, ck) & ~O[w * TILE];
    const int pc = __popc(ab);
    if (w == 0) ninc0 = n0 + (int)(ab & 1u);
    if (!has_refit && pc && (float)(n0 + absq + pc) >= refit_thr) {
      uint32_t r = ab;
      for (int cnt = absq; r; r &= r - 1u) {
        const int j = __ffs(r) - 1;
        if ((float)(n0 + ++cnt) >= refit_thr) {
          has_refit = true;
          f_abs = 32 * w + j;
          f_rank = before + __popc(a & below(0, j));
          ninc_f = n0 + cnt;
          break;
        }
      }
    }
    absq += pc;
    before += __popc(a);
  }
  // Pass 3: the first run of >= PEEK exceedances among the eligible alive
  // observations in rank order (no non-exceeding one inside).
  bool has_brk = false;
  int b_abs = 0, run = 0, run_at = 0;
  for (int w = 0; w < W && !has_brk; ++w) {
    const uint32_t el = A[w * TILE] & ~below(w, ck);
    const uint32_t x = E[w * TILE] & el;
    const uint32_t n = el & ~x;
    const uint32_t cont = n ? x & ((n & (0u - n)) - 1u) : x;
    if (cont) {
      if (run == 0) run_at = 32 * w + __ffs(cont) - 1;
      run += __popc(cont);
    }
    if (run >= PEEK) {
      has_brk = true;
      b_abs = run_at;
      break;
    }
    if (!n) continue;
    const int lo = __ffs(n) - 1, hi = 31 - __clz(n);
    if (hi > lo && __popc(x & between(lo, hi)) >= PEEK) {
      int a = lo;
      for (uint32_t r = n & (n - 1u); r; r &= r - 1u) {
        const int b = __ffs(r) - 1;
        const uint32_t seg = x & between(a, b);
        if (__popc(seg) >= PEEK) {
          has_brk = true;
          b_abs = 32 * w + __ffs(seg) - 1;
          break;
        }
        a = b;
      }
      if (has_brk) break;
    }
    const uint32_t tail = x & ~((2u << hi) - 1u);
    run = __popc(tail);
    run_at = tail ? 32 * w + __ffs(tail) - 1 : 0;
    if (run >= PEEK) {
      has_brk = true;
      b_abs = run_at;
    }
  }
  int b_rank = 0, ninc_b = 0;
  if (has_brk) {
    b_rank = count_below(A, W, b_abs);
    ninc_b = n0;
    for (int w = 0; 32 * w <= b_abs; ++w)
      ninc_b += __popc(A[w * TILE] & ~below(w, ck) & ~O[w * TILE] &
                       below(w, b_abs + 1));
  }
  // The event choice (kernel._monitor_chain).
  const int q_tail = max(m - (PEEK - 1), kq);
  const int b_ev = has_brk ? b_rank : INF;
  const int f_ev = has_refit ? f_rank : INF;
  e.is_tail = q_tail <= min(b_ev, f_ev);
  e.is_brk = !e.is_tail && has_brk && b_ev <= f_ev;
  e.is_refit = !e.is_tail && !e.is_brk && has_refit;
  e.m = m;
  e.ev_rank = e.is_tail ? q_tail : (e.is_brk ? b_ev : f_ev);
  e.pos_ev = e.is_brk ? b_abs : f_abs;
  e.n_rf = e.is_brk ? ninc_b : (has_refit ? ninc_f : ninc0);
  e.kq = kq;
  e.q_tail = q_tail;
  // Pass 4's rank bounds as time steps, and the tail's exceedances.
  n_pos = step_of_rank(A, W, T, e.is_refit ? e.ev_rank + 1 : e.ev_rank);
  t_pos = T;
  if (e.is_tail) {
    t_pos = step_of_rank(A, W, T, q_tail);
    for (int w = 0; w < W; ++w)
      e.n_exceed += __popc(A[w * TILE] & ~below(w, ck) & ~below(w, t_pos) &
                           E[w * TILE]);
  }
  return e;
}

// Pass 4 on word w: the include (in_q) and remove (rm_q) bits of the
// eligible alive steps (alive a, cursor ck) below n_pos (by the outlier
// bits o) and from t_pos on (by the change bits x).  A pixel with no event
// has n_pos 0 and t_pos T: nothing moves.
struct WordPartition {
  uint32_t in_q, rm_q;
};

__device__ __forceinline__ WordPartition partition_word(uint32_t a,
                                                        uint32_t o,
                                                        uint32_t x, int w,
                                                        int ck, int n_pos,
                                                        int t_pos) {
  const uint32_t el = a & ~below(w, ck);
  const uint32_t normal = el & below(w, n_pos);
  const uint32_t tail = el & ~below(w, t_pos);
  return {(normal & ~o) | (tail & ~x), (normal & o) | (tail & x)};
}

}  // namespace fb
