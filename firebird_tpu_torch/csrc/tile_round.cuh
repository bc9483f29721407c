// The post-INIT round of a tile — monitor on bit words, segment close,
// ballot listing and dense refit — shared by the fused_round and
// detect_mega kernels (tile.cuh's block layout: TILE pixels, TILE_THREADS
// threads): pallas_ops._fused_round_block's per-pixel work (with
// _mon_scored_logic, _close_logic and _gram_cd_core), scheduled for this
// card.  A pixel's result depends on no other pixel:
//
//   1. load: the caller's scoring of its words (word_monitor.cuh): every
//      eligible observation of a monitoring pixel scored once into two
//      bits, TILE_Q threads a pixel, beside the alive, included and w_stab
//      words (fused_round builds them from its byte planes; detect_mega
//      keeps them in shared memory between rounds).
//   2. Events: one thread a pixel runs passes 1-3 on the words with
//      popcounts (fb::word_event).
//   3. Partition: included_mon = included | in_q replaces the included
//      words; the caller's part(w, incm, alm) receives each word of the
//      round's included and alive columns.
//   4. Close: the event thread appends a closing pixel's segment
//      (fb::close_write from the included_mon words; a break's magnitudes
//      from the PEEK run's residuals, fb::peek_mags_at, on the round-start
//      alive words) and hands the pixel's event to the caller's event();
//      the fitting pixels (init-ok or refit) are listed with a warp ballot.
//   5. Fit: the listed pixels are fitted densely, TILE_Q lanes a pixel,
//      over their w_stab (init-ok) or included_mon (refit) words
//      (fb::dense_fit, the code of lasso_fit): the coefficients and RMSE
//      are lasso_fit's, bit for bit.
//
// Every thread of the block calls tile_round with the same shapes; its
// four barriers (and dense_fit's) are reached by the whole block whatever
// its pixels' phases, so a tile of DONE or INIT pixels passes through it.
#pragma once

#include "dense_fit.cuh"
#include "segment_close.cuh"
#include "word_monitor.cuh"

namespace fb {

constexpr int TILE_NMASK = 5;   // alive, outlier, change, included, w_stab
constexpr int TILE_NINFO = 5;   // npos, tpos, flist, fnfull, finit a pixel

// A tile round's shared memory for W words a column, in 4-byte words: a
// Gram a listed pixel, the five masks, the per-pixel ints and the fit
// count (padded to 4).  The caller stages the chip's design and days
// before it.
__host__ __device__ constexpr size_t tile_round_words(int W) {
  return (size_t)TILE * GSTRIDE + (size_t)TILE_NMASK * W * TILE +
         TILE_NINFO * TILE + 4;
}

struct TileMem {
  const float* Xs;          // the chip's design [T, K]
  const float* ts;          // the chip's days [T]
  float* Gs;
  uint32_t *mA, *mO, *mE, *mI, *mS;
  int *npos, *tpos, *flist, *fnfull, *finit, *nfit;
};

// tile_round_words(W) words of shared memory from base.
__device__ inline TileMem carve_tile(const float* Xs, const float* ts,
                                     float* base, int W) {
  TileMem m;
  m.Xs = Xs;
  m.ts = ts;
  m.Gs = base;
  m.mA = reinterpret_cast<uint32_t*>(base + TILE * GSTRIDE);
  m.mO = m.mA + W * TILE;
  m.mE = m.mO + W * TILE;
  m.mI = m.mE + W * TILE;
  m.mS = m.mI + W * TILE;
  m.npos = reinterpret_cast<int*>(m.mS + W * TILE);
  m.tpos = m.npos + TILE;
  m.flist = m.tpos + TILE;
  m.fnfull = m.flist + TILE;
  m.finit = m.fnfull + TILE;
  m.nfit = m.finit + TILE;
  return m;
}

// This thread's place: pixel i of the tile (p in the chip, cp = c*P + p;
// valid when p < P) as part q; cp0 addresses the tile's first pixel.  mon
// and ck (the monitor's cursor) are every thread's.
struct TilePixel {
  int i, q, p;
  bool valid;
  size_t cp, cp0;
  bool mon;
  int ck;
};

// The event thread's round state of its pixel (state() returns it where
// it is needed): the last fit count, the INIT block's handoff, the first-
// segment flag and the segment count.
struct TileState {
  int nlast;
  bool iok;
  int n_ok;
  bool first_seg;
  int nseg;
};

// One round of the tile.  Yc is the chip's spectra [B, T, P]; coefs
// [.., B, K] / rmse [.., B] the current model (read by the monitor and the
// close), coefs_out / rmse_out the fitted pixels' new model (the same
// arrays when the caller updates in place: the close reads its rows before
// the fit writes them); vario [.., B].
//   load(coef, dden): step 1 (every thread), the detection bands' model and
//     score denominators given (zeros unless the pixel monitors);
//   part(w, incm, alm): step 3, word w of the round's included and alive
//     columns (every pixel, valid or not);
//   event(e, close, do_fit, n_full): step 4, by a valid pixel's event
//     thread.
template <int B, class State, class Load, class Part, class Event>
__device__ __forceinline__ void tile_round(
    const TileMem& m, const TilePixel& px, const int16_t* Yc, int T, int P,
    const float* coefs, const float* rmse, const float* vario,
    float* coefs_out, float* rmse_out, const Roles& roles,
    const SegBufs& bufs, float change_thr, float outlier_thr, State state,
    Load load, Part part, Event event) {
  constexpr int ND = NDET;
  const int W = (T + 31) / 32;
  const size_t TP = (size_t)T * P;
  const int tid = threadIdx.x;
  const int i = px.i, q = px.q;
  const size_t cp = px.cp;

  // 1. Score once, keep bits.
  {
    float coef[ND][K], dden[ND];
    if (px.mon) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int b = roles.det[d];
        dden[d] = pmax(rmse[cp * B + b], vario[cp * B + b]);
#pragma unroll
        for (int k = 0; k < K; ++k) coef[d][k] = coefs[(cp * B + b) * K + k];
      }
    }
    load(coef, dden);
  }
  __syncthreads();

  // 2. Events: thread i of warp 0 for pixel i (passes 1-3 on words).
  const uint32_t* A = m.mA + i;
  MonitorEvent e{};
  if (tid < TILE) {
    int n_pos = 0, t_pos = T;
    if (px.mon)
      e = word_event(A, m.mO + i, m.mE + i, m.mI + i, W, T, px.ck,
                     state().nlast, n_pos, t_pos);
    m.npos[i] = n_pos;
    m.tpos[i] = t_pos;
  }
  __syncthreads();

  // 3. Partition: included_mon = included | in_q, alive_mon = alive & !rm_q.
  {
    const int n_pos = m.npos[i], t_pos = m.tpos[i];
    for (int w = q; w < W; w += TILE_Q) {
      const uint32_t a = m.mA[w * TILE + i];
      const WordPartition pq = partition_word(
          a, m.mO[w * TILE + i], m.mE[w * TILE + i], w, px.ck, n_pos, t_pos);
      const uint32_t incm = m.mI[w * TILE + i] | pq.in_q;
      m.mI[w * TILE + i] = incm;
      part(w, incm, a & ~pq.rm_q);
    }
  }
  __syncthreads();

  // 4. Close, the event out, the fit list.
  if (tid < TILE) {
    const TileState s = state();
    const bool close = e.is_tail || e.is_brk;
    const bool do_fit = px.valid && (s.iok || e.is_refit);
    const int n_full = s.iok ? s.n_ok : e.n_rf;
    if (px.valid) {
      if (close) {
        const float* coef_row = coefs + cp * B * K;
        int first = -1, last = T - 1, n_obs = 0;
        for (int w = 0; w < W; ++w) {
          const uint32_t v = m.mI[w * TILE + i];
          if (!v) continue;
          if (first < 0) first = 32 * w + __ffs(v) - 1;
          last = 32 * w + 31 - __clz(v);
          n_obs += __popc(v);
        }
        if (first < 0) first = 0;
        float mags[B];
        if (e.is_brk) {
          int run[PEEK];
          const int n = min(e.ev_rank + PEEK, e.m) - e.ev_rank;
          for (int k = 0; k < n; ++k)
            run[k] = step_of_rank(A, W, T, e.ev_rank + k);
          peek_mags_at<B>(Yc, m.Xs, coef_row, run, n, T, P, px.p, mags);
        }
        close_write<B>(m.ts, first, last, n_obs, cp, e.is_brk, e.pos_ev,
                       e.n_exceed, s.first_seg, s.nseg, rmse + cp * B,
                       e.is_brk ? mags : nullptr, coef_row, bufs);
      }
      event(e, close, do_fit, n_full);
    }
    const int slot = list_pixels(do_fit, i, m.nfit);
    if (do_fit) {
      m.flist[slot] = i;
      m.fnfull[slot] = n_full;
      m.finit[slot] = s.iok;
    }
  }
  __syncthreads();

  // 5. Fit: group g fits listed pixel g over its w_stab (init-ok) or
  // included_mon (refit) words.
  const int g = tid / TILE_Q, l = tid % TILE_Q;
  const bool fits = g < *m.nfit;
  const int fi = fits ? m.flist[g] : 0;
  const size_t fcp = px.cp0 + fi;
  bool mask[K];
  coef_mask(fits ? m.fnfull[g] : 0, mask);
  dense_fit<B>(fits, l, (fits && m.finit[g] ? m.mS : m.mI) + fi, W,
               Yc + (px.p - i) + fi, TP, P, m.Xs, m.Gs + g * GSTRIDE, mask,
               true, coefs_out + fcp * B * K, rmse_out + fcp * B);
}

}  // namespace fb
