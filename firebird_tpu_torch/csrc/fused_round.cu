// fused_round: the whole post-INIT round of the event loop — monitor chain,
// segment close and shared Lasso refit — for a tile of pixels, in one
// launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::fused_round
// (_fused_round_block, with _mon_scored_logic, _close_logic and
// _gram_cd_core).  It computes what fb::round_pixel (fused_round.cuh, the
// body detect_mega runs per thread) computes, with the same float
// operations in the same order per pixel, scheduled for this card:
//
//   0. The block stages its chip's design X [T,8] and days t [T] in shared
//      memory (dynamic, sized from T; fused_round_smem_bytes).
//   1. Scoring: TILE pixels a block, Q threads a pixel, each thread a set of
//      32-step words.  Every alive observation a monitoring pixel can use
//      (t >= cur_k) is scored once (fb::score_obs, the arithmetic of
//      fb::Scorer), and only two bits of the score are kept: s > outlier
//      and s > change.  The alive, included and w_stab columns become bit
//      masks too, ceil(T/32) words each, in shared memory.
//   2. Events: one thread a pixel runs passes 1-3 of fb::monitor_event on
//      the words with popcounts: the alive count and cursor rank, the
//      first refit crossing (a prefix count of absorbed observations), the
//      first run of >= PEEK exceedances in rank order (runs may cross
//      words), and the tail / break / refit choice.  Integer work on the
//      same bits, so the event is the same.
//   3. Partition: the include / remove partition of pass 4 as word masks;
//      every thread writes its words' rows of included_mon and alive_mon
//      (a non-monitoring pixel's columns are copied the same way).
//   4. Close: the event thread appends a closing pixel's segment
//      (fb::close_write, from the included_mon words; a break's magnitudes
//      from the PEEK run's residuals, fb::peek_mags_at), and the block's
//      fitting pixels (init-ok or refit) are listed with a warp ballot.
//   5. Fit: the listed pixels are fitted densely, Q lanes a pixel.  The
//      Gram and correlation sums are split over the lanes by sum (lane l
//      owns Gram row l and band l's correlations), each summed over the
//      window in time order with Gram::add's operations; the window is the
//      pixel's w_stab (init-ok) or included_mon (refit) words.  Then lane
//      l < 7 runs band l's coordinate descent (fb::cd_loop on the Gram in
//      shared memory) and band l's RMSE pass.  The coefficients and RMSE
//      are those of fb::fit_window, bit for bit.
//
// Bound: bytes (the monitoring pixels' detection bands at the observations
// scored, the fitting pixels' windows, the planes in and out); the CD loop's
// serial chain (50 sweeps x 8 coordinates a band) bounds a block's latency.
#include "monitor_chain.cuh"
#include "segment_close.cuh"

namespace {

constexpr int B = fb::NBAND;
constexpr int ND = fb::NDET;
constexpr int TILE = 32;              // pixels a block
constexpr int THREADS = 256;
constexpr int Q = THREADS / TILE;     // threads a pixel (scoring, fitting)
constexpr int MIN_BLOCKS = 3;         // 24 warps an SM (80 registers)
constexpr int GSTRIDE = fb::K * fb::K + 1;    // a pixel's Gram in shared memory
constexpr int NMASK = 5;              // alive, outlier, change, incl., w_stab
constexpr int NINFO = 5;              // per-pixel ints in shared memory

// Dynamic shared memory of a block for T time steps, in 4-byte words:
// X and t, the Grams, the masks, the per-pixel ints and the fit count.
// cuda_ops.fused_round_smem_bytes computes the same.
size_t smem_words(int T) {
  const int W = (T + 31) / 32;
  return (size_t)9 * T + TILE * GSTRIDE + (size_t)NMASK * W * TILE +
         NINFO * TILE + 4;
}

// Bits j of word w with 32w + j < lim.
__device__ __forceinline__ uint32_t below(int w, int lim) {
  const int k = lim - 32 * w;
  return k <= 0 ? 0u : (k >= 32 ? ~0u : (1u << k) - 1u);
}

// Bits strictly between bit a and bit b (a < b).
__device__ __forceinline__ uint32_t between(int a, int b) {
  return ((1u << b) - 1u) & ~((2u << a) - 1u);
}

// The count of bits of mask m (W words, stride TILE) below time step t.
__device__ int count_below(const uint32_t* m, int W, int t) {
  int n = 0;
  for (int w = 0; w < W && 32 * w < t; ++w) n += __popc(m[w * TILE] & below(w, t));
  return n;
}

// The time step of the set bit of rank r of mask m, T when r >= its count.
__device__ int step_of_rank(const uint32_t* m, int W, int T, int r) {
  for (int w = 0; w < W; ++w) {
    uint32_t v = m[w * TILE];
    const int pc = __popc(v);
    if (r < pc) {
      for (; r > 0; --r) v &= v - 1u;
      return 32 * w + __ffs(v) - 1;
    }
    r -= pc;
  }
  return T;
}

// The set bits of a pixel's window mask (W words, stride TILE) in time
// order, FIT_BATCH at a time with their band values loaded together (the
// loads of a batch are in flight at once; the sums still run in order).
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
  // The next FIT_BATCH steps (-1 past the last) and, where load, the band
  // values y[t * P] of those that exist.
  __device__ void take(int* tq, const int16_t* y, int P, bool load,
                       float* yq) {
#pragma unroll
    for (int u = 0; u < FIT_BATCH; ++u) {
      if (done()) {
        tq[u] = -1;
      } else {
        tq[u] = 32 * w + __ffs(r) - 1;
        r &= r - 1u;
      }
    }
#pragma unroll
    for (int u = 0; u < FIT_BATCH; ++u)
      yq[u] = (load && tq[u] >= 0) ? (float)y[(size_t)tq[u] * P] : 0.f;
  }
};

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
    uint8_t* __restrict__ alm_out, int C, int T, int P, float change_thr,
    float outlier_thr) {
  using namespace fb;
  extern __shared__ __align__(16) float smem[];
  const int W = (T + 31) / 32;
  float* Xs = smem;
  float* ts = Xs + T * K;
  float* Gs = ts + T;
  uint32_t* mA = reinterpret_cast<uint32_t*>(Gs + TILE * GSTRIDE);
  uint32_t* mO = mA + W * TILE;
  uint32_t* mE = mO + W * TILE;
  uint32_t* mI = mE + W * TILE;
  uint32_t* mS = mI + W * TILE;
  int* npos = reinterpret_cast<int*>(mS + W * TILE);
  int* tpos = npos + TILE;
  int* flist = tpos + TILE;
  int* fnfull = flist + TILE;
  int* finit = fnfull + TILE;
  int* nfit = finit + TILE;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t TP = (size_t)T * P;
  const int16_t* Yc = Yt + (size_t)c * B * TP;

  // 0. Stage the design and the days.
  for (int i = tid; i < T * K; i += THREADS) Xs[i] = X[(size_t)c * T * K + i];
  for (int i = tid; i < T; i += THREADS) ts[i] = tt[(size_t)c * T + i];
  __syncthreads();

  // 1. Score once, keep bits.  Thread (q, i): pixel i, words q, q+Q, ...
  const int i = tid % TILE;
  const int q = tid / TILE;
  const int p = blockIdx.x * TILE + i;
  const bool valid = p < P;
  const size_t cp = (size_t)c * P + (valid ? p : 0);
  const bool mon = valid && in_mon[cp] != 0;
  const bool iok = valid && init_ok[cp] != 0;
  const int ck = valid ? cur_k[cp] : 0;
  {
    float coef[ND][K], dden[ND];
    if (mon) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        dden[d] = pmax(rmse[cp * B + d + 1], vario[cp * B + d + 1]);
#pragma unroll
        for (int k = 0; k < K; ++k) coef[d][k] = coefs[(cp * B + d + 1) * K + k];
      }
    }
    const uint8_t* al = alive + c * TP + p;
    const uint8_t* inc = included + c * TP + p;
    const uint8_t* ws = w_stab + c * TP + p;
    const int16_t* Y1 = Yc + TP + p;      // band 1, the first detection band
    for (int w = q; w < W; w += Q) {
      uint32_t a = 0, o = 0, e = 0, in = 0, s = 0;
      if (valid) {
        // The column bytes first (independent loads), then the scores of
        // the eligible steps, two at a time (ten loads in flight).
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const int t = 32 * w + j;
          if (t < T) {
            const size_t at = (size_t)t * P;
            a |= (uint32_t)(al[at] != 0) << j;
            in |= (uint32_t)(inc[at] != 0) << j;
            if (iok) s |= (uint32_t)(ws[at] != 0) << j;
          }
        }
        for (uint32_t r = mon ? a & ~below(w, ck) : 0u; r;) {
          int js[2];
          int16_t ys[2][ND];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            js[u] = r ? __ffs(r) - 1 : -1;
            r &= r - 1u;
            if (js[u] >= 0) {
              const int16_t* y = Y1 + (size_t)(32 * w + js[u]) * P;
#pragma unroll
              for (int b = 0; b < ND; ++b) ys[u][b] = y[(size_t)b * TP];
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (js[u] < 0) break;
            const int t = 32 * w + js[u];
            float x[K];
#pragma unroll
            for (int k = 0; k < K; ++k) x[k] = Xs[t * K + k];
            const float sc = score_obs<ND>(
                x, coef, dden, [&](int b) { return ys[u][b]; });
            o |= (uint32_t)(sc > outlier_thr) << js[u];
            e |= (uint32_t)(sc > change_thr) << js[u];
          }
        }
      }
      mA[w * TILE + i] = a;
      mO[w * TILE + i] = o;
      mE[w * TILE + i] = e;
      mI[w * TILE + i] = in;
      mS[w * TILE + i] = s;
    }
  }
  __syncthreads();

  // 2. Events: thread i of warp 0 for pixel i (passes 1-3 on words).
  const uint32_t* A = mA + i;
  MonitorEvent e{};
  if (tid < TILE) {
    int n_pos = 0, t_pos = T;
    if (mon) {
      const int INF = T + 1;
      int m = 0, kq = 0, n0 = 0;
      for (int w = 0; w < W; ++w) {
        const uint32_t a = A[w * TILE];
        m += __popc(a);
        kq += __popc(a & below(w, ck));
        n0 += __popc(mI[w * TILE + i]);
      }
      // Pass 2: the refit crossing, n_inc = n0 + #absorbed so far.
      const float refit_thr = REFIT_FACTOR * (float)nlast[cp];
      bool has_refit = false;
      int f_abs = 0, f_rank = 0, ninc_f = 0, absq = 0, ninc0 = n0;
      for (int w = 0, before = 0; w < W; ++w) {
        const uint32_t a = A[w * TILE];
        const uint32_t ab = a & ~below(w, ck) & ~mO[w * TILE + i];
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
      // Pass 3: the first run of >= PEEK exceedances among the eligible
      // alive observations in rank order (no non-exceeding one inside).
      bool has_brk = false;
      int b_abs = 0, run = 0, run_at = 0;
      for (int w = 0; w < W && !has_brk; ++w) {
        const uint32_t el = A[w * TILE] & ~below(w, ck);
        const uint32_t x = mE[w * TILE + i] & el;
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
          ninc_b += __popc(A[w * TILE] & ~below(w, ck) & ~mO[w * TILE + i] &
                           below(w, b_abs + 1));
      }
      // The event choice (fb::monitor_event).
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
      // Pass 4's rank bounds as time steps.
      n_pos = step_of_rank(A, W, T, e.is_refit ? e.ev_rank + 1 : e.ev_rank);
      if (e.is_tail) {
        t_pos = step_of_rank(A, W, T, q_tail);
        for (int w = 0; w < W; ++w)
          e.n_exceed += __popc(A[w * TILE] & ~below(w, ck) & ~below(w, t_pos) &
                               mE[w * TILE + i]);
      }
    }
    npos[i] = n_pos;
    tpos[i] = t_pos;
  }
  __syncthreads();

  // 3. Partition: included_mon = included | in_q, alive_mon = alive & !rm_q.
  {
    const int n_pos = npos[i], t_pos = tpos[i];
    uint8_t* im = incm_out + c * TP + p;
    uint8_t* am = alm_out + c * TP + p;
    for (int w = q; w < W; w += Q) {
      const uint32_t a = mA[w * TILE + i];
      const uint32_t el = a & ~below(w, ck);
      const uint32_t normal = el & below(w, n_pos);
      const uint32_t tail = el & ~below(w, t_pos);
      const uint32_t o = mO[w * TILE + i], x = mE[w * TILE + i];
      const uint32_t in_q = (normal & ~o) | (tail & ~x);
      const uint32_t rm_q = (normal & o) | (tail & x);
      const uint32_t incm = mI[w * TILE + i] | in_q;
      const uint32_t alm = a & ~rm_q;
      mI[w * TILE + i] = incm;
      if (valid) {
        const int hi = min(32, T - 32 * w);
        for (int j = 0; j < hi; ++j) {
          const size_t at = (size_t)(32 * w + j) * P;
          im[at] = (incm >> j) & 1u;
          am[at] = (alm >> j) & 1u;
        }
      }
    }
  }
  __syncthreads();

  // 4. Close, events out, the fit list.
  if (tid < TILE) {
    const bool close = e.is_tail || e.is_brk;
    const bool do_fit = valid && (iok || e.is_refit);
    const int n_full = iok ? n_ok[cp] : e.n_rf;
    if (valid) {
      const float* coef_row = coefs + cp * B * K;
      const float* rmse_row = rmse + cp * B;
      if (close) {
        int first = -1, last = T - 1, n_obs = 0;
        for (int w = 0; w < W; ++w) {
          const uint32_t v = mI[w * TILE + i];
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
          peek_mags_at<B>(Yc, Xs, coef_row, run, n, T, P, p, mags);
        }
        close_write<B>(ts, first, last, n_obs, cp, e.is_brk, e.pos_ev,
                       e.n_exceed, first_seg[cp] != 0, nseg[cp], rmse_row,
                       e.is_brk ? mags : nullptr, coef_row, bufs);
      }
      nseg_out[cp] = nseg[cp] + close;
      const size_t CP = (size_t)C * P;
      ev[0 * CP + cp] = e.is_tail;
      ev[1 * CP + cp] = e.is_brk;
      ev[2 * CP + cp] = e.is_refit;
      ev[3 * CP + cp] = e.pos_ev;
      ev[4 * CP + cp] = do_fit;
      ev[5 * CP + cp] = n_full;
      if (!do_fit) {
        for (int k = 0; k < B * K; ++k) coefs_out[cp * B * K + k] = coef_row[k];
        for (int b = 0; b < B; ++b) rmse_out[cp * B + b] = rmse_row[b];
      }
    }
    const uint32_t fit = __ballot_sync(~0u, do_fit);
    if (do_fit) {
      const int slot = __popc(fit & below(0, i));
      flist[slot] = i;
      fnfull[slot] = n_full;
      finit[slot] = iok;
    }
    if (i == 0) *nfit = __popc(fit);
  }
  __syncthreads();

  // 5. Fit: group g (Q lanes) fits listed pixel g; lane l owns Gram row l
  // and band l's correlations, the count on every lane.
  const int g = tid / Q, l = tid % Q;
  const bool fits = g < *nfit;
  const int fi = fits ? flist[g] : 0;
  const size_t fcp = (size_t)c * P + blockIdx.x * TILE + fi;
  const uint32_t* win = (fits && finit[g] ? mS : mI) + fi;
  const int16_t* Yb = Yc + (size_t)min(l, B - 1) * TP + (fcp - (size_t)c * P);
  float* G = Gs + g * GSTRIDE;
  float nw = 0.f;
  float cb[1][K];
  if (fits) {
    float grow[K];
#pragma unroll
    for (int k = 0; k < K; ++k) grow[k] = cb[0][k] = 0.f;
    const float wt = 1.f;
    for (BitWalk it{win, W}; !it.done();) {
      int tq[FIT_BATCH];
      float yq[FIT_BATCH];
      it.take(tq, Yb, P, l < B, yq);
#pragma unroll
      for (int u = 0; u < FIT_BATCH; ++u) {
        if (tq[u] < 0) break;
        const int t = tq[u];
        float x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = Xs[t * K + k];
        const float xl = Xs[t * K + l];
        nw = nw + wt;
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j >= l) grow[j] = grow[j] + wt * (xl * x[j]);
        if (l < B) {
          const float yw = yq[u] * wt;
#pragma unroll
          for (int k = 0; k < K; ++k) cb[0][k] = cb[0][k] + yw * x[k];
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
    for (int k = 0; k < K; ++k) cb[0][k] = cb[0][k] / nw;
  }
  __syncthreads();
  if (fits && l < B) {
    // fb::lasso_cd for band l, then its RMSE pass (fb::fit_window).
    float diag[K], beta[1][K];
    bool mask[K];
#pragma unroll
    for (int j = 0; j < K; ++j) diag[j] = pmax(G[j * K + j], 1e-12f);
    coef_mask(fnfull[g], mask);
    cd_loop<1>(reinterpret_cast<const float(*)[K]>(G), cb, diag, mask, beta);
#pragma unroll
    for (int k = 0; k < K; ++k) coefs_out[(fcp * B + l) * K + k] = beta[0][k];
    const float wt = 1.f;
    float acc = 0.f;
    for (BitWalk it{win, W}; !it.done();) {
      int tq[FIT_BATCH];
      float yq[FIT_BATCH];
      it.take(tq, Yb, P, true, yq);
#pragma unroll
      for (int u = 0; u < FIT_BATCH; ++u) {
        if (tq[u] < 0) break;
        const int t = tq[u];
        float x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = Xs[t * K + k];
        float pred = beta[0][0] * x[0];
#pragma unroll
        for (int k = 1; k < K; ++k) pred = pred + beta[0][k] * x[k];
        const float res = yq[u] - pred;
        acc = acc + res * res * wt;
      }
    }
    rmse_out[fcp * B + l] = sqrtf(pmax(acc / nw, 0.f));
  }
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
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fused_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                   (float*)coef_b, S};
  fused_round_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
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

// The launch geometry at T: out[0] the dynamic shared memory bytes, out[1]
// the blocks resident on one SM, out[2] registers a thread, out[3] local
// (stack and spill) bytes a thread.
extern "C" int fb_fused_round_geometry(int T, int* out) {
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fused_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1],
                                                    fused_round_kernel,
                                                    THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, fused_round_kernel);
  out[0] = (int)smem;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return (int)e;
}
