// monitor_chain_scored: the MONITOR round of the event loop, per pixel.
//
// Replaces the Pallas kernel
// firebird_tpu/ccd/pallas_ops.py::monitor_chain_scored
// (_monitor_scored_block, _mon_scored_logic, _monitor_logic).  Per pixel:
// the chi-square score of every alive observation against the current model,
// sum over detection bands of ((y - X beta) / max(rmse, vario))^2; the break
// search (a run of >= PEEK_SIZE exceedances in the alive sequence, found by a
// backward scan that carries the next non-exceeding rank, as the reverse
// cummin does); the refit search (absorbed count crossing REFIT_FACTOR x the
// last fit's count, by a running sum); the tail/break/refit choice; and the
// include/remove partition of the observations before the event.
//
// Bound: bytes.  The detection-band int16 spectra [nb,T,P] are read three
// times (the score is recomputed in each scan rather than staged: T floats
// a thread would not fit in registers), the alive/included planes once or
// twice; everything after the score is integer.
#include "ccd_common.cuh"

namespace {

constexpr int PEEK = 6;
constexpr float REFIT_FACTOR = 1.33f;

template <int NB>
struct Scorer {
  const int16_t* Y;   // chip base [NB, T, P]
  const float* X;     // chip base [T, K]
  float coef[NB][fb::K];
  float dden[NB];
  int T, P, p;

  __device__ float operator()(int t) const {
    float x[fb::K];
#pragma unroll
    for (int k = 0; k < fb::K; ++k) x[k] = X[t * fb::K + k];
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float pred = x[0] * coef[b][0];
#pragma unroll
      for (int k = 1; k < fb::K; ++k) pred = pred + x[k] * coef[b][k];
      const float r = ((float)Y[((size_t)b * T + t) * P + p] - pred) / dden[b];
      s = (b == 0) ? r * r : s + r * r;
    }
    return s;
  }
};

template <int NB>
__global__ void __launch_bounds__(fb::BLOCK)
monitor_kernel(const int16_t* __restrict__ Yd, const float* __restrict__ coefs_d,
               const float* __restrict__ dden, const float* __restrict__ X,
               const uint8_t* __restrict__ alive,
               const uint8_t* __restrict__ included,
               const int* __restrict__ cur_k, const int* __restrict__ nlast,
               const uint8_t* __restrict__ in_mon, int* __restrict__ out,
               uint8_t* __restrict__ inc_q, uint8_t* __restrict__ rem_q, int C,
               int T, int P, float change_thr, float outlier_thr) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const uint8_t* al = alive + (size_t)c * T * P;
  const uint8_t* inc = included + (size_t)c * T * P;

  Scorer<NB> score;
  score.Y = Yd + (size_t)c * NB * T * P;
  score.X = X + (size_t)c * T * K;
  score.T = T;
  score.P = P;
  score.p = p;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    score.dden[b] = dden[cp * NB + b];
#pragma unroll
    for (int k = 0; k < K; ++k) score.coef[b][k] = coefs_d[(cp * NB + b) * K + k];
  }
  const int ck = cur_k[cp];
  const int nl = nlast[cp];
  const bool mon = in_mon[cp] != 0;
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
  const int q_tail = max(m - (PEEK - 1), kq);
  const int b_ev = has_brk ? b_rank : INF;
  const int f_ev = has_refit ? f_rank : INF;
  const bool is_tail = mon && q_tail <= min(b_ev, f_ev);
  const bool is_brk = mon && !is_tail && has_brk && b_ev <= f_ev;
  const bool is_refit = mon && !is_tail && !is_brk && has_refit;
  const int ev_rank = is_tail ? q_tail : (is_brk ? b_ev : f_ev);
  const int normal_hi = is_refit ? ev_rank + 1 : ev_rank;
  const int pos_ev = is_brk ? b_abs : f_abs;
  // n_inc at pos_ev: f_abs defaults to 0 when no refit crossing exists.
  const int n_rf = is_brk ? ninc_b : (has_refit ? ninc_f : ninc0);

  // Pass 4 (forward): the include/remove partition.
  uint8_t* iq = inc_q + (size_t)c * T * P;
  uint8_t* rq = rem_q + (size_t)c * T * P;
  int n_exceed = 0;
  rank = -1;
  for (int t = 0; t < T; ++t) {
    bool in_q = false, rm_q = false;
    if (al[(size_t)t * P + p] != 0) {
      ++rank;
      if (rank >= kq) {
        const float s = score(t);
        const bool o = s > outlier_thr;
        const bool normalq = rank < normal_hi;
        in_q = normalq && !o;
        rm_q = normalq && o;
        if (is_tail && rank >= q_tail) {
          const bool tail_ex = s > change_thr;
          in_q = in_q || !tail_ex;
          rm_q = rm_q || tail_ex;
          n_exceed += tail_ex;
        }
      }
    }
    iq[(size_t)t * P + p] = in_q;
    rq[(size_t)t * P + p] = rm_q;
  }

  const size_t CP = (size_t)C * P;
  out[0 * CP + cp] = m;
  out[1 * CP + cp] = is_tail;
  out[2 * CP + cp] = is_brk;
  out[3 * CP + cp] = is_refit;
  out[4 * CP + cp] = ev_rank;
  out[5 * CP + cp] = pos_ev;
  out[6 * CP + cp] = n_exceed;
  out[7 * CP + cp] = n_rf;
}

}  // namespace

// Yd [C,nb,T,P] int16, coefs_d [C,P,nb,8], dden [C,P,nb], X [C,T,8] f32,
// alive/included [C,T,P] u8, cur_k/nlast [C,P] i32, in_mon [C,P] u8
// -> out [8,C,P] i32 (m, is_tail, is_brk, is_refit, ev_rank, pos_ev,
//    n_exceed, n_rf), inc_q/rem_q [C,T,P] u8.
extern "C" int fb_monitor_chain_scored(
    const void* Yd, const void* coefs_d, const void* dden, const void* X,
    const void* alive, const void* included, const void* cur_k,
    const void* nlast, const void* in_mon, void* out, void* inc_q,
    void* rem_q, int C, int nb, int T, int P, float change_thr,
    float outlier_thr, void* stream) {
  if (nb != 5) return (int)cudaErrorInvalidValue;
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  monitor_kernel<5><<<grid, fb::BLOCK, 0, (cudaStream_t)stream>>>(
      (const int16_t*)Yd, (const float*)coefs_d, (const float*)dden,
      (const float*)X, (const uint8_t*)alive, (const uint8_t*)included,
      (const int*)cur_k, (const int*)nlast, (const uint8_t*)in_mon,
      (int*)out, (uint8_t*)inc_q, (uint8_t*)rem_q, C, T, P, change_thr,
      outlier_thr);
  return (int)cudaGetLastError();
}
