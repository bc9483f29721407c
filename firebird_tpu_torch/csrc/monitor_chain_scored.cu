// monitor_chain_scored: the MONITOR round of the event loop, per pixel.
//
// Replaces the Pallas kernel
// firebird_tpu/ccd/pallas_ops.py::monitor_chain_scored
// (_monitor_scored_block, _mon_scored_logic, _monitor_logic).  Per pixel:
// the chi-square score of every alive observation against the current model,
// sum over detection bands of ((y - X beta) / max(rmse, vario))^2; the break
// search, the refit search, the tail/break/refit choice and the
// include/remove partition of the observations before the event.  The
// per-pixel body is fb::monitor_chain (monitor_chain.cuh), which the
// monitor_chain, fused_round and detect_mega kernels run too.
//
// Bound: bytes.  The detection-band int16 spectra [nb,T,P] are read three
// times (the score is recomputed in each scan rather than staged: T floats
// a thread would not fit in registers), the alive/included planes once or
// twice; everything after the score is integer.
#include "monitor_chain.cuh"

namespace {

// Writes the include / remove partition as two [T, P] planes.
struct PartitionSink {
  uint8_t* iq;
  uint8_t* rq;
  int P, p;
  __device__ void operator()(int t, bool in_q, bool rm_q) const {
    iq[(size_t)t * P + p] = in_q;
    rq[(size_t)t * P + p] = rm_q;
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
  PartitionSink sink{inc_q + (size_t)c * T * P, rem_q + (size_t)c * T * P, P,
                     p};
  const MonitorEvent e = monitor_chain(
      score, alive + (size_t)c * T * P, included + (size_t)c * T * P, T, P, p,
      cur_k[cp], nlast[cp], in_mon[cp] != 0, change_thr, outlier_thr, sink);

  const size_t CP = (size_t)C * P;
  out[0 * CP + cp] = e.m;
  out[1 * CP + cp] = e.is_tail;
  out[2 * CP + cp] = e.is_brk;
  out[3 * CP + cp] = e.is_refit;
  out[4 * CP + cp] = e.ev_rank;
  out[5 * CP + cp] = e.pos_ev;
  out[6 * CP + cp] = e.n_exceed;
  out[7 * CP + cp] = e.n_rf;
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
