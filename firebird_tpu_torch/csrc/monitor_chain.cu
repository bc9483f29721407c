// monitor_chain: the MONITOR round's event chain on a precomputed score
// plane, per pixel.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::monitor_chain
// (_monitor_block, _monitor_logic), which serves the JAX package's
// FIREBIRD_PALLAS=monitor route: there XLA computes the [P,T] chi-square
// score plane and the kernel runs the event logic on it.  Per pixel: the
// alive ranks (computed here by counting; the Pallas kernel takes them as
// an input plane), the break search, the refit search, the tail/break/refit
// choice and the include/remove partition — fb::monitor_chain
// (monitor_chain.cuh) with a scorer that reads s[t*P + p], the same code
// that monitor_chain_scored runs with a scorer that computes the score.
//
// Bound: bytes.  The f32 score plane (read three times: the refit, break
// and partition scans), the alive plane (four times) and the included plane
// (once) dominate, and the two partition planes out; there is no float
// arithmetic beyond the threshold compares.
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

__global__ void __launch_bounds__(fb::BLOCK)
monitor_plane_kernel(const float* __restrict__ s,
                     const uint8_t* __restrict__ alive,
                     const uint8_t* __restrict__ included,
                     const int* __restrict__ cur_k,
                     const int* __restrict__ nlast,
                     const uint8_t* __restrict__ in_mon, int* __restrict__ out,
                     uint8_t* __restrict__ inc_q, uint8_t* __restrict__ rem_q,
                     int C, int T, int P, float change_thr,
                     float outlier_thr) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const size_t TP = (size_t)T * P;
  const PlaneScore score{s + c * TP, P, p};
  PartitionSink sink{inc_q + c * TP, rem_q + c * TP, P, p};
  const MonitorEvent e = monitor_chain(
      score, alive + c * TP, included + c * TP, T, P, p, cur_k[cp], nlast[cp],
      in_mon[cp] != 0, change_thr, outlier_thr, sink);

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

// s [C,T,P] f32, alive/included [C,T,P] u8, cur_k/nlast [C,P] i32, in_mon
// [C,P] u8 -> out [8,C,P] i32 (m, is_tail, is_brk, is_refit, ev_rank,
// pos_ev, n_exceed, n_rf), inc_q/rem_q [C,T,P] u8.
extern "C" int fb_monitor_chain(const void* s, const void* alive,
                                const void* included, const void* cur_k,
                                const void* nlast, const void* in_mon,
                                void* out, void* inc_q, void* rem_q, int C,
                                int T, int P, float change_thr,
                                float outlier_thr, void* stream) {
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  monitor_plane_kernel<<<grid, fb::BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const uint8_t*)alive, (const uint8_t*)included,
      (const int*)cur_k, (const int*)nlast, (const uint8_t*)in_mon, (int*)out,
      (uint8_t*)inc_q, (uint8_t*)rem_q, C, T, P, change_thr, outlier_thr);
  return (int)cudaGetLastError();
}
