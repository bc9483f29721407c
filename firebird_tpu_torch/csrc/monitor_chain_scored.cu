// monitor_chain_scored: the MONITOR round of the event loop, a tile of
// pixels a block.
//
// Replaces the Pallas kernel
// firebird_tpu/ccd/pallas_ops.py::monitor_chain_scored
// (_monitor_scored_block, _mon_scored_logic, _monitor_logic).  Per
// monitoring pixel: the chi-square score of every alive observation against
// the current model, sum over detection bands of ((y - X beta) /
// max(rmse, vario))^2; the break search, the refit search, the
// tail/break/refit choice and the include/remove partition of the
// observations before the event.  A pixel that does not monitor gets the
// zero outputs of kernel._mon_zeros (every consumer masks it on in_mon) and
// costs no scoring.
//
// Bound: bytes (the detection bands at the monitoring pixels' eligible
// observations, the alive / included planes in, the two partition planes
// out); everything after the score is integer.  The design, fused_round's
// steps 0-3 (tile.cuh's layout, word_monitor.cuh):
//   0. The block stages its chip's design X [T,8] in shared memory.
//   1. TILE_Q threads a pixel score each eligible observation once
//      (fb::score_obs) and keep two bits of it, beside the alive and
//      included columns as 32-step words in shared memory.
//   2. One thread a pixel runs passes 1-3 on the words with popcounts.
//   3. Every thread writes its words' rows of the two partition planes.
// A narrow launch (the bucketed tail) spreads a pixel's walk over TILE_Q
// threads instead of walking T three times on one.
// With ``active`` (pallas_ops' per-block skip guard, normally in_mon), a
// tile with no active pixel writes the zero outputs and stages nothing
// (fb::tile_active).
#include "word_monitor.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int Q = fb::TILE_Q;
constexpr int MIN_BLOCKS = 3;         // 24 warps an SM (80 registers)
constexpr int ND = fb::NDET;

// Dynamic shared memory of a block for T time steps, in 4-byte words: X,
// the alive / outlier / change / included words, and the partition bounds.
// cuda_ops.monitor_chain_scored_smem_bytes computes the same.
size_t smem_words(int T) {
  const int W = (T + 31) / 32;
  return (size_t)8 * T + (size_t)4 * W * TILE + 2 * TILE;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
monitor_kernel(const int16_t* __restrict__ Yd, const float* __restrict__ coefs_d,
               const float* __restrict__ dden, const float* __restrict__ X,
               const uint8_t* __restrict__ alive,
               const uint8_t* __restrict__ included,
               const int* __restrict__ cur_k, const int* __restrict__ nlast,
               const uint8_t* __restrict__ in_mon, int* __restrict__ out,
               uint8_t* __restrict__ inc_q, uint8_t* __restrict__ rem_q,
               const uint8_t* __restrict__ active, int C, int T, int P,
               float change_thr, float outlier_thr) {
  using namespace fb;
  extern __shared__ __align__(16) float smem[];
  const int W = (T + 31) / 32;
  float* Xs = smem;
  uint32_t* mA = reinterpret_cast<uint32_t*>(Xs + T * K);
  uint32_t* mO = mA + W * TILE;
  uint32_t* mE = mO + W * TILE;
  uint32_t* mI = mE + W * TILE;
  int* npos = reinterpret_cast<int*>(mI + W * TILE);
  int* tpos = npos + TILE;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t TP = (size_t)T * P;
  const int p0 = blockIdx.x * TILE;

  // The guard: a tile with no active pixel writes the zero outputs.
  if (!tile_active(active, (size_t)c * P + p0, min(TILE, P - p0))) {
    const size_t CP = (size_t)C * P;
    if (tid < TILE && p0 + tid < P)
      for (int k = 0; k < 8; ++k) out[k * CP + (size_t)c * P + p0 + tid] = 0;
    fill_plane(inc_q + c * TP, nullptr, T, P, p0, min(TILE, P - p0));
    fill_plane(rem_q + c * TP, nullptr, T, P, p0, min(TILE, P - p0));
    return;
  }

  // 0. Stage the design.
  stage(Xs, X + (size_t)c * T * K, T * K);
  __syncthreads();

  // 1. Score once, keep bits.  Thread (q, i): pixel i, words q, q+Q, ...
  const int i = tid % TILE;
  const int q = tid / TILE;
  const int p = p0 + i;
  const bool valid = p < P;
  const size_t cp = (size_t)c * P + (valid ? p : 0);
  const bool mon = valid && in_mon[cp] != 0;
  const int ck = mon ? cur_k[cp] : 0;
  {
    float coef[ND][K], dden_p[ND];
    if (mon) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        dden_p[d] = dden[cp * ND + d];
#pragma unroll
        for (int k = 0; k < K; ++k) coef[d][k] = coefs_d[(cp * ND + d) * K + k];
      }
    }
    const int band[ND] = {0, 1, 2, 3, 4};
    score_words<ND>(q, mon, mon, ck, alive + c * TP + p,
                    included + c * TP + p, nullptr,
                    Yd + (size_t)c * ND * TP + p, band, TP, T, P, Xs, coef,
                    dden_p, change_thr, outlier_thr, mA + i, mO + i, mE + i,
                    mI + i, nullptr);
  }
  __syncthreads();

  // 2. Events: thread i of warp 0 for pixel i (passes 1-3 on words).
  if (tid < TILE) {
    MonitorEvent e{};
    int n_pos = 0, t_pos = T;
    if (mon)
      e = word_event(mA + i, mO + i, mE + i, mI + i, W, T, ck, nlast[cp],
                     n_pos, t_pos);
    npos[i] = n_pos;
    tpos[i] = t_pos;
    if (valid) {
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
  }
  __syncthreads();

  // 3. The include / remove partition planes.
  if (!valid) return;
  const int n_pos = npos[i], t_pos = tpos[i];
  for (int w = q; w < W; w += Q) {
    const WordPartition pq = partition_word(
        mA[w * TILE + i], mO[w * TILE + i], mE[w * TILE + i], w, ck, n_pos,
        t_pos);
    write_word(inc_q + c * TP + p, P, w, T, pq.in_q);
    write_word(rem_q + c * TP + p, P, w, T, pq.rm_q);
  }
}

}  // namespace

// Yd [C,nb,T,P] int16, coefs_d [C,P,nb,8], dden [C,P,nb], X [C,T,8] f32,
// alive/included [C,T,P] u8, cur_k/nlast [C,P] i32, in_mon [C,P] u8, active
// [C,P] u8 or null -> out [8,C,P] i32 (m, is_tail, is_brk, is_refit,
//    ev_rank, pos_ev, n_exceed, n_rf), inc_q/rem_q [C,T,P] u8; all zero for
//    a pixel that does not monitor and on a tile with no active pixel.  nb
//    is the 5 detection bands.
extern "C" int fb_monitor_chain_scored(
    const void* Yd, const void* coefs_d, const void* dden, const void* X,
    const void* alive, const void* included, const void* cur_k,
    const void* nlast, const void* in_mon, void* out, void* inc_q,
    void* rem_q, const void* active, int C, int nb, int T, int P,
    float change_thr, float outlier_thr, void* stream) {
  if (nb != ND) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      monitor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  monitor_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int16_t*)Yd, (const float*)coefs_d, (const float*)dden,
      (const float*)X, (const uint8_t*)alive, (const uint8_t*)included,
      (const int*)cur_k, (const int*)nlast, (const uint8_t*)in_mon,
      (int*)out, (uint8_t*)inc_q, (uint8_t*)rem_q, (const uint8_t*)active, C,
      T, P, change_thr, outlier_thr);
  return (int)cudaGetLastError();
}
