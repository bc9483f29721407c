// monitor_chain: the MONITOR round's event chain on a precomputed score
// plane, a tile of pixels a block.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::monitor_chain
// (_monitor_block, _monitor_logic), which serves the JAX package's
// FIREBIRD_PALLAS=monitor route: there XLA computes the [P,T] chi-square
// score plane and the kernel runs the event logic on it.  Per monitoring
// pixel: the alive ranks (counted here; the Pallas kernel takes them as an
// input plane), the break search, the refit search, the tail/break/refit
// choice and the include/remove partition.  A pixel that does not monitor
// gets the zero outputs of kernel._mon_zeros (every consumer masks it on
// in_mon) and costs no reads.
//
// Bound: bytes (the alive and included planes, the score plane at the
// monitoring pixels' eligible steps, the two partition planes out); there
// is no float arithmetic beyond the threshold compares.  The design is
// monitor_chain_scored's (tile.cuh's layout, word_monitor.cuh) with the
// score bits read from the plane:
//   1. Warp q takes words q, q + TILE_Q, ... of its tile (a short series,
//      fewer words than warps, splits each word's 32 steps over
//      TILE_Q / W warps); lane i is pixel i, so at each step a warp's
//      loads are one row of the tile: 32 bytes of the alive and included
//      planes, 128 of s.  Each plane is read once, s only at the alive
//      steps t >= cur_k, and two bits of each score kept: s > outlier and
//      s > change (strict, as _monitor_logic: a NaN sets neither).  The
//      alive and included columns become words too, in shared memory.
//   2. One thread a pixel runs passes 1-3 on the words (fb::word_event).
//   3. Every thread writes its steps' rows of the two partition planes
//      (fb::partition_word), lane = pixel at each step.
// With ``active`` (pallas_ops' per-block skip guard, normally in_mon), a
// tile with no active pixel writes the zero outputs and reads nothing
// (fb::tile_active).
#include "word_monitor.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int Q = fb::TILE_Q;
constexpr int MIN_BLOCKS = 8;         // 64 warps an SM (32 registers)

// Dynamic shared memory of a block for T time steps, in 4-byte words: the
// alive / outlier / change / included words and the partition bounds.
// cuda_ops.monitor_chain_smem_bytes computes the same.
size_t smem_words(int T) {
  const int W = (T + 31) / 32;
  return (size_t)4 * W * TILE + 2 * TILE;
}

// Warps that share a word of the series: every warp has steps to read
// when the series has fewer words than the block has warps (Sentinel-2's
// 64 steps are two words), 32 / parts steps each.  A power of two, as Q is.
__device__ __forceinline__ int word_parts(int W) { return W < Q ? Q / W : 1; }

// The words of pixel i into shared memory (pre-zeroed; this thread's
// part q: the steps of slices q, q + Q, ... of the W * word_parts(W)),
// each mask's word w at [w * TILE] from the pointer given (already offset
// to the pixel): A alive, I included, and O / E the scores above the
// outlier / change threshold at the eligible steps (alive, t >= ck).  al,
// inc and sp are the pixel's columns (stride P), read only where the
// pixel monitors (else every word is 0).
__device__ void plane_words(int q, bool mon, int ck, const uint8_t* al,
                            const uint8_t* inc, const float* sp, int T, int P,
                            float change_thr, float outlier_thr, uint32_t* A,
                            uint32_t* O, uint32_t* E, uint32_t* I) {
  using fb::below;
  const int W = (T + 31) / 32, parts = word_parts(W), span = 32 / parts;
  if (!__any_sync(~0u, mon)) return;
  for (int u = q; u < W * parts; u += Q) {
    const int w = u / parts, j0 = u % parts * span;
    const int j1 = min(j0 + span, T - 32 * w);
    uint32_t a = 0, in = 0, o = 0, e = 0;
#pragma unroll 8
    for (int j = j0; j < j1; ++j) {
      if (mon) {
        const size_t at = (size_t)(32 * w + j) * P;
        a |= (uint32_t)(al[at] != 0) << j;
        in |= (uint32_t)(inc[at] != 0) << j;
      }
    }
    const uint32_t r = mon ? a & ~below(w, ck) : 0u;
    if (__any_sync(~0u, r != 0)) {
#pragma unroll 8
      for (int j = j0; j < j1; ++j) {
        if ((r >> j) & 1u) {
          const float v = sp[(size_t)(32 * w + j) * P];
          o |= (uint32_t)(v > outlier_thr) << j;
          e |= (uint32_t)(v > change_thr) << j;
        }
      }
    }
    atomicOr(&A[w * TILE], a);
    atomicOr(&O[w * TILE], o);
    atomicOr(&E[w * TILE], e);
    atomicOr(&I[w * TILE], in);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
monitor_plane_kernel(const float* __restrict__ s,
                     const uint8_t* __restrict__ alive,
                     const uint8_t* __restrict__ included,
                     const int* __restrict__ cur_k,
                     const int* __restrict__ nlast,
                     const uint8_t* __restrict__ in_mon, int* __restrict__ out,
                     uint8_t* __restrict__ inc_q, uint8_t* __restrict__ rem_q,
                     const uint8_t* __restrict__ active, int C, int T, int P,
                     float change_thr, float outlier_thr) {
  using namespace fb;
  extern __shared__ __align__(16) uint32_t smw[];
  const int W = (T + 31) / 32;
  uint32_t* mA = smw;
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

  // 1. The words.  Thread (q, i): pixel i, slices q, q+Q, ...
  for (int k = tid; k < 4 * W * TILE; k += THREADS) smw[k] = 0u;
  __syncthreads();
  const int i = tid % TILE;
  const int q = tid / TILE;
  const int p = p0 + i;
  const bool valid = p < P;
  const size_t cp = (size_t)c * P + (valid ? p : 0);
  const bool mon = valid && in_mon[cp] != 0;
  const int ck = mon ? cur_k[cp] : 0;
  const size_t col = c * TP + (valid ? p : 0);
  plane_words(q, mon, ck, alive + col, included + col, s + col, T, P,
              change_thr, outlier_thr, mA + i, mO + i, mE + i, mI + i);
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

  // 3. The include / remove partition planes, a byte a step of this
  // thread's slices.
  if (!valid) return;
  const int n_pos = npos[i], t_pos = tpos[i];
  const int parts = word_parts(W), span = 32 / parts;
  for (int u = q; u < W * parts; u += Q) {
    const int w = u / parts, j0 = u % parts * span;
    const int j1 = min(j0 + span, T - 32 * w);
    const WordPartition pq = partition_word(
        mA[w * TILE + i], mO[w * TILE + i], mE[w * TILE + i], w, ck, n_pos,
        t_pos);
    for (int j = j0; j < j1; ++j) {
      const size_t at = col + (size_t)(32 * w + j) * P;
      inc_q[at] = (pq.in_q >> j) & 1u;
      rem_q[at] = (pq.rm_q >> j) & 1u;
    }
  }
}

}  // namespace

// s [C,T,P] f32, alive/included [C,T,P] u8, cur_k/nlast [C,P] i32, in_mon
// [C,P] u8, active [C,P] u8 or null -> out [8,C,P] i32 (m, is_tail, is_brk,
// is_refit, ev_rank, pos_ev, n_exceed, n_rf), inc_q/rem_q [C,T,P] u8; all
// zero for a pixel that does not monitor and on a tile with no active pixel.
extern "C" int fb_monitor_chain(const void* s, const void* alive,
                                const void* included, const void* cur_k,
                                const void* nlast, const void* in_mon,
                                void* out, void* inc_q, void* rem_q,
                                const void* active, int C, int T, int P,
                                float change_thr, float outlier_thr,
                                void* stream) {
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      monitor_plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  monitor_plane_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)s, (const uint8_t*)alive, (const uint8_t*)included,
      (const int*)cur_k, (const int*)nlast, (const uint8_t*)in_mon, (int*)out,
      (uint8_t*)inc_q, (uint8_t*)rem_q, (const uint8_t*)active, C, T, P,
      change_thr, outlier_thr);
  return (int)cudaGetLastError();
}

// The launch geometry at T: out[0] the dynamic shared memory, out[1] the
// resident blocks an SM, out[2] the registers and out[3] the local bytes a
// thread.
extern "C" int fb_monitor_chain_geometry(int T, int* out) {
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      monitor_plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], monitor_plane_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, monitor_plane_kernel);
  out[0] = (int)smem;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return (int)e;
}
