// The block layout of the tile kernels (fused_round, lasso_fit,
// monitor_chain_scored, fused_fit_close, detect_mega, monitor_chain; and
// lasso_cd's tiles, a band a lane) and the word helpers they share.
//
// A block owns TILE neighbouring pixels of one chip with TILE_THREADS
// threads: thread tid works for pixel i = tid % TILE as part q = tid / TILE
// of its TILE_Q threads (scoring and the column words), or as lane
// l = tid % TILE_Q of group g = tid / TILE_Q (the dense fit of listed pixel
// g).  A boolean time column of a pixel is held as ceil(T/32) 32-bit words
// in shared memory, bit j of word w for time step 32w + j, word w of pixel
// i at [w * TILE + i]: the word helpers below take a pointer already
// offset to the pixel and step by TILE.
#pragma once

#include "ccd_common.cuh"

namespace fb {

constexpr int TILE = 32;                       // pixels a block
constexpr int TILE_THREADS = 256;
constexpr int TILE_Q = TILE_THREADS / TILE;    // threads (lanes) a pixel

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
__device__ inline int count_below(const uint32_t* m, int W, int t) {
  int n = 0;
  for (int w = 0; w < W && 32 * w < t; ++w) n += __popc(m[w * TILE] & below(w, t));
  return n;
}

// The time step of the set bit of rank r of mask m, T when r >= its count.
__device__ inline int step_of_rank(const uint32_t* m, int W, int T, int r) {
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

// The block's copy of n floats (a chip's design, its days) into shared
// memory; the caller synchronises before reading it.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int k = threadIdx.x; k < n; k += TILE_THREADS) dst[k] = src[k];
}

// Word w of a pixel's byte or float column (col at the pixel, stride P):
// bit j set where step 32w + j < T is nonzero.
template <class V>
__device__ __forceinline__ uint32_t column_word(const V* col, int P, int w,
                                                int T) {
  uint32_t v = 0;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int t = 32 * w + j;
    if (t < T) v |= (uint32_t)(col[(size_t)t * P] != 0) << j;
  }
  return v;
}

// A dead tile's planes (the skip guard's fill): for the tile's n pixels
// from p0 of a [T, P] byte plane, dst = src (a copy) where src is given,
// else 0; every thread of the block, a 32-byte row of the tile a time step.
__device__ __forceinline__ void fill_plane(uint8_t* dst, const uint8_t* src,
                                           int T, int P, int p0, int n) {
  for (int k = threadIdx.x; k < T * TILE; k += TILE_THREADS) {
    const int i = k % TILE;
    if (i >= n) continue;
    const size_t at = (size_t)(k / TILE) * P + p0 + i;
    dst[at] = src ? src[at] : 0;
  }
}

// Writes word w's bits into a pixel's byte column (col at the pixel,
// stride P), one byte a time step below T.
__device__ __forceinline__ void write_word(uint8_t* col, int P, int w, int T,
                                           uint32_t bits) {
  const int hi = min(32, T - 32 * w);
  for (int j = 0; j < hi; ++j) col[(size_t)(32 * w + j) * P] = (bits >> j) & 1u;
}

// The per-tile skip guard (pallas_ops._when_active on this layout): whether
// the tile's n pixels from cp0 hold an active lane (active[cp0 + i] != 0,
// i < n), true where ``active`` is null (the unguarded call).  Called by
// every thread of the block, before its first barrier of the tile: the
// answer is the whole block's, so a tile that leaves early leaves whole and
// no thread is left at a __syncthreads.  Needs at least TILE threads.
__device__ __forceinline__ bool tile_active(const uint8_t* active, size_t cp0,
                                            int n) {
  if (active == nullptr) return true;
  const int i = threadIdx.x;
  return __syncthreads_or(i < n && active[cp0 + i] != 0) != 0;
}

// Run by the TILE threads of warp 0, thread i for pixel i: the block's
// pixels with ``listed`` set get consecutive slots in the order of their
// index (a warp ballot).  Returns pixel i's slot; *count receives the number
// listed.
__device__ __forceinline__ int list_pixels(bool listed, int i, int* count) {
  const uint32_t all = __ballot_sync(~0u, listed);
  if (i == 0) *count = __popc(all);
  return __popc(all & below(0, i));
}

}  // namespace fb
