// tmask_bad: the Tmask IRLS outlier screen on gathered windows, a tile of
// pixels a block.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::tmask_bad
// (_tmask_block, _tmask_core), which serves the JAX package's
// FIREBIRD_PALLAS=tmask route: there XLA gathers each initializing pixel's
// window members (their no-trend design rows, their Tmask-band values and a
// 0/1 slot validity) and the kernel runs the screen.  Per pixel:
// TMASK_IRLS_ITERS Huber reweightings of a weighted 5x5 SPD solve per band
// (unrolled Cholesky, NaN on a non-positive pivot so that nothing is
// flagged), MAD sigma from masked medians, and a flag where the final
// residual exceeds TMASK_CONST x the band's variogram — fb::tmask_warp
// (tmask_warp.cuh), the screen init_window runs.
//
// Bound: operations.  A pixel reads (NT + 3) x W floats and writes W
// bytes, but runs 6 solves per band, each a W-slot weighted Gram (~20 flops
// a slot) and a 5x5 Cholesky, and 10 medians of W values.  The design
// (tile.cuh's layout: TILE pixels a block of TILE_THREADS threads, warp g
// taking the tile's pixels g, g + 8, ...): a warp reads its pixel's window
// as the wrapper gathered it (Xtw [N, W, NT], Y2 [N, 2, W], w [N, W]: a
// pixel's rows contiguous, so the loads are coalesced and no transpose is
// needed), one slot a lane; a pixel with no member (no slot of weight > 0)
// gets all-false flags without a screen, which is exact: a flag is only
// ever raised on a member; the flags [N, W] go out a slot a lane.
// With ``active`` (pallas_ops' per-block skip guard, normally the in_init
// set), a tile with no active pixel writes all-false flags and reads
// nothing (fb::tile_active).
#include "tmask_warp.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int NWARP = THREADS / 32;
constexpr int MIN_BLOCKS = 4;

// Dynamic shared memory of a block of instance WMAX, in 4-byte words: the
// warps' areas (fb::TmaskArea).  cuda_ops.tmask_bad_smem_bytes computes the
// same.
size_t smem_words(int wmax) {
  return (size_t)NWARP * (fb::TM_ROWS * (wmax + 1) + fb::TM_SCRATCH);
}

template <int WMAX>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tmask_kernel(const float* __restrict__ xt, const float* __restrict__ y2,
             const float* __restrict__ w, const float* __restrict__ vario2,
             uint8_t* __restrict__ bad_out,
             const uint8_t* __restrict__ active, int N, int W) {
  using namespace fb;
  constexpr int S = WMAX / 32;
  extern __shared__ __align__(16) float smem[];
  const int p0 = blockIdx.x * TILE;
  const int n_px = min(TILE, N - p0);
  // The guard: a tile with no active pixel writes all-false flags (its
  // pixels' rows are contiguous).
  if (!tile_active(active, p0, n_px)) {
    for (int k = threadIdx.x; k < n_px * W; k += THREADS)
      bad_out[(size_t)p0 * W + k] = 0;
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const TmaskArea A(smem + warp * (TM_ROWS * (WMAX + 1) + TM_SCRATCH), WMAX);
  for (int pi = warp; pi < TILE; pi += NWARP) {
    const int p = p0 + pi;
    if (p >= N) break;
    const size_t pw = (size_t)p * W;
    float y0[S], y1[S], wv[S];
    bool any = false;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int s = lane + 32 * k;
      wv[k] = s < W ? w[pw + s] : 0.f;
      any = any || wv[k] > 0.f;
    }
    uint32_t bad = 0;
    if (__any_sync(FULL_WARP, any)) {
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int s = lane + 32 * k;
        y0[k] = y1[k] = 0.f;
        if (s < W) {
#pragma unroll
          for (int c = 0; c < NT; ++c)
            A.X[c * A.R + s] = xt[(pw + s) * NT + c];
          y0[k] = y2[2 * pw + s];
          y1[k] = y2[2 * pw + W + s];
        }
      }
      __syncwarp();
      bad = tmask_warp<WMAX>(A, y0, y1, wv, W,
                             TMASK_CONST * vario2[(size_t)p * 2],
                             TMASK_CONST * vario2[(size_t)p * 2 + 1], lane);
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int s = lane + 32 * k;
      if (s < W) bad_out[pw + s] = (bad >> k) & 1u;
    }
    __syncwarp();
  }
}

template <int WMAX>
int launch(const void* xt, const void* y2, const void* w, const void* vario2,
           void* bad, const void* active, int N, int W, cudaStream_t stream) {
  const size_t smem = smem_words(WMAX) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      tmask_kernel<WMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  tmask_kernel<WMAX><<<(N + TILE - 1) / TILE, THREADS, smem, stream>>>(
      (const float*)xt, (const float*)y2, (const float*)w,
      (const float*)vario2, (uint8_t*)bad, (const uint8_t*)active, N, W);
  return (int)cudaGetLastError();
}

template <int WMAX>
int geometry(int* out) {
  const auto kern = tmask_kernel<WMAX>;
  const size_t smem = smem_words(WMAX) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kern, THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  out[0] = (int)smem;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return (int)e;
}

}  // namespace

// Xtw [N,W,5], Y2 [N,2,W], w [N,W], vario2 [N,2] f32, active [N] u8 or null
// -> bad [N,W] u8 (all false on a tile of TILE pixels of the N with no active
// one).  N is the flattened chip x pixel count, w_max the instance (32, 64 or
// 128) that holds W.
extern "C" int fb_tmask_bad(const void* xt, const void* y2, const void* w,
                            const void* vario2, void* bad, const void* active,
                            int N, int W, int w_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > w_max) return (int)cudaErrorInvalidValue;
  switch (w_max) {
    case 32:
      return launch<32>(xt, y2, w, vario2, bad, active, N, W, s);
    case 64:
      return launch<64>(xt, y2, w, vario2, bad, active, N, W, s);
    case 128:
      return launch<128>(xt, y2, w, vario2, bad, active, N, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launch geometry of the w_max instance: out[0] the dynamic shared
// memory, out[1] the resident blocks an SM, out[2] the registers and out[3]
// the local bytes a thread.
extern "C" int fb_tmask_bad_geometry(int w_max, int* out) {
  switch (w_max) {
    case 32:
      return geometry<32>(out);
    case 64:
      return geometry<64>(out);
    case 128:
      return geometry<128>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
