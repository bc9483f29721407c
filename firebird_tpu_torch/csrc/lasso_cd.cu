// lasso_cd: the Lasso coordinate-descent loop on precomputed Gram systems,
// tiles of pixels a block, a band a lane.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::lasso_cd
// (_cd_block), which serves the JAX package's FIREBIRD_PALLAS=lasso route:
// there XLA computes the normalised Gram, the correlations and the floored
// diagonal, the kernel runs LASSO_ITERS cyclic sweeps on them (soft
// threshold LASSO_ALPHA, intercept unpenalized, coordinates outside the
// mask held at zero), and XLA computes the RMSE.
//
// Bound: operations.  A pixel reads 64 + 8*B + 8 floats and 8 mask bytes
// and writes 8*B floats (~0.8 KB) but runs, for each band with weight, 50
// sweeps of 8 coordinates, each a dot of 8 plus the soft threshold (~20
// flops): ~8 000 flops a band.  Each band's sweeps are a chain of 400
// dependent updates (a dot summed in order, a true division), ~45
// instructions and ~130 cycles of latency an update on the card: the
// kernel's time is the chains' instructions, so the design keeps enough
// chains in flight to fill every cycle, spends no instruction it can
// leave out, and runs no chain that has no weight.  On tile.cuh's tiles
// (TILE pixels):
//   1. A block walks its tiles (blockIdx.x, + gridDim.x, ...; as many
//      blocks as the card holds at once).  For each, every thread reads
//      the tile's c, G and diag rows (each array's rows of the tile lie
//      contiguous) in 16-byte loads and flags each pixel with a band whose
//      c row holds a nonzero, or whose G is not finite or diag not
//      positive and finite.  Warp 0 queues the flagged pixels (a ballot);
//      the others get +0 on every coefficient, written at once.
//   2. Once TILE pixels are queued (and at the end), the block stages
//      their Grams in shared memory and runs their chains, a band a lane
//      (B lanes a pixel).  A lane holds its c row, beta, the diagonal and
//      the mask in registers and reads the Gram a row an update (56
//      registers, 35 warps an SM; with the Gram in registers, 120 and 14).
//      A lane whose c row is all +-0, on a finite G with a positive finite
//      diagonal, writes +0 without its chain:
//      there rho is +0 at every update (each product with a +0 beta is
//      +-0, and +-0 + diag * +0 is +0), so the CD math gives +0 on every
//      coordinate.  The component route hands the kernel every pixel of
//      the chip, most with no weight on a late round: the queue packs the
//      pixels with weight of many tiles into full warps.
// With ``active`` (pallas_ops' per-block skip guard), a tile with no active
// pixel writes +0 betas and goes on to the next before step 1 (it reads
// nothing and leaves the queue as it was): an inactive pixel's system has
// zero correlations, whose betas are +0 (fb::tile_active).
#include "tile.cuh"

namespace {

using fb::K;
using fb::TILE;

// Resident warps an SM the launch bounds ask for (they cap the registers:
// a lane holds its c row, beta, the diagonal and the mask, and reads the
// Gram a row at a time).
constexpr int MIN_WARPS = 32;

// A band a lane: B lanes a pixel, TILE pixels a block.
template <int B>
struct Shape {
  static constexpr int threads = TILE * B;
  static constexpr int min_blocks =
      MIN_WARPS * 32 / threads > 0 ? MIN_WARPS * 32 / threads : 1;
};

// A staged Gram's floats in shared memory: 64 and four of padding, so that
// the pixels of a warp read their rows from distinct banks.
constexpr int GS_STRIDE = K * K + 4;
// Dynamic shared memory of a block, in bytes: a Gram a pixel of the tile,
// the queue of pixels (two tiles of ints) and its length, then a flag a
// pixel of the tile.  cuda_ops.lasso_cd_smem_bytes computes the same.
constexpr size_t SMEM_BYTES = 4 * (TILE * GS_STRIDE + 2 * TILE + 1) + TILE;

__device__ __forceinline__ bool positive_finite(float x) {
  return x > 0.f && x < INFINITY;
}

__device__ __forceinline__ bool all_finite(float4 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
}

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

// Row j of a Gram staged in shared memory (8 floats at row), two 16-byte
// loads a call that the compiler keeps inside the sweep: the chain reads a
// row an update rather than holding the Gram's 64 floats in registers.
__device__ __forceinline__ void gram_row(const float* row, float g[K]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(g[0]), "=f"(g[1]), "=f"(g[2]), "=f"(g[3])
               : "r"(a));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(g[4]), "=f"(g[5]), "=f"(g[6]), "=f"(g[7])
               : "r"(a + 16));
}

// fb::cd_loop<1>'s sweeps on one system whose Gram is staged in shared
// memory (Gs, rows of 8 floats).  The arithmetic and order are cd_loop's
// (a dot summed column by column, a true division by diag[j], the soft
// threshold), so beta is cd_loop's bit for bit.  One step is left out
// where it cannot change a bit: a soft-thresholded coordinate of +-0 (most
// coordinates a Lasso holds at zero) over a positive diag[j] is itself,
// so it is not divided (``positive``: every diag[j] > 0); the division's
// range check sends a zero dividend down its slow path.
__device__ __forceinline__ void cd_chain(const float* Gs, const float c[K],
                                         const float diag[K],
                                         const bool mask[K], bool positive,
                                         float beta[K]) {
  using fb::fsign;
  using fb::pmax;
#pragma unroll
  for (int k = 0; k < K; ++k) beta[k] = 0.f;
#pragma unroll 1
  for (int it = 0; it < fb::LASSO_ITERS; ++it) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float g[K];
      gram_row(Gs + j * K, g);
      float acc = g[0] * beta[0];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = acc + g[k] * beta[k];
      const float rho = c[j] - acc + diag[j] * beta[j];
      float bj;
      if (j == 0) {
        bj = rho / diag[0];
      } else {
        bj = fsign(rho) * pmax(fabsf(rho) - fb::LASSO_ALPHA, 0.f);
        if (bj != 0.f || !positive) bj = bj / diag[j];
      }
      beta[j] = mask[j] ? bj : 0.f;
    }
  }
}

// Band b of queued pixel p, whose Gram is staged at Gs: its diagonal and
// mask, its c row, the chain, the beta row out.
template <int B>
__device__ void band_chain(size_t p, int b, const float* Gs,
                           const float* __restrict__ c,
                           const float* __restrict__ diag,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ beta) {
  float d[K], cc[K], out[K];
  bool m[K];
  bool run = false;                   // the chain may not be skipped
  bool positive = true;               // every diag[j] > 0
#pragma unroll
  for (int q = 0; q < K * K / 4; ++q)
    run = run || !all_finite(reinterpret_cast<const float4*>(Gs)[q]);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    d[j] = diag[p * K + j];
    run = run || !positive_finite(d[j]);
    positive = positive && d[j] > 0.f;
    m[j] = mask[p * K + j] != 0;
  }
  const float4* c4 = reinterpret_cast<const float4*>(c + (p * B + b) * K);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = c4[h];
    run = run || nonzero(v);
    cc[4 * h] = v.x;
    cc[4 * h + 1] = v.y;
    cc[4 * h + 2] = v.z;
    cc[4 * h + 3] = v.w;
  }
  if (run) {
    cd_chain(Gs, cc, d, m, positive, out);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = 0.f;
  }
  float4* o = reinterpret_cast<float4*>(beta + (p * B + b) * K);
  o[0] = make_float4(out[0], out[1], out[2], out[3]);
  o[1] = make_float4(out[4], out[5], out[6], out[7]);
}

// Runs the chains of the first min(queued, TILE) queued pixels (their
// Grams staged in Gs first, GS_STRIDE floats apart), then moves the rest
// of the queue to its front.  Called by the whole block.
template <int B>
__device__ void run_queue(float* Gs, int* queue, int* queued,
                          const float* G, const float* c, const float* diag,
                          const uint8_t* mask, float* beta) {
  const int tid = threadIdx.x;
  const int n = min(*queued, TILE);
  for (int k = tid; k < n * K * K / 4; k += Shape<B>::threads) {
    const int g = k / (K * K / 4), q = k % (K * K / 4);
    reinterpret_cast<float4*>(Gs + g * GS_STRIDE)[q] =
        reinterpret_cast<const float4*>(G + (size_t)queue[g] * K * K)[q];
  }
  __syncthreads();
  const int g = tid / B;
  if (g < n)
    band_chain<B>((size_t)queue[g], tid % B, Gs + g * GS_STRIDE, c, diag,
                  mask, beta);
  const int rest = *queued - n;
  const int moved = tid < rest ? queue[n + tid] : 0;
  __syncthreads();
  if (tid < rest) queue[tid] = moved;
  if (tid == 0) *queued = rest;
  __syncthreads();
}

template <int B>
__global__ void __launch_bounds__(Shape<B>::threads, Shape<B>::min_blocks)
lasso_cd_kernel(const float* __restrict__ G, const float* __restrict__ c,
                const float* __restrict__ diag,
                const uint8_t* __restrict__ mask, float* __restrict__ beta,
                const uint8_t* __restrict__ active, int N) {
  constexpr int THREADS = Shape<B>::threads;
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;                           // [TILE][GS_STRIDE]
  int* queue = reinterpret_cast<int*>(Gs + TILE * GS_STRIDE);   // [2 TILE]
  int* queued = queue + 2 * TILE;
  uint8_t* flagged = reinterpret_cast<uint8_t*>(queued + 1);   // [TILE]

  const int tid = threadIdx.x;
  if (tid == 0) *queued = 0;
  const int tiles = (N + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t base = (size_t)tile * TILE;
    const int n = min(TILE, N - (int)base);
    float4* out4 = reinterpret_cast<float4*>(beta + base * B * K);

    // The guard: a tile with no active pixel writes +0 betas.
    if (!fb::tile_active(active, base, n)) {
      for (int k = tid; k < n * B * K / 4; k += THREADS)
        out4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }

    // 1. Flag the tile's pixels with a chain to run.
    if (tid < TILE) flagged[tid] = 0;
    __syncthreads();
    const float4* c4 = reinterpret_cast<const float4*>(c + base * B * K);
    for (int k = tid; k < n * B * K / 4; k += THREADS)
      if (nonzero(c4[k])) flagged[4 * k / (B * K)] = 1;
    const float4* G4 = reinterpret_cast<const float4*>(G + base * K * K);
    for (int k = tid; k < n * K * K / 4; k += THREADS)
      if (!all_finite(G4[k])) flagged[4 * k / (K * K)] = 1;
    for (int k = tid; k < n * K; k += THREADS)
      if (!positive_finite(diag[base * K + k])) flagged[k / K] = 1;
    __syncthreads();
    if (tid < 32) {
      const bool on = tid < n && flagged[tid] != 0;
      const uint32_t all = __ballot_sync(~0u, on);
      const int at = *queued;
      if (on) queue[at + __popc(all & fb::below(0, tid))] = (int)base + tid;
      __syncwarp();
      if (tid == 0) *queued = at + __popc(all);
    }
    // The others' betas are +0.
    for (int k = tid; k < n * B * K / 4; k += THREADS)
      if (!flagged[4 * k / (B * K)]) out4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // 2. A full tile's worth queued: run it.
    if (*queued >= TILE)
      run_queue<B>(Gs, queue, queued, G, c, diag, mask, beta);
  }
  while (*queued > 0) run_queue<B>(Gs, queue, queued, G, c, diag, mask, beta);
}

template <int B>
int launch(const void* G, const void* c, const void* diag, const void* mask,
           void* beta, const void* active, int N, cudaStream_t stream) {
  if (N <= 0) return 0;
  const auto kern = lasso_cd_kernel<B>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, Shape<B>::threads, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // As many blocks as the card holds at once, each walking its tiles.
  const int tiles = (N + TILE - 1) / TILE;
  const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const int grid = tiles < resident ? tiles : resident;
  kern<<<grid, Shape<B>::threads, SMEM_BYTES, stream>>>(
      (const float*)G, (const float*)c, (const float*)diag,
      (const uint8_t*)mask, (float*)beta, (const uint8_t*)active, N);
  return (int)cudaGetLastError();
}

template <int B>
int geometry(int* out) {
  const auto kern = lasso_cd_kernel<B>;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], kern, Shape<B>::threads, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  out[0] = (int)SMEM_BYTES;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return (int)e;
}

}  // namespace

// G [N,8,8], c [N,nb,8], diag [N,8] f32, mask [N,8] u8, active [N] u8 or
// null -> beta [N,nb,8] f32 (+0 on a tile of TILE pixels of the N with no
// active one), N the flattened chip x pixel count, nb one of fb::with_nb's
// band counts; G, c, diag and beta 16-byte aligned.
extern "C" int fb_lasso_cd(const void* G, const void* c, const void* diag,
                           const void* mask, void* beta, const void* active,
                           int N, int nb, void* stream) {
  return fb::with_nb(nb, [&](auto nbc) {
    return launch<decltype(nbc)::value>(G, c, diag, mask, beta, active, N,
                                        (cudaStream_t)stream);
  });
}

// The launch geometry of the nb-band instance: out[0] the dynamic shared
// memory, out[1] the resident blocks an SM, out[2] the registers and out[3]
// the local bytes a thread.
extern "C" int fb_lasso_cd_geometry(int nb, int* out) {
  return fb::with_nb(nb, [&](auto nbc) {
    return geometry<decltype(nbc)::value>(out);
  });
}
