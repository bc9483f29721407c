// init_window: the INIT round of the event loop, a tile of pixels a block.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::init_window
// (_init_window_block, _init_logic, with _tmask_core and _gram_cd_core
// inlined).  Its outputs are those of fb::init_pixel (init_window.cuh, the
// one-thread body detect_mega runs) bit for bit, on every pixel.
//
// Bound: bytes on a state with few initializing pixels (the alive plane in,
// the w_stab and alive_init planes out), operations on one where most
// initialize (the Tmask IRLS, the stability fit's CD loop).  The design
// (tile.cuh's layout: TILE pixels of one chip, TILE_THREADS threads):
//   0. The block turns its pixels' alive columns into 32-step words in
//      shared memory, TILE_Q threads a pixel, a warp's 32 pixels reading
//      one 32-byte row a time step.
//   1. Warp 0, one thread a pixel, finds every pixel's window on the words
//      (the first set bit at or after the cursor, the first member from
//      rank MEOW_SIZE - 1 on whose day passes INIT_DAYS, the next alive
//      step) and lists the initializing pixels with a window by ballot.
//      A tile with none writes its planes and is done.
//   2. One warp a listed pixel runs the Tmask screen (fb::tmask_warp,
//      tmask_warp.cuh): the members' values and no-trend design rows
//      gathered one slot a lane, then the warp-cooperative IRLS.  A
//      flagged member's alive bit is cleared in place.
//   3. The pixels that passed are listed again and fitted by fb::dense_fit
//      (TILE_Q lanes a pixel, coefficients k < 4, the sensor's detection
//      bands) over their alive words restricted to [i, j]: the one-thread
//      Gram::add fit's coefficients, bit for bit.
//   4. One warp a fitted pixel takes the stability test: the window's
//      residuals one slot a lane, each band's squared residuals summed in
//      slot order by one lane.
//   5. Warp 0 writes the per-pixel outputs; the block writes the
//      alive_init and w_stab planes from the words in 32-byte rows.
// The designs and days are read through the read-only cache.  Shared
// memory grows with T (one word column: 4 T bytes a tile) and W_MAX, and
// fits the card up to T = 32 767 at W_MAX 128 (smem_words).
#include "dense_fit.cuh"
#include "tmask_warp.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int Q = fb::TILE_Q;
constexpr int NWARP = THREADS / 32;
constexpr int MIN_BLOCKS = 4;
constexpr int NSTATE = 8;       // ints a pixel: i, j, cnt, tm, stab, keep,
                                // and the two lists

// A warp's window area in floats: the screen's rows (fb::TmaskArea: the
// no-trend design rows of the slots, then the stability test's squared
// residuals; R = WMAX + 1 a row) and its scratch (the test's first and
// last residuals), then the member steps.
template <int WMAX>
__host__ __device__ constexpr int area_floats() {
  return fb::TM_ROWS * (WMAX + 1) + fb::TM_SCRATCH + WMAX;
}

// Dynamic shared memory of a block at T, in 4-byte words: the alive words,
// the per-pixel state and two counts, the fits' coefficients and rmse
// rows, then the warps' areas (the fit's Grams alias them).
// cuda_ops.init_window_smem_bytes computes the same.
template <int WMAX>
size_t smem_words(int T) {
  const int Wd = (T + 31) / 32;
  const size_t areas = (size_t)NWARP * area_floats<WMAX>();
  const size_t grams = (size_t)TILE * fb::GSTRIDE;
  return (size_t)Wd * TILE + NSTATE * TILE + 4 +
         (size_t)TILE * fb::NDET * (fb::K + 1) +
         (areas > grams ? areas : grams);
}

// The spectra band of detection band b (dense_fit's band map).
struct InitBands {
  fb::Roles r;
  __device__ int operator()(int b) const {
    return b == 0 ? r.det[0]
                  : b == 1 ? r.det[1]
                           : b == 2 ? r.det[2] : b == 3 ? r.det[3] : r.det[4];
  }
};

// The first set bit at or after step t of a pixel's words (stride TILE),
// -1 when none.
__device__ int first_from(const uint32_t* col, int Wd, int t) {
  t = max(t, 0);
  for (int w = t >> 5; w < Wd; ++w) {
    const uint32_t v = col[w * TILE] & ~fb::below(w, t);
    if (v) return 32 * w + __ffs(v) - 1;
  }
  return -1;
}

// The time step of window member s: the set bit of rank s counted from
// step i (alive).
__device__ __forceinline__ int member_step(const uint32_t* col, int Wd, int i,
                                           int s) {
  const int w0 = i >> 5;
  const int skip = __popc(col[w0 * TILE] & fb::below(w0, i));
  return 32 * w0 +
         fb::step_of_rank(col + w0 * TILE, Wd - w0, 32 * (Wd - w0), s + skip);
}

template <int WMAX>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
init_kernel(const uint8_t* __restrict__ alive, const int* __restrict__ cur_i,
            const uint8_t* __restrict__ in_init, const float* __restrict__ tt,
            const float* __restrict__ X, const float* __restrict__ Xt,
            const int16_t* __restrict__ Yt, const float* __restrict__ vario,
            uint8_t* __restrict__ flags, int* __restrict__ out,
            uint8_t* __restrict__ w_stab,
            uint8_t* __restrict__ alive_out, fb::Roles roles, int C, int nb,
            int T, int P, int W) {
  using namespace fb;
  constexpr int S = WMAX / 32;
  constexpr int R = WMAX + 1;
  extern __shared__ __align__(16) float smem[];
  const int Wd = (T + 31) / 32;
  uint32_t* mA = reinterpret_cast<uint32_t*>(smem);
  int* s_i = reinterpret_cast<int*>(mA + Wd * TILE);
  int* s_j = s_i + TILE;
  int* s_cnt = s_j + TILE;
  int* s_tm = s_cnt + TILE;
  int* s_stab = s_tm + TILE;
  int* s_keep = s_stab + TILE;
  int* tlist = s_keep + TILE;
  int* flist = tlist + TILE;
  int* ntm = flist + TILE;
  int* nfit = ntm + 1;
  float* c4s = reinterpret_cast<float*>(ntm + 4);       // [TILE][NDET*K]
  float* r4s = c4s + TILE * NDET * K;                   // [TILE][NDET]
  float* areas = r4s + TILE * NDET;                     // the Grams alias

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * TILE;
  const size_t TP = (size_t)T * P;
  const float* tc = tt + (size_t)c * T;
  const float* Xc = X + (size_t)c * T * K;
  const float* Xtc = Xt + (size_t)c * T * NT;
  const int16_t* Yc = Yt + (size_t)c * nb * TP;

  // 0. The alive words, thread (q, i): pixel i, words q, q+Q, ...
  {
    const int i = tid % TILE;
    const bool valid = p0 + i < P;
    for (int v = tid / TILE; v < Wd; v += Q)
      mA[v * TILE + i] =
          valid ? column_word(alive + (size_t)c * TP + p0 + i, P, v, T) : 0u;
  }
  __syncthreads();

  // 1. Every pixel's window (warp 0, lane i = pixel i).
  int wi = 0, wj = 0, cnt = 0, i_adv = 0;
  bool valid = false, init = false, has_w = false, has_adv = false;
  if (warp == 0) {
    const int i = lane;
    const uint32_t* col = mA + i;
    valid = p0 + i < P;
    const size_t cp = (size_t)c * P + p0 + i;
    init = valid && in_init[cp] != 0;
    const int ci = valid ? cur_i[cp] : 0;
    const int fi = first_from(col, Wd, ci);
    const bool has_i = fi >= 0;
    wi = has_i ? fi : 0;
    // j: the first member from rank MEOW - 1 on whose day passes INIT_DAYS.
    const float t_i = __ldg(tc + wi);
    bool has_w_raw = false;
    for (int w = wi >> 5; w < Wd && !has_w_raw; ++w) {
      uint32_t v = col[w * TILE] & ~below(w, wi);
      const int pc = __popc(v);
      if (cnt + pc < MEOW) {
        cnt += pc;
        continue;
      }
      for (; v; v &= v - 1u) {
        const int t = 32 * w + __ffs(v) - 1;
        if (++cnt >= MEOW && __ldg(tc + t) - t_i >= INIT_DAYS) {
          wj = t;
          has_w_raw = true;
          break;
        }
      }
    }
    has_w = has_i && has_w_raw;
    const int fa = first_from(col, Wd, wi + 1);
    has_adv = fa >= 0;
    i_adv = has_adv ? fa : 0;
    const bool work = init && has_w;
    s_i[i] = wi;
    s_j[i] = wj;
    s_cnt[i] = cnt;
    s_tm[i] = 0;
    s_stab[i] = 0;
    s_keep[i] = 0;
    const int slot = list_pixels(work, i, ntm);
    if (work) tlist[slot] = i;
  }
  __syncthreads();
  const int n_tm = *ntm;

  if (n_tm > 0) {
    const TmaskArea A(areas + warp * area_floats<WMAX>(), WMAX);
    int* pos = reinterpret_cast<int*>(A.scratch + TM_SCRATCH);
    const InitBands det{roles};
    const int tb0 = det(roles.tm[0]), tb1 = det(roles.tm[1]);

    // 2. The Tmask screen, one warp a listed pixel: the members' no-trend
    // design rows and Tmask-band values gathered one slot a lane.
    for (int g = warp; g < n_tm; g += NWARP) {
      const int pi = tlist[g];
      uint32_t* col = mA + pi;
      const int i0 = s_i[pi];
      const int n = min(s_cnt[pi], W);
      const int16_t* Yp = Yc + p0 + pi;
      float y0[S], y1[S], w1[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int s = lane + 32 * k;
        y0[k] = y1[k] = 0.f;
        w1[k] = 1.f;
        if (s < n) {
          const int t = member_step(col, Wd, i0, s);
          pos[s] = t;
#pragma unroll
          for (int kk = 0; kk < NT; ++kk)
            A.X[kk * R + s] = __ldg(Xtc + t * NT + kk);
          y0[k] = (float)Yp[((size_t)tb0 * T + t) * P];
          y1[k] = (float)Yp[((size_t)tb1 * T + t) * P];
        }
      }
      __syncwarp();
      const float* vrow = vario + ((size_t)c * P + p0 + pi) * nb;
      const uint32_t bad = tmask_warp<WMAX>(
          A, y0, y1, w1, n, TMASK_CONST * vrow[tb0], TMASK_CONST * vrow[tb1],
          lane);
#pragma unroll
      for (int k = 0; k < S; ++k)
        if ((bad >> k) & 1u) {
          const int t = pos[lane + 32 * k];
          atomicAnd(&col[(t >> 5) * TILE], ~(1u << (t & 31)));
        }
      const bool any = __any_sync(FULL_WARP, bad != 0);
      if (lane == 0) s_tm[pi] = any;
      __syncwarp();
    }
    __syncthreads();

    // 3. The stability fit of the pixels that passed, over their alive
    // words restricted to [i, j] (the edge words masked while it reads).
    uint32_t e0 = 0, e1 = 0;
    if (warp == 0) {
      const bool keep = init && has_w && !s_tm[lane];
      const int slot = list_pixels(keep, lane, nfit);
      if (keep) {
        flist[slot] = lane;
        s_keep[lane] = 1;
        uint32_t* col = mA + lane;
        e0 = col[(wi >> 5) * TILE];
        e1 = col[(wj >> 5) * TILE];
        col[(wi >> 5) * TILE] = e0 & ~below(wi >> 5, wi);
        col[(wj >> 5) * TILE] &= below(wj >> 5, wj + 1);
      }
    }
    __syncthreads();
    const int n_fit = *nfit;
    if (n_fit > 0) {
      const int g = tid / Q, l = tid % Q;
      const bool fits = g < n_fit;
      const int fi = fits ? flist[g] : 0;
      const int w0 = fits ? s_i[fi] >> 5 : 0;
      const int w1 = fits ? s_j[fi] >> 5 : 0;
      bool m4[K];
#pragma unroll
      for (int k = 0; k < K; ++k) m4[k] = k < 4;
      dense_fit<NDET>(fits, l, mA + w0 * TILE + fi, w1 - w0 + 1,
                      Yc + p0 + fi + (size_t)32 * w0 * P, TP, P,
                      Xc + (size_t)32 * w0 * K, areas + g * GSTRIDE, m4,
                      false, c4s + g * NDET * K, r4s + g * NDET,
                      InitBands{roles});
      // dense_fit's barrier is behind every read of the words.
      if (warp == 0 && s_keep[lane]) {
        uint32_t* col = mA + lane;
        col[(wj >> 5) * TILE] = e1;
        col[(wi >> 5) * TILE] = e0;
      }
    }
    __syncthreads();

    // 4. The stability test, one warp a fitted pixel.
    for (int g = warp; g < n_fit; g += NWARP) {
      const int pi = flist[g];
      const uint32_t* col = mA + pi;
      const int i0 = s_i[pi], j0 = s_j[pi], cn = s_cnt[pi];
      const int n = min(cn, W);
      const int16_t* Yp = Yc + p0 + pi;
      const float* c4 = c4s + g * NDET * K;
      float* rf = A.scratch;                     // r_first, r_last by band
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int s = lane + 32 * k;
        if (s < n) {
          const int t = member_step(col, Wd, i0, s);
          float x[K];
#pragma unroll
          for (int kk = 0; kk < K; ++kk) x[kk] = __ldg(Xc + t * K + kk);
#pragma unroll
          for (int d = 0; d < NDET; ++d) {
            const float y = (float)Yp[((size_t)roles.det[d] * T + t) * P];
            float pred = c4[d * K] * x[0];
#pragma unroll
            for (int kk = 1; kk < K; ++kk)
              pred = pred + c4[d * K + kk] * x[kk];
            const float rr = y - pred;
            A.X[d * R + s] = rr * rr;
            if (s == 0) rf[d] = rr;
            if (s == cn - 1) rf[NDET + d] = rr;
          }
        }
      }
      __syncwarp();
      bool ok = true;
      if (lane < NDET) {
        const int d = lane;
        float acc = 0.f;
        for (int s = 0; s < n; ++s) acc = acc + A.X[d * R + s];
        const float n4 = fmaxf((float)n, 1.f);
        const float r4 = sqrtf(pmax(acc / n4, 0.f));
        const float denom =
            STAB * pmax(r4, vario[((size_t)c * P + p0 + pi) * nb + det(d)]);
        const float span = __ldg(tc + j0) - __ldg(tc + i0);
        const float slope_day = c4[d * K + 1] / 365.25f;
        const float r_first = rf[d];
        const float r_last = cn <= n ? rf[NDET + d] : 0.f;
        ok = (fabsf(slope_day * span) <= denom) && (fabsf(r_first) <= denom) &&
             (fabsf(r_last) <= denom);
      }
      const bool stable = __all_sync(FULL_WARP, ok);
      if (lane == 0) s_stab[pi] = stable;
      __syncwarp();
    }
    __syncthreads();
  }

  // 5. The per-pixel outputs (warp 0) and the planes (the block).
  if (warp == 0 && valid) {
    const int i = lane;
    const int fn = first_from(mA + i, Wd, wi);
    const bool work = init && has_w;
    const bool tm = work && s_tm[i];
    const bool stable = s_stab[i] != 0;
    const size_t cp = (size_t)c * P + p0 + i;
    const size_t CP = (size_t)C * P;
    flags[0 * CP + cp] = init && !has_w;          // init_nowin
    flags[1 * CP + cp] = tm;                      // init_tm
    flags[2 * CP + cp] = work && !tm && stable;   // init_ok
    flags[3 * CP + cp] = work && !tm && !stable;  // init_bad
    flags[4 * CP + cp] = has_adv;
    out[0 * CP + cp] = fn >= 0 ? fn : T;          // i_next_tm
    out[1 * CP + cp] = i_adv;
    out[2 * CP + cp] = wj;
    out[3 * CP + cp] = work && !tm ? cnt : 0;     // n_ok
  }
  {
    const int i = tid % TILE;
    if (p0 + i < P) {
      const bool keep = s_keep[i] != 0;
      const int i0 = s_i[i], j0 = s_j[i];
      const size_t off = (size_t)c * TP + p0 + i;
      for (int v = tid / TILE; v < Wd; v += Q) {
        const uint32_t a = mA[v * TILE + i];
        write_word(alive_out + off, P, v, T, a);
        write_word(w_stab + off, P, v, T,
                   keep ? a & below(v, j0 + 1) & ~below(v, i0) : 0u);
      }
    }
  }
}

template <int WMAX>
int launch(const void* alive, const void* cur_i, const void* in_init,
           const void* t, const void* X, const void* Xt, const void* Yt,
           const void* vario, void* flags, void* out, void* w_stab,
           void* alive_out, const fb::Roles& roles, int C, int nb, int T,
           int P, int W, cudaStream_t stream) {
  const size_t smem = smem_words<WMAX>(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      init_kernel<WMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  init_kernel<WMAX><<<grid, THREADS, smem, stream>>>(
      (const uint8_t*)alive, (const int*)cur_i, (const uint8_t*)in_init,
      (const float*)t, (const float*)X, (const float*)Xt,
      (const int16_t*)Yt, (const float*)vario, (uint8_t*)flags, (int*)out,
      (uint8_t*)w_stab, (uint8_t*)alive_out, roles, C, nb, T, P, W);
  return (int)cudaGetLastError();
}

template <int WMAX>
int geometry(int T, int* out) {
  const auto kern = init_kernel<WMAX>;
  const size_t smem = smem_words<WMAX>(T) * 4;
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

// alive [C,T,P] bool, cur_i [C,P] i32, in_init [C,P] bool, t [C,T] f32,
// X [C,T,8], Xt [C,T,5] f32, Yt [C,nb,T,P] int16, vario [C,P,nb] f32,
// roles the host array of the sensor's band roles (fb::roles_from)
// -> flags [5,C,P] bool (init_nowin, init_tm, init_ok, init_bad, has_adv),
//    out [4,C,P] i32 (i_next_tm, i_adv, j, n_ok), w_stab / alive_out
//    [C,T,P] bool.
// W is the window cap, w_max the instance (32, 64 or 128) that holds it.
extern "C" int fb_init_window(const void* alive, const void* cur_i,
                              const void* in_init, const void* t,
                              const void* X, const void* Xt, const void* Yt,
                              const void* vario, void* flags, void* out,
                              void* w_stab, void* alive_out,
                              const void* roles_h, int C,
                              int nb, int T, int P, int W, int w_max,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > w_max || T > 32767) return (int)cudaErrorInvalidValue;
  const fb::Roles roles = fb::roles_from(roles_h);
  switch (w_max) {
    case 32:
      return launch<32>(alive, cur_i, in_init, t, X, Xt, Yt, vario, flags,
                        out, w_stab, alive_out, roles, C, nb, T, P, W, s);
    case 64:
      return launch<64>(alive, cur_i, in_init, t, X, Xt, Yt, vario, flags,
                        out, w_stab, alive_out, roles, C, nb, T, P, W, s);
    case 128:
      return launch<128>(alive, cur_i, in_init, t, X, Xt, Yt, vario, flags,
                         out, w_stab, alive_out, roles, C, nb, T, P, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launch geometry of the w_max instance at T: out[0] the dynamic
// shared memory, out[1] the resident blocks an SM, out[2] the registers
// and out[3] the local bytes a thread.
extern "C" int fb_init_window_geometry(int w_max, int T, int* out) {
  switch (w_max) {
    case 32:
      return geometry<32>(T, out);
    case 64:
      return geometry<64>(T, out);
    case 128:
      return geometry<128>(T, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
