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
//   1-3. The monitor on bit words (word_monitor.cuh): every eligible
//      observation of a monitoring pixel scored once into two bits, Q
//      threads a pixel; passes 1-3 by one thread a pixel with popcounts;
//      the include / remove partition a word at a time, every thread
//      writing its words' rows of included_mon and alive_mon (a
//      non-monitoring pixel's columns are copied the same way).  The
//      w_stab column of an init-ok pixel becomes words beside them.
//   4. Close: the event thread appends a closing pixel's segment
//      (fb::close_write, from the included_mon words; a break's magnitudes
//      from the PEEK run's residuals, fb::peek_mags_at), and the block's
//      fitting pixels (init-ok or refit) are listed with a warp ballot.
//   5. Fit: the listed pixels are fitted densely, Q lanes a pixel, over
//      their w_stab (init-ok) or included_mon (refit) words
//      (fb::dense_fit, the code of lasso_fit): the coefficients and RMSE
//      are those of fb::fit_window, bit for bit.
//
// The detection bands are the sensor's (fb::Roles); NB bands a pixel.
// Bound: bytes (the monitoring pixels' detection bands at the observations
// scored, the fitting pixels' windows, the planes in and out); the CD loop's
// serial chain (50 sweeps x 8 coordinates a band) bounds a block's latency.
#include "dense_fit.cuh"
#include "segment_close.cuh"
#include "word_monitor.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int Q = fb::TILE_Q;         // threads a pixel (scoring, fitting)
constexpr int MIN_BLOCKS = 3;         // 24 warps an SM (80 registers)
constexpr int NMASK = 5;              // alive, outlier, change, incl., w_stab
constexpr int NINFO = 5;              // per-pixel ints in shared memory

// Dynamic shared memory of a block for T time steps, in 4-byte words:
// X and t, the Grams, the masks, the per-pixel ints and the fit count.
// cuda_ops.fused_round_smem_bytes computes the same.
size_t smem_words(int T) {
  const int W = (T + 31) / 32;
  return (size_t)9 * T + TILE * fb::GSTRIDE + (size_t)NMASK * W * TILE +
         NINFO * TILE + 4;
}

template <int B>
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
    uint8_t* __restrict__ alm_out, fb::Roles roles, int C, int T, int P,
    float change_thr, float outlier_thr) {
  using namespace fb;
  constexpr int ND = NDET;
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
  stage(Xs, X + (size_t)c * T * K, T * K);
  stage(ts, tt + (size_t)c * T, T);
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
        const int b = roles.det[d];
        dden[d] = pmax(rmse[cp * B + b], vario[cp * B + b]);
#pragma unroll
        for (int k = 0; k < K; ++k) coef[d][k] = coefs[(cp * B + b) * K + k];
      }
    }
    // w_stab's words only where the pixel's INIT block fitted (else 0).
    score_words<ND>(q, valid, mon, ck, alive + c * TP + p,
                    included + c * TP + p,
                    iok ? w_stab + c * TP + p : nullptr, Yc + p, roles.det,
                    TP, T, P, Xs, coef, dden, change_thr, outlier_thr,
                    mA + i, mO + i, mE + i, mI + i, mS + i);
  }
  __syncthreads();

  // 2. Events: thread i of warp 0 for pixel i (passes 1-3 on words).
  const uint32_t* A = mA + i;
  MonitorEvent e{};
  if (tid < TILE) {
    int n_pos = 0, t_pos = T;
    if (mon)
      e = word_event(A, mO + i, mE + i, mI + i, W, T, ck, nlast[cp], n_pos,
                     t_pos);
    npos[i] = n_pos;
    tpos[i] = t_pos;
  }
  __syncthreads();

  // 3. Partition: included_mon = included | in_q, alive_mon = alive & !rm_q.
  {
    const int n_pos = npos[i], t_pos = tpos[i];
    for (int w = q; w < W; w += Q) {
      const uint32_t a = mA[w * TILE + i];
      const WordPartition pq = partition_word(
          a, mO[w * TILE + i], mE[w * TILE + i], w, ck, n_pos, t_pos);
      const uint32_t incm = mI[w * TILE + i] | pq.in_q;
      mI[w * TILE + i] = incm;
      if (valid) {
        write_word(incm_out + c * TP + p, P, w, T, incm);
        write_word(alm_out + c * TP + p, P, w, T, a & ~pq.rm_q);
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
    const int slot = list_pixels(do_fit, i, nfit);
    if (do_fit) {
      flist[slot] = i;
      fnfull[slot] = n_full;
      finit[slot] = iok;
    }
  }
  __syncthreads();

  // 5. Fit: group g fits listed pixel g over its w_stab (init-ok) or
  // included_mon (refit) words.
  const int g = tid / Q, l = tid % Q;
  const bool fits = g < *nfit;
  const int fi = fits ? flist[g] : 0;
  const size_t fcp = (size_t)c * P + blockIdx.x * TILE + fi;
  bool mask[K];
  coef_mask(fits ? fnfull[g] : 0, mask);
  dense_fit<B>(fits, l, (fits && finit[g] ? mS : mI) + fi, W,
               Yc + (fcp - (size_t)c * P), TP, P, Xs, Gs + g * GSTRIDE, mask,
               true, coefs_out + fcp * B * K, rmse_out + fcp * B);
}

template <int B>
int launch(const void* const* a, void* const* o, const fb::SegBufs& bufs,
           const fb::Roles& roles, int C, int T, int P, float change_thr,
           float outlier_thr, cudaStream_t stream) {
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fused_round_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  fused_round_kernel<B><<<grid, THREADS, smem, stream>>>(
      (const int16_t*)a[0], (const float*)a[1], (const float*)a[2],
      (const uint8_t*)a[3], (const uint8_t*)a[4], (const int*)a[5],
      (const int*)a[6], (const uint8_t*)a[7], (const float*)a[8],
      (const float*)a[9], (const float*)a[10], (const uint8_t*)a[11],
      (const uint8_t*)a[12], (const int*)a[13], (const uint8_t*)a[14],
      (const int*)a[15], bufs, (int*)o[0], (float*)o[1], (float*)o[2],
      (int*)o[3], (uint8_t*)o[4], (uint8_t*)o[5], roles, C, T, P, change_thr,
      outlier_thr);
  return (int)cudaGetLastError();
}

}  // namespace

// Yt [C,nb,T,P] int16, X [C,T,8], t [C,T] f32, alive/included [C,T,P] u8,
// cur_k/nlast [C,P] i32, in_mon [C,P] u8, coefs [C,P,nb,8], rmse/vario
// [C,P,nb] f32, init_ok [C,P] u8, w_stab [C,T,P] u8, n_ok [C,P] i32,
// first_seg [C,P] u8, nseg [C,P] i32; buffers meta [C,P,S,6], rmse_b/mag_b
// [C,P,S,nb], coef_b [C,P,S,nb,8] f32 (updated in place); roles the host
// array of the sensor's band roles (fb::roles_from)
// -> nseg_out [C,P] i32, coefs_out [C,P,nb,8], rmse_out [C,P,nb] f32,
//    ev [6,C,P] i32 (is_tail, is_brk, is_refit, pos_ev, do_fit, n_full),
//    incm/alm [C,T,P] u8 (included_mon, alive_mon).  nb is one of
//    fb::with_nb's band counts.
extern "C" int fb_fused_round(
    const void* Yt, const void* X, const void* t, const void* alive,
    const void* included, const void* cur_k, const void* nlast,
    const void* in_mon, const void* coefs, const void* rmse,
    const void* vario, const void* init_ok, const void* w_stab,
    const void* n_ok, const void* first_seg, const void* nseg, void* meta_b,
    void* rmse_b, void* mag_b, void* coef_b, void* nseg_out,
    void* coefs_out, void* rmse_out, void* ev, void* incm, void* alm,
    const void* roles_h, int C, int nb, int T, int P, int S,
    float change_thr, float outlier_thr, void* stream) {
  const void* a[] = {Yt,     X,      t,     alive, included, cur_k,
                     nlast,  in_mon, coefs, rmse,  vario,    init_ok,
                     w_stab, n_ok,   first_seg, nseg};
  void* o[] = {nseg_out, coefs_out, rmse_out, ev, incm, alm};
  const fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                         (float*)coef_b, S};
  const fb::Roles roles = fb::roles_from(roles_h);
  return fb::with_nb(nb, [&](auto nbc) {
    return launch<decltype(nbc)::value>(a, o, bufs, roles, C, T, P,
                                        change_thr, outlier_thr,
                                        (cudaStream_t)stream);
  });
}

// The launch geometry of the nb-band instance at T: out[0] the dynamic
// shared memory bytes, out[1] the blocks resident on one SM, out[2]
// registers a thread, out[3] local (stack and spill) bytes a thread.
extern "C" int fb_fused_round_geometry(int nb, int T, int* out) {
  return fb::with_nb(nb, [&](auto nbc) {
    const auto kern = fused_round_kernel<decltype(nbc)::value>;
    const size_t smem = smem_words(T) * 4;
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
  });
}
