// detect_mega: the whole event-horizon loop of every pixel in one launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::detect_mega
// (_detect_mega_block, with _init_logic, _mon_scored_logic, _close_logic
// and _gram_cd_core).  As the Pallas kernel's pixel block does, a block
// owns a tile of TILE pixels of one chip (tile.cuh's layout, TILE_THREADS
// threads) and loops over rounds while any of its pixels is not DONE and
// the round count is below 2T+8.  Each round runs
//   - the INIT body (fb::init_pixel, the code of init_window), one thread
//     a pixel of warp 0, for the tile's initializing pixels;
//   - the post-INIT round (fb::tile_round, the code of fused_round): the
//     monitor on bit words, the close of a tail or a break, the dense
//     refit of the init-ok and refitting pixels, TILE_Q lanes a pixel;
//   - the state advance of kernel._detect_batch_impl's loop body.
// A DONE pixel sits idle in its tile until the tile's last pixel is DONE.
// Pixels are independent: a pixel's round r is the lockstep loop's round r.
//
// State between rounds: the phase, cursors, counts and first-segment flag
// of pixel i in registers of warp 0's thread i (the phase and monitor
// cursor published in shared memory for the other threads); the alive,
// included and w_stab columns as 32-step words in shared memory (a break
// or an init-ok costs W word copies); the chip's design, no-trend design
// and days staged in shared memory for the block's life; the model
// ([C,P,B,8] coefs, [C,P,B] rmse) in device memory, updated in place (the
// monitor and the close read a row before the fit writes it).  The
// round's alive plane goes out once, at the end.  The round order follows
// the Pallas body: INIT writes the alive_init and w_stab words first; the
// close's PEEK run reads the round-start alive words, and the included
// words are replaced by w_stab (init-ok) or cleared (break) only after the
// close and the refit have read them.
//
// Per chip, ``rounds`` is the most rounds any of its tiles ran
// (atomicMax), and ``flags[c, g, r]`` is set to 1 (plain stores) when some
// pixel of the chip ran the INIT body (g=0), a fit (g=1) or a close (g=2)
// in round r; the wrapper sums the flags into the route's round_counts.
//
// Bound: operations, on this route's data.  What holds it: a tile waits on
// its slowest pixel, and INIT runs on one warp of the block while the
// other seven wait at the barrier.
#include "init_window.cuh"
#include "tile_round.cuh"

namespace {

using fb::TILE;
constexpr int THREADS = fb::TILE_THREADS;
constexpr int Q = fb::TILE_Q;
// 16 warps an SM at 128 registers: 51.5 ms on the main path's 8 chips,
// against 73.6 ms for 24 warps at 80 (the INIT body spills) on an H100
// (tools/kernel_variants.py).
constexpr int MIN_BLOCKS = 2;
constexpr int NSTATE = 3;             // per-pixel ints shared a round

// Dynamic shared memory of a block for T time steps, in 4-byte words: X,
// t and Xt, the tile round's (the Grams, the five masks, the per-pixel ints
// and the fit count) and the per-pixel state.  cuda_ops.
// detect_mega_smem_bytes computes the same.
size_t smem_words(int T) {
  return (size_t)(fb::K + 1 + fb::NT) * T +
         fb::tile_round_words((T + 31) / 32) + NSTATE * TILE;
}

// A pixel's alive and w_stab columns as words in shared memory (stride
// TILE), read and written in place by the INIT body; the designs read
// from shared memory.
struct WordColumns {
  uint32_t* A;
  uint32_t* S;
  __device__ bool alive(int t) const {
    return (A[(t >> 5) * TILE] >> (t & 31)) & 1u;
  }
  __device__ void put(int t, bool a_out, bool w) {
    const int k = (t >> 5) * TILE;
    const uint32_t bit = 1u << (t & 31);
    A[k] = a_out ? A[k] | bit : A[k] & ~bit;
    S[k] = w ? S[k] | bit : S[k] & ~bit;
  }
  __device__ static float ld(const float* p) { return *p; }
};

// The INIT body of one pixel over its words.  Inlined: out of line (its
// window arrays in a frame of their own) it ran 1.4 % slower at 2 blocks
// an SM, 16 % faster at 3 (tools/kernel_variants.py).
// The mixed instance (FB_MIXED) runs it on every lane of warp 0 once any
// of them initializes (init: this pixel does; the stability fit's Gram is
// the warp's, staged in the tile's Grams), the f32 instance on the
// initializing lanes only.
template <int WMAX>
__device__ __forceinline__ fb::InitOut mega_init(
    uint32_t* A, uint32_t* S, int cur_i, bool init, const float* ts,
    const float* Xs, const float* Xts, const int16_t* Yp, const float* vrow,
    const fb::Roles& roles, int T, int P, int W, float* stage) {
  WordColumns col{A, S};
  return fb::init_pixel<WMAX>(col, cur_i, init, ts, Xs, Xts, Yp, vrow, roles,
                              T, P, W, stage);
}

template <int B, int WMAX>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mega_kernel(const int16_t* __restrict__ Yt, const float* __restrict__ tt,
            const float* __restrict__ X, const float* __restrict__ Xt,
            const float* __restrict__ vario, const int* __restrict__ phase0,
            const int* __restrict__ cur_i0, const int* __restrict__ nseg0,
            fb::SegBufs bufs, uint8_t* alive, float* coefs, float* rmse,
            int* __restrict__ nseg_out, int* __restrict__ rounds,
            int* __restrict__ flags, fb::Roles roles, int C, int T, int P,
            int W, int max_rounds, float change_thr, float outlier_thr) {
  using namespace fb;
  constexpr int ND = NDET;
  extern __shared__ __align__(16) float smem[];
  const int Wd = (T + 31) / 32;
  float* Xs = smem;
  float* ts = Xs + T * K;
  float* Xts = ts + T;
  const TileMem m = carve_tile(Xs, ts, Xts + T * NT, Wd);
  int* s_phase = m.nfit + 4;
  int* s_ck = s_phase + TILE;
  int* s_act = s_ck + TILE;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t TP = (size_t)T * P;
  const int16_t* Yc = Yt + (size_t)c * B * TP;
  int* fl = flags + (size_t)c * 3 * max_rounds;

  // The block's constants and the tile's start state.
  stage(Xs, X + (size_t)c * T * K, T * K);
  stage(ts, tt + (size_t)c * T, T);
  stage(Xts, Xt + (size_t)c * T * NT, T * NT);
  TilePixel px;
  px.i = tid % TILE;
  px.q = tid / TILE;
  px.p = blockIdx.x * TILE + px.i;
  px.valid = px.p < P;
  px.cp = (size_t)c * P + (px.valid ? px.p : 0);
  px.cp0 = (size_t)c * P + blockIdx.x * TILE;
  const int i = px.i, p = px.p;
  const size_t cp = px.cp;
  for (int w = px.q; w < Wd; w += Q) {
    m.mA[w * TILE + i] =
        px.valid ? column_word(alive + c * TP + p, P, w, T) : 0u;
    m.mI[w * TILE + i] = 0u;
    m.mS[w * TILE + i] = 0u;
  }
  // Warp 0's thread i: pixel i's state (a pixel past P is DONE).
  int phase = PHASE_DONE, cur_i = 0, cur_k = 0, nlast = 1, nseg = 0;
  bool first_seg = true;
  if (tid < TILE && px.valid) {
    phase = phase0[cp];
    cur_i = cur_i0[cp];
    nseg = nseg0[cp];
  }

  int r = 0;
  for (;; ++r) {
    if (tid < TILE) {
      s_phase[i] = phase;
      s_ck[i] = cur_k;
    }
    // Block-uniform: every thread leaves at the same round.
    const bool live = __syncthreads_or(tid < TILE && phase != PHASE_DONE);
    if (!live || r >= max_rounds) break;

    // INIT, warp 0: alive_init and w_stab into the words.
    InitOut io{};
    if (tid < TILE) {
      const bool in_init = phase == PHASE_INIT;
#if FB_MIXED
      if (__any_sync(~0u, in_init))
#else
      if (in_init)
#endif
        io = mega_init<WMAX>(m.mA + i, m.mS + i, cur_i, in_init, ts, Xs, Xts,
                             Yc + p, vario + cp * B, roles, T, P, W, m.Gs);
      if (__ballot_sync(~0u, in_init) && i == 0) fl[r] = 1;
    }
    __syncthreads();

    // The post-INIT round.
    px.mon = s_phase[i] == PHASE_MONITOR;
    px.ck = s_ck[i];
    MonitorEvent e{};
    bool close = false, do_fit = false;
    int n_full = 0;
    tile_round<B>(
        m, px, Yc, T, P, coefs, rmse, vario, coefs, rmse, roles, bufs,
        change_thr, outlier_thr,
        [&] {
          return TileState{nlast, io.ok != 0, io.n_ok, first_seg, nseg};
        },
        [&](const float (&coef)[ND][K], const float (&dden)[ND]) {
          score_alive_words<ND>(px.q, px.mon, px.ck, m.mA + i, Yc + p,
                                roles.det, TP, T, P, Xs, coef, dden,
                                change_thr, outlier_thr, m.mO + i, m.mE + i);
        },
        // alive_mon over the outlier words (step 3 reads them no more).
        [&](int w, uint32_t, uint32_t alm) { m.mO[w * TILE + i] = alm; },
        [&](const MonitorEvent& ev, bool cl, bool fit, int nf) {
          e = ev;
          close = cl;
          do_fit = fit;
          n_full = nf;
        });

    // Next state (kernel._detect_batch_impl's loop body).
    if (tid < TILE) {
      if (__ballot_sync(~0u, do_fit) && i == 0) fl[max_rounds + r] = 1;
      if (__ballot_sync(~0u, close) && i == 0) fl[2 * max_rounds + r] = 1;
      const bool done = io.nowin || (io.bad && !io.has_adv);
      const int phase_n = done ? PHASE_DONE
                          : io.ok ? PHASE_MONITOR
                          : e.is_tail ? PHASE_DONE
                          : e.is_brk ? PHASE_INIT : phase;
      cur_i = io.tm ? io.i_next_tm
              : (io.bad && io.has_adv) ? io.i_adv
              : e.is_brk ? e.pos_ev : cur_i;
      cur_k = io.ok ? io.j + 1 : e.is_refit ? e.pos_ev + 1 : cur_k;
      if (do_fit) nlast = n_full;
      first_seg = first_seg && !e.is_brk;
      nseg += close;
      phase = phase_n;
      s_act[i] = io.ok ? 1 : e.is_brk ? 2 : 0;
    }
    // The fit has read the included and w_stab words (dense_fit's lanes).
    __syncthreads();
    {
      const int act = s_act[i];
      for (int w = px.q; w < Wd; w += Q) {
        m.mA[w * TILE + i] = m.mO[w * TILE + i];
        if (act) m.mI[w * TILE + i] = act == 1 ? m.mS[w * TILE + i] : 0u;
      }
    }
  }

  // The final alive plane, the segment counts and the chip's rounds.
  if (px.valid)
    for (int w = px.q; w < Wd; w += Q)
      write_word(alive + c * TP + p, P, w, T, m.mA[w * TILE + i]);
  if (tid < TILE && px.valid) nseg_out[cp] = nseg;
  if (tid == 0) atomicMax(rounds + c, r);
}

template <int B, int WMAX>
int launch(const void* Yt, const void* t, const void* X, const void* Xt,
           const void* vario, const void* phase0, const void* cur_i0,
           const void* nseg0, fb::SegBufs bufs, void* alive, void* coefs,
           void* rmse, void* nseg_out, void* rounds, void* flags,
           const fb::Roles& roles, int C, int T, int P, int W,
           int max_rounds, float change_thr, float outlier_thr,
           cudaStream_t stream) {
  const size_t smem = smem_words(T) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      mega_kernel<B, WMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TILE - 1) / TILE, C);
  mega_kernel<B, WMAX><<<grid, THREADS, smem, stream>>>(
      (const int16_t*)Yt, (const float*)t, (const float*)X, (const float*)Xt,
      (const float*)vario, (const int*)phase0, (const int*)cur_i0,
      (const int*)nseg0, bufs, (uint8_t*)alive, (float*)coefs, (float*)rmse,
      (int*)nseg_out, (int*)rounds, (int*)flags, roles, C, T, P, W,
      max_rounds, change_thr, outlier_thr);
  return (int)cudaGetLastError();
}

// f(WMAX) for the window instance w_max (32, 64 or 128); another is
// refused.
template <class F>
int with_wmax(int w_max, F&& f) {
  switch (w_max) {
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Yt [C,nb,T,P] int16, t [C,T], X [C,T,8], Xt [C,T,5], vario [C,P,nb]
// f32, phase0/cur_i0/nseg0 [C,P] i32; buffers meta [C,P,S,6], rmse_b/mag_b
// [C,P,S,nb], coef_b [C,P,S,nb,8] f32 (updated in place); state the kernel
// updates in place: alive [C,T,P] u8 (the start plane in, the final one
// out), coefs [C,P,nb,8] f32 (zeros in), rmse [C,P,nb] f32 (ones in);
// roles the host array of the sensor's band roles (fb::roles_from)
// -> nseg_out [C,P] i32, rounds [C] i32 (zeros in), flags [C,3,max_rounds]
//    i32 (zeros in).  W is the window cap, w_max the instance (32, 64 or
//    128) that holds it; nb one of fb::with_nb's band counts.  A block's
//    shared memory (smem_words) must fit the card's 227 KB.
extern "C" int fb_detect_mega(
    const void* Yt, const void* t, const void* X, const void* Xt,
    const void* vario, const void* phase0, const void* cur_i0,
    const void* nseg0, void* meta_b, void* rmse_b, void* mag_b, void* coef_b,
    void* alive, void* coefs, void* rmse, void* nseg_out, void* rounds,
    void* flags, const void* roles_h, int C, int nb, int T, int P, int S,
    int W, int w_max, int max_rounds, float change_thr, float outlier_thr,
    void* stream) {
  if (W > w_max || T > 32767) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const fb::Roles roles = fb::roles_from(roles_h);
  fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                   (float*)coef_b, S};
  return fb::with_nb(nb, [&](auto nbc) {
    return with_wmax(w_max, [&](auto wm) {
      return launch<decltype(nbc)::value, decltype(wm)::value>(
          Yt, t, X, Xt, vario, phase0, cur_i0, nseg0, bufs, alive, coefs,
          rmse, nseg_out, rounds, flags, roles, C, T, P, W, max_rounds,
          change_thr, outlier_thr, s);
    });
  });
}

// The launch geometry of the (nb, w_max) instance at T: out[0] the dynamic
// shared memory bytes, out[1] the blocks resident on one SM, out[2]
// registers a thread, out[3] local (stack and spill) bytes a thread.
extern "C" int fb_detect_mega_geometry(int nb, int w_max, int T, int* out) {
  return fb::with_nb(nb, [&](auto nbc) {
    return with_wmax(w_max, [&](auto wm) {
      const auto kern = mega_kernel<decltype(nbc)::value, decltype(wm)::value>;
      const size_t smem = smem_words(T) * 4;
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kern,
                                                        THREADS, smem);
      if (e != cudaSuccess) return (int)e;
      cudaFuncAttributes fa;
      e = cudaFuncGetAttributes(&fa, kern);
      out[0] = (int)smem;
      out[2] = fa.numRegs;
      out[3] = (int)fa.localSizeBytes;
      return (int)e;
    });
  });
}
