// detect_mega: the whole event-horizon loop of every pixel in one launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::detect_mega
// (_detect_mega_block, with _init_logic, _mon_scored_logic, _close_logic
// and _gram_cd_core).  One thread owns one pixel from the prologue's start
// state to the end of its series: it loops over rounds until its phase is
// DONE or the round count reaches 2T+8, and each round runs
//   - the INIT body (fb::init_pixel, the code of init_window) when the
//     pixel initializes, its Tmask screen and stability fit included;
//   - the post-INIT round body (fb::round_pixel, the code of fused_round):
//     the monitor chain when it monitors, the close of a tail or a break,
//     the refit of an init-ok or refitting pixel;
//   - the state advance of kernel._detect_batch_impl's loop body.
// Pixels are independent, so a thread runs exactly its own pixel's rounds,
// where the Pallas kernel's pixel block runs until its last pixel is DONE.
//
// State: the phase, cursors, counts and first-segment flag stay in
// registers; the pixel's model and its alive / included / w_stab columns
// live in device memory (the [C,T,P] planes and the [C,P,B,8] model the
// wrapper allocates) and are updated in place.  The round order follows
// the Pallas body: the monitor and the close's PEEK run read the
// round-start alive column — round_pixel takes the break magnitudes
// before its partition pass writes alive_mon over it — and the included
// column is replaced by w_stab (init-ok) or cleared (break) only after the
// close and the refit have read it.
//
// Per chip, ``rounds`` is the most rounds any of its pixels ran (atomicMax),
// and ``flags[c, g, r]`` is set to 1 (plain stores) when some pixel of the
// chip ran the INIT body (g=0), a fit (g=1) or a close (g=2) in round r;
// the wrapper sums the flags into the route's round_counts.
//
// Bound: operations, on this route's data; the spectra are read once per
// round a pixel scores or fits, not once per launch as the bound counts.
// Warp divergence is the design's cost: the 32 pixels of a warp run
// different phases in the same round and different numbers of rounds.
#include "fused_round.cuh"
#include "init_window.cuh"

namespace {

template <int B, int WMAX>
__global__ void __launch_bounds__(fb::BLOCK)
mega_kernel(const int16_t* __restrict__ Yt, const float* __restrict__ tt,
            const float* __restrict__ X, const float* __restrict__ Xt,
            const float* __restrict__ vario, const int* __restrict__ phase0,
            const int* __restrict__ cur_i0, const int* __restrict__ nseg0,
            fb::SegBufs bufs, uint8_t* alive, uint8_t* included,
            uint8_t* w_stab, float* coefs, float* rmse,
            int* __restrict__ nseg_out, int* __restrict__ rounds,
            int* __restrict__ flags, fb::Roles roles, int C, int T, int P,
            int W, int max_rounds, float change_thr, float outlier_thr) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const size_t TP = (size_t)T * P;
  const int16_t* Yc = Yt + c * B * TP;
  const float* tc = tt + (size_t)c * T;
  const float* Xc = X + (size_t)c * T * K;
  const float* Xtc = Xt + (size_t)c * T * NT;
  const float* vrow = vario + cp * B;
  uint8_t* al = alive + c * TP;
  uint8_t* inc = included + c * TP;
  uint8_t* ws = w_stab + c * TP;
  float* coef_row = coefs + cp * B * K;
  float* rmse_row = rmse + cp * B;
  // The round's planes: included_mon and alive_mon overwrite the state.
  const RoundPlanes pl{al, inc, inc, al, ws};
  int* fl = flags + (size_t)c * 3 * max_rounds;

  int phase = phase0[cp], cur_i = cur_i0[cp], cur_k = 0, nlast = 1;
  int nseg = nseg0[cp];
  bool first_seg = true;
  int r = 0;
  for (; r < max_rounds && phase != PHASE_DONE; ++r) {
    const bool in_init = phase == PHASE_INIT;
    InitOut io{};
    if (in_init) {
      io = init_pixel<WMAX>(al + p, cur_i, true, tc, Xc, Xtc, Yc + p, vrow,
                            roles, T, P, W, ws + p, al + p);
      fl[r] = 1;
    }
    const RoundIn in{phase == PHASE_MONITOR, cur_k, nlast, io.ok != 0,
                     io.n_ok, first_seg, nseg, coef_row, rmse_row, vrow};
    const RoundOut o = round_pixel<B>(Yc, Xc, tc, pl, T, P, p, cp, in, roles,
                                      bufs, coef_row, rmse_row, change_thr,
                                      outlier_thr);
    if (o.do_fit) fl[max_rounds + r] = 1;
    if (o.close) fl[2 * max_rounds + r] = 1;

    // Next state (kernel._detect_batch_impl's loop body).
    const MonitorEvent& e = o.e;
    const bool done = io.nowin || (io.bad && !io.has_adv);
    const int phase_n = done ? PHASE_DONE
                        : io.ok ? PHASE_MONITOR
                        : e.is_tail ? PHASE_DONE
                        : e.is_brk ? PHASE_INIT : phase;
    cur_i = io.tm ? io.i_next_tm
            : (io.bad && io.has_adv) ? io.i_adv
            : e.is_brk ? e.pos_ev : cur_i;
    cur_k = io.ok ? io.j + 1 : e.is_refit ? e.pos_ev + 1 : cur_k;
    if (o.do_fit) nlast = o.n_full;
    first_seg = first_seg && !e.is_brk;
    nseg += o.close;
    if (io.ok) {
      for (int t = 0; t < T; ++t) inc[(size_t)t * P + p] = ws[(size_t)t * P + p];
    } else if (e.is_brk) {
      for (int t = 0; t < T; ++t) inc[(size_t)t * P + p] = 0;
    }
    phase = phase_n;
  }
  nseg_out[cp] = nseg;
  atomicMax(rounds + c, r);
}

template <int B, int WMAX>
int launch(const void* Yt, const void* t, const void* X, const void* Xt,
           const void* vario, const void* phase0, const void* cur_i0,
           const void* nseg0, fb::SegBufs bufs, void* alive, void* included,
           void* w_stab, void* coefs, void* rmse, void* nseg_out,
           void* rounds, void* flags, const fb::Roles& roles, int C, int T,
           int P, int W, int max_rounds, float change_thr, float outlier_thr,
           cudaStream_t stream) {
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  mega_kernel<B, WMAX><<<grid, fb::BLOCK, 0, stream>>>(
      (const int16_t*)Yt, (const float*)t, (const float*)X, (const float*)Xt,
      (const float*)vario, (const int*)phase0, (const int*)cur_i0,
      (const int*)nseg0, bufs, (uint8_t*)alive, (uint8_t*)included,
      (uint8_t*)w_stab, (float*)coefs, (float*)rmse, (int*)nseg_out,
      (int*)rounds, (int*)flags, roles, C, T, P, W, max_rounds, change_thr,
      outlier_thr);
  return (int)cudaGetLastError();
}

}  // namespace

// Yt [C,nb,T,P] int16, t [C,T], X [C,T,8], Xt [C,T,5], vario [C,P,nb]
// f32, phase0/cur_i0/nseg0 [C,P] i32; buffers meta [C,P,S,6], rmse_b/mag_b
// [C,P,S,nb], coef_b [C,P,S,nb,8] f32 (updated in place); state the kernel
// updates in place: alive [C,T,P] u8 (the start plane in, the final one
// out), included [C,T,P] u8 (zeros in), w_stab [C,T,P] u8 (scratch), coefs
// [C,P,nb,8] f32 (zeros in), rmse [C,P,nb] f32 (ones in); roles the host
// array of the sensor's band roles (fb::roles_from)
// -> nseg_out [C,P] i32, rounds [C] i32 (zeros in), flags [C,3,max_rounds]
//    i32 (zeros in).  W is the window cap, w_max the instance (32, 64 or
//    128) that holds it; nb one of fb::with_nb's band counts.
extern "C" int fb_detect_mega(
    const void* Yt, const void* t, const void* X, const void* Xt,
    const void* vario, const void* phase0, const void* cur_i0,
    const void* nseg0, void* meta_b, void* rmse_b, void* mag_b, void* coef_b,
    void* alive, void* included, void* w_stab, void* coefs, void* rmse,
    void* nseg_out, void* rounds, void* flags, const void* roles_h, int C,
    int nb, int T, int P, int S, int W, int w_max, int max_rounds,
    float change_thr, float outlier_thr, void* stream) {
  if (W > w_max || T > 32767) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const fb::Roles roles = fb::roles_from(roles_h);
  fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                   (float*)coef_b, S};
  return fb::with_nb(nb, [&](auto nbc) {
    constexpr int B = decltype(nbc)::value;
#define FB_MEGA_LAUNCH(WM)                                                  \
  launch<B, WM>(Yt, t, X, Xt, vario, phase0, cur_i0, nseg0, bufs, alive,    \
                included, w_stab, coefs, rmse, nseg_out, rounds, flags,     \
                roles, C, T, P, W, max_rounds, change_thr, outlier_thr, s)
    switch (w_max) {
      case 32:
        return FB_MEGA_LAUNCH(32);
      case 64:
        return FB_MEGA_LAUNCH(64);
      case 128:
        return FB_MEGA_LAUNCH(128);
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef FB_MEGA_LAUNCH
  });
}
