// fused_round: the whole post-INIT round of the event loop — monitor chain,
// segment close and shared Lasso refit — per pixel, in one launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::fused_round
// (_fused_round_block, with _mon_scored_logic, _close_logic and
// _gram_cd_core).  The per-pixel body is fb::round_pixel (fused_round.cuh):
// the monitor chain of a monitoring pixel, the close of a pixel that ends
// in a tail or a break, the refit of an init-ok or refitting pixel;
// detect_mega runs the same body inside its round loop.  Here it writes
// the round's included / alive planes and the new model to separate
// outputs.  A pixel's result depends on no other pixel: the Pallas
// kernel's per-block gates (any monitoring / closing / fitting lane) only
// skip work whose result the pixel discards.
//
// Bound: bytes.  The detection-band spectra are read three times by the
// monitor (the score is recomputed per scan), the fitting pixels' windows
// twice more; the alive / included planes in and the two planes out
// dominate the rest.  The buffers are touched only at the closing pixels'
// slot.
#include "fused_round.cuh"

namespace {

constexpr int B = fb::NBAND;

__global__ void __launch_bounds__(fb::BLOCK)
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
    int* __restrict__ ev, uint8_t* incm_out, uint8_t* __restrict__ alm_out,
    int C, int T, int P, float change_thr, float outlier_thr) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const size_t TP = (size_t)T * P;
  // incm is written here and read back by this thread (close, refit
  // window).
  const RoundPlanes pl{alive + c * TP, included + c * TP, incm_out + c * TP,
                       alm_out + c * TP, w_stab + c * TP};
  const RoundIn in{in_mon[cp] != 0, cur_k[cp], nlast[cp], init_ok[cp] != 0,
                   n_ok[cp], first_seg[cp] != 0, nseg[cp], coefs + cp * B * K,
                   rmse + cp * B, vario + cp * B};
  const RoundOut o = round_pixel(Yt + c * B * TP, X + (size_t)c * T * K,
                                 tt + (size_t)c * T, pl, T, P, p, cp, in, bufs,
                                 coefs_out + cp * B * K, rmse_out + cp * B,
                                 change_thr, outlier_thr);
  nseg_out[cp] = in.nseg + o.close;

  const size_t CP = (size_t)C * P;
  ev[0 * CP + cp] = o.e.is_tail;
  ev[1 * CP + cp] = o.e.is_brk;
  ev[2 * CP + cp] = o.e.is_refit;
  ev[3 * CP + cp] = o.e.pos_ev;
  ev[4 * CP + cp] = o.do_fit;
  ev[5 * CP + cp] = o.n_full;
}

}  // namespace

// Yt [C,7,T,P] int16, X [C,T,8], t [C,T] f32, alive/included [C,T,P] u8,
// cur_k/nlast [C,P] i32, in_mon [C,P] u8, coefs [C,P,7,8], rmse/vario
// [C,P,7] f32, init_ok [C,P] u8, w_stab [C,T,P] u8, n_ok [C,P] i32,
// first_seg [C,P] u8, nseg [C,P] i32; buffers meta [C,P,S,6], rmse_b/mag_b
// [C,P,S,7], coef_b [C,P,S,7,8] f32 (updated in place)
// -> nseg_out [C,P] i32, coefs_out [C,P,7,8], rmse_out [C,P,7] f32,
//    ev [6,C,P] i32 (is_tail, is_brk, is_refit, pos_ev, do_fit, n_full),
//    incm/alm [C,T,P] u8 (included_mon, alive_mon).
extern "C" int fb_fused_round(
    const void* Yt, const void* X, const void* t, const void* alive,
    const void* included, const void* cur_k, const void* nlast,
    const void* in_mon, const void* coefs, const void* rmse,
    const void* vario, const void* init_ok, const void* w_stab,
    const void* n_ok, const void* first_seg, const void* nseg, void* meta_b,
    void* rmse_b, void* mag_b, void* coef_b, void* nseg_out,
    void* coefs_out, void* rmse_out, void* ev, void* incm, void* alm, int C,
    int nb, int T, int P, int S, float change_thr, float outlier_thr,
    void* stream) {
  if (nb != B) return (int)cudaErrorInvalidValue;
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                   (float*)coef_b, S};
  fused_round_kernel<<<grid, fb::BLOCK, 0, (cudaStream_t)stream>>>(
      (const int16_t*)Yt, (const float*)X, (const float*)t,
      (const uint8_t*)alive, (const uint8_t*)included, (const int*)cur_k,
      (const int*)nlast, (const uint8_t*)in_mon, (const float*)coefs,
      (const float*)rmse, (const float*)vario, (const uint8_t*)init_ok,
      (const uint8_t*)w_stab, (const int*)n_ok, (const uint8_t*)first_seg,
      (const int*)nseg, bufs, (int*)nseg_out, (float*)coefs_out,
      (float*)rmse_out, (int*)ev, (uint8_t*)incm, (uint8_t*)alm, C, T, P,
      change_thr, outlier_thr);
  return (int)cudaGetLastError();
}
