// fused_fit_close: one round's segment close and shared Lasso refit, per
// pixel, in one launch.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::fused_fit_close
// (_fused_fit_close_block).  Per pixel:
//   1. a closing pixel (tail or break) appends its segment — meta row,
//      the closing model's rmse and coefficients, the break magnitudes that
//      arrive precomputed (kernel._close_mags, the same program as the
//      unfused route) — at slot nseg of the result buffers, in place;
//   2. a fitting pixel (init-ok or refit) gets a new Lasso fit over its
//      window (fb::fit_window, the very code of lasso_fit); the others keep
//      their model.
// Because the fit runs lasso_fit's instructions and every close value is a
// select, an integer or a carried input, the route's results are
// byte-identical to the per-component route's.
//
// Bound: bytes.  The spectra of the fitting pixels' windows (read twice,
// Gram and RMSE pass), the weight plane and the included plane dominate;
// the result buffers are touched only at the closing pixels' slot (a
// copying kernel would move the whole [C,P,S,760 B] buffers every round).
// The CD loop adds ~50*8*B*16 flops per fitting pixel.  Pixels that
// neither close nor fit only copy their model.
#include "segment_close.cuh"

namespace {

template <int B>
__global__ void __launch_bounds__(fb::BLOCK)
fused_fit_close_kernel(
    const int16_t* __restrict__ Yt, const float* __restrict__ X,
    const float* __restrict__ tt, const float* __restrict__ w,
    const uint8_t* __restrict__ do_fit, const int* __restrict__ n_full,
    const uint8_t* __restrict__ incm, const float* __restrict__ coefs,
    const float* __restrict__ rmse, const float* __restrict__ mags,
    const uint8_t* __restrict__ is_tail, const uint8_t* __restrict__ is_brk,
    const int* __restrict__ pos_ev, const int* __restrict__ n_exceed,
    const uint8_t* __restrict__ first_seg, const int* __restrict__ nseg,
    fb::SegBufs bufs, int* __restrict__ nseg_out,
    float* __restrict__ coefs_out, float* __restrict__ rmse_out, int T,
    int P) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const float* coef_row = coefs + cp * B * K;
  const float* rmse_row = rmse + cp * B;

  const bool brk = is_brk[cp] != 0;
  const bool close = brk || is_tail[cp] != 0;
  const int ns = nseg[cp];
  if (close)
    close_segment<B>(incm + (size_t)c * T * P, tt + (size_t)c * T, T, P, p,
                     cp, brk, pos_ev[cp], n_exceed[cp], first_seg[cp] != 0,
                     ns, rmse_row, brk ? mags + cp * B : nullptr, coef_row,
                     bufs);
  nseg_out[cp] = ns + close;

  float* co = coefs_out + cp * B * K;
  float* ro = rmse_out + cp * B;
  if (do_fit[cp] != 0) {
    bool m[K];
    coef_mask(n_full[cp], m);
    fit_window<B>(Yt + (size_t)c * B * T * P, X + (size_t)c * T * K,
                  PlaneWeight{w + (size_t)c * T * P, P, p}, T, P, p, m, co,
                  ro, true);
  } else {
    for (int i = 0; i < B * K; ++i) co[i] = coef_row[i];
    for (int b = 0; b < B; ++b) ro[b] = rmse_row[b];
  }
}

}  // namespace

// Yt [C,nb,T,P] int16, X [C,T,8], t [C,T], w [C,T,P] f32, do_fit [C,P] u8,
// n_full [C,P] i32, incm [C,T,P] u8, coefs [C,P,nb,8], rmse/mags [C,P,nb]
// f32, is_tail/is_brk [C,P] u8, pos_ev/n_exceed [C,P] i32, first_seg
// [C,P] u8, nseg [C,P] i32; buffers meta [C,P,S,6], rmse_b/mag_b
// [C,P,S,nb], coef_b [C,P,S,nb,8] f32 (updated in place)
// -> nseg_out [C,P] i32, coefs_out [C,P,nb,8], rmse_out [C,P,nb] f32; nb
// one of fb::with_nb's band counts.
extern "C" int fb_fused_fit_close(
    const void* Yt, const void* X, const void* t, const void* w,
    const void* do_fit, const void* n_full, const void* incm,
    const void* coefs, const void* rmse, const void* mags,
    const void* is_tail, const void* is_brk, const void* pos_ev,
    const void* n_exceed, const void* first_seg, const void* nseg,
    void* meta_b, void* rmse_b, void* mag_b, void* coef_b, void* nseg_out,
    void* coefs_out, void* rmse_out, int C, int nb, int T, int P, int S,
    void* stream) {
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  fb::SegBufs bufs{(float*)meta_b, (float*)rmse_b, (float*)mag_b,
                   (float*)coef_b, S};
  return fb::with_nb(nb, [&](auto nbc) {
    fused_fit_close_kernel<decltype(nbc)::value>
        <<<grid, fb::BLOCK, 0, (cudaStream_t)stream>>>(
            (const int16_t*)Yt, (const float*)X, (const float*)t,
            (const float*)w, (const uint8_t*)do_fit, (const int*)n_full,
            (const uint8_t*)incm, (const float*)coefs, (const float*)rmse,
            (const float*)mags, (const uint8_t*)is_tail,
            (const uint8_t*)is_brk, (const int*)pos_ev, (const int*)n_exceed,
            (const uint8_t*)first_seg, (const int*)nseg, bufs, (int*)nseg_out,
            (float*)coefs_out, (float*)rmse_out, T, P);
    return (int)cudaGetLastError();
  });
}
