// init_window: the INIT round of the event loop, per pixel.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::init_window
// (_init_window_block, _init_logic, with _tmask_core and _gram_cd_core
// inlined).  The per-pixel body is fb::init_pixel (init_window.cuh): the
// initialization window, the Tmask IRLS screen (fb::tmask_screen, which
// the tmask_bad kernel runs too), the 4-coefficient stability fit and the
// cursor advances; detect_mega runs the same body inside its round loop.
//
// Bound: bytes, narrowly over operations.  The alive plane in and the two
// [T,P] planes out dominate the bytes; a pixel's window is ~12-32
// observations, and the IRLS, medians and CD loop run on per-thread arrays
// sized by the template's W_MAX (spilled to local memory; -Xptxas -v
// reports it).  The alive plane is read two or three times, the spectra
// once per window member.  Pixels that are not initializing, or have no
// window, skip steps 2-4: their outputs are exactly those of an empty
// window.
#include "init_window.cuh"

namespace {

template <int WMAX>
__global__ void __launch_bounds__(fb::BLOCK)
init_kernel(const uint8_t* __restrict__ alive, const int* __restrict__ cur_i,
            const uint8_t* __restrict__ in_init, const float* __restrict__ tt,
            const float* __restrict__ X, const float* __restrict__ Xt,
            const int16_t* __restrict__ Yt, const float* __restrict__ vario,
            int* __restrict__ out, uint8_t* __restrict__ w_stab,
            uint8_t* __restrict__ alive_out, fb::Roles roles, int C, int nb,
            int T, int P, int W) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const size_t TP = (size_t)T * P;
  ByteColumns col{alive + c * TP + p, w_stab + c * TP + p,
                  alive_out + c * TP + p, P};
  const InitOut o = init_pixel<WMAX>(
      col, cur_i[cp], in_init[cp] != 0, tt + (size_t)c * T,
      X + (size_t)c * T * K, Xt + (size_t)c * T * NT,
      Yt + c * nb * TP + p, vario + cp * nb, roles, T, P, W);

  const size_t CP = (size_t)C * P;
  out[0 * CP + cp] = o.nowin;                 // init_nowin
  out[1 * CP + cp] = o.tm;                    // init_tm
  out[2 * CP + cp] = o.ok;                    // init_ok
  out[3 * CP + cp] = o.bad;                   // init_bad
  out[4 * CP + cp] = o.has_adv;
  out[5 * CP + cp] = o.i_next_tm;
  out[6 * CP + cp] = o.i_adv;
  out[7 * CP + cp] = o.j;
  out[8 * CP + cp] = o.n_ok;
}

template <int WMAX>
int launch(const void* alive, const void* cur_i, const void* in_init,
           const void* t, const void* X, const void* Xt, const void* Yt,
           const void* vario, void* out, void* w_stab, void* alive_out,
           const fb::Roles& roles, int C, int nb, int T, int P, int W,
           cudaStream_t stream) {
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  init_kernel<WMAX><<<grid, fb::BLOCK, 0, stream>>>(
      (const uint8_t*)alive, (const int*)cur_i, (const uint8_t*)in_init,
      (const float*)t, (const float*)X, (const float*)Xt,
      (const int16_t*)Yt, (const float*)vario, (int*)out, (uint8_t*)w_stab,
      (uint8_t*)alive_out, roles, C, nb, T, P, W);
  return (int)cudaGetLastError();
}

}  // namespace

// alive [C,T,P] bool, cur_i [C,P] i32, in_init [C,P] bool, t [C,T] f32,
// X [C,T,8], Xt [C,T,5] f32, Yt [C,nb,T,P] int16, vario [C,P,nb] f32,
// roles the host array of the sensor's band roles (fb::roles_from)
// -> out [9,C,P] i32 (init_nowin, init_tm, init_ok, init_bad, has_adv,
//    i_next_tm, i_adv, j, n_ok), w_stab / alive_out [C,T,P] bool.
// W is the window cap, w_max the instance (32, 64 or 128) that holds it.
extern "C" int fb_init_window(const void* alive, const void* cur_i,
                              const void* in_init, const void* t,
                              const void* X, const void* Xt, const void* Yt,
                              const void* vario, void* out, void* w_stab,
                              void* alive_out, const void* roles_h, int C,
                              int nb, int T, int P, int W, int w_max,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > w_max || T > 32767) return (int)cudaErrorInvalidValue;
  const fb::Roles roles = fb::roles_from(roles_h);
  switch (w_max) {
    case 32:
      return launch<32>(alive, cur_i, in_init, t, X, Xt, Yt, vario, out,
                        w_stab, alive_out, roles, C, nb, T, P, W, s);
    case 64:
      return launch<64>(alive, cur_i, in_init, t, X, Xt, Yt, vario, out,
                        w_stab, alive_out, roles, C, nb, T, P, W, s);
    case 128:
      return launch<128>(alive, cur_i, in_init, t, X, Xt, Yt, vario, out,
                         w_stab, alive_out, roles, C, nb, T, P, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
