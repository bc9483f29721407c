// init_window: the INIT round of the event loop, per pixel.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::init_window
// (_init_window_block, _init_logic, with _tmask_core and _gram_cd_core
// inlined).  Per pixel:
//   1. the initialization window: from the first alive observation i at or
//      after the cursor, the first alive j with at least MEOW_SIZE alive
//      observations in [i, j] spanning INIT_DAYS;
//   2. the window's members (at most W, the host's window_cap) gathered by
//      position into per-thread arrays;
//   3. the Tmask screen: TMASK_IRLS_ITERS Huber reweightings of a 5x5 SPD
//      solve (unrolled Cholesky, NaN on a non-positive pivot so that
//      nothing is flagged), masked medians by insertion sort, a flag where
//      the residual exceeds TMASK_CONST x the variogram;
//   4. the 4-coefficient stability fit of the detection bands over the
//      window (the lasso_fit Gram/CD core) and the STABILITY_FACTOR test;
//   5. the cursor advances and the w_stab / alive_init planes.
//
// Bound: bytes, narrowly over operations.  The alive plane in and the two
// [T,P] planes out dominate the bytes; a pixel's window is ~12-32
// observations, and the IRLS, medians and CD loop run on per-thread arrays
// sized by the template's W_MAX (spilled to local memory; -Xptxas -v
// reports it).  The alive plane is read two or three times, the spectra
// once per window member.  Pixels that are not initializing, or have no window, skip steps
// 2-4: their outputs are exactly those of an empty window.
#include "ccd_common.cuh"

namespace {

constexpr int B = 7;                                 // Landsat bands
constexpr int ND = 5;                                // detection bands 1..5
constexpr int MEOW = 12;                             // params.MEOW_SIZE
constexpr float INIT_DAYS = 365.25f;
constexpr int TM_ITERS = 5;                          // TMASK_IRLS_ITERS
constexpr float HUBER_K = 1.345f;
constexpr float TMASK_CONST = 4.89f;
constexpr float STAB = 3.0f;                         // STABILITY_FACTOR
// Tmask bands (green, swir1) as indices into the detection bands.
constexpr int TM0 = 0, TM1 = 3;

// Solve G beta = c for the 5x5 SPD G (lower half filled) by unrolled
// Cholesky — kernel._chol_solve_small.  A pivot that is not > 0 makes
// the whole solution NaN.
__device__ void chol_solve5(float G[fb::NT][fb::NT], const float c[fb::NT],
                            float x[fb::NT]) {
  using fb::NT;
  float L[NT][NT];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = G[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) s = s - L[i][q] * L[j][q];
      if (i == j) {
        ok = ok && (s > 0.f);
        L[i][j] = sqrtf(fb::pmax(s, 1e-30f));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  float y[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float s = c[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s = s - L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = NT - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < NT; ++q) s = s - L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < NT; ++i) x[i] = NAN;
  }
}

template <int WMAX>
__global__ void __launch_bounds__(fb::BLOCK)
init_kernel(const uint8_t* __restrict__ alive, const int* __restrict__ cur_i,
            const uint8_t* __restrict__ in_init, const float* __restrict__ tt,
            const float* __restrict__ X, const float* __restrict__ Xt,
            const int16_t* __restrict__ Yt, const float* __restrict__ vario,
            int* __restrict__ out, uint8_t* __restrict__ w_stab,
            uint8_t* __restrict__ alive_out, int C, int T, int P, int W) {
  using namespace fb;
  const int c = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cp = (size_t)c * P + p;
  const uint8_t* al = alive + (size_t)c * T * P + p;
  const float* tc = tt + (size_t)c * T;
  const float* Xc = X + (size_t)c * T * K;
  const float* Xtc = Xt + (size_t)c * T * NT;
  const int16_t* Yc = Yt + (size_t)c * B * T * P + p;
  const bool init = in_init[cp] != 0;
  const int ci = cur_i[cp];

  // 1. i: first alive at or after the cursor (0 when none), and the alive
  //    count before it.
  int i = 0, a_before = 0;
  bool has_i = false;
  for (int t = 0; t < T; ++t) {
    const bool a = al[(size_t)t * P] != 0;
    if (a && t >= ci) {
      i = t;
      has_i = true;
      break;
    }
    a_before += a;
  }
  if (!has_i) a_before = 0;
  //    j: first alive with MEOW_SIZE alive obs in [i, j] spanning INIT_DAYS
  //    (0 when none); the alive obs of [i, j] are the window's members.
  const float t_i = tc[i];
  int j = 0, cnt = 0, n_win = 0;
  bool has_w_raw = false;
  short pos[WMAX];
  for (int t = i; t < T; ++t) {
    if (al[(size_t)t * P] == 0) continue;
    if (cnt < WMAX) pos[cnt] = (short)t;
    ++cnt;
    if (cnt >= MEOW && tc[t] - t_i >= INIT_DAYS) {
      j = t;
      has_w_raw = true;
      break;
    }
  }
  const bool has_w = has_i && has_w_raw;
  const bool work = init && has_w;
  if (work) n_win = min(cnt, min(W, WMAX));

  // 2-4. Window members, Tmask screen, stability.
  bool bad[WMAX];
  bool tm_removed = false, stable = false;
  if (work) {
    const int n = n_win;
    float Y[ND][WMAX];
    for (int s = 0; s < n; ++s) {
      bad[s] = false;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        Y[d][s] = (float)Yc[((size_t)(d + 1) * T + pos[s]) * P];
    }

    // 3. Tmask IRLS on the two Tmask bands.
    const int tmb[2] = {TM0, TM1};
    float wt[2][WMAX];
    float r[WMAX], tmp[WMAX];
    float beta[2][NT];
    for (int s = 0; s < n; ++s) wt[0][s] = wt[1][s] = 1.f;
    for (int it = 0; it <= TM_ITERS; ++it) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (it > 0) {
          // Huber weights from the previous solve's residuals.
          for (int s = 0; s < n; ++s) {
            float x[NT];
#pragma unroll
            for (int k = 0; k < NT; ++k) x[k] = __ldg(Xtc + pos[s] * NT + k);
            float pred = beta[q][0] * x[0];
#pragma unroll
            for (int k = 1; k < NT; ++k) pred = pred + beta[q][k] * x[k];
            r[s] = Y[tmb[q]][s] - pred;
          }
          const float med = median<WMAX>(r, n);
          for (int s = 0; s < n; ++s) tmp[s] = fabsf(r[s] - med);
          const float mad = median<WMAX>(tmp, n);
          const float sigma = pmax(mad / 0.6745f, 1e-6f);
          for (int s = 0; s < n; ++s) {
            const float a = fabsf(r[s]) / (HUBER_K * sigma);
            const float h = (a <= 1.f) ? 1.f : 1.f / pmax(a, 1e-12f);
            wt[q][s] = 1.f * h;
          }
        }
        // Weighted 5x5 normal equations, summed slot by slot.
        float G[NT][NT], cc[NT];
#pragma unroll
        for (int a = 0; a < NT; ++a) {
          cc[a] = 0.f;
#pragma unroll
          for (int b = 0; b < NT; ++b) G[a][b] = 0.f;
        }
        for (int s = 0; s < n; ++s) {
          float x[NT];
#pragma unroll
          for (int k = 0; k < NT; ++k) x[k] = __ldg(Xtc + pos[s] * NT + k);
          const float w = wt[q][s];
          const float yw = Y[tmb[q]][s] * w;
#pragma unroll
          for (int a = 0; a < NT; ++a) {
#pragma unroll
            for (int b = 0; b <= a; ++b) G[a][b] = G[a][b] + w * (x[a] * x[b]);
            cc[a] = cc[a] + yw * x[a];
          }
        }
#pragma unroll
        for (int a = 0; a < NT; ++a) G[a][a] = G[a][a] + 1e-9f;
        chol_solve5(G, cc, beta[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float thr = TMASK_CONST * vario[cp * B + tmb[q] + 1];
      for (int s = 0; s < n; ++s) {
        float x[NT];
#pragma unroll
        for (int k = 0; k < NT; ++k) x[k] = __ldg(Xtc + pos[s] * NT + k);
        float pred = beta[q][0] * x[0];
#pragma unroll
        for (int k = 1; k < NT; ++k) pred = pred + beta[q][k] * x[k];
        if (fabsf(Y[tmb[q]][s] - pred) > thr) {
          bad[s] = true;
          tm_removed = true;
        }
      }
    }

    // 4. Stability: 4-coefficient fit of the detection bands over the
    //    window, then the slope / first / last residual tests.
    if (!tm_removed) {
      // The fit runs over every alive observation of [i, j] (the window
      // holds more than W members only if W is below window_cap).
      Gram<ND> g;
      g.zero();
      for (int t = i; t <= j; ++t) {
        if (al[(size_t)t * P] == 0) continue;
        float x[K], y[ND];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = __ldg(Xc + t * K + k);
#pragma unroll
        for (int d = 0; d < ND; ++d)
          y[d] = (float)Yc[((size_t)(d + 1) * T + t) * P];
        g.add(x, y, 1.f);
      }
      g.finish();
      bool m4[K];
#pragma unroll
      for (int k = 0; k < K; ++k) m4[k] = k < 4;
      float c4[ND][K];
      lasso_cd<ND>(g, m4, c4);
      const float span = tc[j] - t_i;
      const float n4 = fmaxf((float)n, 1.f);
      stable = true;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float acc = 0.f, r_first = 0.f, r_last = 0.f;
        for (int s = 0; s < n; ++s) {
          float x[K];
#pragma unroll
          for (int k = 0; k < K; ++k) x[k] = __ldg(Xc + pos[s] * K + k);
          float pred = c4[d][0] * x[0];
#pragma unroll
          for (int k = 1; k < K; ++k) pred = pred + c4[d][k] * x[k];
          const float rr = Y[d][s] - pred;
          acc = acc + rr * rr * 1.f;
          if (s == 0) r_first = rr;
          if (s == cnt - 1) r_last = rr;    // 0 when the last member is past W
        }
        const float r4 = sqrtf(pmax(acc / n4, 0.f));
        const float denom = STAB * pmax(r4, vario[cp * B + d + 1]);
        const float slope_day = c4[d][1] / 365.25f;
        const bool ok = (fabsf(slope_day * span) <= denom) &&
                        (fabsf(r_first) <= denom) && (fabsf(r_last) <= denom);
        stable = stable && ok;
      }
    }
  }

  // 5. Cursor advances and the output planes.
  const bool keep = work && !tm_removed;         // w_stab's pixel gate
  int i_next = T, i_adv = 0, q = 0;
  bool has_adv = false, found_next = false;
  uint8_t* ws = w_stab + (size_t)c * T * P + p;
  uint8_t* ao = alive_out + (size_t)c * T * P + p;
  for (int t = 0; t < T; ++t) {
    const bool a = al[(size_t)t * P] != 0;
    bool b = false;
    if (work && q < n_win && pos[q] == t) {
      b = bad[q];
      ++q;
    }
    const bool a_out = a && !b;
    ao[(size_t)t * P] = a_out;
    ws[(size_t)t * P] = keep && a && t >= i && t <= j;
    if (!found_next && a_out && t >= i) {
      found_next = true;
      i_next = t;
    }
    if (!has_adv && a && t >= i + 1) {
      has_adv = true;
      i_adv = t;
    }
  }

  const size_t CP = (size_t)C * P;
  out[0 * CP + cp] = init && !has_w;                     // init_nowin
  out[1 * CP + cp] = work && tm_removed;                 // init_tm
  out[2 * CP + cp] = work && !tm_removed && stable;      // init_ok
  out[3 * CP + cp] = work && !tm_removed && !stable;     // init_bad
  out[4 * CP + cp] = has_adv;
  out[5 * CP + cp] = i_next;                             // i_next_tm
  out[6 * CP + cp] = i_adv;
  out[7 * CP + cp] = j;
  out[8 * CP + cp] = keep ? cnt : 0;                     // n_ok
}

template <int WMAX>
int launch(const void* alive, const void* cur_i, const void* in_init,
           const void* t, const void* X, const void* Xt, const void* Yt,
           const void* vario, void* out, void* w_stab, void* alive_out, int C,
           int T, int P, int W, cudaStream_t stream) {
  dim3 grid((P + fb::BLOCK - 1) / fb::BLOCK, C);
  init_kernel<WMAX><<<grid, fb::BLOCK, 0, stream>>>(
      (const uint8_t*)alive, (const int*)cur_i, (const uint8_t*)in_init,
      (const float*)t, (const float*)X, (const float*)Xt,
      (const int16_t*)Yt, (const float*)vario, (int*)out, (uint8_t*)w_stab,
      (uint8_t*)alive_out, C, T, P, W);
  return (int)cudaGetLastError();
}

}  // namespace

// alive [C,T,P] bool, cur_i [C,P] i32, in_init [C,P] bool, t [C,T] f32,
// X [C,T,8], Xt [C,T,5] f32, Yt [C,7,T,P] int16, vario [C,P,7] f32
// -> out [9,C,P] i32 (init_nowin, init_tm, init_ok, init_bad, has_adv,
//    i_next_tm, i_adv, j, n_ok), w_stab / alive_out [C,T,P] bool.
// W is the window cap, w_max the instance (32, 64 or 128) that holds it.
extern "C" int fb_init_window(const void* alive, const void* cur_i,
                              const void* in_init, const void* t,
                              const void* X, const void* Xt, const void* Yt,
                              const void* vario, void* out, void* w_stab,
                              void* alive_out, int C, int T, int P, int W,
                              int w_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > w_max || T > 32767) return (int)cudaErrorInvalidValue;
  switch (w_max) {
    case 32:
      return launch<32>(alive, cur_i, in_init, t, X, Xt, Yt, vario, out,
                        w_stab, alive_out, C, T, P, W, s);
    case 64:
      return launch<64>(alive, cur_i, in_init, t, X, Xt, Yt, vario, out,
                        w_stab, alive_out, C, T, P, W, s);
    case 128:
      return launch<128>(alive, cur_i, in_init, t, X, Xt, Yt, vario, out,
                         w_stab, alive_out, C, T, P, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
