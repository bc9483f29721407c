// The segment close, shared by the fused_fit_close, fused_round and
// detect_mega kernels: the closing segment's meta row and its one-slot
// append into the [C, P, S, k] result buffers (cuda_ops.write_slot, the
// contract of pallas_ops._close_logic), and the break magnitudes over the
// PEEK run (kernel._close_mags).
#pragma once

#include "ccd_common.cuh"

namespace fb {

constexpr int QA_INSIDE = 4;    // params.CURVE_QA_INSIDE
constexpr int QA_START = 8;     // params.CURVE_QA_START
constexpr int QA_END = 16;      // params.CURVE_QA_END

// The four result buffers of a batch: meta [C,P,S,6], rmse and mag
// [C,P,S,NB], coef [C,P,S,NB,K].  Written in place, one slot at a time.
struct SegBufs {
  float* meta;
  float* rmse;
  float* mag;
  float* coef;
  int S;
};

// Append one pixel's closing segment at slot nseg (cp = c*P + p), given
// the segment's first / last included observation (0 / T-1 when none:
// argmax semantics) and their count; tc is the chip's days [T], rmse_row
// [NB] and coef_row [NB*K] the closing model, mag_row [NB] its break
// magnitudes (null: zeros, as for a tail).  A slot past capacity S is not
// written; the caller still counts the close (capacity_retry relies on
// it).
template <int NB>
__device__ void close_write(const float* tc, int first, int last, int n_obs,
                            size_t cp, bool is_brk, int pos_ev, int n_exceed,
                            bool first_seg, int nseg, const float* rmse_row,
                            const float* mag_row, const float* coef_row,
                            const SegBufs& bufs) {
  if (nseg >= bufs.S) return;
  const float end_day = tc[last];
  const int qa = is_brk ? (first_seg ? QA_START : QA_INSIDE)
                        : QA_END + (first_seg ? QA_START : 0);
  const size_t slot = cp * bufs.S + nseg;
  float* meta = bufs.meta + slot * 6;
  meta[0] = tc[first];
  meta[1] = end_day;
  meta[2] = is_brk ? tc[pos_ev] : end_day;
  // A true division: a multiply by the reciprocal is one ulp off.
  meta[3] = is_brk ? 1.f : __fdiv_rn((float)n_exceed, (float)PEEK);
  meta[4] = (float)qa;
  meta[5] = (float)n_obs;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    bufs.rmse[slot * NB + b] = rmse_row[b];
    bufs.mag[slot * NB + b] = mag_row ? mag_row[b] : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      bufs.coef[(slot * NB + b) * K + k] = coef_row[b * K + k];
  }
}

// The break magnitudes from the PEEK run's time steps ts[0..n) (n <= PEEK,
// in order): per band, the median residual of the model coef_row.  Xc may
// lie in global or shared memory.
template <int NB>
__device__ void peek_mags_at(const int16_t* Yc, const float* Xc,
                             const float* coef_row, const int* ts, int n,
                             int T, int P, int p, float mags[NB]) {
  float r[NB][PEEK];
  for (int i = 0; i < n; ++i) {
    const int t = ts[i];
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = Xc[t * K + k];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float pred = coef_row[b * K] * x[0];
#pragma unroll
      for (int k = 1; k < K; ++k) pred = pred + coef_row[b * K + k] * x[k];
      r[b][i] = (float)Yc[((size_t)b * T + t) * P + p] - pred;
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) mags[b] = median<PEEK>(r[b], n);
}

}  // namespace fb
