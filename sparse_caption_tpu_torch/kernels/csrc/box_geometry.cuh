// ORT box geometry shared by K1 (box attention, forward) and K7 (its backward).
//
// For a pair of boxes (i, j) as (x_min, y_min, x_max, y_max): the four
// log-deltas of models/layers.py:338-365, then 64 trig features
// sin/cos(100 * delta_c * freq_f) (c = 0..3, f = 0..7; sin at c * 8 + f, cos
// at 32 + c * 8 + f), in f32 with full sincosf (the arguments reach 691 rad),
// each feature rounded to the compute dtype T before the wg projection.
#pragma once

#include "common.cuh"

namespace sct {

constexpr int kMaxHeads = 16;
constexpr int kFreqs = 8;  // dim_g 64 = 4 coords x 8 freqs x (sin, cos)

__device__ __forceinline__ void pair_deltas(const float* bi, const float* bj, float pos[4]) {
  const float cxi = (bi[0] + bi[2]) * 0.5f, cyi = (bi[1] + bi[3]) * 0.5f;
  const float wi = (bi[2] - bi[0]) + 1.f, hi = (bi[3] - bi[1]) + 1.f;
  const float cxj = (bj[0] + bj[2]) * 0.5f, cyj = (bj[1] + bj[3]) * 0.5f;
  const float wj = (bj[2] - bj[0]) + 1.f, hj = (bj[3] - bj[1]) + 1.f;
  pos[0] = logf(fmaxf(fabsf((cxi - cxj) / wi), 1e-3f));
  pos[1] = logf(fmaxf(fabsf((cyi - cyj) / hi), 1e-3f));
  pos[2] = logf(wi / wj);
  pos[3] = logf(hi / hj);
}

// Feature pair (sin, cos) of coordinate c and frequency f, rounded to T.
template <typename T>
__device__ __forceinline__ void trig_feature(float delta_c, float freq_f, float& sn, float& cs) {
  sincosf(100.f * delta_c * freq_f, &sn, &cs);
  sn = round_to<T>(sn);
  cs = round_to<T>(cs);
}

// Clamped geometry weight w_g = max(relu(round(round(geo . wg_h) + wg_b_h)), 1e-6)
// of every head for pair (i, j), with the cast points of layers.py:425-435
// (the log of it is the attention bias). w_s: H x 64 f32 (Linear layout),
// wb_s: H, freq_s: kFreqs.
template <typename T>
__device__ __forceinline__ void pair_wg(const float* bi, const float* bj, const float* w_s, const float* wb_s,
                                        const float* freq_s, int H, float out[kMaxHeads]) {
  float pos[4];
  pair_deltas(bi, bj, pos);
  float acc[kMaxHeads];
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) acc[hh] = 0.f;
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
#pragma unroll 1
    for (int f = 0; f < kFreqs; ++f) {
      float sn, cs;
      trig_feature<T>(pos[c], freq_s[f], sn, cs);
      const int g = c * kFreqs + f;
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) {
        if (hh < H) {
          acc[hh] = fmaf(sn, w_s[hh * 64 + g], acc[hh]);
          acc[hh] = fmaf(cs, w_s[hh * 64 + 4 * kFreqs + g], acc[hh]);
        }
      }
    }
  }
  const float min_wg = round_to<T>(1e-6f);
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    if (hh < H) {
      const float wg = round_to<T>(round_to<T>(acc[hh]) + wb_s[hh]);
      out[hh] = fmaxf(fmaxf(wg, 0.f), min_wg);  // relu, then the 1e-6 clamp
    }
  }
}

}  // namespace sct
