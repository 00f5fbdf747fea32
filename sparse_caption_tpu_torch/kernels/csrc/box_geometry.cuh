// ORT box geometry shared by K1 (box attention, forward) and K7 (its backward).
//
// For a pair of boxes (i, j) as (x_min, y_min, x_max, y_max): the four
// log-deltas of models/layers.py:338-365, then 64 trig features
// sin/cos(100 * delta_c * freq_f) (c = 0..3, f = 0..7; sin at c * 8 + f, cos
// at 32 + c * 8 + f), in f32 with full sincosf (the arguments reach 691 rad),
// each feature rounded to the compute dtype T before the wg projection.
// The raw geometry (dim_g 4, --no_box_trigonometric_embedding,
// layers.py:358-360): the four log-deltas themselves, rounded to T, are the
// features; the projection is four FMAs a head in coordinate order. dim_g is
// a run-time argument of the kernels (64 or kRawG), not a template axis.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace sct {

constexpr int kMaxHeads = 16;
constexpr int kFreqs = 8;  // dim_g 64 = 4 coords x 8 freqs x (sin, cos)
constexpr int kTrigG = 64;
constexpr int kRawG = 4;  // dim_g of the raw geometry: the four log-deltas

// Log-delta c of the pair (i, j) (layers.py:338-365): c = 0, 1 the clamped
// log |center offset| over box i's width / height, c = 2, 3 the log of the
// width / height ratio.
__device__ __forceinline__ float pair_delta(const float* bi, const float* bj, int c) {
  const int lo = c & 1;  // x (0) or y (1)
  const float ci = (bi[lo] + bi[lo + 2]) * 0.5f, si = (bi[lo + 2] - bi[lo]) + 1.f;
  const float cj = (bj[lo] + bj[lo + 2]) * 0.5f, sj = (bj[lo + 2] - bj[lo]) + 1.f;
  return c < 2 ? logf(fmaxf(fabsf((ci - cj) / si), 1e-3f)) : logf(si / sj);
}

// sincosf kept out of line: its full-range reduction is long, and the
// kernels call it from unrolled loops (16 call sites in a geometry tile); one
// copy keeps the instruction cache from thrashing
__device__ __noinline__ float2 sincos_call(float x) {
  float2 r;
  sincosf(x, &r.x, &r.y);
  return r;
}

// Feature pair (sin, cos) of coordinate c and frequency f, rounded to T.
template <typename T>
__device__ __forceinline__ void trig_feature(float delta_c, float freq_f, float& sn, float& cs) {
  const float2 r = sincos_call(100.f * delta_c * freq_f);
  sn = r.x;
  cs = r.y;
  sn = round_to<T>(sn);
  cs = round_to<T>(cs);
}

// The raw geometry's clamped w_g of every head for pair (i, j): the log-deltas
// rounded to T, then max(relu(round(round(geo . wg_h) + wg_b_h)), round(1e-6))
// with the product summed in coordinate order (F.linear's rounding: the
// product, then the bias add). w: H x 4 (Linear layout) in f32 or T, wb_s: H.
template <typename T, typename W>
__device__ __forceinline__ void pair_wg_raw(const float* bi, const float* bj, const W* w, const float* wb_s, int H,
                                            float out[kMaxHeads]) {
  float pos[kRawG];
#pragma unroll
  for (int c = 0; c < kRawG; ++c) pos[c] = round_to<T>(pair_delta(bi, bj, c));
  const float min_wg = round_to<T>(1e-6f);
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    if (hh < H) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kRawG; ++c) acc = fmaf(pos[c], to_f(w[hh * kRawG + c]), acc);
      const float wg = round_to<T>(round_to<T>(acc) + wb_s[hh]);
      out[hh] = fmaxf(fmaxf(wg, 0.f), min_wg);  // relu, then the 1e-6 clamp
    }
  }
}

// The raw geometry's log-bias log(w_g) of one image's every (head, pair),
// pair by pair over the block's threads, into bias_s (H x R x R) and, when
// not null, bias_out (the image's H x R x R). A function of its own (not
// inlined) for the bf16 kernels, whose trig path then keeps the code it had
// before the raw geometry came; the f32 kernels branch pair by pair (a call
// there costs them registers, and a loop of each kind more time).
template <typename T, typename W>
__device__ __noinline__ void raw_log_bias(const float* box_s, const W* w, const float* wb_s, int H, int R, T* bias_s,
                                          T* bias_out) {
  const int P = R * R;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int i = p / R, j = p - (p / R) * R;
    float wg[kMaxHeads];
    pair_wg_raw<T>(box_s + 4 * i, box_s + 4 * j, w, wb_s, H, wg);
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh < H) {
        const T lb = from_f<T>(logf(wg[hh]));
        bias_s[hh * P + p] = lb;
        if (bias_out != nullptr) bias_out[hh * P + p] = lb;
      }
    }
  }
}

// Clamped geometry weight w_g = max(relu(round(round(geo . wg_h) + wg_b_h)), 1e-6)
// of every head for pair (i, j), with the cast points of layers.py:425-435
// (the log of it is the attention bias). w_s: H x 64 f32 (Linear layout),
// wb_s: H, freq_s: kFreqs.
template <typename T>
__device__ __forceinline__ void pair_wg(const float* bi, const float* bj, const float* w_s, const float* wb_s,
                                        const float* freq_s, int H, float out[kMaxHeads]) {
  float pos[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) pos[c] = pair_delta(bi, bj, c);
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

// ---------------------------------------------- bf16: the wg projection by MMA
// The (pairs x 64) trig features times wg^T (64 x h) as mma.m16n8k16 tiles:
// a tile is 16 pairs (of the R x R grid, row-major i * R + j), the whole
// 64-wide feature row is four k-steps, and one n-tile holds 8 heads (two for
// h <= 16). Each thread computes exactly the features its A fragments hold:
// for its pairs 16 mt + g and + 8 and frequencies 2t, 2t + 1, one sincosf per
// (pair, coordinate, frequency) gives the sin (k-steps 0-1) and the cos
// (k-steps 2-3) feature. No feature and no weight goes through shared memory.
constexpr int kHeadTiles = kMaxHeads / 8;

// B fragments of wg^T: wg_w is (H, 64) bf16 in global memory, heads >= H zero
__device__ __forceinline__ void load_wg_frags(const __nv_bfloat16* __restrict__ wg_w, int H,
                                              uint32_t wfrag[kHeadTiles][4][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kHeadTiles; ++nt) {
    const int head = 8 * nt + g;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const __nv_bfloat16* w = wg_w + head * 64 + 16 * ks + 2 * t;
      wfrag[nt][ks][0] = head < H ? *reinterpret_cast<const uint32_t*>(w) : 0u;
      wfrag[nt][ks][1] = head < H ? *reinterpret_cast<const uint32_t*>(w + 8) : 0u;
    }
  }
}

// Clamped w_g = max(relu(round(round(geo . wg_h) + wg_b_h)), round(1e-6)) of
// pair tile mt for this thread's C fragment: wgc[nt][e] is pair 16 mt + g +
// 8 (e >> 1), head 8 nt + 2t + (e & 1). fq: freq[2t], freq[2t + 1]; wb_s: the
// H biases (f32 values of bf16); pairs past R * R compute pair 0 (not to be stored).
__device__ __forceinline__ void geometry_tile_bf16(const float* box_s, int R, int mt, const float fq[2],
                                                   const uint32_t wfrag[kHeadTiles][4][2], int H,
                                                   const float* wb_s, float wgc[kHeadTiles][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the quad shares its two pairs: each lane computes coordinate t, then shuffles
  float pos[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int p = 16 * mt + g + 8 * q;
    if (p >= R * R) p = 0;
    const int i = p / R, j = p - (p / R) * R;
    const float mine = pair_delta(box_s + 4 * i, box_s + 4 * j, t);
#pragma unroll
    for (int c = 0; c < 4; ++c) pos[q][c] = __shfl_sync(0xffffffffu, mine, (lane & ~3) + c);
  }
  uint32_t a[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s0, c0, s1, c1;
      trig_feature<float>(pos[q][c], fq[0], s0, c0);  // rounded to bf16 as they are packed
      trig_feature<float>(pos[q][c], fq[1], s1, c1);
      a[c >> 1][q + 2 * (c & 1)] = pack_bf16(s0, s1);        // sin: feature c * 8 + f
      a[2 + (c >> 1)][q + 2 * (c & 1)] = pack_bf16(c0, c1);  // cos: feature 32 + c * 8 + f
    }
  }
  const float min_wg = round_to<__nv_bfloat16>(1e-6f);
#pragma unroll
  for (int nt = 0; nt < kHeadTiles; ++nt) {
    if (8 * nt >= H) break;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_bf16(acc, a[ks], wfrag[nt][ks]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = 8 * nt + 2 * t + (e & 1);
      const float wb = head < H ? wb_s[head] : 0.f;
      const float wg = round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(acc[e]) + wb);
      wgc[nt][e] = fmaxf(fmaxf(wg, 0.f), min_wg);  // relu, then the 1e-6 clamp
    }
  }
}

}  // namespace sct
