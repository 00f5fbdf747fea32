// K2's backward (ancestry_self_attention_bwd.cu: the identity map;
// ancestry_self_attention_bwd_anc.cu: the ancestry mode): the code both
// modes share, each mode a library of its own so that the two compile in
// parallel (every (head width, slot registers) pair is an instance of each).
// What the kernels compute, their bound and their design are in the two
// sources' notes. The walks over a register block's 32 slots (the inner
// loops over l) unroll 4 deep, not whole: unrolled whole, the ancestry mode's
// 18 instances took 340 s to compile on the card's host, longer than every
// other library.
#pragma once

#include "common.cuh"

namespace sct {

// The (row, head)'s softmax over slots 0..t and its score gradients, from
// the lanes' slots: `slot(s)` is the offset of slot s of the row the warp
// reads (this lane's dims), `vals` the V cache (the K cache in the kv mode).
// Leaves p and ds in the registers of the lane of each slot (register j: slot
// j * 32 + lane).
template <int DK, int S, typename SlotFn>
__device__ __forceinline__ void slot_softmax_grad(const LaneDims<DK, float>& qv, const LaneDims<DK, float>& gv,
                                                  const float* __restrict__ cache_k, const float* __restrict__ vals,
                                                  SlotFn slot, int lane, int t, float sqrt_dk, float (&p)[S],
                                                  float (&ds)[S]) {
  float my_score[S], my_dp[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    my_score[j] = -INFINITY;
    my_dp[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll 4
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const size_t so = slot(j * 32 + l);
      LaneDims<DK, float> kk, vv;
      kk.load(cache_k + so, lane);
      vv.load(vals + so, lane);
      const float sc = div_score(warp_sum(qv.dot(kk)), sqrt_dk);
      const float dp = warp_sum(gv.dot(vv));
      if (lane == l) {
        my_score[j] = sc;
        my_dp[j] = dp;
      }
    }
  }
  float m = my_score[0];
#pragma unroll
  for (int j = 1; j < S; ++j) m = fmaxf(m, my_score[j]);
  m = warp_max(m);
  float e[S], sum = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    e[j] = j * 32 + lane <= t ? expf(my_score[j] - m) : 0.f;
    sum += e[j];
  }
  sum = warp_sum(sum);
  float pdp = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    p[j] = e[j] / sum;
    pdp += p[j] * my_dp[j];
  }
  const float dsum = warp_sum(pdp);
#pragma unroll
  for (int j = 0; j < S; ++j) ds[j] = div_score(p[j] * (my_dp[j] - dsum), sqrt_dk);
}

// Slot so of the gradient buffers takes this step's dK (dkv) and dV (dvv):
// added where s < t; at slot t the total goes to the step's dk_t / dv_t (at
// `to`) and the slot is zeroed. The kv mode (dcache_v == nullptr) adds both
// terms to the one buffer and its slot t's total to dk_t.
template <int DK>
__device__ __forceinline__ void update_slot(float* __restrict__ dcache_k, float* __restrict__ dcache_v,
                                            float* __restrict__ dk_t, float* __restrict__ dv_t, size_t so, size_t to,
                                            bool last, const LaneDims<DK, float>& dkv,
                                            const LaneDims<DK, float>& dvv, int lane) {
  using L = LaneDims<DK, float>;
  const L zero{};
  L ck;
  ck.load(dcache_k + so, lane);
  if (dcache_v == nullptr) {  // the kv mode: one buffer, both terms
    const L tot = ck.plus(dkv.plus(dvv));
    tot.store(last ? dk_t + to : dcache_k + so, lane);
    if (last) zero.store(dcache_k + so, lane);
    return;
  }
  L cv;
  cv.load(dcache_v + so, lane);
  const L tk = ck.plus(dkv), tv = cv.plus(dvv);
  if (!last) {
    tk.store(dcache_k + so, lane);
    tv.store(dcache_v + so, lane);
  } else {  // slot t: the later steps' sum plus this step's, to k_t / v_t; the slot is zeroed
    tk.store(dk_t + to, lane);
    tv.store(dv_t + to, lane);
    zero.store(dcache_k + so, lane);
    zero.store(dcache_v + so, lane);
  }
}

// dynamic shared memory of the ancestry mode: the image's K rows' q and
// dout (dk each), then p, ds and the map's columns 0..t
__host__ __device__ inline size_t anc_bwd_smem_bytes(int dk, int K, int t) {
  return (size_t)K * 2 * dk * sizeof(float) + (size_t)K * (t + 1) * 3 * sizeof(float);
}

// the arguments both modes take: anc == nullptr is the identity map (K = 1);
// cv == nullptr the kv mode, with dcv and dvt null too
inline bool k2_bwd_args_ok(int dk, const void* cv, const void* dcv, const void* dvt, const void* anc, int N, int H,
                           int K, int t_max, int t) {
  return K >= 1 && N >= K && N % K == 0 && H >= 1 && H <= 32 && t >= 0 && t < t_max && t_max <= 1024 &&
         (cv == nullptr) == (dcv == nullptr) && (cv == nullptr) == (dvt == nullptr) &&
         (anc == nullptr || anc_bwd_smem_bytes(dk, K, t) <= (size_t)kBlockSmemLimit);
}

}  // namespace sct

// Statements that return, as an int, LAUNCH(DK, S) for the instance of
// head width dk (64, 32, 13) whose S, the smallest of 1, 2, 4, .., 32 with
// 32 S >= t_max, holds the slots, and cudaErrorInvalidValue for any other
// width: the body of each mode's entry after its argument checks.
#define SCT_K2B_BY_S(DK, t_max, LAUNCH)               \
  if ((t_max) <= 32) return (int)LAUNCH(DK, 1);       \
  if ((t_max) <= 64) return (int)LAUNCH(DK, 2);       \
  if ((t_max) <= 128) return (int)LAUNCH(DK, 4);      \
  if ((t_max) <= 256) return (int)LAUNCH(DK, 8);      \
  if ((t_max) <= 512) return (int)LAUNCH(DK, 16);     \
  return (int)LAUNCH(DK, 32);
#define SCT_K2B_DISPATCH(dk, t_max, LAUNCH)                \
  if ((dk) == 64) { SCT_K2B_BY_S(64, t_max, LAUNCH) }      \
  if ((dk) == 32) { SCT_K2B_BY_S(32, t_max, LAUNCH) }      \
  if ((dk) == 13) { SCT_K2B_BY_S(13, t_max, LAUNCH) }      \
  return (int)cudaErrorInvalidValue;
