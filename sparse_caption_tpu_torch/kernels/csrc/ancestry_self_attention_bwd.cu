// K2's backward: the gradient of one decode step of causal self-attention
// against the K/V cache, f32, head widths 64, 32 and 13, for the identity
// map (each row reads its own cache row; the sampling decode) and, in the
// ancestry mode (ancestry_self_attention_bwd_anc.cu, its own library),
// through the beam-ancestry map (beam search: row r of image b reads slot
// t' of row b K + anc[b, r, t']); each with unshared K and V or in the kv
// mode (ACORT's kv-shared layers: one cache array read as K and V,
// sparse_caption_tpu/models/layers.py:296,305-310). The code the modes
// share is in ancestry_self_attention_bwd.cuh.
//
// Replaces: the gradient of sparse_caption_tpu/models/layers.py:317-320
// MultiHeadAttention.decode_self (scaled_dot_attention over the cache with
// the slots t' <= t valid), which XLA's autodiff derives inside the
// differentiable decode scan of supermask SCST (engine/training.py:769,
// decoding/sample.py:161-171), and in the ancestry mode the gradient of
// layers.py:320-333 (the scores and the output through ancestry_onehot),
// which it derives inside the differentiable beam search of beam-sample
// SCST (engine/training.py:467-468,768-770); left to XLA on the TPU.
//
// For row n, head h at step t, with p = softmax(q . k_t' / sqrt(dk)) over
// t' <= t (the forward's, recomputed) and dout the output's gradient:
//   dv_t' = p_t' dout
//   ds_t' = p_t' (dout . v_t' - sum_t'' p_t'' dout . v_t'') / sqrt(dk)
//   dq    = sum_t' ds_t' k_t'           dk_t' = ds_t' q
// where k_t', v_t' are the slots the row read. In the ancestry mode slot t'
// of row j receives the sum of dk_t' / dv_t' over the image's rows r with
// anc[b, r, t'] == j, taken in the order r = 0, 1, ..., K - 1 (no atomics;
// at t' = 0 every beam descends from beam 0, so one slot takes K terms).
// The caller's cache gradient dcache (N, H, T_max, dk; the sum of the later
// steps' contributions, kernels/ancestry_self_attention.py DecodeSelfStep)
// is updated in place: slots t' < t get += dk_t' / dv_t'; slot t's total,
// dcache[t] + this step's dk_t / dv_t, is written to dk_t / dv_t (the
// gradient of the k_t / v_t this step wrote) and slot t is zeroed. The
// division by sqrt(dk) is the plain version's true division (common.cuh
// div_score) of the scores' gradient.
//
// The kv mode: the one cache is K and V, so slot t' of its gradient takes
// both terms, ds_t' q + p_t' dout (summed as dk_t' + dv_t', the plain
// version's autograd adding the two uses of the one tensor), and the step's
// d(k_t) is slot t's total; there is no dcache_v and no dv_t.
//
// Bound on the H100: bytes. At step t it must read q and dout, the (t + 1)
// cached key and value slots of every row, the (t + 1) slots of both
// gradient buffers, write them back and write dq, dk_t, dv_t: at the SCST
// gradient pass (960 rows, 8 heads of 64, f32) 4 x 491,520 x (5 + 6 (t + 1))
// bytes, 21.6 MB at t = 0 and 210.4 MB at t = 16 (0.006 and 0.063 ms at
// 3.35 TB/s); a few flops a byte. In the ancestry mode only the (row, slot)
// pairs the map names are read and written back (chip_smoke.py
// k2_bwd_anc_bytes counts them on the run's map).
//
// Design: as the forward, one block per row (all heads), one warp per
// (row, head), each lane holding its dims of the row (common.cuh LaneDims:
// 2 of 64, 1 of 32; at dk 13 lanes 0-12 one each, lanes 13-31 hold 0 and
// touch no memory), and the slot t' = j * 32 +
// lane's score, dout . v and probability in its register j (S = ceil(T_max /
// 32) registers). Pass 1 walks the slots for the scores and dout . v (one
// warp reduction each), then the softmax (the forward's order) and the sum
// D = sum p dout . v (each lane's slots, then the butterfly); pass 2 walks
// them again for dq and each slot's dk / dv, read-modify-writing the
// gradient buffers. A slot's row belongs to one warp, so there are no
// atomics and the result does not change from run to run.
//
// The ancestry mode: ancestry_self_attention_bwd_anc.cu.
#include "ancestry_self_attention_bwd.cuh"

// Statements that return, as an int, LAUNCH(DK, S) for the instance of
// head width dk (64, 32, 13) whose S, the smallest of 1, 2, 4, .., 32 with
// 32 S >= t_max, holds the slots, and cudaErrorInvalidValue for any other
// width: the body of the entry after its argument checks.
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

namespace sct {

// The walks over a register block's 32 slots (the inner loops over l)
// unroll 4 deep, not whole: unrolled whole, an 18-instance library of them
// took 340 s to compile on the card's host.

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


// cache_v, dcache_v, dv_t == nullptr: the kv mode
template <int DK, int S>
__global__ void ancestry_self_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ cache_k,
                                                   const float* __restrict__ cache_v, const float* __restrict__ dout,
                                                   float* __restrict__ dq, float* __restrict__ dcache_k,
                                                   float* __restrict__ dcache_v, float* __restrict__ dk_t,
                                                   float* __restrict__ dv_t, int H, int t_max, int t,
                                                   float sqrt_dk) {
  using L = LaneDims<DK, float>;
  constexpr int PL = kLaneDims<DK>;  // dims a lane holds
  const float* __restrict__ vals = cache_v != nullptr ? cache_v : cache_k;
  const int n = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t qo = ((size_t)n * H + h) * DK + PL * lane;
  L qv, gv;
  qv.load(q + qo, lane);
  gv.load(dout + qo, lane);
  const size_t head = ((size_t)n * H + h) * t_max * DK + PL * lane;  // slot 0 of this lane's dims
  float p[S], ds[S];
  slot_softmax_grad<DK, S>(qv, gv, cache_k, vals, [&](int s) { return head + (size_t)s * DK; }, lane, t, sqrt_dk,
                           p, ds);
  L dqa{};
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll 4
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const int s = j * 32 + l;
      const float dss = __shfl_sync(0xffffffffu, ds[j], l);
      const float ps = __shfl_sync(0xffffffffu, p[j], l);
      const size_t so = head + (size_t)s * DK;
      L kk;
      kk.load(cache_k + so, lane);
      dqa.add(dss, kk);
      update_slot<DK>(dcache_k, dcache_v, dk_t, dv_t, so, qo, s == t, qv.times(dss), gv.times(ps), lane);
    }
  }
  dqa.store(dq + qo, lane);
}

template <int DK, int S>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* dout, void* dq, void* dck, void* dcv,
                   void* dkt, void* dvt, int N, int H, int t_max, int t, float sqrt_dk, cudaStream_t stream) {
  ancestry_self_attention_bwd_kernel<DK, S><<<N, H * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck), static_cast<const float*>(cv),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dck), static_cast<float*>(dcv),
      static_cast<float*>(dkt), static_cast<float*>(dvt), H, t_max, t, sqrt_dk);
  return cudaGetLastError();
}

// cv == nullptr: the kv mode (dcv, dvt null too)
int entry(int dk, const void* q, const void* ck, const void* cv, const void* dout, void* dq, void* dck, void* dcv,
          void* dkt, void* dvt, int N, int H, int t_max, int t, float sqrt_dk, void* stream) {
  if (!k2_bwd_args_ok(dk, cv, dcv, dvt, nullptr, N, H, 1, t_max, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2B_LAUNCH(DK, S) launch<DK, S>(q, ck, cv, dout, dq, dck, dcv, dkt, dvt, N, H, t_max, t, sqrt_dk, s)
  SCT_K2B_DISPATCH(dk, t_max, SCT_K2B_LAUNCH)
#undef SCT_K2B_LAUNCH
}

}  // namespace sct

// dk: 64, 32 or 13 (f32). q, dout, dq, dk_t, dv_t (N, H, dk); cache_k/v and
// their gradients dcache_k/v (N, H, T_max, dk), T_max <= 1024, H <= 32, the
// gradients updated in place; 0 <= t < T_max; sqrt_dk: the scores' divisor.
extern "C" int sct_ancestry_self_attention_bwd(int dk, const void* q, const void* cache_k, const void* cache_v,
                                               const void* dout, void* dq, void* dcache_k, void* dcache_v,
                                               void* dk_t, void* dv_t, int N, int H, int t_max, int t,
                                               float sqrt_dk, void* stream) {
  if (cache_v == nullptr) return (int)cudaErrorInvalidValue;
  return sct::entry(dk, q, cache_k, cache_v, dout, dq, dcache_k, dcache_v, dk_t, dv_t, N, H, t_max, t, sqrt_dk,
                    stream);
}

// The kv mode: cache (N, H, T_max, dk) is K and V; dcache its gradient; dk_t
// the gradient of the step's one row.
extern "C" int sct_ancestry_self_attention_bwd_kv(int dk, const void* q, const void* cache, const void* dout,
                                                  void* dq, void* dcache, void* dk_t, int N, int H, int t_max, int t,
                                                  float sqrt_dk, void* stream) {
  return sct::entry(dk, q, cache, nullptr, dout, dq, dcache, nullptr, dk_t, nullptr, N, H, t_max, t, sqrt_dk, stream);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
