// K2's backward: the gradient of one decode step of causal self-attention
// against the K/V cache, for the identity map (each row reads its own
// cache row), f32, head width 64.
//
// Replaces: the gradient of sparse_caption_tpu/models/layers.py:317-320
// MultiHeadAttention.decode_self (scaled_dot_attention over the cache with
// the slots t' <= t valid), which XLA's autodiff derives inside the
// differentiable decode scan of supermask SCST (engine/training.py:769,
// decoding/sample.py:161-171); left to XLA on the TPU.
//
// For row n, head h at step t, with p = softmax(q . k_t' / sqrt(dk)) over
// t' <= t (the forward's, recomputed) and dout the output's gradient:
//   dv_t' = p_t' dout
//   ds_t' = p_t' (dout . v_t' - sum_t'' p_t'' dout . v_t'') / sqrt(dk)
//   dq    = sum_t' ds_t' k_t'           dk_t' = ds_t' q
// The caller's cache gradient dcache (N, H, T_max, dk; the sum of the later
// steps' contributions, kernels/ancestry_self_attention.py DecodeSelfStep)
// is updated in place: slots t' < t get += dk_t' / dv_t'; slot t's total,
// dcache[t] + this step's dk_t / dv_t, is written to dk_t / dv_t (the
// gradient of the k_t / v_t this step wrote) and slot t is zeroed. The
// division by sqrt(dk) is the plain version's true division (common.cuh
// div_score) of the scores' gradient.
//
// Bound on the H100: bytes. At step t it must read q and dout, the (t + 1)
// cached key and value slots of every row, the (t + 1) slots of both
// gradient buffers, write them back and write dq, dk_t, dv_t: at the SCST
// gradient pass (960 rows, 8 heads of 64, f32) 4 x 491,520 x (5 + 6 (t + 1))
// bytes, 21.6 MB at t = 0 and 210.4 MB at t = 16 (0.006 and 0.063 ms at
// 3.35 TB/s); a few flops a byte.
//
// Design: as the forward, one block per row (all heads), one warp per
// (row, head), each lane holding 2 of the 64 dims, and the slot t' = j * 32 +
// lane's score, dout . v and probability in its register j (S = ceil(T_max /
// 32) registers). Pass 1 walks the slots for the scores and dout . v (one
// warp reduction each), then the softmax (the forward's order) and the sum
// D = sum p dout . v (each lane's slots, then the butterfly); pass 2 walks
// them again for dq and each slot's dk / dv, read-modify-writing the
// gradient buffers. A slot's row belongs to one warp, so there are no
// atomics and the result does not change from run to run.
#include "common.cuh"

namespace sct {

template <int S>
__global__ void ancestry_self_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ cache_k,
                                                   const float* __restrict__ cache_v, const float* __restrict__ dout,
                                                   float* __restrict__ dq, float* __restrict__ dcache_k,
                                                   float* __restrict__ dcache_v, float* __restrict__ dk_t,
                                                   float* __restrict__ dv_t, int H, int t_max, int t,
                                                   float sqrt_dk) {
  constexpr int DK = 64;
  const int n = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t qo = ((size_t)n * H + h) * DK + 2 * lane;
  const float2 qv = load2(q + qo), gv = load2(dout + qo);
  const size_t head = ((size_t)n * H + h) * t_max * DK + 2 * lane;  // slot 0 of this lane's dims
  float my_score[S], my_dp[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    my_score[j] = -INFINITY;
    my_dp[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const size_t so = head + (size_t)(j * 32 + l) * DK;
      const float2 kv = load2(cache_k + so), vv = load2(cache_v + so);
      const float sc = div_score(warp_sum(qv.x * kv.x + qv.y * kv.y), sqrt_dk);
      const float dp = warp_sum(gv.x * vv.x + gv.y * vv.y);
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
  float p[S], pdp = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    p[j] = e[j] / sum;
    pdp += p[j] * my_dp[j];
  }
  const float dsum = warp_sum(pdp);
  float ds[S];
#pragma unroll
  for (int j = 0; j < S; ++j) ds[j] = div_score(p[j] * (my_dp[j] - dsum), sqrt_dk);
  float2 dqa = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const int s = j * 32 + l;
      const float dss = __shfl_sync(0xffffffffu, ds[j], l);
      const float ps = __shfl_sync(0xffffffffu, p[j], l);
      const size_t so = head + (size_t)s * DK;
      const float2 kv = load2(cache_k + so);
      dqa.x += dss * kv.x;
      dqa.y += dss * kv.y;
      const float2 dkv = make_float2(dss * qv.x, dss * qv.y), dvv = make_float2(ps * gv.x, ps * gv.y);
      const float2 ck = load2(dcache_k + so), cv = load2(dcache_v + so);
      if (s < t) {
        store2(dcache_k + so, make_float2(ck.x + dkv.x, ck.y + dkv.y));
        store2(dcache_v + so, make_float2(cv.x + dvv.x, cv.y + dvv.y));
      } else {  // slot t: the later steps' sum plus this step's, to k_t / v_t; the slot is zeroed
        store2(dk_t + qo, make_float2(ck.x + dkv.x, ck.y + dkv.y));
        store2(dv_t + qo, make_float2(cv.x + dvv.x, cv.y + dvv.y));
        store2(dcache_k + so, make_float2(0.f, 0.f));
        store2(dcache_v + so, make_float2(0.f, 0.f));
      }
    }
  }
  store2(dq + qo, dqa);
}

template <int S>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* dout, void* dq, void* dck, void* dcv,
                   void* dkt, void* dvt, int N, int H, int t_max, int t, float sqrt_dk, cudaStream_t stream) {
  ancestry_self_attention_bwd_kernel<S><<<N, H * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck), static_cast<const float*>(cv),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dck), static_cast<float*>(dcv),
      static_cast<float*>(dkt), static_cast<float*>(dvt), H, t_max, t, sqrt_dk);
  return cudaGetLastError();
}

}  // namespace sct

// dk: 64 (f32). q, dout, dq, dk_t, dv_t (N, H, dk); cache_k/v and their
// gradients dcache_k/v (N, H, T_max, dk), T_max <= 1024, the gradients
// updated in place; 0 <= t < T_max; sqrt_dk: the scores' divisor.
extern "C" int sct_ancestry_self_attention_bwd(int dk, const void* q, const void* cache_k, const void* cache_v,
                                               const void* dout, void* dq, void* dcache_k, void* dcache_v,
                                               void* dk_t, void* dv_t, int N, int H, int t_max, int t,
                                               float sqrt_dk, void* stream) {
  if (dk != 64 || N < 1 || H < 1 || H > 32 || t < 0 || t >= t_max || t_max > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2B(S) (int)sct::launch<S>(q, cache_k, cache_v, dout, dq, dcache_k, dcache_v, dk_t, dv_t, N, H, t_max, t, \
                                       sqrt_dk, s)
  if (t_max <= 32) return SCT_K2B(1);
  if (t_max <= 64) return SCT_K2B(2);
  if (t_max <= 128) return SCT_K2B(4);
  if (t_max <= 256) return SCT_K2B(8);
  if (t_max <= 512) return SCT_K2B(16);
  return SCT_K2B(32);
#undef SCT_K2B
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
