// K2: one decode step of causal self-attention against a K/V cache whose rows
// are never reordered by the beam search (beam-ancestry attention).
//
// Replaces: sparse_caption_tpu/models/layers.py:280-334
// MultiHeadAttention.decode_self, ancestry branch 320-334 (left to XLA on the
// TPU, where the ancestor row is selected by contracting a one-hot map).
//
// For query row n = b*K + k and head h at step t:
//   score[t'] = q[n,h] . cache_k[b*K + anc[b,k,t'], h, t'] / sqrt(dk),  t' <= t
//   out[n,h]  = sum_t' softmax(score)[t'] * cache_v[b*K + anc[b,k,t'], h, t']
// anc == nullptr means the identity map (row n reads itself).
//
// Bound on the H100 (beam 5, 8 heads, dk 64, T_max 17): bytes. At step t it
// must read the (t + 1) cached key and value slots of every row: at
// B = 2048 and t = 16, 356 MB of bf16 (0.11 ms at 3.35 TB/s), plus 21 MB of
// q and out. Slots t' > t are never read (the reference masks them to -1e9,
// whose softmax weight is exactly 0).
//
// Design: one warp per (row, head), one block per row (all heads). Each lane
// holds 2 of the 64 dims; the warp walks the slots t' = 0..t, reading the
// ancestor index directly (one broadcast load) instead of a one-hot
// contraction, and keeps an online softmax (running max, sum and P.V) in
// registers, so nothing but q, the touched cache slots and out moves.
#include "common.cuh"

namespace sct {

template <typename T>
__global__ void ancestry_self_attention_kernel(const T* __restrict__ q, const T* __restrict__ cache_k,
                                               const T* __restrict__ cache_v, const int* __restrict__ anc,
                                               T* __restrict__ out, int H, int t_max, int K, int t,
                                               float scale) {
  const int n = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t qo = ((size_t)n * H + h) * kHeadDim + 2 * lane;
  const float2 qv = load2(q + qo);
  const int b = n / K;
  const int* arow = anc != nullptr ? anc + (size_t)n * t_max : nullptr;  // anc (B, K, T_max), row n = b*K + k
  float m = -INFINITY, l = 0.f;
  float2 acc = make_float2(0.f, 0.f);
  for (int s = 0; s <= t; ++s) {
    const int r = arow != nullptr ? b * K + arow[s] : n;
    const size_t off = (((size_t)r * H + h) * t_max + s) * kHeadDim + 2 * lane;
    const float2 kv = load2(cache_k + off);
    const float2 vv = load2(cache_v + off);
    const float sc = warp_sum(qv.x * kv.x + qv.y * kv.y) * scale;
    const float mn = fmaxf(m, sc);
    const float corr = expf(m - mn);
    const float p = expf(sc - mn);
    l = l * corr + p;
    acc.x = acc.x * corr + p * vv.x;
    acc.y = acc.y * corr + p * vv.y;
    m = mn;
  }
  const float inv = 1.f / l;
  store2(out + qo, make_float2(acc.x * inv, acc.y * inv));
}

template <typename T>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* anc, void* out, int N, int H,
                   int t_max, int K, int t, float scale, cudaStream_t stream) {
  ancestry_self_attention_kernel<T><<<N, H * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const int*>(anc), static_cast<T*>(out), H, t_max, K, t, scale);
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. q/out (N, H, 64); cache_k/v (N, H, T_max, 64);
// anc (N / K, K, T_max) int32 or null; 0 <= t < T_max.
extern "C" int sct_ancestry_self_attention(int dtype, const void* q, const void* cache_k, const void* cache_v,
                                           const void* anc, void* out, int N, int H, int t_max, int K, int t,
                                           float scale, void* stream) {
  if (H < 1 || H > 32 || K < 1 || N % K != 0 || t < 0 || t >= t_max) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)sct::launch<float>(q, cache_k, cache_v, anc, out, N, H, t_max, K, t, scale, s);
  if (dtype == 1)
    return (int)sct::launch<__nv_bfloat16>(q, cache_k, cache_v, anc, out, N, H, t_max, K, t, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
