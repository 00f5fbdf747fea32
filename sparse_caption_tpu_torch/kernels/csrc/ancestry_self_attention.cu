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
// Bound on the H100 (beam 5, 8 heads, dk 64, T_max 17; at dk 32 half the bytes): bytes. At step t it
// must read the (t + 1) cached key and value slots of every row: at
// B = 2048 and t = 16, 356 MB of bf16 (0.11 ms at 3.35 TB/s), plus 21 MB of
// q and out. Slots t' > t are never read (the reference masks them to -1e9,
// whose softmax weight is exactly 0).
//
// Design: one warp per (row, head), one block per row (all heads). Each lane
// holds DK / 32 of the DK dims (2 at DK = 64, 1 at DK = 32: ACORT-small's
// d256 over 8 heads; at DK = 13, ORT-xsmall's d104 over 8 heads, lanes 0-12
// one dim each and lanes 13-31 idle, SIMT as at 32), and S = ceil(T_max / 32) slots of the row: slot
// j*32 + lane in its register j, with that slot's cache row (its ancestor,
// one load per lane instead of a one-hot contraction). The warp walks the
// slots t' = 0..t twice: first the keys, each score reduced across the warp
// and kept by the lane of its slot, then the values. The softmax between the
// two passes is the plain version's, rounding point for rounding point: the
// score rounded to T (the product q k^T in T), divided by sqrt(dk) in T
// (common.cuh div_score) and rounded again; then PyTorch's warp softmax over the row (rows up to 1024), in its
// layout: each lane's max over its slots, the butterfly max, e = exp(score -
// max), each lane's sum of its e in slot order, the butterfly sum, p = e /
// sum rounded to T; the output sums p v in f32 and rounds once. The row's
// scores and weights stay in registers; nothing but q, the touched cache
// slots and out moves.
//
// kv mode (sct_ancestry_self_attention_kv; ACORT's kv-shared layers, whose
// cache holds one array that is both K and V): the value pass reads the same
// cache rows as the key pass, which the key pass has just brought into the
// SM's L1 (the kernel takes no shared memory, so L1 keeps its largest
// carveout) or L2: each cached slot comes from memory once. Bytes at ACORT
// serving (B = 2048, beam 5, 8 heads, step t): (t + 1) x 10.5 MB instead of
// (t + 1) x 21 MB. Keeping the rows in shared memory between the passes was
// slower on an H100 (bf16, B = 2048, 26 slots, last step: 0.1908 ms
// against 0.1811 for the re-read; f32 0.2616 against 0.1995): the staging
// shrinks L1, and the stores cost more than the re-read's hits.
#include "common.cuh"

namespace sct {

// cache_v == nullptr: the kv mode, V read from the K cache
template <int DK, typename T, int S>
__global__ void ancestry_self_attention_kernel(const T* __restrict__ q, const T* __restrict__ cache_k,
                                               const T* __restrict__ cache_v, const int* __restrict__ anc,
                                               T* __restrict__ out, int H, int t_max, int K, int t,
                                               float sqrt_dk) {
  constexpr int PL = kLaneDims<DK>;  // dims a lane holds
  const T* __restrict__ vals = cache_v != nullptr ? cache_v : cache_k;
  const int n = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t qo = ((size_t)n * H + h) * DK + PL * lane;
  LaneDims<DK, T> qv;
  qv.load(q + qo, lane);
  const int b = n / K;
  // anc (B, K, T_max), row n = b*K + k; lane l's register j <= t holds slot j*32 + l's cache row
  int my_row[S];
  float my_score[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int slot = j * 32 + lane;
    my_row[j] = anc != nullptr && slot <= t ? b * K + anc[(size_t)n * t_max + slot] : n;
    my_score[j] = -INFINITY;
  }
  const size_t head = (size_t)h * t_max * DK + PL * lane;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const int s = j * 32 + l;
      const int r = __shfl_sync(0xffffffffu, my_row[j], l);
      LaneDims<DK, T> kv;
      kv.load(cache_k + (size_t)r * H * t_max * DK + head + (size_t)s * DK, lane);
      const float sc = round_to<T>(div_score(round_to<T>(warp_sum(qv.dot(kv))), sqrt_dk));
      if (lane == l) my_score[j] = sc;
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
  float p[S];
#pragma unroll
  for (int j = 0; j < S; ++j) p[j] = round_to<T>(e[j] / sum);
  LaneDims<DK, T> acc{};
#pragma unroll
  for (int j = 0; j < S; ++j) {
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const int s = j * 32 + l;
      const int r = __shfl_sync(0xffffffffu, my_row[j], l);
      const float ps = __shfl_sync(0xffffffffu, p[j], l);
      LaneDims<DK, T> vv;
      vv.load(vals + (size_t)r * H * t_max * DK + head + (size_t)s * DK, lane);
      acc.add(ps, vv);
    }
  }
  acc.store(out + qo, lane);
}

template <int DK, typename T, int S>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* anc, void* out, int N, int H,
                   int t_max, int K, int t, float sqrt_dk, cudaStream_t stream) {
  ancestry_self_attention_kernel<DK, T, S><<<N, H * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const int*>(anc), static_cast<T*>(out), H, t_max, K, t, sqrt_dk);
  return cudaGetLastError();
}

// the smallest S of 1, 2, 4, .., 32 with 32 S >= T_max
template <int DK, typename T>
cudaError_t dispatch(const void* q, const void* ck, const void* cv, const void* anc, void* out, int N, int H,
                     int t_max, int K, int t, float sqrt_dk, cudaStream_t stream) {
  if (t_max <= 32) return launch<DK, T, 1>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
  if (t_max <= 64) return launch<DK, T, 2>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
  if (t_max <= 128) return launch<DK, T, 4>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
  if (t_max <= 256) return launch<DK, T, 8>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
  if (t_max <= 512) return launch<DK, T, 16>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
  return launch<DK, T, 32>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
}

int entry(int dtype, int dk, const void* q, const void* ck, const void* cv, const void* anc, void* out, int N,
          int H, int t_max, int K, int t, float sqrt_dk, void* stream) {
  if (H < 1 || H > 32 || K < 1 || N % K != 0 || t < 0 || t >= t_max || t_max > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2(DK, T) (int)dispatch<DK, T>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, s)
  if (dk == 64 && dtype == 0) return SCT_K2(64, float);
  if (dk == 64 && dtype == 1) return SCT_K2(64, __nv_bfloat16);
  if (dk == 32 && dtype == 0) return SCT_K2(32, float);
  if (dk == 32 && dtype == 1) return SCT_K2(32, __nv_bfloat16);
  if (dk == 13 && dtype == 0) return SCT_K2(13, float);
  if (dk == 13 && dtype == 1) return SCT_K2(13, __nv_bfloat16);
#undef SCT_K2
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16; dk: 64, 32 or 13. q/out (N, H, dk); cache_k/v
// (N, H, T_max, dk), T_max <= 1024; anc (N / K, K, T_max) int32 or null; 0 <= t < T_max;
// sqrt_dk: the scores' divisor, sqrt(dk) rounded to the compute dtype.
extern "C" int sct_ancestry_self_attention(int dtype, int dk, const void* q, const void* cache_k, const void* cache_v,
                                           const void* anc, void* out, int N, int H, int t_max, int K, int t,
                                           float sqrt_dk, void* stream) {
  if (cache_v == nullptr) return (int)cudaErrorInvalidValue;
  return sct::entry(dtype, dk, q, cache_k, cache_v, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
}

// kv mode: cache (N, H, T_max, dk) is both K and V.
extern "C" int sct_ancestry_self_attention_kv(int dtype, int dk, const void* q, const void* cache, const void* anc,
                                              void* out, int N, int H, int t_max, int K, int t, float sqrt_dk,
                                              void* stream) {
  return sct::entry(dtype, dk, q, cache, nullptr, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
