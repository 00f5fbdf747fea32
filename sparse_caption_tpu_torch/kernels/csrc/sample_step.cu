// K9: one step of the sampling decode: log_softmax, temperature, Gumbel-max
// sample (or greedy argmax), chosen log-prob and the `unfinished` latch,
// without materialising the (N, V) log-probs.
//
// Replaces: sparse_caption_tpu/decoding/sample.py:134-159 (the body of the
// sampling loop: decoding_constraint, jax.random.categorical, the chosen
// log-prob, the latch and the seq writes) together with the train-mode
// generator's f32 log_softmax (sparse_caption_tpu/models/layers.py:465-472).
// Left to XLA on the TPU.
//
// For each row n of logits (N, V) in the compute dtype T:
//   lp[v] = T((x[v] - max) - log(sum exp(x - max)))        (log_softmax, f32 stats)
//   c[v]  = f32(lp[v]) + (-1e30 if ban_prev and v == prev[n])  (decoding_constraint, t > 0)
//   z[v]  = c[v] / temperature + g[v]                        (random; greedy: z = c)
//   g[v]  = -log(-log(u)),  u = ((bits >> 9) * 2 + 1) * 2^-24 in (0, 1)
//           bits: Philox4x32-10 under (key, site), counter (site, t, n, v / 4), word v % 4
//   w     = argmax z (ties to the lower index);  chosen = c[w] (un-tempered)
//   tok   = unfinished[n] ? w : pad;  seq[n, t] = tok;  seq_lp[n, t] = chosen;
//   next[n] = tok;  unfinished[n] &= (w != eos)
//
// Bound on the H100 (N = 960 samples, V = 10000, f32): bytes. The logits are
// read once (38.4 MB, 11.5 us at 3.35 TB/s); the 2.4M Philox calls and 19M
// logf are below the card's integer and SFU rates.
//
// Design: one block of 256 threads per row, as K4's scalar path. Pass 1
// keeps an online max/sum per thread and merges them across the block; pass
// 2 rereads the row (from L2: 40 KB per row), each thread taking 4
// consecutive columns per Philox call, and keeps its best (z, index); a
// block-wide argmax merges them.
#include <climits>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace sct {

constexpr int kSampleThreads = 256;
constexpr float kBanPrev = -1e30f;  // sample.py: nan_to_num(one_hot * -inf, neginf=-1e30)

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = static_cast<float>((bits >> 9) * 2u + 1u) * 0x1p-24f;
  return -logf(-logf(u));
}

template <typename T>
__global__ void __launch_bounds__(kSampleThreads)
sample_step_kernel(const T* __restrict__ logits, int V, const int* __restrict__ prev,
                   unsigned char* __restrict__ unfinished, int* __restrict__ seq, float* __restrict__ seq_lp,
                   int* __restrict__ next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site, int greedy,
                   float temperature, int ban_prev, int eos_id, int pad_id) {
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  __shared__ int red_i[32];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const T* x = logits + (size_t)row * V;

  // pass 1: log-sum-exp
  float m = -INFINITY, s = 0.f;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const float xi = to_f(x[i]);
    if (xi > m) {
      s = s * expf(m - xi) + 1.f;
      m = xi;
    } else {
      s += expf(xi - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o), os = __shfl_xor_sync(0xffffffffu, s, o);
    merge_max_sum(m, s, om, os);
  }
  if (lane == 0) {
    red_a[warp] = m;
    red_b[warp] = s;
  }
  __syncthreads();
  m = -INFINITY;
  s = 0.f;
  for (int w = 0; w < nwarps; ++w) merge_max_sum(m, s, red_a[w], red_b[w]);
  const float mx = m, logsum = logf(s);
  __syncthreads();  // red_a is reused below

  // pass 2: constrained log-probs, noise, per-thread argmax over 4 columns a call
  const int ban = ban_prev ? prev[row] : -1;
  float best = -INFINITY;
  int best_i = INT_MAX;
  const int groups = (V + 3) / 4;
  for (int c4 = threadIdx.x; c4 < groups; c4 += blockDim.x) {
    Philox4 r{0u, 0u, 0u, 0u};
    if (!greedy) r = philox4x32_10(Philox4{site, (uint32_t)t, (uint32_t)row, (uint32_t)c4}, k0, k1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * c4 + q;
      if (i >= V) break;
      float c = round_to<T>((to_f(x[i]) - mx) - logsum);
      if (i == ban) c += kBanPrev;
      const float z = greedy ? c : c / temperature + gumbel(philox_word(r, q));
      if (z > best) {  // i grows within a thread, so a tie keeps the lower index
        best = z;
        best_i = i;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ranks_above(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red_a[warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w)
      if (ranks_above(red_a[w], red_i[w], best, best_i)) {
        best = red_a[w];
        best_i = red_i[w];
      }
    if (best_i >= V) best_i = 0;  // every z was -inf: argmax's first index
    float chosen = round_to<T>((to_f(x[best_i]) - mx) - logsum);
    if (best_i == ban) chosen += kBanPrev;
    const bool live = unfinished[row] != 0;
    const int tok = live ? best_i : pad_id;
    seq[(size_t)row * t_max + t] = tok;
    seq_lp[(size_t)row * t_max + t] = chosen;
    next[row] = tok;
    unfinished[row] = (live && best_i != eos_id) ? 1 : 0;
  }
}

template <typename T>
cudaError_t launch(const void* logits, int N, int V, const void* prev, void* unfinished, void* seq, void* seq_lp,
                   void* next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site, int greedy,
                   float temperature, int ban_prev, int eos_id, int pad_id, cudaStream_t stream) {
  sample_step_kernel<T><<<N, kSampleThreads, 0, stream>>>(
      static_cast<const T*>(logits), V, static_cast<const int*>(prev), static_cast<unsigned char*>(unfinished),
      static_cast<int*>(seq), static_cast<float*>(seq_lp), static_cast<int*>(next), t, t_max, k0, k1, site, greedy,
      temperature, ban_prev, eos_id, pad_id);
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. logits (N, V); prev (N,) int32; unfinished
// (N,) bool, updated in place; seq (N, t_max) int32 and seq_lp (N, t_max) f32,
// column t written; next (N,) int32.
extern "C" int sct_sample_step(int dtype, const void* logits, int N, int V, const void* prev, void* unfinished,
                               void* seq, void* seq_lp, void* next, int t, int t_max, uint32_t k0, uint32_t k1,
                               uint32_t site, int greedy, float temperature, int ban_prev, int eos_id, int pad_id,
                               void* stream) {
  if (N <= 0 || V <= 0 || t < 0 || t >= t_max || !(temperature > 0.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)sct::launch<float>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site, greedy,
                                   temperature, ban_prev, eos_id, pad_id, s);
  if (dtype == 1)
    return (int)sct::launch<__nv_bfloat16>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site,
                                           greedy, temperature, ban_prev, eos_id, pad_id, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
