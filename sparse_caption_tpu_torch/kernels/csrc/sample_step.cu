// K9: one step of the sampling decode: log_softmax, temperature, a sampling
// filter (top-k or nucleus) or the Gumbel method, the Gumbel-max draw (or the
// greedy argmax), the chosen log-prob and the `unfinished` latch, without
// materialising the (N, V) log-probs.
//
// Replaces: sparse_caption_tpu/decoding/sample.py:134-159 (the body of the
// sampling loop: decoding_constraint, jax.random.categorical, the chosen
// log-prob, the latch and the seq writes), :29-66 modified_sample_logits (the
// top-k and nucleus filters) and :69-90 sample_next_word (the Gumbel method),
// together with the train-mode generator's f32 log_softmax
// (sparse_caption_tpu/models/layers.py:465-472). Left to XLA on the TPU.
// The ss mode (sct_scheduled_sample) replaces the scheduled sampling of the
// Up-Down XE forward, sparse_caption_tpu/models/up_down.py:170-183 (a coin a
// row against ss_prob, then jax.random.categorical on step t-1's
// log-probs); left to XLA on the TPU too.
//
// For each row n of logits (N, V) in the compute dtype T:
//   lp[v] = T((x[v] - max) - log(sum exp(x - max)))        (log_softmax, f32 stats)
//   c[v]  = f32(lp[v]) + (-1e30 if ban_prev and v == prev[n])  (decoding_constraint, t > 0)
//   g[v]  = -log(-log(u)),  u = ((bits >> 9) * 2 + 1) * 2^-24 in (0, 1)
//           bits: Philox4x32-10 under (key, site), counter (site, t, n, v / 4), word v % 4
//   mode random:  z[v] = c[v] / temperature + g[v];   chosen = c[w]
//   mode gumbel:  z[v] = c[v] + g'[v], g' = -log(-log(u + 1e-20) + 1e-20) (the
//                 same u; no temperature, sample.py:81-85);   chosen = c[w]
//   mode top-k:   s[v] = c[v] / temperature; kth = the k-th largest s (with
//                 repeats, as lax.top_k); m[v] = s[v] if s[v] >= kth (ties
//                 kept) else -1e30;  z[v] = m[v] + g[v];   chosen = m[w]
//   mode nucleus: s as top-k; p = softmax(s) (f32: exp(s - max) / sum);
//                 sorted descending, equal p by the lower index (a stable
//                 sort); csum the prefix sums of the sorted p; the first
//                 n_keep = 1 + #{j <= V - 2 : csum[j] < top_p} sorted entries
//                 kept; m[v] = log(p[v] / denom) if kept else -1e30, denom =
//                 the sum of the kept p;  z[v] = m[v] + g[v];   chosen = m[w]
//   greedy:       z = c;   chosen = c[w]
//   w     = argmax z (ties to the lower index)
//   tok   = unfinished[n] ? w : pad;  seq[n, t] = tok;  seq_lp[n, t] = chosen;
//   next[n] = tok;  unfinished[n] &= (w != eos)
// The chosen log-prob is the un-tempered c for random and gumbel
// (sample.py:85,150) and the filtered m for top-k and nucleus (:89).
// The nucleus's prefix sums are taken in this order: thread j of the block
// (256) sums the sorted entries [j L, (j + 1) L), L = ceil(V / 256), one
// after another; thread 0 adds those 256 chunk sums one after another into
// each chunk's base; csum of an entry is its chunk's base plus the chunk's
// entries up to it, one after another. torch.cumsum (the plain version)
// and XLA's cumsum round in their own orders, so a row whose cutoff sum
// lies within a few ulps of top_p may keep one entry more or less.
//
// The ss mode, for row n of step t-1's log-probs lp (N, V) in the compute
// dtype T and the teacher token teacher[n] of step t:
//   coin  = u_c < ss_prob,  u_c = (bits >> 8) 2^-24, bits: Philox (key, coin
//           site), counter (coin site, t, n, 0), word 0 (f32, as JAX's coin)
//   u[v]  = T: f32 ((bits >> 9) 2 + 1) 2^-24, bf16 ((bits >> 25) 2 + 1) 2^-8
//           (exact in bf16, in (0, 1)); bits: counter (noise site, t, n,
//           v / 4), word v % 4
//   g[v]  = -T(log(-T(log(u[v]))))          (jax.random.gumbel in T: each
//                                             log rounded to T)
//   z[v]  = T(lp[v] + g[v]);  w = argmax z (ties to the lower index)
//   out[n] = coin ? w : teacher[n]
// A row whose coin fails reads nothing of lp.
//
// Bound on the H100 (N = 960 samples, V = 10000, f32): bytes. The logits are
// read once (38.4 MB, 11.5 us at 3.35 TB/s); the 2.4M Philox calls and 19M
// logf are below the card's integer and SFU rates. The nucleus's sort of the
// row (one bitonic sort of 16,384 keys a row in shared memory) is no part of
// the bound.
//
// Design: one block of 256 threads per row, as K4's scalar path. Pass 1
// keeps an online max/sum per thread and merges them across the block
// (row_topk.cuh row_logsumexp); the filter modes then write the row's
// tempered values into shared memory (40 KB at V = 10000) and filter them
// there: top-k through K4's per-row top-k code (row_topk.cuh: the register
// path for k <= 32, the radix select above); nucleus by a block-wide bitonic
// sort of packed (p, index) keys (128 KB at V = 10000), the prefix sums above
// and a rewrite of the row as m. The last pass reads the row (the logits
// again, from L2, or the filtered row), each thread taking 4 consecutive
// columns per Philox call, and keeps its best (z, index); a block-wide
// argmax merges them. The mode is a template parameter, one instance each,
// still one launch a step: the random instance (greedy too) holds no filter
// code, no top-k registers and no filter scratch in shared memory, so it
// keeps the registers and occupancy it had before the filter modes came.
// The ss mode is a kernel of its own (one block of 256 threads a row, the
// last pass of the random mode on the given log-probs), one instance a dtype.
#include <climits>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"
#include "row_softmax.cuh"
#include "row_topk.cuh"

namespace sct {

constexpr int kSampleThreads = 256;
constexpr int kTopkRegister = 32;  // largest k of the register path
constexpr float kBanPrev = -1e30f;  // sample.py: nan_to_num(one_hot * -inf, neginf=-1e30)
constexpr float kFiltered = -1e30f;  // sample.py NEG_INF: a filtered-out entry
enum SampleMode { kRandom = 0, kGumbel = 1, kTopK = 2, kNucleus = 3 };

__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return static_cast<float>((bits >> 9) * 2u + 1u) * 0x1p-24f;
}

__device__ __forceinline__ float gumbel(uint32_t bits) { return -logf(-logf(uniform_of(bits))); }

// the Gumbel method's noise, with the eps of sample.py:81-84
__device__ __forceinline__ float gumbel_eps(uint32_t bits) {
  return -logf(-logf(uniform_of(bits) + 1e-20f) + 1e-20f);
}

__device__ __forceinline__ int block_sum_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) r += red[w];
  __syncthreads();
  return r;
}

// top-k filter of the row sv[0..V) in place: entries below the k-th largest
// become -1e30
__device__ __forceinline__ void topk_filter(float* sv, int V, int k, float* red_a, int* red_i) {
  __shared__ int winner;
  __shared__ int hist[256];
  __shared__ unsigned int prefix_s;
  __shared__ int remaining_s;
  __shared__ float kth_s;
  if (k <= kTopkRegister) {
    float tv[kTopkRegister], thr;
    int ti[kTopkRegister];
    topk_init(tv, ti, thr);
    for (int i = threadIdx.x; i < V; i += blockDim.x) topk_insert(sv[i], i, k, tv, ti, thr);
    topk_merge(tv, ti, k, red_a, red_i, &winner, [&](int r, float cv, int) {
      if (r == k - 1) kth_s = cv;
    });
  } else {
    unsigned int key;
    int need_eq;
    radix_select_kth(sv, V, k, hist, &prefix_s, &remaining_s, key, need_eq);
    if (threadIdx.x == 0) kth_s = order_value(key);
    __syncthreads();
  }
  const float kth = kth_s;
  for (int i = threadIdx.x; i < V; i += blockDim.x)
    if (!(sv[i] >= kth)) sv[i] = kFiltered;
  __syncthreads();
}

// nucleus filter of the row sv[0..V) in place (module notes); keys: cap
// uint64 of shared memory (cap = pow2ceil(V))
__device__ __forceinline__ void nucleus_filter(float* sv, int V, float top_p, unsigned long long* keys, int cap,
                                               float* red_a, float* red_b, int* red_i) {
  __shared__ float part_s[kSampleThreads];
  const int tid = threadIdx.x, nt = blockDim.x;
  // softmax: the row's max, then the sum of exp(s - max), each in a fixed order
  float m = -INFINITY;
  for (int i = tid; i < V; i += nt) m = fmaxf(m, sv[i]);
  m = block_max(m, red_a);
  float s = 0.f;
  for (int i = tid; i < V; i += nt) s += expf(sv[i] - m);
  s = block_sum(s, red_b);
  for (int i = tid; i < cap; i += nt)
    keys[i] = i < V ? ((unsigned long long)order_key(expf(sv[i] - m) / s) << 32) | (0xFFFFFFFFu - (unsigned int)i)
                    : 0ull;
  __syncthreads();
  bitonic_sort_desc(keys, cap);  // p descending, equal p by the lower index
  // prefix sums of the sorted p: each thread's chunk, the chunk sums in order
  const int len = (V + nt - 1) / nt, lo = min(tid * len, V), hi = min(lo + len, V);
  float chunk = 0.f;
  for (int j = lo; j < hi; ++j) chunk += order_value((unsigned int)(keys[j] >> 32));
  part_s[tid] = chunk;
  __syncthreads();
  if (tid == 0) {
    float base = 0.f;
    for (int w = 0; w < nt; ++w) {
      const float c = part_s[w];
      part_s[w] = base;
      base += c;
    }
  }
  __syncthreads();
  float run = part_s[tid];
  int below = 0;  // entries j <= V - 2 of this chunk with csum[j] < top_p
  for (int j = lo; j < hi; ++j) {
    run += order_value((unsigned int)(keys[j] >> 32));
    if (j <= V - 2 && run < top_p) ++below;
  }
  const int n_keep = 1 + block_sum_int(below, red_i);
  // the denominator: the kept p, each thread's share of them in order, then the threads' in order
  float kept = 0.f;
  for (int j = lo; j < hi && j < n_keep; ++j) kept += order_value((unsigned int)(keys[j] >> 32));
  part_s[tid] = kept;
  __syncthreads();
  if (tid == 0) {
    float d = 0.f;
    for (int w = 0; w < nt; ++w) d += part_s[w];
    part_s[0] = d;
  }
  __syncthreads();
  const float denom = part_s[0];
  for (int j = tid; j < V; j += nt) {
    const int i = (int)(0xFFFFFFFFu - (unsigned int)keys[j]);
    sv[i] = j < n_keep ? logf(order_value((unsigned int)(keys[j] >> 32)) / denom) : kFiltered;
  }
  __syncthreads();
}

__host__ __device__ inline int pow2_at_least(int n) {
  int c = 1;
  while (c < n) c <<= 1;
  return c;
}

// dynamic shared memory of a mode: the nucleus's keys, then the row
inline size_t sample_smem_bytes(int V, int mode) {
  if (mode != kTopK && mode != kNucleus) return 0;
  return (mode == kNucleus ? (size_t)pow2_at_least(V) * sizeof(unsigned long long) : 0) + (size_t)V * sizeof(float);
}

// kMode: a SampleMode. The random instance (greedy too) carries none of the
// filter code, its registers or its shared memory.
template <typename T, int kMode>
__global__ void __launch_bounds__(kSampleThreads)
sample_step_kernel(const T* __restrict__ logits, int V, const int* __restrict__ prev,
                   unsigned char* __restrict__ unfinished, int* __restrict__ seq, float* __restrict__ seq_lp,
                   int* __restrict__ next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site, int greedy,
                   float temperature, int ban_prev, int eos_id, int pad_id, int top_k, float top_p) {
  constexpr bool filtered = kMode == kTopK || kMode == kNucleus;
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  __shared__ int red_i[32];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const T* x = logits + (size_t)row * V;

  // pass 1: log-sum-exp
  float mx, logsum;
  row_logsumexp(x, V, red_a, red_b, mx, logsum);
  const int ban = ban_prev ? prev[row] : -1;
  auto logprob = [&](int i) {  // c[i] of the module notes
    float c = round_to<T>((to_f(x[i]) - mx) - logsum);
    if (i == ban) c += kBanPrev;
    return c;
  };

  // the filter modes: the tempered row in shared memory, filtered in place
  float* sv = nullptr;
  if constexpr (filtered) {
    extern __shared__ __align__(16) unsigned char sample_smem[];
    const int cap = kMode == kNucleus ? pow2_at_least(V) : 0;
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(sample_smem);
    sv = reinterpret_cast<float*>(keys + cap);
    for (int i = threadIdx.x; i < V; i += blockDim.x) sv[i] = logprob(i) / temperature;
    __syncthreads();
    if constexpr (kMode == kTopK) topk_filter(sv, V, top_k, red_a, red_i);
    else nucleus_filter(sv, V, top_p, keys, cap, red_a, red_b, red_i);
  }

  // last pass: noise, per-thread argmax over 4 columns a call
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
      float z;
      if (greedy) {
        z = logprob(i);
      } else if (filtered) {
        z = sv[i] + gumbel(philox_word(r, q));
      } else if (kMode == kGumbel) {
        z = logprob(i) + gumbel_eps(philox_word(r, q));
      } else {
        z = logprob(i) / temperature + gumbel(philox_word(r, q));
      }
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
    const float chosen = filtered ? sv[best_i] : logprob(best_i);
    const bool live = unfinished[row] != 0;
    const int tok = live ? best_i : pad_id;
    seq[(size_t)row * t_max + t] = tok;
    seq_lp[(size_t)row * t_max + t] = chosen;
    next[row] = tok;
    unfinished[row] = (live && best_i != eos_id) ? 1 : 0;
  }
}


// the ss mode's noise: a uniform with T's precision (exact in T), then
// -log(-log(u)) with each log rounded to T, as jax.random.gumbel in T
template <typename T>
__device__ __forceinline__ float ss_gumbel(uint32_t bits);
template <>
__device__ __forceinline__ float ss_gumbel<float>(uint32_t bits) {
  return -logf(-logf(uniform_of(bits)));
}
template <>
__device__ __forceinline__ float ss_gumbel<__nv_bfloat16>(uint32_t bits) {
  const float u = static_cast<float>((bits >> 25) * 2u + 1u) * 0x1p-8f;
  return -round_to<__nv_bfloat16>(logf(-round_to<__nv_bfloat16>(logf(u))));
}

template <typename T>
__global__ void __launch_bounds__(kSampleThreads)
scheduled_sample_kernel(const T* __restrict__ lp, int V, const int* __restrict__ teacher, int* __restrict__ out,
                        int t, uint32_t k0, uint32_t k1, uint32_t coin_site, uint32_t noise_site, float ss_prob) {
  __shared__ float red_a[32];
  __shared__ int red_i[32];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const uint32_t coin_bits = philox4x32_10(Philox4{coin_site, (uint32_t)t, (uint32_t)row, 0u}, k0, k1).x;
  if (!(static_cast<float>(coin_bits >> 8) * 0x1p-24f < ss_prob)) {  // the teacher's token
    if (threadIdx.x == 0) out[row] = teacher[row];
    return;
  }
  const T* x = lp + (size_t)row * V;
  float best = -INFINITY;
  int best_i = INT_MAX;
  const int groups = (V + 3) / 4;
  for (int c4 = threadIdx.x; c4 < groups; c4 += blockDim.x) {
    const Philox4 r = philox4x32_10(Philox4{noise_site, (uint32_t)t, (uint32_t)row, (uint32_t)c4}, k0, k1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * c4 + q;
      if (i >= V) break;
      const float z = round_to<T>(to_f(x[i]) + ss_gumbel<T>(philox_word(r, q)));
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
    out[row] = best_i >= V ? 0 : best_i;  // every z NaN or -inf: argmax's first index
  }
}

template <typename T, int kMode>
cudaError_t launch_mode(const void* logits, int N, int V, const void* prev, void* unfinished, void* seq,
                        void* seq_lp, void* next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site,
                        int greedy, float temperature, int ban_prev, int eos_id, int pad_id, int top_k, float top_p,
                        cudaStream_t stream) {
  const size_t smem = sample_smem_bytes(V, kMode);
  if (smem > 48 * 1024) {
    if (smem > 232448 - 8192) return cudaErrorInvalidValue;  // the static shared arrays need the rest
    const cudaError_t err = cudaFuncSetAttribute(sample_step_kernel<T, kMode>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sample_step_kernel<T, kMode><<<N, kSampleThreads, smem, stream>>>(
      static_cast<const T*>(logits), V, static_cast<const int*>(prev), static_cast<unsigned char*>(unfinished),
      static_cast<int*>(seq), static_cast<float*>(seq_lp), static_cast<int*>(next), t, t_max, k0, k1, site, greedy,
      temperature, ban_prev, eos_id, pad_id, top_k, top_p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* logits, int N, int V, const void* prev, void* unfinished, void* seq, void* seq_lp,
                   void* next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site, int greedy,
                   float temperature, int ban_prev, int eos_id, int pad_id, int mode, int top_k, float top_p,
                   cudaStream_t stream) {
#define SCT_MODE(M)                                                                                                 \
  launch_mode<T, M>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site, greedy, temperature, \
                    ban_prev, eos_id, pad_id, top_k, top_p, stream)
  if (greedy || mode == kRandom) return SCT_MODE(kRandom);
  if (mode == kGumbel) return SCT_MODE(kGumbel);
  if (mode == kTopK) return SCT_MODE(kTopK);
  return SCT_MODE(kNucleus);
#undef SCT_MODE
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. logits (N, V); prev (N,) int32; unfinished
// (N,) bool, updated in place; seq (N, t_max) int32 and seq_lp (N, t_max) f32,
// column t written; next (N,) int32. mode: 0 random, 1 gumbel, 2 top-k (top_k
// in 1..V), 3 nucleus (top_p in (0, 1); V <= 16384); greedy overrides it.
extern "C" int sct_sample_step(int dtype, const void* logits, int N, int V, const void* prev, void* unfinished,
                               void* seq, void* seq_lp, void* next, int t, int t_max, uint32_t k0, uint32_t k1,
                               uint32_t site, int greedy, float temperature, int ban_prev, int eos_id, int pad_id,
                               int mode, int top_k, float top_p, void* stream) {
  if (N <= 0 || V <= 0 || t < 0 || t >= t_max || !(temperature > 0.f) || mode < sct::kRandom ||
      mode > sct::kNucleus || (mode == sct::kTopK && (top_k < 1 || top_k > V)) ||
      (mode == sct::kNucleus && !(top_p > 0.f && top_p < 1.f)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)sct::launch<float>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site, greedy,
                                   temperature, ban_prev, eos_id, pad_id, mode, top_k, top_p, s);
  if (dtype == 1)
    return (int)sct::launch<__nv_bfloat16>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site,
                                           greedy, temperature, ban_prev, eos_id, pad_id, mode, top_k, top_p, s);
  return (int)cudaErrorInvalidValue;
}

// The ss mode. dtype: 0 = float32, 1 = bfloat16. lp (N, V), step t-1's
// log-probs; teacher (N,) int32, step t's teacher tokens; out (N,) int32,
// step t's input tokens; (k0, k1) the 64-bit key; 0 <= ss_prob <= 1.
extern "C" int sct_scheduled_sample(int dtype, const void* lp, int N, int V, const void* teacher, void* out, int t,
                                    uint32_t k0, uint32_t k1, uint32_t coin_site, uint32_t noise_site, float ss_prob,
                                    void* stream) {
  if (N <= 0 || V <= 0 || t < 0 || !(ss_prob >= 0.f && ss_prob <= 1.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sct::scheduled_sample_kernel<float><<<N, sct::kSampleThreads, 0, s>>>(
        static_cast<const float*>(lp), V, static_cast<const int*>(teacher), static_cast<int*>(out), t, k0, k1,
        coin_site, noise_site, ss_prob);
  else if (dtype == 1)
    sct::scheduled_sample_kernel<__nv_bfloat16><<<N, sct::kSampleThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lp), V, static_cast<const int*>(teacher), static_cast<int*>(out), t, k0,
        k1, coin_site, noise_site, ss_prob);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
