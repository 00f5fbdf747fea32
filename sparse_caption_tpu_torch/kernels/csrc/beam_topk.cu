// K4: per-row log_softmax + beam constraints + top-K over the vocabulary,
// without materialising the (N, V) log-prob tensor.
//
// Replaces: sparse_caption_tpu/models/layers.py:458-472 Generator (eval
// log_softmax) together with sparse_caption_tpu/decoding/beam.py:165-175
// (constraints) and :55-69,186-200 (the per-beam top-K of the two-level
// top-K). Left to XLA on the TPU.
//
// For each row n of logits (N, V) in the compute dtype T:
//   lp[v] = T((x[v] - max) - log(sum exp(x - max)))          (log_softmax, f32 stats)
//   c[v]  = f32(lp[v]) + -1e18 if v == ban_token[n]           (decoding_constraint, t > 0)
//                      + -1e18 if ban_eos[n] and v == eos_id  (bad ending, t > 0)
//                      + -1000 if v == unk_id                 (suppress_UNK)
//   out   = top-k of c (ties to the lower index, as lax.top_k), their indices,
//           and the raw f32(lp) at those indices.
//
// Bound on the H100 (beam 5, vocab 10000): bytes. The logits are read once:
// at B = 2048 (N = 10240 rows) 205 MB of bf16, 0.06 ms at 3.35 TB/s.
//
// Design: one block of 256 threads per row. Pass 1 keeps an online max/sum
// per thread and merges them across the block; pass 2 rereads the row (from
// L2: 20 KB per row) and keeps a sorted per-thread top-k in registers; k
// rounds of a block-wide argmax then merge the per-thread lists.
#include <climits>

#include "common.cuh"

namespace sct {

constexpr int kTopkThreads = 256;
constexpr int kMaxK = 8;
constexpr float kNegBig = -1e18f;  // beam.py NEG_BIG

template <typename T>
__global__ void __launch_bounds__(kTopkThreads)
beam_topk_kernel(const T* __restrict__ logits, int V, int k, const int* __restrict__ ban_token,
                 const unsigned char* __restrict__ ban_eos, int eos_id, int unk_id, float* __restrict__ out_val,
                 int* __restrict__ out_idx, float* __restrict__ out_raw) {
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  __shared__ int red_i[32];
  __shared__ int winner;
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
  __syncthreads();  // red_a / red_b are reused below

  // pass 2: constrained log-probs, sorted per-thread top-k
  const int ban = ban_token != nullptr ? ban_token[row] : -1;
  const bool no_eos = ban_eos != nullptr && ban_eos[row] != 0;
  float tv[kMaxK];
  int ti[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    tv[j] = -INFINITY;
    ti[j] = INT_MAX;
  }
  float thr = -INFINITY;  // tv[k - 1]
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    float c = round_to<T>((to_f(x[i]) - mx) - logsum);
    if (i == ban) c += kNegBig;
    if (no_eos && i == eos_id) c += kNegBig;
    if (i == unk_id) c += -1000.f;
    if (c > thr) {  // i grows within a thread, so an equal value never displaces a lower index
      bool placed = false;
#pragma unroll
      for (int j = kMaxK - 1; j > 0; --j) {
        if (j < k && !placed) {
          if (c > tv[j - 1]) {
            tv[j] = tv[j - 1];
            ti[j] = ti[j - 1];
          } else {
            tv[j] = c;
            ti[j] = i;
            placed = true;
          }
        }
      }
      if (!placed) {
        tv[0] = c;
        ti[0] = i;
      }
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j == k - 1) thr = tv[j];
    }
  }

  // merge: k rounds of a block-wide argmax over each thread's best remaining entry
  int head = 0;
  for (int r = 0; r < k; ++r) {
    float cv = -INFINITY;
    int ci = INT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j == head) {
        cv = tv[j];
        ci = ti[j];
      }
    const int mine = ci;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ci, o);
      if (ranks_above(ov, oi, cv, ci)) {
        cv = ov;
        ci = oi;
      }
    }
    if (lane == 0) {
      red_a[warp] = cv;
      red_i[warp] = ci;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < nwarps; ++w)
        if (ranks_above(red_a[w], red_i[w], cv, ci)) {
          cv = red_a[w];
          ci = red_i[w];
        }
      const size_t o = (size_t)row * k + r;
      out_val[o] = cv;
      out_idx[o] = ci;
      out_raw[o] = round_to<T>((to_f(x[ci]) - mx) - logsum);
      winner = ci;
    }
    __syncthreads();
    if (mine == winner) ++head;
  }
}

template <typename T>
cudaError_t launch(const void* logits, int N, int V, int k, const void* ban_token, const void* ban_eos, int eos_id,
                   int unk_id, void* out_val, void* out_idx, void* out_raw, cudaStream_t stream) {
  beam_topk_kernel<T><<<N, kTopkThreads, 0, stream>>>(
      static_cast<const T*>(logits), V, k, static_cast<const int*>(ban_token),
      static_cast<const unsigned char*>(ban_eos), eos_id, unk_id, static_cast<float*>(out_val),
      static_cast<int*>(out_idx), static_cast<float*>(out_raw));
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. logits (N, V); ban_token (N,) int32 or null;
// ban_eos (N,) bool or null; unk_id < 0 disables the UNK penalty.
// Outputs: values (N, k) f32, indices (N, k) int32, raw log-probs (N, k) f32.
extern "C" int sct_beam_topk(int dtype, const void* logits, int N, int V, int k, const void* ban_token,
                             const void* ban_eos, int eos_id, int unk_id, void* out_val, void* out_idx,
                             void* out_raw, void* stream) {
  if (k < 1 || k > sct::kMaxK || V < k) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)sct::launch<float>(logits, N, V, k, ban_token, ban_eos, eos_id, unk_id, out_val, out_idx, out_raw,
                                   s);
  if (dtype == 1)
    return (int)sct::launch<__nv_bfloat16>(logits, N, V, k, ban_token, ban_eos, eos_id, unk_id, out_val, out_idx,
                                           out_raw, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
