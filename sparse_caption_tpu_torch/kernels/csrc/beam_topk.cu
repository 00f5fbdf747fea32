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
// per thread and merges them across the block. For k <= 32, pass 2 rereads
// the row (from L2: 20 KB per row) and keeps a sorted per-thread top-k in
// registers (a list of 8, 16 or 32 entries, chosen at compile time from k);
// k rounds of a block-wide argmax then merge the per-thread lists. For
// k > 32 (any k <= V), pass 2 writes the row's constrained f32 values into
// shared memory (40 KB at V = 10000), a block-wide radix select (four 8-bit
// passes of a shared histogram over order-preserving uint32 keys) finds the
// k-th value, the values above it and the first of the values equal to it
// in index order are gathered, and a bitonic sort of those k entries (value
// descending, index ascending, packed in one uint64) orders them.
#include <climits>

#include "common.cuh"

namespace sct {

constexpr int kTopkThreads = 256;
constexpr int kRegisterK = 32;  // largest k kept in per-thread register lists
constexpr float kNegBig = -1e18f;  // beam.py NEG_BIG

// Row statistics of pass 1: the max and log(sum exp(x - max)) of one row of
// V logits, merged across the block (every thread returns them).
template <typename T>
__device__ __forceinline__ void row_logsumexp(const T* __restrict__ x, int V, float* red_a, float* red_b, float& mx,
                                              float& logsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
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
  mx = m;
  logsum = logf(s);
  __syncthreads();  // red_a / red_b are reused by the caller
}

// The constrained value c[i] of the module notes.
template <typename T>
__device__ __forceinline__ float constrained(const T* __restrict__ x, int i, float mx, float logsum, int ban,
                                             bool no_eos, int eos_id, int unk_id) {
  float c = round_to<T>((to_f(x[i]) - mx) - logsum);
  if (i == ban) c += kNegBig;
  if (no_eos && i == eos_id) c += kNegBig;
  if (i == unk_id) c += -1000.f;
  return c;
}

template <typename T, int KMAX>
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
  float mx, logsum;
  row_logsumexp(x, V, red_a, red_b, mx, logsum);

  // pass 2: constrained log-probs, sorted per-thread top-k
  const int ban = ban_token != nullptr ? ban_token[row] : -1;
  const bool no_eos = ban_eos != nullptr && ban_eos[row] != 0;
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = -INFINITY;
    ti[j] = INT_MAX;
  }
  float thr = -INFINITY;  // tv[k - 1]
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const float c = constrained(x, i, mx, logsum, ban, no_eos, eos_id, unk_id);
    if (c > thr) {  // i grows within a thread, so an equal value never displaces a lower index
      bool placed = false;
#pragma unroll
      for (int j = KMAX - 1; j > 0; --j) {
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
      for (int j = 0; j < KMAX; ++j)
        if (j == k - 1) thr = tv[j];
    }
  }

  // merge: k rounds of a block-wide argmax over each thread's best remaining entry
  int head = 0;
  for (int r = 0; r < k; ++r) {
    float cv = -INFINITY;
    int ci = INT_MAX;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
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

// order-preserving uint32 key of a float (larger float, larger key; -0 as +0)
__device__ __forceinline__ unsigned int order_key(float f) {
  const unsigned int u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// k > kRegisterK: radix select over the row's constrained values in shared
// memory, then a bitonic sort of the k selected entries. Dynamic shared
// memory: V floats, then `cap` (a power of two >= k) uint64 entries.
template <typename T>
__global__ void __launch_bounds__(kTopkThreads)
beam_topk_select_kernel(const T* __restrict__ logits, int V, int k, int cap, const int* __restrict__ ban_token,
                        const unsigned char* __restrict__ ban_eos, int eos_id, int unk_id,
                        float* __restrict__ out_val, int* __restrict__ out_idx, float* __restrict__ out_raw) {
  extern __shared__ __align__(16) unsigned char topk_smem[];
  unsigned long long* cand = reinterpret_cast<unsigned long long*>(topk_smem);  // cap
  float* c_s = reinterpret_cast<float*>(cand + cap);                            // V
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  __shared__ int hist[256];
  __shared__ int warp_count[32];
  __shared__ unsigned int prefix_s;
  __shared__ int remaining_s, n_cand;
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const T* x = logits + (size_t)row * V;
  float mx, logsum;
  row_logsumexp(x, V, red_a, red_b, mx, logsum);
  const int ban = ban_token != nullptr ? ban_token[row] : -1;
  const bool no_eos = ban_eos != nullptr && ban_eos[row] != 0;
  for (int i = threadIdx.x; i < V; i += blockDim.x) c_s[i] = constrained(x, i, mx, logsum, ban, no_eos, eos_id, unk_id);
  if (threadIdx.x == 0) {
    prefix_s = 0u;
    remaining_s = k;
    n_cand = 0;
  }
  // radix select of the k-th largest key, 8 bits a pass from the top
  unsigned int mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    const unsigned int prefix = prefix_s;
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const unsigned int key = order_key(c_s[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int above = 0, d = 255;
      for (; d > 0 && above + hist[d] < remaining_s; --d) above += hist[d];
      remaining_s -= above;  // entries of the chosen digit still needed
      prefix_s = prefix | ((unsigned int)d << shift);
    }
    mask |= 0xFFu << shift;
    __syncthreads();
  }
  const unsigned int kth = prefix_s;
  const int need_eq = remaining_s;  // values equal to the k-th taken, lowest indices first
  // gather: every value above the k-th, then the first need_eq equal ones in index order
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const unsigned int key = order_key(c_s[i]);
    if (key > kth) cand[atomicAdd(&n_cand, 1)] = ((unsigned long long)key << 32) | (0xFFFFFFFFu - (unsigned int)i);
  }
  int taken = 0;  // equal values taken so far, in index order
  for (int base = 0; base < V && taken < need_eq; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool eq = i < V && order_key(c_s[i]) == kth;
    const unsigned int ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = taken;
    for (int w = 0; w < warp; ++w) before += warp_count[w];
    before += __popc(ballot & ((1u << lane) - 1u));
    if (eq && before < need_eq) {
      cand[k - need_eq + (before)] = ((unsigned long long)kth << 32) | (0xFFFFFFFFu - (unsigned int)i);
    }
    int chunk = 0;
    for (int w = 0; w < nwarps; ++w) chunk += warp_count[w];
    taken += chunk;
    __syncthreads();  // warp_count is rewritten by the next chunk
  }
  for (int e = k + threadIdx.x; e < cap; e += blockDim.x) cand[e] = 0ull;  // below every real entry
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < cap / 2; e += blockDim.x) {
        const int lo = 2 * e - (e & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = cand[lo], b = cand[hi];
        if ((a < b) == desc) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int i = (int)(0xFFFFFFFFu - (unsigned int)(cand[r] & 0xFFFFFFFFull));
    const size_t o = (size_t)row * k + r;
    out_val[o] = c_s[i];
    out_idx[o] = i;
    out_raw[o] = round_to<T>((to_f(x[i]) - mx) - logsum);
  }
}

inline int select_capacity(int k) {
  int cap = 1;
  while (cap < k) cap <<= 1;
  return cap;
}

inline size_t select_smem_bytes(int V, int k) {
  return (size_t)select_capacity(k) * sizeof(unsigned long long) + (size_t)V * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* logits, int N, int V, int k, const void* ban_token, const void* ban_eos, int eos_id,
                   int unk_id, void* out_val, void* out_idx, void* out_raw, cudaStream_t stream) {
  const T* lg = static_cast<const T*>(logits);
  const int* bt = static_cast<const int*>(ban_token);
  const unsigned char* be = static_cast<const unsigned char*>(ban_eos);
  float* ov = static_cast<float*>(out_val);
  int* oi = static_cast<int*>(out_idx);
  float* orw = static_cast<float*>(out_raw);
  if (k <= 8) {
    beam_topk_kernel<T, 8><<<N, kTopkThreads, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, ov, oi, orw);
  } else if (k <= 16) {
    beam_topk_kernel<T, 16><<<N, kTopkThreads, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, ov, oi, orw);
  } else if (k <= kRegisterK) {
    beam_topk_kernel<T, 32><<<N, kTopkThreads, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, ov, oi, orw);
  } else {
    const size_t smem = select_smem_bytes(V, k);
    if (smem > 232448 - 4096) return cudaErrorInvalidValue;  // the static shared arrays need the rest
    cudaError_t err = cudaFuncSetAttribute(beam_topk_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    beam_topk_select_kernel<T><<<N, kTopkThreads, smem, stream>>>(lg, V, k, select_capacity(k), bt, be, eos_id,
                                                                 unk_id, ov, oi, orw);
  }
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. logits (N, V); ban_token (N,) int32 or null;
// ban_eos (N,) bool or null; unk_id < 0 disables the UNK penalty; 1 <= k <= V
// (k > 32: 8 * pow2ceil(k) + 4 * V bytes of shared memory, at most 223 KB).
// Outputs: values (N, k) f32, indices (N, k) int32, raw log-probs (N, k) f32.
extern "C" int sct_beam_topk(int dtype, const void* logits, int N, int V, int k, const void* ban_token,
                             const void* ban_eos, int eos_id, int unk_id, void* out_val, void* out_idx,
                             void* out_raw, void* stream) {
  if (k < 1 || V < k) return (int)cudaErrorInvalidValue;
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
