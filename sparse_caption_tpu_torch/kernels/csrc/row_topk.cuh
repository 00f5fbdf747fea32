// Per-row top-k device code shared by K4 (beam log-softmax + top-K,
// beam_topk.cu) and K9's top-k filter (sample_step.cu): one block a row.
//
// - row_logsumexp: the row's max and log(sum exp(x - max)), an online max /
//   sum per thread merged across the block (every thread returns them).
// - The register path (k <= KMAX <= 32): each thread keeps its best KMAX
//   (value, index) entries sorted (topk_insert, indices growing within a
//   thread, so an equal value never displaces a lower index), then k rounds
//   of a block-wide argmax over the threads' heads (topk_merge) give the
//   row's top k in order, ties to the lower index (as lax.top_k).
// - The radix select (any k <= V): the k-th largest of V f32 values in shared
//   memory, four 8-bit passes of a shared histogram over order-preserving
//   uint32 keys (radix_select_kth), and how many values equal to it belong
//   to the top k.
// - bitonic_sort_desc: a block's sort of packed uint64 keys in shared memory.
#pragma once

#include <climits>

#include "common.cuh"

namespace sct {

// Row statistics: the max and log(sum exp(x - max)) of one row of V values,
// merged across the block (every thread returns them). red_a, red_b: 32
// floats of shared memory each, free again when this returns.
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

// order-preserving uint32 key of a float (larger float, larger key; -0 as +0)
__device__ __forceinline__ unsigned int order_key(float f) {
  const unsigned int u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the float of an order_key
__device__ __forceinline__ float order_value(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// The register path: a thread's best KMAX entries, best first (value -inf,
// index INT_MAX when empty); thr is entry k - 1, the value a new entry must beat.
template <int KMAX>
__device__ __forceinline__ void topk_init(float (&tv)[KMAX], int (&ti)[KMAX], float& thr) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = -INFINITY;
    ti[j] = INT_MAX;
  }
  thr = -INFINITY;
}

template <int KMAX>
__device__ __forceinline__ void topk_insert(float c, int i, int k, float (&tv)[KMAX], int (&ti)[KMAX], float& thr) {
  if (!(c > thr)) return;  // i grows within a thread, so an equal value never displaces a lower index
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

// k rounds of a block-wide argmax over each thread's best remaining entry:
// round r's winner (the row's r-th largest, ties to the lower index) goes to
// emit(r, value, index) on thread 0. red_a, red_i: 32 entries of shared
// memory each; winner: one shared int.
template <int KMAX, typename Emit>
__device__ __forceinline__ void topk_merge(const float (&tv)[KMAX], const int (&ti)[KMAX], int k, float* red_a,
                                           int* red_i, int* winner, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
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
      emit(r, cv, ci);
      *winner = ci;
    }
    __syncthreads();
    if (mine == *winner) ++head;
  }
}

// The radix select: the order_key of the k-th largest of vals_s[0..V) (shared
// memory, read only), 8 bits a pass from the top, and need_eq, how many of the
// values equal to it are among the top k (the first ones in index order are).
// hist: 256 shared ints; prefix_s, remaining_s: shared scratch. Every thread
// returns the results.
__device__ __forceinline__ void radix_select_kth(const float* vals_s, int V, int k, int* hist, unsigned int* prefix_s,
                                                 int* remaining_s, unsigned int& kth, int& need_eq) {
  if (threadIdx.x == 0) {
    *prefix_s = 0u;
    *remaining_s = k;
  }
  unsigned int mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    const unsigned int prefix = *prefix_s;
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const unsigned int key = order_key(vals_s[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int above = 0, d = 255;
      for (; d > 0 && above + hist[d] < *remaining_s; --d) above += hist[d];
      *remaining_s -= above;  // entries of the chosen digit still needed
      *prefix_s = prefix | ((unsigned int)d << shift);
    }
    mask |= 0xFFu << shift;
    __syncthreads();
  }
  kth = *prefix_s;
  need_eq = *remaining_s;
  __syncthreads();  // prefix_s / remaining_s may be reused by the caller
}

// A block-wide bitonic sort of cap (a power of two) uint64 keys in shared
// memory, descending; the block's threads are synchronised on return.
__device__ __forceinline__ void bitonic_sort_desc(unsigned long long* keys, int cap) {
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < cap / 2; e += blockDim.x) {
        const int lo = 2 * e - (e & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a < b) == desc) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace sct
