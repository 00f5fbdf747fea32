// K16: the magnitude-pruning threshold of every pool and the new 0/1 masks.
//
// Replaces: sparse_caption_tpu/pruning/engine.py:210-257
// update_masks_once_device (left to XLA on the TPU: one jnp.quantile, a full
// sort, per pool, then the compares), the mask update of gradual magnitude
// pruning.
//
// For a set of f32 weight tensors, each in one pool (a tensor of its own for
// the *_uniform types, one pool of all of them for blind and dist):
//   c          = |w|, or |(w - mean) / std| with the tensor's own mean and
//                biased std (dist)
//   th[pool]   = v_lo lw + v_hi hw, v_lo and v_hi the pool's order
//                statistics at ranks lo and hi (ascending), lo, hi, lw, hw
//                from jnp.quantile's f32 index arithmetic (the wrapper's
//                quantile_index); two rounded products and one rounded add
//   mask       = c > th[pool] ? 1 : 0   (f32)
//
// Bound on the H100: bytes. The pass must read every weight once and write
// every mask once, 8 B a weight: at the ORT's 55,331,840 masked weights 443 MB,
// 0.13 ms at 3.35 TB/s (dist: 4 B a weight more for the stats). The select
// itself needs no arithmetic worth counting.
//
// Design: every criterion is >= 0, so its f32 bits order as a uint32, and a
// radix select over the bits finds each order statistic exactly, with no
// sort. Three histogram passes over the bits 31..21, 20..10 and 9..0: a
// block takes a chunk of 16,384 weights of one tensor, counts the digits of
// the elements whose higher bits match the prefix chosen so far into a
// 2048-bin histogram in shared memory and adds it to the pool's histogram
// in global memory; one block per (pool, rank) then scans that histogram
// (integer counts: any order gives the same sums), picks the bin that holds
// the rank and carries the prefix and the rank within the bin to the next
// pass. The two ranks of a pool share one histogram while their prefixes
// agree (always in the first pass). After the third pass the prefix is the
// value itself; one thread per pool forms th, and a last pass writes the
// masks (the wrapper may hand it the model's mask parameters themselves).
// dist first takes each tensor's mean and biased std in two passes,
// per-chunk partial sums then one block per tensor, in a fixed order. The
// table of tensors is the kernels' parameter, as K5's (__grid_constant__,
// 128 tensors a launch): a longer list runs as groups of 128, each pass over
// every group before the select that needs it. The pools' ranks and weights
// live in device memory, so the count of pools is not bounded by the table.
#include <limits.h>
#include <string.h>

#include "common.cuh"

namespace sct {

constexpr int kSelThreads = 256;
constexpr int kChunk = 16384;  // weights a block takes in a pass
constexpr int kBins = 2048;    // histogram bins (the widest digit: 11 bits)
constexpr int kPasses = 3;
constexpr int kMaxTensors = 128;

// one tensor: its weights, the mask it gets, its size, its first chunk, its pool
struct PoolEntry {
  const float* w;
  float* mask;
  long long n, chunk0, pool;
};
// a group of at most 128 tensors: its first tensor and chunk in the whole list
struct PoolSet {
  PoolEntry e[kMaxTensors];
  int count, tensor0;
  long long chunk0, chunks;
};

// radix pass p looks at bits [shift, shift + width) of the key; the bits
// above them are the prefix the earlier passes chose
__device__ __forceinline__ int pass_shift(int p) { return p == 0 ? 21 : p == 1 ? 10 : 0; }
__device__ __forceinline__ int pass_width(int p) { return p == 2 ? 10 : 11; }

struct Chunk {
  int ti;
  long long begin, end;
};

// the elements [begin, end) of the group's tensor ti that block `chunk` (of
// the whole list) takes
__device__ __forceinline__ Chunk chunk_of(const PoolSet& set, long long chunk) {
  int lo = 0, hi = set.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (set.e[mid].chunk0 <= chunk) lo = mid;
    else hi = mid - 1;
  }
  Chunk c;
  c.ti = lo;
  c.begin = (chunk - set.e[lo].chunk0) * kChunk;
  c.end = c.begin + kChunk < set.e[lo].n ? c.begin + kChunk : set.e[lo].n;
  return c;
}

// ti: the tensor's index in the whole list
__device__ __forceinline__ float criterion(float w, const float* stats, int ti) {
  if (stats == nullptr) return fabsf(w);
  return fabsf((w - stats[2 * ti]) / stats[2 * ti + 1]);
}

// the block's sum in a fixed order (a tree over its threads)
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kSelThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// dist stats, first step: the chunk's sum of w (second == 0) or of (w - mean)^2
__global__ void __launch_bounds__(kSelThreads)
stats_partial_kernel(const __grid_constant__ PoolSet set, int second, const float* __restrict__ stats,
                     float* __restrict__ partials) {
  __shared__ float red[kSelThreads];
  const long long chunk = set.chunk0 + blockIdx.x;
  const Chunk c = chunk_of(set, chunk);
  const float* w = set.e[c.ti].w;
  const float mean = second ? stats[2 * (set.tensor0 + c.ti)] : 0.f;
  float acc = 0.f;
  for (long long i = c.begin + threadIdx.x; i < c.end; i += kSelThreads) {
    const float d = w[i] - mean;
    acc += second ? d * d : w[i];
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) partials[chunk] = s;
}

// dist stats, second step: one block per tensor sums its chunks' partials;
// mean = sum / n, then std = sqrt(sum of squares / n)
__global__ void __launch_bounds__(kSelThreads)
stats_final_kernel(const __grid_constant__ PoolSet set, int second, const float* __restrict__ partials,
                   float* __restrict__ stats) {
  __shared__ float red[kSelThreads];
  const int ti = blockIdx.x, gi = set.tensor0 + ti;
  const long long chunks = (set.e[ti].n + kChunk - 1) / kChunk;
  float acc = 0.f;
  for (long long i = threadIdx.x; i < chunks; i += kSelThreads) acc += partials[set.e[ti].chunk0 + i];
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) {
    const float v = s / (float)set.e[ti].n;
    if (second) stats[2 * gi + 1] = sqrtf(v);
    else stats[2 * gi] = v;
  }
}

// state: (slot, target, {prefix, rank}); target 2 pool is the pool's rank lo,
// 2 pool + 1 its rank hi; slot 0 holds (0, rank) from the host, slot p + 1
// what radix pass p chose
__device__ __forceinline__ const long long* pass_state(const long long* state, int slot, int npools) {
  return state + (long long)slot * 2 * npools * 2;
}

// radix pass `pass`: the digit histogram of the elements under each rank's prefix
__global__ void __launch_bounds__(kSelThreads)
hist_kernel(const __grid_constant__ PoolSet set, int npools, int pass, const float* __restrict__ stats,
            const long long* __restrict__ state, unsigned int* __restrict__ hist) {
  __shared__ unsigned int h[2 * kBins];
  const Chunk c = chunk_of(set, set.chunk0 + blockIdx.x);
  const float* w = set.e[c.ti].w;
  const int pool = (int)set.e[c.ti].pool;
  const int shift = pass_shift(pass), above = shift + pass_width(pass);
  const unsigned int digit_mask = (1u << pass_width(pass)) - 1u;
  const long long* prev = pass_state(state, pass, npools);
  const unsigned int pre_lo = (unsigned int)prev[4 * pool], pre_hi = (unsigned int)prev[4 * pool + 2];
  const bool two = pre_lo != pre_hi;  // the pool's two ranks under different prefixes: a histogram each
  for (int i = threadIdx.x; i < 2 * kBins; i += kSelThreads) h[i] = 0u;
  __syncthreads();
  for (long long i = c.begin + threadIdx.x; i < c.end; i += kSelThreads) {
    const unsigned int key = __float_as_uint(criterion(w[i], stats, set.tensor0 + c.ti));
    const unsigned int d = (key >> shift) & digit_mask;
    if (pass == 0) {
      atomicAdd(&h[d], 1u);
      continue;
    }
    const unsigned int pre = key >> above;
    if (pre == pre_lo) atomicAdd(&h[d], 1u);
    else if (two && pre == pre_hi) atomicAdd(&h[kBins + d], 1u);
  }
  __syncthreads();
  unsigned int* g = hist + ((long long)pass * 2 * npools + 2 * pool) * kBins;
  for (int b = threadIdx.x; b < kBins; b += kSelThreads) {
    if (h[b] != 0u) atomicAdd(g + b, h[b]);
    if (two && h[kBins + b] != 0u) atomicAdd(g + kBins + b, h[kBins + b]);
  }
}

// after radix pass `pass`: one block per rank finds the bin that holds it,
// and carries prefix and rank into the next pass
__global__ void __launch_bounds__(kSelThreads)
select_kernel(int npools, int pass, const unsigned int* __restrict__ hist, long long* __restrict__ state) {
  constexpr int kPer = kBins / kSelThreads;  // bins a thread scans
  __shared__ unsigned long long part[kSelThreads];
  const int target = blockIdx.x, pool = target >> 1;
  const long long* prev = pass_state(state, pass, npools);
  const unsigned long long prefix = (unsigned long long)prev[2 * target];
  const long long rank = prev[2 * target + 1];
  const bool two = prev[4 * pool] != prev[4 * pool + 2];
  const unsigned int* row = hist + ((long long)pass * 2 * npools + (two ? target : 2 * pool)) * kBins;
  const int bins = 1 << pass_width(pass);
  unsigned int cnt[kPer];
  unsigned long long s = 0ull;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = threadIdx.x * kPer + k;
    cnt[k] = b < bins ? row[b] : 0u;
    s += cnt[k];
  }
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive prefix sum of the threads' counts
    unsigned long long acc = 0ull;
    for (int i = 0; i < kSelThreads; ++i) {
      const unsigned long long v = part[i];
      part[i] = acc;
      acc += v;
    }
  }
  __syncthreads();
  unsigned long long below = part[threadIdx.x];
  const unsigned long long r = (unsigned long long)rank;
  if (r < below || r >= below + s) return;
  for (int k = 0; k < kPer; ++k) {
    if (r < below + cnt[k]) {
      long long* out = state + ((long long)(pass + 1) * 2 * npools + target) * 2;
      out[0] = (long long)((prefix << pass_width(pass)) | (unsigned long long)(threadIdx.x * kPer + k));
      out[1] = (long long)(r - below);
      return;
    }
    below += cnt[k];
  }
}

// th = v_lo lw + v_hi hw: two products and one add, each rounded to f32, as
// jnp.quantile computes it (written with the _rn intrinsics so that nvcc
// cannot contract them into a fused multiply-add)
// lwhw: (npools, 2) f32, each pool's (lw, hw)
__global__ void threshold_kernel(int npools, const long long* __restrict__ state, const float* __restrict__ lwhw,
                                 float* __restrict__ th) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npools) return;
  const long long* fin = pass_state(state, kPasses, npools);
  const float v_lo = __uint_as_float((unsigned int)fin[4 * p]);
  const float v_hi = __uint_as_float((unsigned int)fin[4 * p + 2]);
  th[p] = __fadd_rn(__fmul_rn(v_lo, lwhw[2 * p]), __fmul_rn(v_hi, lwhw[2 * p + 1]));
}

__global__ void __launch_bounds__(kSelThreads)
mask_kernel(const __grid_constant__ PoolSet set, const float* __restrict__ stats, const float* __restrict__ th) {
  const Chunk c = chunk_of(set, set.chunk0 + blockIdx.x);
  const float* w = set.e[c.ti].w;
  float* mask = set.e[c.ti].mask;
  const float t = th[set.e[c.ti].pool];
  for (long long i = c.begin + threadIdx.x; i < c.end; i += kSelThreads)
    mask[i] = criterion(w[i], stats, set.tensor0 + c.ti) > t ? 1.f : 0.f;
}

}  // namespace sct

#define SCT_LAUNCHED()                          \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// entries: `count` PoolEntry rows (5 int64 each: w, mask, n, first chunk,
// pool) in host memory, in order of their first chunks, the tensors' chunks
// of 16,384 weights numbering `chunks`. dist: 0 (criterion |w|) or 1 (stats
// (count, 2) and partials (chunks) f32 scratch, written). hist: (3, 2 npools,
// 2048) uint32, zeroed; state: (4, 2 npools, 2) int64, slot 0 holding each
// pool's (0, lo), (0, hi); lwhw: (npools, 2) f32, each pool's (lw, hw); th:
// (npools) f32, written.
extern "C" int sct_magnitude_threshold(const void* entries, int count, int npools, long long chunks, int dist,
                                       void* stats, void* partials, void* hist, void* state, const void* lwhw,
                                       void* th, void* stream) {
  if (entries == nullptr || count < 1 || npools < 1 || npools > count || chunks < 1 || chunks > INT_MAX ||
      hist == nullptr || state == nullptr || lwhw == nullptr || th == nullptr ||
      (dist && (stats == nullptr || partials == nullptr)))
    return (int)cudaErrorInvalidValue;
  const sct::PoolEntry* all = static_cast<const sct::PoolEntry*>(entries);
  const int ngroups = (count + sct::kMaxTensors - 1) / sct::kMaxTensors;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = sct::kSelThreads;
  float* st = dist ? static_cast<float*>(stats) : nullptr;
  unsigned int* h = static_cast<unsigned int*>(hist);
  long long* sel = static_cast<long long*>(state);
  auto group = [&](int g) {  // the table of group g
    sct::PoolSet set;
    set.tensor0 = g * sct::kMaxTensors;
    set.count = count - set.tensor0 < sct::kMaxTensors ? count - set.tensor0 : sct::kMaxTensors;
    memcpy(set.e, all + set.tensor0, (size_t)set.count * sizeof(sct::PoolEntry));
    set.chunk0 = set.e[0].chunk0;
    const long long end = set.tensor0 + set.count < count ? all[set.tensor0 + set.count].chunk0 : chunks;
    set.chunks = end - set.chunk0;
    return set;
  };
  if (dist) {
    for (int g = 0; g < ngroups; ++g) {
      const sct::PoolSet set = group(g);
      for (int second = 0; second < 2; ++second) {
        sct::stats_partial_kernel<<<(int)set.chunks, T, 0, s>>>(set, second, st, static_cast<float*>(partials));
        SCT_LAUNCHED();
        sct::stats_final_kernel<<<set.count, T, 0, s>>>(set, second, static_cast<const float*>(partials), st);
        SCT_LAUNCHED();
      }
    }
  }
  for (int pass = 0; pass < sct::kPasses; ++pass) {
    for (int g = 0; g < ngroups; ++g) {
      const sct::PoolSet set = group(g);
      sct::hist_kernel<<<(int)set.chunks, T, 0, s>>>(set, npools, pass, st, sel, h);
      SCT_LAUNCHED();
    }
    sct::select_kernel<<<2 * npools, T, 0, s>>>(npools, pass, h, sel);
    SCT_LAUNCHED();
  }
  sct::threshold_kernel<<<(npools + 127) / 128, 128, 0, s>>>(npools, sel, static_cast<const float*>(lwhw),
                                                             static_cast<float*>(th));
  SCT_LAUNCHED();
  for (int g = 0; g < ngroups; ++g) {
    const sct::PoolSet set = group(g);
    sct::mask_kernel<<<(int)set.chunks, T, 0, s>>>(set, st, static_cast<const float*>(th));
    SCT_LAUNCHED();
  }
  return 0;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
