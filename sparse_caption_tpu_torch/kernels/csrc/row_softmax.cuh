// The held-row log-softmax statistics shared by K13 (vocabulary
// log-softmax) and K4 (beam log-softmax + top-K): one block per row, each
// thread holding up to kRowHeld values of the row as raw 16-byte vectors,
// consecutive threads on consecutive vectors (thread t holds vectors t,
// t + nt, ...). The row's max and log-sum-exp are reduced in one fixed order
// (each thread's values in order, a warp shuffle tree, then the warps in
// order), so the two kernels give the same log-sum, and so the same log-probs,
// bit for bit, and a run repeats bit for bit.
#pragma once

#include "common.cuh"
#include "vec.cuh"

namespace sct {

constexpr int kRowHeld = 32;  // values a thread of a held row holds
// the largest block of K4's and K9's held paths (V <= 320 x kRowHeld = 10,240)
constexpr int kTopkHeldMaxThreads = 320;

// threads of a held row of V elements of T: V / UE vectors, kRowHeld / UE a
// thread, rounded up to whole warps; 0 if V is not whole 16-byte vectors or
// the row needs more than max_threads
template <typename T>
inline int held_row_threads(int V, int max_threads) {
  constexpr int UE = 16 / sizeof(T);
  if (V % UE != 0) return 0;
  const int per = kRowHeld / UE;
  const int threads = ((V / UE + per - 1) / per + 31) / 32 * 32;
  return threads <= max_threads ? threads : 0;
}

// the row's max / sum over the block from each thread's value, in every
// thread; red: 32 floats of shared memory per reduction
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = -INFINITY;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) r += red[w];
  return r;
}

// the row's max m and log(sum exp(x - m)) from the held vectors (raw[k] is
// vector k nt + t of the row, `units` vectors in all), in every thread, and
// the thread's own largest value in `mine` (-inf if it holds none); one expf
// an element, no online rescale. red_max, red_sum: 32 floats each.
template <typename T, int PER>
__device__ __forceinline__ void held_row_stats(const uint4 (&raw)[PER], int units, float* red_max, float* red_sum,
                                               float& m, float& logsum, float& mine) {
  constexpr int UE = 16 / sizeof(T);
  const int nt = blockDim.x, tid = threadIdx.x;
  float mloc = -INFINITY;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (k * nt + tid < units) {
      float v[UE];
      unpack16<T>(raw[k], v);
#pragma unroll
      for (int i = 0; i < UE; ++i) mloc = fmaxf(mloc, v[i]);
    }
  }
  mine = mloc;
  m = block_max(mloc, red_max);
  float sloc = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (k * nt + tid < units) {
      float v[UE];
      unpack16<T>(raw[k], v);
#pragma unroll
      for (int i = 0; i < UE; ++i) sloc += expf(v[i] - m);
    }
  }
  logsum = logf(block_sum(sloc, red_sum));
}

}  // namespace sct
