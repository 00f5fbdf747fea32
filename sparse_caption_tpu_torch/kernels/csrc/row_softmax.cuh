// The held-row log-softmax statistics shared by K13 (vocabulary
// log-softmax) and K4 (beam log-softmax + top-K): one block per row, each
// thread holding up to kRowHeld values of the row as raw 16-byte vectors,
// consecutive threads on consecutive vectors (thread t holds vectors t,
// t + nt, ...). The row's max and log-sum-exp are reduced in one fixed order
// (each thread's values in order, a warp shuffle tree, then the warps in
// order), so the two kernels give the same log-sum, and so the same log-probs,
// bit for bit, and a run repeats bit for bit. A bf16 row's log-probs round
// where jax.nn.log_softmax rounds them (common.cuh lsm_*).
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

// the two sums' block totals, in every thread, each in block_sum's order; red: 64 floats
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    r.x += red[w];
    r.y += red[32 + w];
  }
  return r;
}

// the row's max m and lse = R(log(R(sum exp(R(x - m))))) (common.cuh lsm_*:
// R the dtype the log-probs round in, T itself or f32 where they are not
// rounded) from the held vectors (raw[k] is vector k nt + t of the row,
// `units` vectors in all), in every thread, and the thread's own largest
// value in `mine` (-inf if it holds none); one expf an element, no online
// rescale. With `exact` (K13's forward in bf16 when a backward follows, which
// recomputes the f32 softmax), also log(sum exp(x - m)) unrounded: a second
// expf an element, both sums reduced at once. red_max: 32 floats; red_sum: 32 floats, 64 with
// `exact`.
template <typename T, int PER, typename R = T>
__device__ __forceinline__ void held_row_stats(const uint4 (&raw)[PER], int units, float* red_max, float* red_sum,
                                               float& m, float& lse, float& mine, float* exact = nullptr) {
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
  float sloc = 0.f, eloc = 0.f;
  if (exact != nullptr) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (k * nt + tid < units) {
        float v[UE];
        unpack16<T>(raw[k], v);
#pragma unroll
        for (int i = 0; i < UE; i += 2) {
          const float2 sh = lsm_shift2<R>(v[i], v[i + 1], m);
          sloc += expf(sh.x);
          sloc += expf(sh.y);
          eloc += expf(v[i] - m);
          eloc += expf(v[i + 1] - m);
        }
      }
    }
    const float2 sums = block_sum2(sloc, eloc, red_sum);
    lse = lsm_lse<R>(sums.x);
    *exact = logf(sums.y);
    return;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (k * nt + tid < units) {
      float v[UE];
      unpack16<T>(raw[k], v);
#pragma unroll
      for (int i = 0; i < UE; i += 2) {
        const float2 sh = lsm_shift2<R>(v[i], v[i + 1], m);
        sloc += expf(sh.x);
        sloc += expf(sh.y);
      }
    }
  }
  lse = lsm_lse<R>(block_sum(sloc, red_sum));
}

}  // namespace sct
