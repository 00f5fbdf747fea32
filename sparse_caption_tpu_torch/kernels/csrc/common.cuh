// Shared device helpers of the port's hand-written Hopper kernels.
//
// Inputs are f32 or bf16; all arithmetic runs in f32. `round_to<T>` marks the
// points where the JAX reference rounds an intermediate to the compute dtype
// (a no-op for f32). The attention kernels take the head width DK as a template
// parameter, instantiated for 64 (d_model 512, 8 heads: the ORT, ACORT-base)
// and 32 (d_model 256, 8 heads: ACORT-small and ORT-small); the Python
// wrappers check dk before launching.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace sct {

constexpr float kNegInf = -1e9f;  // the masked-score fill (layers.py NEG_INF)
constexpr int kBlockSmemLimit = 232448;  // dynamic shared memory a block may use on the H100

// the card's SMs (a persistent grid's size)
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n < 1 ? 1 : n;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T (round to nearest even, as PyTorch casts) and widened again
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// two neighbouring elements in one 8-byte (f32) or 4-byte (bf16) access
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// a / b rounded to nearest, from r = 1 / b rounded to nearest: one
// remainder step with FMAs (Markstein's correction), the result of the
// IEEE division for the finite, non-tiny operands of a softmax; one
// reciprocal then serves a whole row
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// merge a partial (max, sum exp(x - max)) pair into another (online log-sum-exp)
__device__ __forceinline__ void merge_max_sum(float& m, float& s, float om, float os) {
  const float mm = fmaxf(m, om);
  if (mm == -INFINITY) return;
  s = s * expf(m - mm) + os * expf(om - mm);
  m = mm;
}

// a ranks above b: larger value, ties to the lower index
__device__ __forceinline__ bool ranks_above(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Shared-memory row strides of a key tile (odd: lane j reading row j hits bank
// (j + d) % 32, no conflicts) and of a value tile (lane reads 2 neighbours).
template <int DK> constexpr int kKeyStride = DK + 1;
template <int DK> constexpr int kValStride = DK;

// A lane's columns of a DK-wide row in the f32 layouts where lane l owns
// columns 2 l and 2 l + 1: every lane at DK = 64, lanes 0-15 at DK = 32 (the
// others skip the row's loads and stores).
template <int DK> __device__ __forceinline__ bool owns_cols(int lane) { return DK == 64 || 2 * lane < DK; }

// Copy `rows` rows of DK elements from global memory into f32 shared memory.
template <int DK, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int rows, int stride) {
  for (int e = threadIdx.x; e < rows * (DK / 2); e += blockDim.x) {
    const int r = e / (DK / 2), c = (e % (DK / 2)) * 2;
    const float2 v = load2(src + r * DK + c);
    dst[r * stride + c] = v.x;
    dst[r * stride + c + 1] = v.y;
  }
}

// One warp attends one query row to R <= 64 keys held in shared memory:
// scores q.k * scale, the -1e9 fill where mask == 0, an optional additive
// bias AFTER the fill, softmax, then P.V written to `out` (DK elements).
// q_s: DK f32; k_s: R rows of kKeyStride; v_s: R rows of kValStride;
// p_s: 64 f32 of scratch owned by this warp. Optional (training): `keep`, the
// row's R dropout flags, turns p into p * keep / keep_prob before P.V, and
// `lse` receives the row's log-sum-exp of the scores (f32). `v_stride`: the
// value rows' stride (kKeyStride where the key tile serves as V).
template <int DK, typename T>
__device__ __forceinline__ void warp_attend_row(const float* q_s, const float* k_s, const float* v_s,
                                                const unsigned char* mask_s, const float* bias, int R,
                                                float scale, float* p_s, T* __restrict__ out,
                                                const unsigned char* __restrict__ keep = nullptr,
                                                float keep_prob = 1.f, float* __restrict__ lse = nullptr,
                                                int v_stride = kValStride<DK>) {
  const int lane = threadIdx.x & 31;
  float s[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = lane + 32 * c;
    float v = -INFINITY;
    if (j < R) {
      const float* kr = k_s + j * kKeyStride<DK>;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DK; ++d) acc = fmaf(q_s[d], kr[d], acc);
      v = acc * scale;
      if (mask_s != nullptr && mask_s[j] == 0) v = kNegInf;
      if (bias != nullptr) v += bias[j];
    }
    s[c] = v;
  }
  const float m = warp_max(fmaxf(s[0], s[1]));
  const float e0 = lane < R ? expf(s[0] - m) : 0.f;
  const float e1 = lane + 32 < R ? expf(s[1] - m) : 0.f;
  const float sum = warp_sum(e0 + e1);
  const float inv = 1.f / sum;
  float p0 = e0 * inv, p1 = e1 * inv;
  if (keep != nullptr) {
    p0 = lane < R && keep[lane] ? p0 / keep_prob : 0.f;
    p1 = lane + 32 < R && keep[lane + 32] ? p1 / keep_prob : 0.f;
  }
  if (lane < R) p_s[lane] = p0;
  if (lane + 32 < R) p_s[lane + 32] = p1;
  if (lse != nullptr && lane == 0) *lse = m + logf(sum);
  __syncwarp();
  if (owns_cols<DK>(lane)) {
    float2 acc = make_float2(0.f, 0.f);
    for (int j = 0; j < R; ++j) {
      const float p = p_s[j];
      const float* vr = v_s + j * v_stride + 2 * lane;
      acc.x = fmaf(p, vr[0], acc.x);
      acc.y = fmaf(p, vr[1], acc.y);
    }
    store2(out + 2 * lane, acc);
  }
  __syncwarp();  // p_s and the caller's q_s are rewritten for the next row
}

}  // namespace sct
