// Shared device helpers of the port's hand-written Hopper kernels.
//
// Inputs are f32 or bf16; all arithmetic runs in f32. `round_to<T>` marks the
// points where the JAX reference rounds an intermediate to the compute dtype
// (a no-op for f32). The attention kernels take the head width DK as a template
// parameter, instantiated for 64 (d_model 512, 8 heads: the ORT, ACORT-base),
// 32 (d_model 256, 8 heads: ACORT-small and ORT-small) and 13 (d_model 104,
// 8 heads: ORT-xsmall); the Python wrappers check dk before launching.
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

// The log-softmax of a row in the compute dtype R, rounded where
// jax.nn.log_softmax rounds an R row (sparse_caption_tpu/models/layers.py:472):
//   sh = R(x - max);  s = sum exp(sh) in f32;  lse = R(log(R(s)));  lp = R(sh - lse)
// (kernels/vocab_log_softmax.py rounded_log_softmax is the plain rule). Each
// rounding is the identity in f32. lp grows with x (R is monotone), so the
// largest logit of a set has its largest log-prob. `lsm_shift2` rounds two
// shifts by one conversion of the pair.
template <typename R> __device__ __forceinline__ float lsm_shift(float x, float m) { return round_to<R>(x - m); }
template <typename R> __device__ __forceinline__ float lsm_lse(float s) { return round_to<R>(logf(round_to<R>(s))); }
template <typename R> __device__ __forceinline__ float lsm_logprob(float x, float m, float lse) {
  return round_to<R>(lsm_shift<R>(x, m) - lse);
}
template <typename R> __device__ __forceinline__ float2 lsm_shift2(float a, float b, float m) {
  if constexpr (sizeof(R) == 2) {
    return __bfloat1622float2(__floats2bfloat162_rn(a - m, b - m));
  } else {
    return make_float2(a - m, b - m);
  }
}

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

// A score q.k over sqrt(dk), or its gradient over the same: the plain
// versions divide by sqrt(dk) rounded to the compute dtype, a 0-dim tensor
// on the scores' device (a true division on every device, and the divisor
// JAX's weak typing gives: bf16(sqrt(13)) = 3.609375), so the kernels take
// that divisor and divide by it. A product by 1 / sqrt(dk) is the same only
// at dk 64.
__device__ __forceinline__ float div_score(float x, float d) { return div_by(x, d, __frcp_rn(d)); }

// Head width 13 is a padded instance: its rows are staged and computed at
// width kPad<13> = 16 with columns 13-15 zero, so one mma k-step (16) covers
// the dot product and the zero columns add nothing to a score or a product;
// only the 13 real columns are written back. A 13-wide row is 26 bytes in
// bf16 (52 in f32), and head h of a token starts at byte 26 h: no 16-byte
// copy, TMA or vector access reaches it, so the narrow instance moves its
// rows element by element (`stage_padded`, `store_unpadded`, the `*_col_pair`
// accesses). 64 and 32 are their own padded widths.
__host__ __device__ constexpr int padded_width(int dk) { return (dk + 15) / 16 * 16; }
template <int DK> constexpr int kPad = padded_width(DK);
template <int DK> constexpr bool kNarrow = DK % 8 != 0;

// element c < kPad<DK> of a padded row whose DK real elements are at src: zero past DK
template <int DK, typename T>
__device__ __forceinline__ T padded_elem(const T* __restrict__ src, int c) {
  return c < DK ? src[c] : from_f<T>(0.f);
}

// `rows` rows of DK elements (row r at src + r * DK) into shared rows of
// pitch `ld` at width kPad<DK>, the pad columns zeroed; the calling threads
// take the elements first, first + step, ... (a block: threadIdx.x,
// blockDim.x; a warp: lane, 32)
template <int DK, typename T>
__device__ __forceinline__ void stage_padded(T* dst, int ld, const T* __restrict__ src, int rows, int first,
                                             int step) {
  constexpr int P = kPad<DK>;
  for (int e = first; e < rows * P; e += step) {
    const int r = e / P, c = e - r * P;
    dst[r * ld + c] = padded_elem<DK>(src + r * DK, c);
  }
}

// `rows` shared rows of pitch `ld` to rows of DK elements at dst: the DK real columns
template <int DK, typename T>
__device__ __forceinline__ void store_unpadded(T* __restrict__ dst, const T* src, int ld, int rows, int first,
                                               int step) {
  for (int e = first; e < rows * DK; e += step) {
    const int r = e / DK, c = e - r * DK;
    dst[r * DK + c] = src[r * ld + c];
  }
}

// columns c and c + 1 (c even) of a DK-wide row in global memory: one 8-byte
// (f32) or 4-byte (bf16) access where DK is a multiple of 8; else each column
// alone, zero (load) or skipped (store) past DK
template <int DK, typename T>
__device__ __forceinline__ float2 load_col_pair(const T* row, int c) {
  if constexpr (!kNarrow<DK>) {
    return load2(row + c);
  } else {
    return make_float2(c < DK ? to_f(row[c]) : 0.f, c + 1 < DK ? to_f(row[c + 1]) : 0.f);
  }
}
template <int DK, typename T>
__device__ __forceinline__ void store_col_pair(T* row, int c, float2 v) {
  if constexpr (!kNarrow<DK>) {
    store2(row + c, v);
  } else {
    if (c < DK) row[c] = from_f<T>(v.x);
    if (c + 1 < DK) row[c + 1] = from_f<T>(v.y);
  }
}

// A lane's dims of a head row, at p = the row + kLaneDims<DK> x lane: 2
// neighbours (one 4- or 8-byte access) at DK = 64; one at DK = 32 and 13,
// where the lanes past DK hold 0 and touch no memory (K2 and its backward).
template <int DK> constexpr int kLaneDims = DK == 64 ? 2 : 1;
template <int DK, typename T>
struct LaneDims {
  float v;
  __device__ __forceinline__ void load(const T* p, int lane) { v = lane < DK ? to_f(*p) : 0.f; }
  __device__ __forceinline__ float dot(const LaneDims& o) const { return v * o.v; }
  __device__ __forceinline__ void add(float p, const LaneDims& o) { v += p * o.v; }
  __device__ __forceinline__ LaneDims times(float p) const { return {p * v}; }
  __device__ __forceinline__ LaneDims plus(const LaneDims& o) const { return {v + o.v}; }
  __device__ __forceinline__ void store(T* p, int lane) const {
    if (lane < DK) *p = from_f<T>(v);
  }
};
template <typename T>
struct LaneDims<64, T> {
  float2 v;
  __device__ __forceinline__ void load(const T* p, int) { v = load2(p); }
  __device__ __forceinline__ float dot(const LaneDims& o) const { return v.x * o.v.x + v.y * o.v.y; }
  __device__ __forceinline__ void add(float p, const LaneDims& o) {
    v.x += p * o.v.x;
    v.y += p * o.v.y;
  }
  __device__ __forceinline__ LaneDims times(float p) const { return {make_float2(p * v.x, p * v.y)}; }
  __device__ __forceinline__ LaneDims plus(const LaneDims& o) const { return {make_float2(v.x + o.v.x, v.y + o.v.y)}; }
  __device__ __forceinline__ void store(T* p, int) const { store2(p, v); }
};

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
// (j + d) % 32, no conflicts) and of a value tile (lane reads 2 neighbours),
// at the padded width.
template <int DK> constexpr int kKeyStride = kPad<DK> + 1;
template <int DK> constexpr int kValStride = kPad<DK>;

// A lane's columns of a row in the f32 layouts where lane l owns columns
// 2 l and 2 l + 1 of the padded width: every lane at DK = 64, lanes 0-15 at
// DK = 32, lanes 0-7 at DK = 13 (the others skip the row's loads and stores).
template <int DK> __device__ __forceinline__ bool owns_cols(int lane) { return DK == 64 || 2 * lane < kPad<DK>; }

// Copy `rows` rows of DK f32 elements from global memory into shared memory
// at the padded width (the narrow instance's pad columns zeroed).
template <int DK>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows, int stride) {
  if constexpr (kNarrow<DK>) {
    stage_padded<DK>(dst, stride, src, rows, threadIdx.x, blockDim.x);
  } else {
    for (int e = threadIdx.x; e < rows * (DK / 2); e += blockDim.x) {
      const int r = e / (DK / 2), c = (e % (DK / 2)) * 2;
      const float2 v = load2(src + r * DK + c);
      dst[r * stride + c] = v.x;
      dst[r * stride + c + 1] = v.y;
    }
  }
}

// One warp attends one query row to R <= 64 keys held in shared memory:
// scores q.k / sqrt_dk (`div_score`), the -1e9 fill where mask == 0, an optional additive
// bias AFTER the fill, softmax, then P.V written to `out` (DK elements).
// q_s: DK f32 (the padded width); k_s: R rows of kKeyStride; v_s: R rows of kValStride;
// p_s: 64 f32 of scratch owned by this warp. Optional (training): `keep`, the
// row's R dropout flags, turns p into p * keep / keep_prob before P.V, and
// `lse` receives the row's log-sum-exp of the scores (f32). `v_stride`: the
// value rows' stride (kKeyStride where the key tile serves as V).
template <int DK, typename T>
__device__ __forceinline__ void warp_attend_row(const float* q_s, const float* k_s, const float* v_s,
                                                const unsigned char* mask_s, const float* bias, int R,
                                                float sqrt_dk, float* p_s, T* __restrict__ out,
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
      v = div_score(acc, sqrt_dk);
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
    store_col_pair<DK>(out, 2 * lane, acc);
  }
  __syncwarp();  // p_s and the caller's q_s are rewritten for the next row
}

}  // namespace sct
