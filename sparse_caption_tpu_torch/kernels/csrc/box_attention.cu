// K1: fused ORT box-relation self-attention, forward.
//
// Replaces: sparse_caption_tpu/models/layers.py:338-365 box_relational_embedding
// and :406-439 BoxMultiHeadAttention.__call__ (left to XLA's fusions on the
// TPU; no Pallas kernel there).
//
// Computes, for each image b and head h,
//   geo[i,j]   = sin/cos(100 * log-delta(box_i, box_j) * freq)     (f32 trig)
//   w_g[i,j,h] = relu(geo[i,j] (cast to T) . wg[h] + wg_b[h])      (rounded to T)
//   bias       = log(max(w_g, 1e-6))                                (rounded to T)
//   out        = softmax(fill(q.k / sqrt(dk), mask, -1e9) + bias) . v
// with the cast points of layers.py:425-435.
//
// Bound on the H100 (d_model 512, 8 heads, R = 36): bytes. q, k, v and out
// are 4 * B * 8 * 36 * 64 elements (302 MB in bf16 at B = 2048, 0.09 ms at
// 3.35 TB/s); the arithmetic (QK, PV, the 64-wide wg dot per pair and head)
// is under 10 GFLOP. The geometry tensor (B, R, R, 64) and the bias (B, h, R, R)
// never leave the SM.
//
// Design: one block per image over all heads. The block first computes the
// geometry of every (i, j) pair once (32 sincosf, box_geometry.cuh) and dots it
// with all heads' wg rows, storing the (h, R, R) log-bias in shared memory;
// then, head by head, it stages K and V in shared memory and each warp attends
// one query row at a time (common.cuh warp_attend_row). Simple CUDA cores, no
// wgmma: the 36-wide products are far too small for tensor-core tiles to
// matter before the memory bound does.
//
// Train variant (sct_box_attention_train): the same kernel also applies the
// attention-probability dropout keep-mask (B, h, R, R) as p * keep / keep_prob
// after the softmax (layers.py:437-438) and writes each row's f32
// log-sum-exp (B, h, R), from which K7 (box_attention_bwd.cu) recomputes the
// probabilities.
#include "box_geometry.cuh"

namespace sct {

constexpr int kBoxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBoxThreads)
box_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ boxes, const T* __restrict__ wg_w, const T* __restrict__ wg_b,
                     const float* __restrict__ freq, const unsigned char* __restrict__ mask,
                     const unsigned char* __restrict__ keep, float keep_prob, T* __restrict__ out,
                     float* __restrict__ lse, int H, int R, float scale) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* bias_s = smem;                    // H * R * R
  float* k_s = bias_s + H * R * R;         // R * kKeyStride
  float* v_s = k_s + R * kKeyStride;       // R * kValStride
  float* q_s = v_s + R * kValStride;       // nwarps * 64
  float* p_s = q_s + nwarps * kHeadDim;    // nwarps * 64
  float* box_s = p_s + nwarps * kHeadDim;  // R * 4
  float* w_s = box_s + R * 4;              // H * 64
  float* wb_s = w_s + H * 64;              // H
  float* freq_s = wb_s + H;                // kFreqs
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(freq_s + kFreqs);  // R

  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < R * 4; e += blockDim.x) box_s[e] = boxes[(size_t)b * R * 4 + e];
  for (int e = threadIdx.x; e < H * 64; e += blockDim.x) w_s[e] = to_f(wg_w[e]);
  for (int e = threadIdx.x; e < H; e += blockDim.x) wb_s[e] = to_f(wg_b[e]);
  for (int e = threadIdx.x; e < kFreqs; e += blockDim.x) freq_s[e] = freq[e];
  for (int e = threadIdx.x; e < R; e += blockDim.x) mask_s[e] = mask[(size_t)b * R + e];
  __syncthreads();

  // geometry log-bias of every (head, i, j)
  for (int p = threadIdx.x; p < R * R; p += blockDim.x) {
    const int i = p / R, j = p - (p / R) * R;
    float wg[kMaxHeads];
    pair_wg<T>(box_s + 4 * i, box_s + 4 * j, w_s, wb_s, freq_s, H, wg);
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh < H) bias_s[(hh * R + i) * R + j] = round_to<T>(logf(wg[hh]));
    }
  }

  for (int hh = 0; hh < H; ++hh) {
    const size_t base = ((size_t)b * H + hh) * R * kHeadDim;
    __syncthreads();  // bias done / previous head's tiles no longer read
    load_tile(k_s, k + base, R, kKeyStride);
    load_tile(v_s, v + base, R, kValStride);
    __syncthreads();
    float* qw = q_s + warp * kHeadDim;
    for (int i = warp; i < R; i += nwarps) {
      const float2 qv = load2(q + base + (size_t)i * kHeadDim + 2 * lane);
      qw[2 * lane] = qv.x;
      qw[2 * lane + 1] = qv.y;
      __syncwarp();
      const size_t row = ((size_t)b * H + hh) * R + i;
      warp_attend_row<T>(qw, k_s, v_s, mask_s, bias_s + (hh * R + i) * R, R, scale,
                         p_s + warp * kHeadDim, out + base + (size_t)i * kHeadDim,
                         keep == nullptr ? nullptr : keep + row * R, keep_prob,
                         lse == nullptr ? nullptr : lse + row);
    }
  }
}

inline size_t box_smem_bytes(int H, int R) {
  const int nwarps = kBoxThreads / 32;
  const size_t floats = (size_t)H * R * R + (size_t)R * kKeyStride + (size_t)R * kValStride +
                        2 * (size_t)nwarps * kHeadDim + (size_t)R * 4 + (size_t)H * 64 + H + kFreqs;
  return floats * sizeof(float) + R;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* boxes, const void* wg_w,
                   const void* wg_b, const void* freq, const void* mask, const void* keep, float keep_prob, void* out,
                   void* lse, int B, int H, int R, float scale, cudaStream_t stream) {
  const size_t smem = box_smem_bytes(H, R);
  cudaError_t err = cudaFuncSetAttribute(box_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  box_attention_kernel<T><<<B, kBoxThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(boxes), static_cast<const T*>(wg_w), static_cast<const T*>(wg_b),
      static_cast<const float*>(freq), static_cast<const unsigned char*>(mask),
      static_cast<const unsigned char*>(keep), keep_prob, static_cast<T*>(out), static_cast<float*>(lse), H, R,
      scale);
  return cudaGetLastError();
}

int dispatch(int dtype, const void* q, const void* k, const void* v, const void* boxes, const void* wg_w,
             const void* wg_b, const void* freq, const void* mask, const void* keep, float keep_prob, void* out,
             void* lse, int B, int H, int R, float scale, void* stream) {
  if (H < 1 || H > kMaxHeads || R < 1 || R > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, out, lse, B, H, R, scale, s);
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k, v, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, out, lse, B, H, R,
                                      scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (B, H, R, 64); boxes (B, R, 4) f32;
// wg_w (H, 64) and wg_b (H,) in the compute dtype; freq (8,) f32; mask (B, R) bool.
extern "C" int sct_box_attention(int dtype, const void* q, const void* k, const void* v, const void* boxes,
                                 const void* wg_w, const void* wg_b, const void* freq, const void* mask,
                                 void* out, int B, int H, int R, float scale, void* stream) {
  return sct::dispatch(dtype, q, k, v, boxes, wg_w, wg_b, freq, mask, nullptr, 1.f, out, nullptr, B, H, R, scale,
                       stream);
}

// Train variant: as above, plus keep (B, H, R, R) bool or null (no dropout)
// with keep_prob, and lse (B, H, R) f32 written.
extern "C" int sct_box_attention_train(int dtype, const void* q, const void* k, const void* v, const void* boxes,
                                       const void* wg_w, const void* wg_b, const void* freq, const void* mask,
                                       const void* keep, float keep_prob, void* out, void* lse, int B, int H, int R,
                                       float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return sct::dispatch(dtype, q, k, v, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, out, lse, B, H, R, scale,
                       stream);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
