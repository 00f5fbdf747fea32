// K14: the decoder's full-sequence attention, forward.
//
// Replaces: sparse_caption_tpu/models/layers.py:158-172 scaled_dot_attention,
// reached through :217-228 MultiHeadAttention.__call__ from the decoder layers
// (models/transformer.py:95-106: causal self-attention over the caption,
// cross-attention over the regions); left to XLA's fusions on the TPU, no
// Pallas kernel there.
//
// For query row n = b * group + m (head h, position i) and key row b:
//   s[i,j]   = fill(q[n,h,i] . k[b,h,j] / sqrt(dk), valid(i, j), -1e9)
//   valid    = key_valid[b, j] (null: all keys) and, causal, j <= i
//   p        = softmax_j(s);   pd = p * keep[n,h,i,j] / keep_prob (optional dropout)
//   out[n,h,i] = sum_j pd[i,j] v[b,h,j]
// rounded to the compute dtype T where the plain version (ops/attention.py)
// rounds: the product and its scaling, the probabilities, their dropout
// scaling and the output. A row with no valid key averages every value
// uniformly, as the -1e9 fill makes the plain version do.
//
// Bound on the H100 (8 heads of 64, 17 query positions; the ORT XE step at
// 256 x 5 captions, bf16): bytes. Self-attention (17 keys) reads q, k, v and
// the keep-mask and writes out: 92 MB, 0.027 ms at 3.35 TB/s; cross-attention
// (36 regions, 5 captions per image) reads one K/V row per image: 70 MB,
// 0.021 ms. The products are 0.8 and 1.6 GFLOP.
//
// Design: one block per (key row, head), so K and V are staged in shared
// memory once and serve every query row of their group (the 5 captions or 15
// samples of an image in cross-attention; the caption itself in
// self-attention) without the repeat the JAX package makes. Each warp takes
// one query row at a time: lane j scores keys j and j + 32, the warp's
// shuffles give the row max and sum, and the weighted sum of V runs two
// columns per lane. No log-sum-exp is written: K15 recomputes each row's
// softmax in one warp from the same scores, bit for bit. CUDA cores only: a
// 17 x 36 x 64 product per (row, head) is far below a tensor-core tile.
#include "decoder_attention.cuh"

namespace sct {

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const unsigned char* __restrict__ key_valid, const unsigned char* __restrict__ keep,
                         float keep_prob, T* __restrict__ out, int H, int Tq, int Tk, int group, int causal,
                         float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* k_s = smem;                            // Tk * kDecStride
  float* v_s = k_s + Tk * kDecStride;           // Tk * kHeadDim
  float* q_s = v_s + Tk * kHeadDim;             // kDecWarps * kHeadDim
  float* p_s = q_s + kDecWarps * kHeadDim;      // kDecWarps * kDecMaxLen
  unsigned char* valid_s = reinterpret_cast<unsigned char*>(p_s + kDecWarps * kDecMaxLen);  // Tk

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t kv_base = ((size_t)b * H + h) * Tk * kHeadDim;
  load_tile(k_s, k + kv_base, Tk, kDecStride);
  load_tile(v_s, v + kv_base, Tk, kHeadDim);
  dec_load_valid(valid_s, key_valid, b, Tk);
  __syncthreads();

  float* qw = q_s + warp * kHeadDim;
  float* pw = p_s + warp * kDecMaxLen;
  for (int r = warp; r < group * Tq; r += kDecWarps) {
    const int m = r / Tq, i = r - (r / Tq) * Tq;
    const size_t row = ((size_t)(b * group + m) * H + h) * Tq + i;  // (n, h, i)
    const float2 qv = load2(q + row * kHeadDim + 2 * lane);
    qw[2 * lane] = qv.x;
    qw[2 * lane + 1] = qv.y;
    __syncwarp();
    float s[2], p[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      s[c] = j < Tk ? dec_score<T>(qw, k_s + j * kDecStride, scale, dec_key_ok(valid_s, i, j, causal)) : -INFINITY;
    }
    dec_softmax<T>(s, Tk, p);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < Tk) {
        float pd = p[c];
        if (keep != nullptr) pd = keep[row * Tk + j] ? round_to<T>(pd / keep_prob) : 0.f;
        pw[j] = pd;
      }
    }
    __syncwarp();
    float2 acc = make_float2(0.f, 0.f);
    for (int j = 0; j < Tk; ++j) {
      const float pj = pw[j];
      const float* vr = v_s + j * kHeadDim + 2 * lane;
      acc.x = fmaf(pj, vr[0], acc.x);
      acc.y = fmaf(pj, vr[1], acc.y);
    }
    store2(out + row * kHeadDim + 2 * lane, acc);
    __syncwarp();  // qw and pw are rewritten for the warp's next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_valid, const void* keep,
                   float keep_prob, void* out, int Nk, int H, int Tq, int Tk, int group, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)Tk * (kDecStride + kHeadDim) + (size_t)kDecWarps * (kHeadDim + kDecMaxLen)) *
                      sizeof(float) + Tk;
  cudaError_t err = cudaFuncSetAttribute(decoder_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decoder_attention_kernel<T><<<Nk * H, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<T*>(out), H, Tq, Tk, group, causal, scale);
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. q/out (Nk * group, H, Tq, 64); k/v (Nk, H,
// Tk, 64); key_valid (Nk, Tk) bool or null (every key valid); keep (Nk * group,
// H, Tq, Tk) bool or null (no dropout) with keep_prob (rounded to the compute
// dtype by the caller); causal: query position i attends keys j <= i.
extern "C" int sct_decoder_attention(int dtype, const void* q, const void* k, const void* v, const void* key_valid,
                                     const void* keep, float keep_prob, void* out, int Nk, int H, int Tq, int Tk,
                                     int group, int causal, float scale, void* stream) {
  if (Nk < 1 || H < 1 || Tq < 1 || Tk < 1 || Tk > sct::kDecMaxLen || group < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)sct::launch<float>(q, k, v, key_valid, keep, keep_prob, out, Nk, H, Tq, Tk, group, causal, scale, s);
  }
  if (dtype == 1) {
    return (int)sct::launch<__nv_bfloat16>(q, k, v, key_valid, keep, keep_prob, out, Nk, H, Tq, Tk, group, causal,
                                           scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
