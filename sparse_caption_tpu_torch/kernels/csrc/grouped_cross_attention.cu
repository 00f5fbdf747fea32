// K3: one decode step of cross-attention where the beam rows of an image share
// that image's projected memory K/V (one row per image, never repeated).
//
// Replaces: sparse_caption_tpu/models/layers.py:236-264
// MultiHeadAttention.decode_cross, grouped branch (left to XLA on the TPU).
//
// For image b, head h and each of its `rep` query rows n = b*rep + r:
//   out[n,h] = softmax(fill(q[n,h] . mem_k[b,h,s] / sqrt(dk), mask[b,s], -1e9)) . mem_v[b,h]
// mem_v == mem_k when the layer shares K and V (mem_v=None in the reference).
//
// Bound on the H100 (beam 5, 8 heads, dk 64, 36 regions): bytes. The memory
// K and V are read once per image: 151 MB of bf16 at B = 2048 (0.045 ms at
// 3.35 TB/s), plus 21 MB of q and out.
//
// Design: one block per (image, head). The block stages the image's 36 x 64
// K and V tiles in shared memory once and its warps serve all `rep` beam rows
// from there (common.cuh warp_attend_row), so the memory rows are read from
// device memory once per image and not once per beam.
#include "common.cuh"

namespace sct {

constexpr int kCrossThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kCrossThreads)
grouped_cross_attention_kernel(const T* __restrict__ q, const T* __restrict__ mem_k, const T* __restrict__ mem_v,
                               const unsigned char* __restrict__ mask, T* __restrict__ out, int H, int S, int rep,
                               float scale) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* k_s = smem;                        // S * kKeyStride
  float* v_s = k_s + S * kKeyStride;        // S * kValStride
  float* q_s = v_s + S * kValStride;        // nwarps * 64
  float* p_s = q_s + nwarps * kHeadDim;     // nwarps * 64
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(p_s + nwarps * kHeadDim);  // S

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t base = ((size_t)b * H + h) * S * kHeadDim;
  load_tile(k_s, mem_k + base, S, kKeyStride);
  load_tile(v_s, mem_v + base, S, kValStride);
  for (int e = threadIdx.x; e < S; e += blockDim.x) mask_s[e] = mask[(size_t)b * S + e];
  __syncthreads();

  float* qw = q_s + warp * kHeadDim;
  for (int r = warp; r < rep; r += nwarps) {
    const size_t qo = ((size_t)(b * rep + r) * H + h) * kHeadDim;
    const float2 qv = load2(q + qo + 2 * lane);
    qw[2 * lane] = qv.x;
    qw[2 * lane + 1] = qv.y;
    __syncwarp();
    warp_attend_row<T>(qw, k_s, v_s, mask_s, nullptr, S, scale, p_s + warp * kHeadDim, out + qo);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* mk, const void* mv, const void* mask, void* out, int B, int H, int S,
                   int rep, float scale, cudaStream_t stream) {
  const int nwarps = kCrossThreads / 32;
  const size_t smem = ((size_t)S * (kKeyStride + kValStride) + 2 * (size_t)nwarps * kHeadDim) * sizeof(float) + S;
  grouped_cross_attention_kernel<T><<<B * H, kCrossThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(mk), static_cast<const T*>(mv),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), H, S, rep, scale);
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. q/out (B * rep, H, 64); mem_k/mem_v (B, H, S, 64)
// (pass mem_k twice for shared K/V); mask (B, S) bool.
extern "C" int sct_grouped_cross_attention(int dtype, const void* q, const void* mem_k, const void* mem_v,
                                           const void* mask, void* out, int B, int H, int S, int rep,
                                           float scale, void* stream) {
  if (H < 1 || S < 1 || S > 64 || rep < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)sct::launch<float>(q, mem_k, mem_v, mask, out, B, H, S, rep, scale, s);
  if (dtype == 1) return (int)sct::launch<__nv_bfloat16>(q, mem_k, mem_v, mask, out, B, H, S, rep, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
