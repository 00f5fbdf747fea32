// K5: supermask weight sample with its straight-through backward.
//
// Replaces: sparse_caption_tpu/ops/masked.py:70-82 _Prunable._masked and
// ops/ste.py:51-64 bernoulli_sample_sigmoid / rounding_sigmoid (left to XLA's
// fusions on the TPU; the fused supermask matmul Pallas kernel was deleted).
//
// Computes, element by element over one masked weight tensor,
//   forward   s     = [u < sigmoid(m)]   (mode 0, train: a Bernoulli draw)
//                   = [0.5 < sigmoid(m)] (mode 1, eval: round(sigmoid(m)))
//                   = m                  (mode 2, a 0/1 mask of another type)
//             w_eff = w * s, written in w's dtype (exact: s is 0 or 1)
//   backward  dw    = g * s                                  (w's dtype)
//             dm    = (g * w) * sigmoid(m) (1 - sigmoid(m))   (f32; mode 0/1)
//                   = g * w                (bypass_sigmoid_grad, or mode 2)
// s is recomputed from (u, m) in the backward, never stored. sigmoid is
// 1 / (1 + expf(-m)), the expression PyTorch's CUDA sigmoid evaluates, so the
// sample equals the plain version's bit for bit.
//
// Bound on the H100: bytes. At paper width 105 tensors carry 55.3M masked
// weights; the forward reads w, m, u and writes w_eff (16 B per weight in
// f32: 0.89 GB, 0.26 ms at 3.35 TB/s), the backward reads g, w, m, u and
// writes dw, dm (24 B: 1.33 GB, 0.40 ms). A few flops per byte.
//
// Design: one launch per tensor, a grid-stride loop of one element per
// thread and step (coalesced, no shared memory). The GEMMs that consume
// w_eff stay in cuBLAS (F.linear), as the JAX package leaves them to XLA.
#include "common.cuh"

namespace sct {

constexpr int kMaskThreads = 256;

__device__ __forceinline__ float mask_sample(int mode, float m, const float* __restrict__ u, size_t i, float& p) {
  p = 1.f / (1.f + expf(-m));
  if (mode == 0) return u[i] < p ? 1.f : 0.f;
  if (mode == 1) return 0.5f < p ? 1.f : 0.f;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kMaskThreads)
supermask_fwd_kernel(const T* __restrict__ w, const float* __restrict__ m, const float* __restrict__ u,
                     T* __restrict__ out, size_t n, int mode) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    float p;
    const float s = mask_sample(mode, m[i], u, i, p);
    out[i] = from_f<T>(to_f(w[i]) * s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaskThreads)
supermask_bwd_kernel(const T* __restrict__ g, const T* __restrict__ w, const float* __restrict__ m,
                     const float* __restrict__ u, T* __restrict__ dw, float* __restrict__ dm, size_t n, int mode,
                     int bypass) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    float p;
    const float s = mask_sample(mode, m[i], u, i, p);
    const float gi = to_f(g[i]);
    const float gw = gi * to_f(w[i]);
    dw[i] = from_f<T>(gi * s);
    dm[i] = (bypass || mode == 2) ? gw : gw * (p * (1.f - p));
  }
}

inline int mask_blocks(size_t n) {
  const size_t want = (n + kMaskThreads - 1) / kMaskThreads;
  return (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16 (w, out). m and u f32, u may be null
// unless mode == 0. Shapes are n elements each.
extern "C" int sct_supermask(int dtype, const void* w, const void* m, const void* u, void* out, long long n,
                             int mode, void* stream) {
  if (n < 0 || mode < 0 || mode > 2 || (mode == 0 && u == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = sct::mask_blocks((size_t)n);
  const float* mf = static_cast<const float*>(m);
  const float* uf = static_cast<const float*>(u);
  if (dtype == 0) {
    sct::supermask_fwd_kernel<float><<<blocks, sct::kMaskThreads, 0, s>>>(
        static_cast<const float*>(w), mf, uf, static_cast<float*>(out), (size_t)n, mode);
  } else if (dtype == 1) {
    sct::supermask_fwd_kernel<__nv_bfloat16><<<blocks, sct::kMaskThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), mf, uf, static_cast<__nv_bfloat16*>(out), (size_t)n, mode);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g, w, dw in the compute dtype; m, u, dm f32.
extern "C" int sct_supermask_bwd(int dtype, const void* g, const void* w, const void* m, const void* u, void* dw,
                                 void* dm, long long n, int mode, int bypass, void* stream) {
  if (n < 0 || mode < 0 || mode > 2 || (mode == 0 && u == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = sct::mask_blocks((size_t)n);
  const float* mf = static_cast<const float*>(m);
  const float* uf = static_cast<const float*>(u);
  if (dtype == 0) {
    sct::supermask_bwd_kernel<float><<<blocks, sct::kMaskThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(w), mf, uf, static_cast<float*>(dw),
        static_cast<float*>(dm), (size_t)n, mode, bypass);
  } else if (dtype == 1) {
    sct::supermask_bwd_kernel<__nv_bfloat16><<<blocks, sct::kMaskThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(w), mf, uf,
        static_cast<__nv_bfloat16*>(dw), static_cast<float*>(dm), (size_t)n, mode, bypass);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
