// K13: row-wise log-softmax over the vocabulary, forward and backward.
//
// Replaces: sparse_caption_tpu/models/up_down.py:124 (`jax.nn.log_softmax` of
// the Up-Down logits, in the compute dtype) and
// sparse_caption_tpu/models/layers.py:465-472 (the Generator's log_softmax,
// f32 in training), wherever the log-probs themselves are needed: the XE
// step, the SCST replay and teacher-forced eval. The beam and sampling steps
// fuse their own (K4, K9). Left to XLA on the TPU.
//
// For each row of x (rows, V) in Tin, with f32 arithmetic throughout:
//   forward   y  = Tout((x - max) - log(sum exp(x - max)))   (rounded as torch.log_softmax)
//             stats[row] = (max, log sum)
//   backward  dx = Tin(dy - exp((x - max) - log sum) * sum(dy))
// The backward recomputes the softmax from x and the row's two stats, so a
// bf16 output costs the gradient no precision.
//
// Bound on the H100: bytes. The forward reads x once and writes y (Up-Down XE
// at 256 x 5 captions x 17 steps: 21,760 rows x 10,000, bf16 in and out, 870
// MB, 0.26 ms at 3.35 TB/s); the backward reads dy and x and writes dx. The
// exp and log are a few operations per byte, far below the card's rate.
//
// Design: one block of 256 threads per row. Forward pass 1 keeps an online
// max / sum per thread and merges the block's in a fixed order; pass 2
// rereads the row (at most 40 KB, from L1/L2) and writes y. Backward pass 1
// sums dy over the block in a fixed order; pass 2 rereads dy and x.
#include "common.cuh"

namespace sct {

constexpr int kLsmThreads = 256;
constexpr int kLsmWarps = kLsmThreads / 32;

// the row's (max, sum exp(x - max)) from each thread's partial pair, in every thread
__device__ __forceinline__ void block_max_sum(float& m, float& s, float* red_m, float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o), os = __shfl_xor_sync(0xffffffffu, s, o);
    merge_max_sum(m, s, om, os);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  m = -INFINITY;
  s = 0.f;
  for (int w = 0; w < kLsmWarps; ++w) merge_max_sum(m, s, red_m[w], red_s[w]);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kLsmThreads)
log_softmax_fwd_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, float* __restrict__ stats, int V) {
  __shared__ float red_m[kLsmWarps];
  __shared__ float red_s[kLsmWarps];
  const size_t base = (size_t)blockIdx.x * V;
  float m = -INFINITY, s = 0.f;
  for (int i = threadIdx.x; i < V; i += kLsmThreads) {
    const float xi = to_f(x[base + i]);
    if (xi > m) {
      s = s * expf(m - xi) + 1.f;
      m = xi;
    } else {
      s += expf(xi - m);
    }
  }
  block_max_sum(m, s, red_m, red_s);
  const float logsum = logf(s);
  for (int i = threadIdx.x; i < V; i += kLsmThreads) y[base + i] = from_f<Tout>((to_f(x[base + i]) - m) - logsum);
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = m;
    stats[2 * blockIdx.x + 1] = logsum;
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kLsmThreads)
log_softmax_bwd_kernel(const Tout* __restrict__ dy, const Tin* __restrict__ x, const float* __restrict__ stats,
                       Tin* __restrict__ dx, int V) {
  __shared__ float red[kLsmWarps];
  const size_t base = (size_t)blockIdx.x * V;
  float acc = 0.f;
  for (int i = threadIdx.x; i < V; i += kLsmThreads) acc += to_f(dy[base + i]);
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = acc;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kLsmWarps; ++w) total += red[w];
  const float m = stats[2 * blockIdx.x], logsum = stats[2 * blockIdx.x + 1];
  for (int i = threadIdx.x; i < V; i += kLsmThreads) {
    const float p = expf((to_f(x[base + i]) - m) - logsum);
    dx[base + i] = from_f<Tin>(to_f(dy[base + i]) - p * total);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_fwd(const void* x, void* y, void* stats, int rows, int V, cudaStream_t st) {
  log_softmax_fwd_kernel<Tin, Tout><<<rows, kLsmThreads, 0, st>>>(static_cast<const Tin*>(x), static_cast<Tout*>(y),
                                                                  static_cast<float*>(stats), V);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_bwd(const void* dy, const void* x, const void* stats, void* dx, int rows, int V, cudaStream_t st) {
  log_softmax_bwd_kernel<Tin, Tout><<<rows, kLsmThreads, 0, st>>>(
      static_cast<const Tout*>(dy), static_cast<const Tin*>(x), static_cast<const float*>(stats),
      static_cast<Tin*>(dx), V);
  return cudaGetLastError();
}

}  // namespace sct

// dtype codes: 0 = float32, 1 = bfloat16, for x (in) and y (out). x, y (rows, V)
// row-major; stats (rows, 2) f32 receives each row's max and log sum.
extern "C" int sct_vocab_log_softmax(int in_dtype, int out_dtype, const void* x, void* y, void* stats, int rows, int V,
                                     void* stream) {
  if (rows < 0 || V < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return (int)sct::launch_fwd<float, float>(x, y, stats, rows, V, st);
  if (in_dtype == 1 && out_dtype == 1) {
    return (int)sct::launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, y, stats, rows, V, st);
  }
  if (in_dtype == 1 && out_dtype == 0) return (int)sct::launch_fwd<__nv_bfloat16, float>(x, y, stats, rows, V, st);
  if (in_dtype == 0 && out_dtype == 1) return (int)sct::launch_fwd<float, __nv_bfloat16>(x, y, stats, rows, V, st);
  return (int)cudaErrorInvalidValue;
}

// dy (rows, V) in the forward's out dtype; x, dx in its in dtype; stats as the forward wrote them.
extern "C" int sct_vocab_log_softmax_bwd(int in_dtype, int out_dtype, const void* dy, const void* x, const void* stats,
                                         void* dx, int rows, int V, void* stream) {
  if (rows < 0 || V < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return (int)sct::launch_bwd<float, float>(dy, x, stats, dx, rows, V, st);
  if (in_dtype == 1 && out_dtype == 1) {
    return (int)sct::launch_bwd<__nv_bfloat16, __nv_bfloat16>(dy, x, stats, dx, rows, V, st);
  }
  if (in_dtype == 1 && out_dtype == 0) return (int)sct::launch_bwd<__nv_bfloat16, float>(dy, x, stats, dx, rows, V, st);
  if (in_dtype == 0 && out_dtype == 1) return (int)sct::launch_bwd<float, __nv_bfloat16>(dy, x, stats, dx, rows, V, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
