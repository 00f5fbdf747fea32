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
// Bound on the H100: bytes. The forward reads x once and writes y; the
// backward reads dy and x and writes dx (21,760 rows x 10,000 of the XE
// step: 20 bytes per element in f32, 10 in bf16, 14 bf16 -> f32; 0.65-1.30
// ms at 3.35 TB/s). The exp and log are a few operations per byte, far below
// the card's rate.
//
// Design: the held path (V a multiple of the 16-byte vector of Tin, aligned
// rows, V <= 1024 threads x 32 values) runs one block per row, sized to the row (320
// threads at V = 10,000), each thread holding 32 values of the row in
// registers, loaded as 16-byte vectors, consecutive threads on consecutive
// vectors. The forward reads x once: a block max over the held values, one
// expf per element (no online rescale) and a block sum (`held_row_stats`,
// row_softmax.cuh, which K4 shares), then y from the held values. The backward holds dy in registers and sums it while each
// thread's part of the x row streams into shared memory with cp.async, then
// writes dx from the two. Block reductions run in a fixed order (warp
// shuffle tree, then the warps in order), so a run repeats bit for bit.
// Other rows (V not a multiple of the vector, unaligned rows such as bf16
// with odd V, or rows too long to hold) take the general path: 256 threads
// per row, scalar loads, an online max / sum over the row in chunks of 256
// elements, then a second pass that rereads the row.
#include "row_softmax.cuh"

namespace sct {

constexpr int kLsmThreads = 256;       // general path
constexpr int kLsmWarps = kLsmThreads / 32;
constexpr int kLsmMaxThreads = 1024;   // held path

// ------------------------------------------------------------ held path
// one row per block; thread t holds the 16-byte vectors t, t + nt, ... (PER of them)
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kLsmMaxThreads)
log_softmax_fwd_held_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, float* __restrict__ stats, int V) {
  constexpr int UE = 16 / sizeof(Tin);
  constexpr int PER = kRowHeld / UE;
  __shared__ float red[2][32];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int units = V / UE;
  const size_t base = (size_t)blockIdx.x * V;
  uint4 raw[PER];  // kept packed: the whole row's loads in flight at once
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int u = k * nt + tid;
    raw[k] = u < units ? ld16(x + base + (size_t)u * UE) : make_uint4(0u, 0u, 0u, 0u);
  }
  float m, logsum, mine;
  held_row_stats<Tin, PER>(raw, units, red[0], red[1], m, logsum, mine);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int u = k * nt + tid;
    if (u < units) {
      float v[UE];
      unpack16<Tin>(raw[k], v);
#pragma unroll
      for (int i = 0; i < UE; ++i) v[i] = (v[i] - m) - logsum;
      store_n<UE>(y + base + (size_t)u * UE, v);
    }
  }
  if (tid == 0) reinterpret_cast<float2*>(stats)[blockIdx.x] = make_float2(m, logsum);
}

// dynamic shared memory: the x row, thread t's vectors at (k nt + t) x 16 bytes
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kLsmMaxThreads)
log_softmax_bwd_held_kernel(const Tout* __restrict__ dy, const Tin* __restrict__ x, const float* __restrict__ stats,
                            Tin* __restrict__ dx, int V) {
  constexpr int UE = 16 / sizeof(Tin);
  constexpr int PER = kRowHeld / UE;
  extern __shared__ __align__(16) unsigned char xs[];
  __shared__ float red[32];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int units = V / UE;
  const size_t base = (size_t)blockIdx.x * V;
#pragma unroll
  for (int k = 0; k < PER; ++k) {  // x streams into shared memory while dy is summed
    const int u = k * nt + tid;
    if (u < units) cp_async<16>(xs + (size_t)u * 16, x + base + (size_t)u * UE);
  }
  cp_async_commit();
  float g[PER][UE];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int u = k * nt + tid;
    if (u < units) {
      load_n<UE>(dy + base + (size_t)u * UE, g[k]);
    } else {
#pragma unroll
      for (int i = 0; i < UE; ++i) g[k][i] = 0.f;
    }
  }
  float tloc = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {  // sum(dy)
#pragma unroll
    for (int i = 0; i < UE; ++i) tloc += g[k][i];
  }
  const float total = block_sum(tloc, red);
  const float2 st = reinterpret_cast<const float2*>(stats)[blockIdx.x];
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int u = k * nt + tid;
    if (u < units) {
      float xv[UE];
      unpack16<Tin>(ld16(xs + (size_t)u * 16), xv);
#pragma unroll
      for (int i = 0; i < UE; ++i) xv[i] = g[k][i] - expf((xv[i] - st.x) - st.y) * total;
      store_n<UE>(dx + base + (size_t)u * UE, xv);
    }
  }
}

// ------------------------------------------------------------ general path
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
  for (int i = threadIdx.x; i < V; i += kLsmThreads) {  // pass 1: online max / sum
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

// ------------------------------------------------------------ launch
// threads of the held path for rows of V elements (0: the row does not fit
// or is not vector-aligned); `a` is x (16 bytes), `b` the Tout tensor
template <typename Tin, typename Tout>
int held_threads(int V, const void* a, const void* b, const void* c) {
  constexpr int UE = 16 / sizeof(Tin);  // a held row is whole vectors of UE elements
  constexpr int out_bytes = UE * sizeof(Tout) < 16 ? UE * sizeof(Tout) : 16;
  if (!aligned_to(a, 16) || !aligned_to(c, 16) || !aligned_to(b, out_bytes)) return 0;
  return held_row_threads<Tin>(V, kLsmMaxThreads);
}

template <typename Tin, typename Tout>
cudaError_t launch_fwd(const void* x, void* y, void* stats, int rows, int V, cudaStream_t st) {
  const int threads = held_threads<Tin, Tout>(V, x, y, nullptr);
  if (threads > 0) {
    log_softmax_fwd_held_kernel<Tin, Tout><<<rows, threads, 0, st>>>(static_cast<const Tin*>(x),
                                                                     static_cast<Tout*>(y),
                                                                     static_cast<float*>(stats), V);
  } else {
    log_softmax_fwd_kernel<Tin, Tout><<<rows, kLsmThreads, 0, st>>>(static_cast<const Tin*>(x),
                                                                    static_cast<Tout*>(y),
                                                                    static_cast<float*>(stats), V);
  }
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_bwd(const void* dy, const void* x, const void* stats, void* dx, int rows, int V, cudaStream_t st) {
  const int threads = held_threads<Tin, Tout>(V, x, dy, dx);
  if (threads > 0) {
    constexpr int UE = 16 / sizeof(Tin);
    const size_t smem = (size_t)(kRowHeld / UE) * threads * 16;
    auto kernel = log_softmax_bwd_held_kernel<Tin, Tout>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<rows, threads, smem, st>>>(static_cast<const Tout*>(dy), static_cast<const Tin*>(x),
                                        static_cast<const float*>(stats), static_cast<Tin*>(dx), V);
  } else {
    log_softmax_bwd_kernel<Tin, Tout><<<rows, kLsmThreads, 0, st>>>(
        static_cast<const Tout*>(dy), static_cast<const Tin*>(x), static_cast<const float*>(stats),
        static_cast<Tin*>(dx), V);
  }
  return cudaGetLastError();
}

}  // namespace sct

// dtype codes: 0 = float32, 1 = bfloat16, for x (in) and y (out). x, y (rows, V)
// row-major; stats (rows, 2) f32 receives each row's max and log sum.
extern "C" int sct_vocab_log_softmax(int in_dtype, int out_dtype, const void* x, void* y, void* stats, int rows, int V,
                                     void* stream) {
  if (rows < 0 || V < 1 || !sct::aligned_to(stats, 8)) return (int)cudaErrorInvalidValue;
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
  if (rows < 0 || V < 1 || !sct::aligned_to(stats, 8)) return (int)cudaErrorInvalidValue;
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
