// K11: the LSTM cell's gate nonlinearities, forward and backward.
//
// Replaces: sparse_caption_tpu/models/up_down.py:47-54 MaskedLSTMCell after
// its two dots (left to XLA's fusions on the TPU). The dots x.W_ih^T + b_ih
// and h.W_hh^T + b_hh stay GEMMs; this kernel takes their outputs gx, gh (N,
// 4H) and the cell state c (N, H), in torch gate order (i, f, g, o):
//   gates = gx + gh
//   c'    = sigmoid(f) c + sigmoid(i) tanh(g)
//   h'    = sigmoid(o) tanh(c')
// in f32, rounded to T at each point where the JAX package's compute dtype
// rounds (every elementwise op; a no-op for f32). The backward takes dh', dc'
// (either may be absent) and recomputes every gate from gx, gh and c, so no
// activation is stored beyond the forward's inputs. It rounds where autograd
// of the plain version rounds in T: each product's gradient, the sum of the
// two gradients of c', and PyTorch's sigmoid and tanh backward, which
// compute in T op by op (sigmoid: round(round(g round(1 - s)) s); tanh:
// round(g round(1 - round(y y)))):
//   g_o~  = round(dh' tanh(c')),  g_tc = round(dh' sigmoid(o))
//   dc    = round(dc' + tanh_bwd(g_tc, tanh(c')))
//   d i   = sigmoid_bwd(round(dc tanh(g)), sigmoid(i))
//   d f   = sigmoid_bwd(round(dc c), sigmoid(f))
//   d g   = tanh_bwd(round(dc sigmoid(i)), tanh(g))
//   d o   = sigmoid_bwd(g_o~, sigmoid(o))
//   d c_prev = round(dc sigmoid(f));  d gx = d gh = d gates
//
// Bound on the H100: bytes. The forward reads gx, gh and c and writes h', c'
// (Up-Down serving at 1024 x 5 beams, H = 1000, bf16: 102 MB, 0.03 ms); the
// backward reads gx, gh, c, dh', dc' and writes d gates and d c_prev. A few
// transcendentals per element are far below the card's rate.
//
// Design: one thread per (row, unit), the four gates of a unit read from
// the four H-wide column blocks (each coalesced across the warp), a
// grid-stride loop over rows x H.
#include "common.cuh"

namespace sct {

constexpr int kCellThreads = 256;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// the gates of unit j of row n, recomputed and rounded as the forward rounds them
template <typename T>
struct Gates {
  float si, sf, tg, so, c_new, tc;
  __device__ __forceinline__ Gates(const T* gx, const T* gh, const T* c, long long n, int j, int H) {
    const long long g0 = n * 4 * H + j;
    const float gi = round_to<T>(to_f(gx[g0]) + to_f(gh[g0]));
    const float gf = round_to<T>(to_f(gx[g0 + H]) + to_f(gh[g0 + H]));
    const float gg = round_to<T>(to_f(gx[g0 + 2 * H]) + to_f(gh[g0 + 2 * H]));
    const float go = round_to<T>(to_f(gx[g0 + 3 * H]) + to_f(gh[g0 + 3 * H]));
    si = round_to<T>(sigmoid_f(gi));
    sf = round_to<T>(sigmoid_f(gf));
    tg = round_to<T>(tanhf(gg));
    so = round_to<T>(sigmoid_f(go));
    c_new = round_to<T>(round_to<T>(sf * to_f(c[n * H + j])) + round_to<T>(si * tg));
    tc = round_to<T>(tanhf(c_new));
  }
};

template <typename T>
__global__ void __launch_bounds__(kCellThreads)
lstm_cell_fwd_kernel(const T* __restrict__ gx, const T* __restrict__ gh, const T* __restrict__ c,
                     T* __restrict__ h_out, T* __restrict__ c_out, int N, int H) {
  const long long total = (long long)N * H;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long n = e / H;
    const int j = (int)(e % H);
    const Gates<T> g(gx, gh, c, n, j, H);
    c_out[e] = from_f<T>(g.c_new);
    h_out[e] = from_f<T>(g.so * g.tc);
  }
}

// PyTorch's sigmoid_backward and tanh_backward, op by op in T
template <typename T>
__device__ __forceinline__ float sigmoid_bwd(float g, float s) {
  return round_to<T>(round_to<T>(g * round_to<T>(1.f - s)) * s);
}
template <typename T>
__device__ __forceinline__ float tanh_bwd(float g, float y) {
  return round_to<T>(g * round_to<T>(1.f - round_to<T>(y * y)));
}

template <typename T>
__global__ void __launch_bounds__(kCellThreads)
lstm_cell_bwd_kernel(const T* __restrict__ gx, const T* __restrict__ gh, const T* __restrict__ c,
                     const T* __restrict__ dh, const T* __restrict__ dc_next, T* __restrict__ dgates,
                     T* __restrict__ dc_prev, int N, int H) {
  const long long total = (long long)N * H;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long n = e / H;
    const int j = (int)(e % H);
    const Gates<T> g(gx, gh, c, n, j, H);
    const float dhv = dh != nullptr ? to_f(dh[e]) : 0.f;
    const float dcv = dc_next != nullptr ? to_f(dc_next[e]) : 0.f;
    const float dc = round_to<T>(dcv + tanh_bwd<T>(round_to<T>(dhv * g.so), g.tc));
    const long long g0 = n * 4 * H + j;
    dgates[g0] = from_f<T>(sigmoid_bwd<T>(round_to<T>(dc * g.tg), g.si));
    dgates[g0 + H] = from_f<T>(sigmoid_bwd<T>(round_to<T>(dc * to_f(c[e])), g.sf));
    dgates[g0 + 2 * H] = from_f<T>(tanh_bwd<T>(round_to<T>(dc * g.si), g.tg));
    dgates[g0 + 3 * H] = from_f<T>(sigmoid_bwd<T>(round_to<T>(dhv * g.tc), g.so));
    dc_prev[e] = from_f<T>(dc * g.sf);
  }
}

inline int cell_grid(long long elements) {
  const long long blocks = (elements + kCellThreads - 1) / kCellThreads;
  return (int)(blocks < 132LL * 16 ? blocks : 132LL * 16);
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. gx, gh (N, 4H); c, h_out, c_out (N, H); row-major.
extern "C" int sct_lstm_cell(int dtype, const void* gx, const void* gh, const void* c, void* h_out, void* c_out, int N,
                             int H, void* stream) {
  if (N < 0 || H < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = sct::cell_grid((long long)N * H);
  if (dtype == 0) {
    sct::lstm_cell_fwd_kernel<float><<<grid, sct::kCellThreads, 0, st>>>(
        static_cast<const float*>(gx), static_cast<const float*>(gh), static_cast<const float*>(c),
        static_cast<float*>(h_out), static_cast<float*>(c_out), N, H);
  } else if (dtype == 1) {
    sct::lstm_cell_fwd_kernel<__nv_bfloat16><<<grid, sct::kCellThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gx), static_cast<const __nv_bfloat16*>(gh),
        static_cast<const __nv_bfloat16*>(c), static_cast<__nv_bfloat16*>(h_out), static_cast<__nv_bfloat16*>(c_out),
        N, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dh, dc_next (N, H) may be null (no gradient); dgates (N, 4H), dc_prev (N, H) written.
extern "C" int sct_lstm_cell_bwd(int dtype, const void* gx, const void* gh, const void* c, const void* dh,
                                 const void* dc_next, void* dgates, void* dc_prev, int N, int H, void* stream) {
  if (N < 0 || H < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = sct::cell_grid((long long)N * H);
  if (dtype == 0) {
    sct::lstm_cell_bwd_kernel<float><<<grid, sct::kCellThreads, 0, st>>>(
        static_cast<const float*>(gx), static_cast<const float*>(gh), static_cast<const float*>(c),
        static_cast<const float*>(dh), static_cast<const float*>(dc_next), static_cast<float*>(dgates),
        static_cast<float*>(dc_prev), N, H);
  } else if (dtype == 1) {
    sct::lstm_cell_bwd_kernel<__nv_bfloat16><<<grid, sct::kCellThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gx), static_cast<const __nv_bfloat16*>(gh),
        static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(dh),
        static_cast<const __nv_bfloat16*>(dc_next), static_cast<__nv_bfloat16*>(dgates),
        static_cast<__nv_bfloat16*>(dc_prev), N, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
