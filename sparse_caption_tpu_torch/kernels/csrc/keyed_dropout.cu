// K8: keyed dropout, the keep-mask of a dropout site drawn as a pure function
// of (key, site, t, row, column).
//
// Replaces: sparse_caption_tpu/models/layers.py:31-68 TimeDropout, whose step
// mode draws `bernoulli(fold_in(site_key, t), keep, (N, 1, D))` and whose
// replay mode redraws the masks of all t in one pass (vmap over fold_in).
// Left to XLA on the TPU (threefry bits + compare, fused into the consumer).
//
// The bits: Philox4x32-10 keyed by the 64-bit step key (k0 = low word), with
// counter (site, t, row, column / 4); word j of the output is column
// 4 * (column / 4) + j, kept where (bits >> 8) * 2^-24 < keep_prob. A tensor
// (N, T, D) drawn from position t0 gives row n, position j the draw at
// t = t0 + j, so a step draw (T = 1, t0 = t) and the replay draw (t0 = 0)
// agree bit for bit at every (t, row, column).
//
// Two entry points: the bool keep-mask (consumed by K6 and K1's train
// variant) and the apply variant out = keep ? x / divisor : 0 (the PE and
// FFN sites, and its own backward on the gradient), divisor = keep_prob
// rounded to x's dtype and an IEEE division, as the JAX package's
// `x / keep` (the plain version divides by a 0-dim tensor on both devices).
//
// Bound on the H100: bytes. The mask writes one byte per element (the replay
// of the FFN site, 75 x 17 x 2048: 2.6 MB, 0.8 us at 3.35 TB/s); the apply
// variant reads and writes x. The Philox rounds are ~20 integer operations
// per 4 elements, far below the card's integer rate. Design: one thread per
// 4 consecutive columns, so one Philox call serves four outputs.
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace sct {

constexpr int kDropThreads = 256;

template <typename T, bool kApply>
__global__ void __launch_bounds__(kDropThreads)
keyed_dropout_kernel(const T* __restrict__ x, T* __restrict__ out, unsigned char* __restrict__ keep_out,
                     uint32_t k0, uint32_t k1, uint32_t site, int t0, int N, int Tl, int D, float keep_prob,
                     float divisor) {
  const int c4n = (D + 3) / 4;
  const long long total = (long long)N * Tl * c4n;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < total;
       g += (long long)gridDim.x * blockDim.x) {
    const int c4 = (int)(g % c4n);
    const long long nt = g / c4n;  // n * Tl + j
    const int j = (int)(nt % Tl), n = (int)(nt / Tl);
    const Philox4 r = philox4x32_10(Philox4{site, (uint32_t)(t0 + j), (uint32_t)n, (uint32_t)c4}, k0, k1);
    const long long base = nt * D + 4LL * c4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * c4 + q >= D) break;
      const bool keep = keep_bit(philox_word(r, q), keep_prob);
      if (kApply) {
        out[base + q] = keep ? from_f<T>(to_f(x[base + q]) / divisor) : from_f<T>(0.f);
      } else {
        keep_out[base + q] = keep ? 1 : 0;
      }
    }
  }
}

inline int grid_for(long long groups) {
  const long long blocks = (groups + kDropThreads - 1) / kDropThreads;
  return (int)(blocks < 132LL * 16 ? blocks : 132LL * 16);
}

}  // namespace sct

// keep (N, Tl, D) bool, row n position j drawn at t0 + j.
extern "C" int sct_keyed_keep_mask(uint32_t k0, uint32_t k1, uint32_t site, int t0, int N, int Tl, int D,
                                   float keep_prob, void* keep, void* stream) {
  if (N <= 0 || Tl <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long groups = (long long)N * Tl * ((D + 3) / 4);
  sct::keyed_dropout_kernel<float, false><<<sct::grid_for(groups), sct::kDropThreads, 0,
                                            static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, static_cast<unsigned char*>(keep), k0, k1, site, t0, N, Tl, D, keep_prob, 0.f);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. x, out (N, Tl, D): out = keep ? x / divisor : 0.
extern "C" int sct_keyed_dropout_apply(int dtype, const void* x, void* out, uint32_t k0, uint32_t k1, uint32_t site,
                                       int t0, int N, int Tl, int D, float keep_prob, float divisor, void* stream) {
  if (N <= 0 || Tl <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long groups = (long long)N * Tl * ((D + 3) / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sct::keyed_dropout_kernel<float, true><<<sct::grid_for(groups), sct::kDropThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), nullptr, k0, k1, site, t0, N, Tl, D, keep_prob,
        divisor);
  } else if (dtype == 1) {
    sct::keyed_dropout_kernel<__nv_bfloat16, true><<<sct::grid_for(groups), sct::kDropThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), nullptr, k0, k1, site, t0, N, Tl,
        D, keep_prob, divisor);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
