// K6: residual add (with the sublayer's dropout) + RefLayerNorm, forward and backward.
//
// Replaces: sparse_caption_tpu/models/layers.py:71-92 RefLayerNorm and
// :135-143 SublayerConnection (left to XLA's fusions on the TPU; the LN+FFN
// Pallas kernel was deleted). The pre-norm stack fuses sublayer i's residual
// add with the norm of sublayer i+1 (or the stack's final norm).
//
// Computes, row by row over the last dimension d,
//   forward   y'   = keep ? y / keep_prob : 0   (keep given; else y' = y; the
//                  wrapper passes keep_prob rounded to T, as the JAX package divides)
//             s    = x + y'                     (rounded to T; y absent: s = x)
//             n    = (a (s - mean)) / (std + eps) + b,  std Bessel-corrected (d - 1)
//   with the stats in f32 and n rounded to T; mean and std are saved per row.
//   backward  dn -> ds_norm (f32, rounded to T), then ds = ds_norm + gs (in T),
//             dx = ds, dy = keep ? ds / keep_prob : 0, and da, db summed over rows.
//
// Bound on the H100: bytes. Forward reads x, y, keep, writes s, n (21,760 rows
// x 512 at batch 256 x 5 x 17, f32: 178 MB, 0.053 ms at 3.35 TB/s); the
// backward reads gn, gs, s, keep and writes dx, dy. At batch 15 both are
// launch-bound (a few hundred rows).
//
// Design: one warp per row, each lane holding d/32 elements in registers
// (d <= 1024), two warp reductions for the stats. The backward
// accumulates da/db per warp in registers over a grid-stride loop of rows,
// folds the warps of a block in a fixed order through shared memory, writes
// one partial per block, and a second kernel sums the partials per column in
// block order: no float atomics, so a run repeats bit for bit.
#include "common.cuh"

namespace sct {

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kNormMaxBlocks = 264;
constexpr int kNormMaxCols = 1024;

template <typename T, int PL>
__global__ void __launch_bounds__(kNormThreads)
add_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y, const unsigned char* __restrict__ keep,
                    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ s_out, T* __restrict__ n_out,
                    float* __restrict__ stats, int rows, int d, float keep_prob, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNormWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
  float v[PL];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    const int c = lane + 32 * k;
    float s = 0.f;
    if (c < d) {
      s = to_f(x[base + c]);
      if (y != nullptr) {
        float yy = to_f(y[base + c]);
        if (keep != nullptr) yy = keep[base + c] ? round_to<T>(yy / keep_prob) : 0.f;
        s = round_to<T>(s + yy);
        s_out[base + c] = from_f<T>(s);
      }
    }
    v[k] = s;
    sum += s;
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    if (lane + 32 * k < d) sq += (v[k] - mean) * (v[k] - mean);
  }
  const float stdv = sqrtf(warp_sum(sq) / (d > 1 ? d - 1 : 1));
  const float den = stdv + eps;
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    const int c = lane + 32 * k;
    if (c < d) n_out[base + c] = from_f<T>((to_f(a[c]) * (v[k] - mean)) / den + to_f(b[c]));
  }
  if (stats != nullptr && lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = stdv;
  }
}

template <typename T, int PL>
__global__ void __launch_bounds__(kNormThreads)
add_norm_bwd_kernel(const T* __restrict__ gn, const T* __restrict__ gs, const T* __restrict__ s,
                    const unsigned char* __restrict__ keep, const T* __restrict__ a, const float* __restrict__ stats,
                    T* __restrict__ dx, T* __restrict__ dy, float* __restrict__ partial, int rows, int d,
                    float keep_prob, float eps) {
  __shared__ float fold[2 * kNormMaxCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  float acc_a[PL], acc_b[PL], av[PL];
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    const int c = lane + 32 * k;
    acc_a[k] = acc_b[k] = 0.f;
    av[k] = c < d ? to_f(a[c]) : 0.f;
  }
  const int nwarps_total = gridDim.x * kNormWarps;
  for (int row = blockIdx.x * kNormWarps + warp; row < rows; row += nwarps_total) {
    const size_t base = (size_t)row * d;
    const float mean = stats[2 * row], stdv = stats[2 * row + 1];
    const float den = stdv + eps;
    float cv[PL], h[PL];
    float gt = 0.f;
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      const int c = lane + 32 * k;
      cv[k] = h[k] = 0.f;
      if (c < d) {
        const float g = to_f(gn[base + c]);
        const float gd = g / den;  // d(a c)
        cv[k] = to_f(s[base + c]) - mean;
        h[k] = gd * av[k];
        acc_a[k] += gd * cv[k];
        acc_b[k] += g;
        gt += g * (av[k] * cv[k]);
      }
    }
    // d std = d den = -sum(g a c) / den^2; then d c += d std * c / ((d - 1) std)
    const float dstd = -warp_sum(gt) / (den * den);
    const float coef = stdv > 0.f ? dstd / ((d > 1 ? d - 1 : 1) * stdv) : 0.f;
    float dsum = 0.f;
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      h[k] += coef * cv[k];
      if (lane + 32 * k < d) dsum += h[k];
    }
    const float dmean = warp_sum(dsum) / d;
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      const int c = lane + 32 * k;
      if (c < d) {
        float ds = round_to<T>(h[k] - dmean);
        if (gs != nullptr) ds = round_to<T>(ds + to_f(gs[base + c]));
        dx[base + c] = from_f<T>(ds);
        if (dy != nullptr) {
          float yy = ds;
          if (keep != nullptr) yy = keep[base + c] ? round_to<T>(ds / keep_prob) : 0.f;
          dy[base + c] = from_f<T>(yy);
        }
      }
    }
  }
  // fold the block's warps in order: warp 0 writes, warps 1.. add
  for (int w = 0; w < kNormWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < PL; ++k) {
        const int c = lane + 32 * k;
        if (c < d) {
          fold[c] = (w == 0 ? 0.f : fold[c]) + acc_a[k];
          fold[d + c] = (w == 0 ? 0.f : fold[d + c]) + acc_b[k];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) partial[(size_t)blockIdx.x * 2 * d + c] = fold[c];
}

// da, db: column sums of the per-block partials, in block order
template <typename T>
__global__ void add_norm_reduce_kernel(const float* __restrict__ partial, int nblocks, int d, T* __restrict__ da,
                                       T* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * d) return;
  float acc = 0.f;
  for (int blk = 0; blk < nblocks; ++blk) acc += partial[(size_t)blk * 2 * d + c];
  if (c < d) da[c] = from_f<T>(acc);
  else db[c - d] = from_f<T>(acc);
}

template <typename T, int PL>
cudaError_t launch_fwd(const void* x, const void* y, const void* keep, const void* a, const void* b, void* s_out,
                       void* n_out, void* stats, int rows, int d, float keep_prob, float eps, cudaStream_t st) {
  const int blocks = (rows + kNormWarps - 1) / kNormWarps;
  add_norm_fwd_kernel<T, PL><<<blocks, kNormThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const unsigned char*>(keep),
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(s_out), static_cast<T*>(n_out),
      static_cast<float*>(stats), rows, d, keep_prob, eps);
  return cudaGetLastError();
}

template <typename T, int PL>
cudaError_t launch_bwd(const void* gn, const void* gs, const void* s, const void* keep, const void* a,
                       const void* stats, void* dx, void* dy, void* da, void* db, void* partial, int nblocks, int rows,
                       int d, float keep_prob, float eps, cudaStream_t st) {
  add_norm_bwd_kernel<T, PL><<<nblocks, kNormThreads, 0, st>>>(
      static_cast<const T*>(gn), static_cast<const T*>(gs), static_cast<const T*>(s),
      static_cast<const unsigned char*>(keep), static_cast<const T*>(a), static_cast<const float*>(stats),
      static_cast<T*>(dx), static_cast<T*>(dy), static_cast<float*>(partial), rows, d, keep_prob, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_norm_reduce_kernel<T><<<(2 * d + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial), nblocks, d,
                                                                static_cast<T*>(da), static_cast<T*>(db));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const void* x, const void* y, const void* keep, const void* a, const void* b, void* s_out,
                         void* n_out, void* stats, int rows, int d, float keep_prob, float eps, cudaStream_t st) {
  if (d <= 32) return launch_fwd<T, 1>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
  if (d <= 64) return launch_fwd<T, 2>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
  if (d <= 128) return launch_fwd<T, 4>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
  if (d <= 256) return launch_fwd<T, 8>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
  if (d <= 512) return launch_fwd<T, 16>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
  return launch_fwd<T, 32>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
}

template <typename T>
cudaError_t dispatch_bwd(const void* gn, const void* gs, const void* s, const void* keep, const void* a,
                         const void* stats, void* dx, void* dy, void* da, void* db, void* partial, int nblocks,
                         int rows, int d, float keep_prob, float eps, cudaStream_t st) {
#define SCT_BWD(PL) launch_bwd<T, PL>(gn, gs, s, keep, a, stats, dx, dy, da, db, partial, nblocks, rows, d, \
                                      keep_prob, eps, st)
  if (d <= 32) return SCT_BWD(1);
  if (d <= 64) return SCT_BWD(2);
  if (d <= 128) return SCT_BWD(4);
  if (d <= 256) return SCT_BWD(8);
  if (d <= 512) return SCT_BWD(16);
  return SCT_BWD(32);
#undef SCT_BWD
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16 for x, y, a, b, s_out, n_out. rows x d row-major.
// y, keep (uint8, rows x d), s_out and stats (rows x 2 f32: mean, std) may be null.
extern "C" int sct_add_ref_layernorm(int dtype, const void* x, const void* y, const void* keep, const void* a,
                                     const void* b, void* s_out, void* n_out, void* stats, int rows, int d,
                                     float keep_prob, float eps, void* stream) {
  if (rows < 0 || d < 1 || d > sct::kNormMaxCols || (y != nullptr) != (s_out != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)sct::dispatch_fwd<float>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
  if (dtype == 1) {
    return (int)sct::dispatch_fwd<__nv_bfloat16>(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Number of per-block partials the backward writes for `rows` rows: the
// caller allocates partial as (blocks, 2, d) f32.
extern "C" int sct_add_ref_layernorm_bwd_blocks(int rows) {
  const int want = (rows + sct::kNormWarps - 1) / sct::kNormWarps;
  return want < 1 ? 1 : (want < sct::kNormMaxBlocks ? want : sct::kNormMaxBlocks);
}

// gn (the norm output's gradient) required; gs (the sum's gradient), keep and
// dy may be null. dx, dy, da, db in the compute dtype.
extern "C" int sct_add_ref_layernorm_bwd(int dtype, const void* gn, const void* gs, const void* s, const void* keep,
                                         const void* a, const void* stats, void* dx, void* dy, void* da, void* db,
                                         void* partial, int rows, int d, float keep_prob, float eps, void* stream) {
  if (rows < 0 || d < 1 || d > sct::kNormMaxCols) return (int)cudaErrorInvalidValue;
  const int nblocks = sct_add_ref_layernorm_bwd_blocks(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)sct::dispatch_bwd<float>(gn, gs, s, keep, a, stats, dx, dy, da, db, partial, nblocks, rows, d,
                                         keep_prob, eps, st);
  }
  if (dtype == 1) {
    return (int)sct::dispatch_bwd<__nv_bfloat16>(gn, gs, s, keep, a, stats, dx, dy, da, db, partial, nblocks, rows,
                                                 d, keep_prob, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
