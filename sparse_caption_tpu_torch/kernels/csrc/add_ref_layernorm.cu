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
// Bound on the H100: bytes. Each element is read and written once or twice
// and takes a few dozen operations (bf16 with the keep-mask: 9 bytes per
// element forward, 11 backward; 21,760 x 512 rows of the ORT XE step move
// 223 MB, 0.067 ms at 3.35 TB/s). The only gain is to keep more bytes in
// flight and to read each byte from memory once.
//
// Design: for rows 16-byte aligned, d a multiple of the 16-byte vector,
// - Forward: G = 8, 16 or 32 lanes per row (16 for bf16 at d = 512), each
//   lane issuing all of its 16-byte loads of x, y and the keep flags before
//   any arithmetic and holding s packed in T (half the registers of f32), so
//   that at most 64 registers a thread give 4 blocks of 16 rows per SM: the
//   serving decode step's 10,240 rows need 1.2 waves of 8,448 resident rows.
//   Two group reductions (shuffles within the G lanes) give the stats.
// - Backward: a persistent grid sized by the occupancy calculator to fill
//   every SM, one warp per row walking rows with a grid stride. Each lane
//   copies its own 16-byte vectors of gn, gs, s and the keep flags of the
//   NEXT row into a two-stage ring in shared memory with cp.async while the
//   current row is reduced; a lane reads back only what it copied, so the
//   wait is per thread and no barrier is needed. da, db accumulate per lane
//   in registers; at the end the block's warps are folded in a fixed order
//   into one partial per block, and a second kernel sums each column's
//   partials with 8 warps over interleaved blocks, folded in a fixed order:
//   no float atomics, so a run repeats bit for bit.
// Other rows (d not a multiple of the vector, or an unaligned base pointer)
// take a scalar path of the same kernels' arithmetic: one warp per row,
// element c on lane c % 32.
#include <initializer_list>

#include "common.cuh"
#include "vec.cuh"

namespace sct {

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kNormMaxBlocksPerSm = 2048 / kNormThreads;
constexpr int kNormMaxCols = 1024;
constexpr int kNormStages = 2;

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ vector path
// G lanes per row; lane g of a row holds vectors g, g + G, ... (NV of them)
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kNormThreads, NV <= 4 ? 4 : 2)
add_norm_fwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ y, const unsigned char* __restrict__ keep,
                        const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ s_out,
                        T* __restrict__ n_out, float* __restrict__ stats, int rows, int d, float keep_prob,
                        float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lg = threadIdx.x % G;
  const int row = blockIdx.x * (kNormThreads / G) + threadIdx.x / G;
  const bool live = row < rows;  // every lane takes part in the shuffles
  const int dv = d / VEC;
  const size_t base = (size_t)(live ? row : 0) * d;
  uint4 sv[NV], yv[NV];
  uint2 kv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {  // every load of the row in flight before any arithmetic
    const int j = lg + G * k;
    sv[k] = yv[k] = make_uint4(0u, 0u, 0u, 0u);
    kv[k] = make_uint2(0u, 0u);
    if (live && j < dv) {
      sv[k] = ld16(x + base + j * VEC);
      if (y != nullptr) yv[k] = ld16(y + base + j * VEC);
      if (keep != nullptr) kv[k] = ld_flags<VEC>(keep + base + j * VEC);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float v[VEC];
    unpack16<T>(sv[k], v);
    if (y != nullptr) {
      float yy[VEC];
      unpack16<T>(yv[k], yy);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float t = yy[i];
        if (keep != nullptr) t = flag(kv[k], i) ? round_to<T>(t / keep_prob) : 0.f;
        v[i] = round_to<T>(v[i] + t);
      }
      sv[k] = pack16<T>(v);  // exact: v is rounded to T
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum += v[i];  // absent vectors are zeros
  }
  const float mean = group_sum<G>(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lg + G * k < dv) {
      float v[VEC];
      unpack16<T>(sv[k], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sq += (v[i] - mean) * (v[i] - mean);
    }
  }
  const float stdv = sqrtf(group_sum<G>(sq) / (d > 1 ? d - 1 : 1));
  const float den = stdv + eps;
  if (!live) return;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lg + G * k;
    if (j < dv) {
      if (y != nullptr) st16(s_out + base + j * VEC, sv[k]);
      float v[VEC], av[VEC], bv[VEC];
      unpack16<T>(sv[k], v);
      unpack16<T>(ld16(a + j * VEC), av);
      unpack16<T>(ld16(b + j * VEC), bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = (av[i] * (v[i] - mean)) / den + bv[i];
      st16(n_out + base + j * VEC, pack16<T>(v));
    }
  }
  if (stats != nullptr && lg == 0) reinterpret_cast<float2*>(stats)[row] = make_float2(mean, stdv);
}

// bytes of one warp's ring stage: gn, gs, s (NV x 32 lanes x 16 bytes each), keep (NV x 32 x VEC)
template <typename T, int NV>
__host__ __device__ constexpr int bwd_stage_bytes() {
  return NV * 32 * (3 * 16 + 16 / (int)sizeof(T));
}

template <typename T, int NV>
size_t bwd_vec_smem(int d) {
  const size_t ring = (size_t)kNormWarps * kNormStages * bwd_stage_bytes<T, NV>();
  const size_t fold = (size_t)kNormWarps * 2 * d * sizeof(float);
  return ring > fold ? ring : fold;
}

// one warp per row, lane l holding vectors l, l + 32, ... (NV of them)
template <typename T, int NV>
__global__ void __launch_bounds__(kNormThreads, 2)
add_norm_bwd_vec_kernel(const T* __restrict__ gn, const T* __restrict__ gs, const T* __restrict__ s,
                        const unsigned char* __restrict__ keep, const T* __restrict__ a,
                        const float* __restrict__ stats, T* __restrict__ dx, T* __restrict__ dy,
                        float* __restrict__ partial, int rows, int d, float keep_prob, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kStage = bwd_stage_bytes<T, NV>();
  constexpr int kTensor = NV * 32 * 16;  // one tensor's part of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int dv = d / VEC;
  unsigned char* ring = smem + warp * kNormStages * kStage + lane * 16;
  unsigned char* kring = smem + warp * kNormStages * kStage + 3 * kTensor + lane * VEC;
  const float2* stat2 = reinterpret_cast<const float2*>(stats);

  // copy row `r`'s vectors of this lane into ring stage `st` (no wait)
  auto issue = [&](int r, int st) {
    const size_t base = (size_t)r * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + 32 * k;
      if (j < dv) {
        unsigned char* slot = ring + st * kStage + k * 32 * 16;
        cp_async<16>(slot, gn + base + j * VEC);
        if (gs != nullptr) cp_async<16>(slot + kTensor, gs + base + j * VEC);
        cp_async<16>(slot + 2 * kTensor, s + base + j * VEC);
        if (keep != nullptr) cp_async<VEC>(kring + st * kStage + k * 32 * VEC, keep + base + j * VEC);
      }
    }
  };

  float av[NV][VEC], acc_a[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lane + 32 * k;
    if (j < dv) {
      unpack16<T>(ld16(a + j * VEC), av[k]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) av[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc_a[k][i] = acc_b[k][i] = 0.f;
  }
  const int nw = gridDim.x * kNormWarps;
  int row = blockIdx.x * kNormWarps + warp;
  float2 st_next = make_float2(0.f, 0.f);
  if (row < rows) {
    issue(row, 0);
    st_next = stat2[row];
  }
  cp_async_commit();
  for (int it = 0; row < rows; row += nw, ++it) {
    const int st = it & 1;
    const float2 stat = st_next;
    if (row + nw < rows) {  // the next row's copies fly while this one is reduced
      issue(row + nw, st ^ 1);
      st_next = stat2[row + nw];
    }
    cp_async_commit();  // possibly empty: the wait below then still covers this row's group
    cp_async_wait<1>();
    const unsigned char* slot = ring + st * kStage;
    const float mean = stat.x, stdv = stat.y;
    const float den = stdv + eps;
    float cv[NV][VEC], h[NV][VEC];
    float gt = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < dv) {
        float g[VEC], sv[VEC];
        unpack16<T>(ld16(slot + k * 32 * 16), g);
        unpack16<T>(ld16(slot + 2 * kTensor + k * 32 * 16), sv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gd = g[i] / den;  // d(a c)
          cv[k][i] = sv[i] - mean;
          h[k][i] = gd * av[k][i];
          acc_a[k][i] += gd * cv[k][i];
          acc_b[k][i] += g[i];
          gt += g[i] * (av[k][i] * cv[k][i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) cv[k][i] = h[k][i] = 0.f;
      }
    }
    // d std = d den = -sum(g a c) / den^2; then d c += d std * c / ((d - 1) std)
    const float dstd = -warp_sum(gt) / (den * den);
    const float coef = stdv > 0.f ? dstd / ((d > 1 ? d - 1 : 1) * stdv) : 0.f;
    float dsum = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        h[k][i] += coef * cv[k][i];
        dsum += h[k][i];  // absent vectors are zeros
      }
    }
    const float dmean = warp_sum(dsum) / d;
    const size_t base = (size_t)row * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + 32 * k;
      if (j < dv) {
        float ds[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) ds[i] = round_to<T>(h[k][i] - dmean);
        if (gs != nullptr) {
          float g2[VEC];
          unpack16<T>(ld16(slot + kTensor + k * 32 * 16), g2);
#pragma unroll
          for (int i = 0; i < VEC; ++i) ds[i] = round_to<T>(ds[i] + g2[i]);
        }
        st16(dx + base + j * VEC, pack16<T>(ds));
        if (dy != nullptr) {
          if (keep != nullptr) {
            const uint2 kw = ld_flags<VEC>(kring + st * kStage + k * 32 * VEC);
#pragma unroll
            for (int i = 0; i < VEC; ++i) ds[i] = flag(kw, i) ? round_to<T>(ds[i] / keep_prob) : 0.f;
          }
          st16(dy + base + j * VEC, pack16<T>(ds));
        }
      }
    }
  }
  // fold the block's warps in order: each warp's (da, db) row into shared
  // memory (over the ring, now idle), then one sum per column
  cp_async_wait<0>();
  __syncthreads();
  float* fold = reinterpret_cast<float*>(smem);  // (kNormWarps, 2, d)
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lane + 32 * k;
    if (j < dv) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        fold[(size_t)warp * 2 * d + j * VEC + i] = acc_a[k][i];
        fold[(size_t)warp * 2 * d + d + j * VEC + i] = acc_b[k][i];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += kNormThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kNormWarps; ++w) t += fold[(size_t)w * 2 * d + c];
    partial[(size_t)blockIdx.x * 2 * d + c] = t;
  }
}

// ------------------------------------------------------------ scalar path
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

// ------------------------------------------------------------ da, db
// column c of the (nblocks, 2d) partials: warp w of the block adds blocks
// w, w + 8, ... in order, then the 8 warp sums are added in order
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
add_norm_colsum_kernel(const float* __restrict__ partial, int nblocks, int d, T* __restrict__ da,
                       T* __restrict__ db) {
  __shared__ float part[kNormWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < 2 * d) {
#pragma unroll 4
    for (int p = warp; p < nblocks; p += kNormWarps) acc += partial[(size_t)p * 2 * d + c];
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < 2 * d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kNormWarps; ++w) t += part[w][lane];
    if (c < d) da[c] = from_f<T>(t);
    else db[c - d] = from_f<T>(t);
  }
}

// ------------------------------------------------------------ launch
// blocks that fill every SM (at most one per 8 rows), from the occupancy calculator
template <typename K>
int fill_blocks(K kernel, size_t smem, int rows) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kNormThreads, smem);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > kNormMaxBlocksPerSm) per_sm = kNormMaxBlocksPerSm;
  const int want = (rows + kNormWarps - 1) / kNormWarps;
  const int cap = sm_count() * per_sm;
  return want < 1 ? 1 : (want < cap ? want : cap);
}

template <typename T>
bool vec_ok(int d, std::initializer_list<const void*> ptrs, const void* keep) {
  constexpr int VEC = 16 / sizeof(T);
  if (d % VEC != 0 || !aligned_to(keep, VEC)) return false;
  for (const void* p : ptrs) {
    if (!aligned_to(p, 16)) return false;
  }
  return true;
}

template <typename T, int G, int NV>
cudaError_t launch_fwd_vec(const void* x, const void* y, const void* keep, const void* a, const void* b, void* s_out,
                           void* n_out, void* stats, int rows, int d, float keep_prob, float eps, cudaStream_t st) {
  constexpr int rows_per_block = kNormThreads / G;
  add_norm_fwd_vec_kernel<T, G, NV><<<(rows + rows_per_block - 1) / rows_per_block, kNormThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const unsigned char*>(keep),
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(s_out), static_cast<T*>(n_out),
      static_cast<float*>(stats), rows, d, keep_prob, eps);
  return cudaGetLastError();
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

template <typename T>
cudaError_t dispatch_fwd(const void* x, const void* y, const void* keep, const void* a, const void* b, void* s_out,
                         void* n_out, void* stats, int rows, int d, float keep_prob, float eps, cudaStream_t st) {
#define SCT_FWD(fn) fn(x, y, keep, a, b, s_out, n_out, stats, rows, d, keep_prob, eps, st)
  if (vec_ok<T>(d, {x, y, a, b, s_out, n_out}, keep)) {
    const int dv = d / (16 / (int)sizeof(T));
    if (dv <= 32) return SCT_FWD((launch_fwd_vec<T, 8, 4>));
    if (dv <= 64) return SCT_FWD((launch_fwd_vec<T, 16, 4>));
    if (dv <= 128) return SCT_FWD((launch_fwd_vec<T, 32, 4>));
    return SCT_FWD((launch_fwd_vec<T, 32, 8>));
  }
  if (d <= 32) return SCT_FWD((launch_fwd<T, 1>));
  if (d <= 64) return SCT_FWD((launch_fwd<T, 2>));
  if (d <= 128) return SCT_FWD((launch_fwd<T, 4>));
  if (d <= 256) return SCT_FWD((launch_fwd<T, 8>));
  if (d <= 512) return SCT_FWD((launch_fwd<T, 16>));
  return SCT_FWD((launch_fwd<T, 32>));
#undef SCT_FWD
}

template <typename T>
cudaError_t launch_colsum(const void* partial, int nblocks, int d, void* da, void* db, cudaStream_t st) {
  add_norm_colsum_kernel<T><<<(2 * d + 31) / 32, kNormThreads, 0, st>>>(static_cast<const float*>(partial), nblocks,
                                                                         d, static_cast<T*>(da), static_cast<T*>(db));
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t launch_bwd_vec(const void* gn, const void* gs, const void* s, const void* keep, const void* a,
                           const void* stats, void* dx, void* dy, void* da, void* db, void* partial, int rows, int d,
                           float keep_prob, float eps, cudaStream_t st) {
  auto kernel = add_norm_bwd_vec_kernel<T, NV>;
  const size_t smem = bwd_vec_smem<T, NV>(d);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nblocks = fill_blocks(kernel, smem, rows);
  kernel<<<nblocks, kNormThreads, smem, st>>>(
      static_cast<const T*>(gn), static_cast<const T*>(gs), static_cast<const T*>(s),
      static_cast<const unsigned char*>(keep), static_cast<const T*>(a), static_cast<const float*>(stats),
      static_cast<T*>(dx), static_cast<T*>(dy), static_cast<float*>(partial), rows, d, keep_prob, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum<T>(partial, nblocks, d, da, db, st);
}

template <typename T, int PL>
cudaError_t launch_bwd(const void* gn, const void* gs, const void* s, const void* keep, const void* a,
                       const void* stats, void* dx, void* dy, void* da, void* db, void* partial, int rows, int d,
                       float keep_prob, float eps, cudaStream_t st) {
  auto kernel = add_norm_bwd_kernel<T, PL>;
  const int nblocks = fill_blocks(kernel, 0, rows);
  kernel<<<nblocks, kNormThreads, 0, st>>>(
      static_cast<const T*>(gn), static_cast<const T*>(gs), static_cast<const T*>(s),
      static_cast<const unsigned char*>(keep), static_cast<const T*>(a), static_cast<const float*>(stats),
      static_cast<T*>(dx), static_cast<T*>(dy), static_cast<float*>(partial), rows, d, keep_prob, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum<T>(partial, nblocks, d, da, db, st);
}

template <typename T>
cudaError_t dispatch_bwd(const void* gn, const void* gs, const void* s, const void* keep, const void* a,
                         const void* stats, void* dx, void* dy, void* da, void* db, void* partial, int rows, int d,
                         float keep_prob, float eps, cudaStream_t st) {
#define SCT_BWD(fn) fn(gn, gs, s, keep, a, stats, dx, dy, da, db, partial, rows, d, keep_prob, eps, st)
  if (vec_ok<T>(d, {gn, gs, s, a, dx, dy}, keep)) {
    const int dv = d / (16 / (int)sizeof(T));
    if (dv <= 64) return SCT_BWD((launch_bwd_vec<T, 2>));
    if (dv <= 128) return SCT_BWD((launch_bwd_vec<T, 4>));
    return SCT_BWD((launch_bwd_vec<T, 8>));
  }
  if (d <= 32) return SCT_BWD((launch_bwd<T, 1>));
  if (d <= 64) return SCT_BWD((launch_bwd<T, 2>));
  if (d <= 128) return SCT_BWD((launch_bwd<T, 4>));
  if (d <= 256) return SCT_BWD((launch_bwd<T, 8>));
  if (d <= 512) return SCT_BWD((launch_bwd<T, 16>));
  return SCT_BWD((launch_bwd<T, 32>));
#undef SCT_BWD
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16 for x, y, a, b, s_out, n_out. rows x d row-major.
// y, keep (uint8, rows x d), s_out and stats (rows x 2 f32: mean, std) may be null.
extern "C" int sct_add_ref_layernorm(int dtype, const void* x, const void* y, const void* keep, const void* a,
                                     const void* b, void* s_out, void* n_out, void* stats, int rows, int d,
                                     float keep_prob, float eps, void* stream) {
  if (rows < 0 || d < 1 || d > sct::kNormMaxCols || (y != nullptr) != (s_out != nullptr) ||
      !sct::aligned_to(stats, 8)) {
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

// At most this many per-block partials for `rows` rows (the backward fills
// every SM, at most 8 blocks each): the caller allocates partial as (blocks, 2, d) f32.
extern "C" int sct_add_ref_layernorm_bwd_blocks(int rows) {
  const int want = (rows + sct::kNormWarps - 1) / sct::kNormWarps;
  const int cap = sct::sm_count() * sct::kNormMaxBlocksPerSm;
  return want < 1 ? 1 : (want < cap ? want : cap);
}

// gn (the norm output's gradient) required; gs (the sum's gradient), keep and
// dy may be null. dx, dy, da, db in the compute dtype.
extern "C" int sct_add_ref_layernorm_bwd(int dtype, const void* gn, const void* gs, const void* s, const void* keep,
                                         const void* a, const void* stats, void* dx, void* dy, void* da, void* db,
                                         void* partial, int rows, int d, float keep_prob, float eps, void* stream) {
  if (rows < 0 || d < 1 || d > sct::kNormMaxCols || !sct::aligned_to(stats, 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)sct::dispatch_bwd<float>(gn, gs, s, keep, a, stats, dx, dy, da, db, partial, rows, d, keep_prob, eps,
                                         st);
  }
  if (dtype == 1) {
    return (int)sct::dispatch_bwd<__nv_bfloat16>(gn, gs, s, keep, a, stats, dx, dy, da, db, partial, rows, d,
                                                 keep_prob, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
