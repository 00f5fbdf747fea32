// K12: Up-Down's additive (tanh) attention with masked renormalisation,
// forward and backward.
//
// Replaces: sparse_caption_tpu/models/up_down.py:67-73 AdditiveAttention after
// its h2att dot (left to XLA's fusions on the TPU). For image b, its `rows`
// query rows n (beams or captions; row b * rows + n of att_h) and its R
// regions:
//   s[n, r]  = w . tanh(p_att[b, r] + att_h[n]) + bias           (A-wide dot)
//   p[n]     = softmax over ALL R of s[n]
//   q[n, r]  = p[n, r] mask[b, r];  weight = q / max(sum_r q, 1e-9)
//   out[n]   = sum_r weight[n, r] att[b, r]                      (D wide)
// so an image with every region padded gives zeros. f32 arithmetic, rounded
// to T where the JAX package's compute dtype rounds (the add, tanh, score,
// probabilities, the sum and the weights; no-ops for f32). The forward also
// writes p and weight (N, R) f32 for the backward:
//   g[n, r]  = dout[n] . att[b, r];  d att[b, r] = sum_n weight[n, r] dout[n]
//   dq       = g / Z' - [Z > 1e-9] (g . q) / Z'^2,  Z' = max(Z, 1e-9)
//   ds       = p (mask dq - p . (mask dq))
//   d p_att[b, r, a] = w_a sum_n ds[n, r] (1 - t^2),  d att_h[n, a] = w_a sum_r ds[n, r] (1 - t^2)
//   d w_a    = sum_{n, r} ds[n, r] t,  d bias = sum_{n, r} ds[n, r]   (t = tanh(p_att + att_h), recomputed)
// d w and d bias are per-block partials, summed over blocks in a fixed order
// by a second kernel: no float atomics.
//
// Bound on the H100: bytes. Each image's p_att (R x A) and att (R x D) are
// read once for all its rows (serving at 1024 images x 5 beams, R = 36, A =
// 512, D = 1000, bf16: 113 MB with att_h and out, 0.03 ms); the rows x R x A
// tanh (94M at that shape) are ~0.1 ms of the f32 units' rate, so the two
// are of one size.
//
// Design: one block of 256 threads per image and chunk of at most 16 of its
// rows (one chunk for beams and XE captions; 4 for SCST's 60 samples).
// Scores: one warp per (row, region) pair, lanes over A, p_att[b] re-read
// from L1 for each row; softmax and renormalisation: one warp per row (R <=
// 64: two regions per lane); the weighted sum: one thread per output column,
// each att element read once for all rows of the chunk. The backward walks
// the same layout, thread per column a of p_att in its last phase so the
// chunk's rows and regions are summed in registers. With more than one chunk
// per image, the chunks' d p_att and d att go to f32 partials that a last
// kernel sums over the image's chunks in order and rounds once.
#include "common.cuh"

namespace sct {

constexpr int kAttThreads = 256;
constexpr int kAttWarps = kAttThreads / 32;
constexpr int kAttMaxRegions = 64;
constexpr int kAttMaxRows = 16;
constexpr float kRenormFloor = 1e-9f;  // up_down.py:72

template <typename T>
__global__ void __launch_bounds__(kAttThreads)
additive_attention_fwd_kernel(const T* __restrict__ p_att, const T* __restrict__ att_h, const T* __restrict__ w,
                              const T* __restrict__ bias, const unsigned char* __restrict__ mask,
                              const T* __restrict__ att, T* __restrict__ out, float* __restrict__ prob_out,
                              float* __restrict__ weight_out, int img_rows, int chunks, int R, int A, int D) {
  __shared__ float s_w[kAttMaxRows * kAttMaxRegions];  // scores, then weights
  const int b = blockIdx.x / chunks, lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int first = (blockIdx.x - b * chunks) * kAttMaxRows, rows = min(kAttMaxRows, img_rows - first);
  const long long row0 = (long long)b * img_rows + first;

  for (int pair = warp; pair < rows * R; pair += kAttWarps) {
    const int n = pair / R, r = pair % R;
    const T* ah = att_h + (row0 + n) * A;
    const T* pa = p_att + ((long long)b * R + r) * A;
    float acc = 0.f;
    for (int a = lane; a < A; a += 32) {
      const float t = round_to<T>(tanhf(round_to<T>(to_f(pa[a]) + to_f(ah[a]))));
      acc = fmaf(t, to_f(w[a]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) s_w[n * R + r] = round_to<T>(acc + to_f(bias[0]));  // one rounding, as F.linear's
  }
  __syncthreads();

  for (int n = warp; n < rows; n += kAttWarps) {
    const bool in0 = lane < R, in1 = lane + 32 < R;
    const float v0 = in0 ? s_w[n * R + lane] : -INFINITY, v1 = in1 ? s_w[n * R + lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = in0 ? expf(v0 - m) : 0.f, e1 = in1 ? expf(v1 - m) : 0.f;
    const float sum = warp_sum(e0 + e1);
    const float p0 = round_to<T>(e0 / sum), p1 = round_to<T>(e1 / sum);
    const float q0 = in0 && mask[(long long)b * R + lane] ? p0 : 0.f;
    const float q1 = in1 && mask[(long long)b * R + lane + 32] ? p1 : 0.f;
    const float z = fmaxf(round_to<T>(warp_sum(q0 + q1)), kRenormFloor);
    const float w0 = round_to<T>(q0 / z), w1 = round_to<T>(q1 / z);
    __syncwarp();
    const long long o = (row0 + n) * R;
    if (in0) {
      s_w[n * R + lane] = w0;
      if (prob_out != nullptr) {
        prob_out[o + lane] = p0;
        weight_out[o + lane] = w0;
      }
    }
    if (in1) {
      s_w[n * R + lane + 32] = w1;
      if (prob_out != nullptr) {
        prob_out[o + lane + 32] = p1;
        weight_out[o + lane + 32] = w1;
      }
    }
  }
  __syncthreads();

  const T* at = att + (long long)b * R * D;
  for (int d = threadIdx.x; d < D; d += kAttThreads) {
    for (int n0 = 0; n0 < rows; n0 += 8) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int r = 0; r < R; ++r) {
        const float av = to_f(at[(long long)r * D + d]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + j < rows) acc[j] = fmaf(s_w[(n0 + j) * R + r], av, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (n0 + j < rows) out[(row0 + n0 + j) * D + d] = from_f<T>(acc[j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAttThreads)
additive_attention_bwd_kernel(const T* __restrict__ p_att, const T* __restrict__ att_h, const T* __restrict__ w,
                              const unsigned char* __restrict__ mask, const T* __restrict__ att,
                              const float* __restrict__ prob, const float* __restrict__ weight,
                              const T* __restrict__ dout, T* __restrict__ d_p_att, T* __restrict__ d_att_h,
                              T* __restrict__ d_att, float* __restrict__ partial_w, float* __restrict__ partial_b,
                              float* __restrict__ part_p_att, float* __restrict__ part_att, int img_rows, int chunks,
                              int R, int A, int D) {
  __shared__ float g_s[kAttMaxRows * kAttMaxRegions];  // d weight, then d score
  __shared__ float w_s[kAttMaxRows * kAttMaxRegions];  // the forward's weights
  __shared__ float row_db[kAttMaxRows];
  const int b = blockIdx.x / chunks, lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int first = (blockIdx.x - b * chunks) * kAttMaxRows, rows = min(kAttMaxRows, img_rows - first);
  const long long row0 = (long long)b * img_rows + first;
  // d p_att / d att: the compute dtype directly (one chunk), else this chunk's f32 partial
  const long long part = (long long)blockIdx.x * R;
  const T* at = att + (long long)b * R * D;
  for (int e = threadIdx.x; e < rows * R; e += kAttThreads) w_s[e] = weight[row0 * R + e];

  // g[n, r] = dout[n] . att[b, r]
  for (int pair = warp; pair < rows * R; pair += kAttWarps) {
    const int n = pair / R, r = pair % R;
    const T* dv = dout + (row0 + n) * D;
    const T* ar = at + (long long)r * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f(dv[d]), to_f(ar[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) g_s[n * R + r] = acc;
  }
  __syncthreads();

  // d att[b, r, d] = sum_n weight[n, r] dout[n, d]
  for (int d = threadIdx.x; d < D; d += kAttThreads) {
    float dv[kAttMaxRows];
#pragma unroll
    for (int n = 0; n < kAttMaxRows; ++n) dv[n] = n < rows ? to_f(dout[(row0 + n) * D + d]) : 0.f;
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kAttMaxRows; ++n) {
        if (n < rows) acc = fmaf(w_s[n * R + r], dv[n], acc);
      }
      if (part_att == nullptr) d_att[((long long)b * R + r) * D + d] = from_f<T>(acc);
      else part_att[(part + r) * D + d] = acc;
    }
  }

  // d score, one warp per row
  for (int n = warp; n < rows; n += kAttWarps) {
    const bool in0 = lane < R, in1 = lane + 32 < R;
    const long long o = (row0 + n) * R;
    const float p0 = in0 ? prob[o + lane] : 0.f, p1 = in1 ? prob[o + lane + 32] : 0.f;
    const float m0 = in0 && mask[(long long)b * R + lane] ? 1.f : 0.f;
    const float m1 = in1 && mask[(long long)b * R + lane + 32] ? 1.f : 0.f;
    const float g0 = in0 ? g_s[n * R + lane] : 0.f, g1 = in1 ? g_s[n * R + lane + 32] : 0.f;
    const float q0 = m0 * p0, q1 = m1 * p1;
    const float z = round_to<T>(warp_sum(q0 + q1));
    const float zc = fmaxf(z, kRenormFloor);
    const float dz = z > kRenormFloor ? -warp_sum(g0 * q0 + g1 * q1) / (zc * zc) : 0.f;
    const float dp0 = m0 * (g0 / zc + dz), dp1 = m1 * (g1 / zc + dz);
    const float pdp = warp_sum(p0 * dp0 + p1 * dp1);
    const float ds0 = p0 * (dp0 - pdp), ds1 = p1 * (dp1 - pdp);
    __syncwarp();
    if (in0) g_s[n * R + lane] = ds0;
    if (in1) g_s[n * R + lane + 32] = ds1;
    const float row_sum = warp_sum(ds0 + ds1);
    if (lane == 0) row_db[n] = row_sum;
  }
  __syncthreads();

  // d p_att, d att_h and the image's d w partial, one thread per column a
  for (int a = threadIdx.x; a < A; a += kAttThreads) {
    const float wa = to_f(w[a]);
    float ah[kAttMaxRows], dah[kAttMaxRows];
#pragma unroll
    for (int n = 0; n < kAttMaxRows; ++n) {
      ah[n] = n < rows ? to_f(att_h[(row0 + n) * A + a]) : 0.f;
      dah[n] = 0.f;
    }
    float dw = 0.f;
    for (int r = 0; r < R; ++r) {
      const float pa = to_f(p_att[((long long)b * R + r) * A + a]);
      float dpa = 0.f;
#pragma unroll
      for (int n = 0; n < kAttMaxRows; ++n) {
        if (n < rows) {
          const float t = round_to<T>(tanhf(round_to<T>(pa + ah[n])));
          const float ds = g_s[n * R + r];
          dw = fmaf(ds, t, dw);
          const float e = ds * wa * (1.f - t * t);
          dpa += e;
          dah[n] += e;
        }
      }
      if (part_p_att == nullptr) d_p_att[((long long)b * R + r) * A + a] = from_f<T>(dpa);
      else part_p_att[(part + r) * A + a] = dpa;
    }
#pragma unroll
    for (int n = 0; n < kAttMaxRows; ++n) {
      if (n < rows) d_att_h[(row0 + n) * A + a] = from_f<T>(dah[n]);
    }
    partial_w[(long long)blockIdx.x * A + a] = dw;
  }
  if (threadIdx.x == 0) {
    float db = 0.f;
    for (int n = 0; n < rows; ++n) db += row_db[n];
    partial_b[blockIdx.x] = db;
  }
}

// d p_att (B, R, A) or d att (B, R, D): the image's chunk partials summed in chunk order
template <typename T>
__global__ void additive_attention_chunk_sum_kernel(const float* __restrict__ part, long long per_image, int chunks,
                                                    long long total, T* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long b = e / per_image, i = e - b * per_image;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[(b * chunks + c) * per_image + i];
  out[e] = from_f<T>(acc);
}

// d w[a] (a < A) and d bias (a == A): sums of the per-block partials in block order
template <typename T>
__global__ void additive_attention_reduce_kernel(const float* __restrict__ partial_w,
                                                 const float* __restrict__ partial_b, int B, int A,
                                                 T* __restrict__ dw, T* __restrict__ db) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a > A) return;
  float acc = 0.f;
  if (a < A) {
    for (int b = 0; b < B; ++b) acc += partial_w[(long long)b * A + a];
    dw[a] = from_f<T>(acc);
  } else {
    for (int b = 0; b < B; ++b) acc += partial_b[b];
    db[0] = from_f<T>(acc);
  }
}

inline int row_chunks(int rows) { return (rows + kAttMaxRows - 1) / kAttMaxRows; }

template <typename T>
cudaError_t launch_fwd(const void* p_att, const void* att_h, const void* w, const void* bias, const void* mask,
                       const void* att, void* out, void* prob, void* weight, int B, int rows, int R, int A, int D,
                       cudaStream_t st) {
  const int chunks = row_chunks(rows);
  additive_attention_fwd_kernel<T><<<B * chunks, kAttThreads, 0, st>>>(
      static_cast<const T*>(p_att), static_cast<const T*>(att_h), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const unsigned char*>(mask), static_cast<const T*>(att),
      static_cast<T*>(out), static_cast<float*>(prob), static_cast<float*>(weight), rows, chunks, R, A, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* p_att, const void* att_h, const void* w, const void* mask, const void* att,
                       const void* prob, const void* weight, const void* dout, void* d_p_att, void* d_att_h,
                       void* d_att, void* dw, void* db, void* partial_w, void* partial_b, void* part_p_att,
                       void* part_att, int B, int rows, int R, int A, int D, cudaStream_t st) {
  const int chunks = row_chunks(rows);
  if (chunks > 1 && (part_p_att == nullptr || part_att == nullptr)) return cudaErrorInvalidValue;
  float* pp = chunks > 1 ? static_cast<float*>(part_p_att) : nullptr;
  float* pa = chunks > 1 ? static_cast<float*>(part_att) : nullptr;
  additive_attention_bwd_kernel<T><<<B * chunks, kAttThreads, 0, st>>>(
      static_cast<const T*>(p_att), static_cast<const T*>(att_h), static_cast<const T*>(w),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(att), static_cast<const float*>(prob),
      static_cast<const float*>(weight), static_cast<const T*>(dout), static_cast<T*>(d_p_att),
      static_cast<T*>(d_att_h), static_cast<T*>(d_att), static_cast<float*>(partial_w),
      static_cast<float*>(partial_b), pp, pa, rows, chunks, R, A, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (chunks > 1) {
    const long long n_pa = (long long)B * R * A, n_at = (long long)B * R * D;
    additive_attention_chunk_sum_kernel<T><<<(unsigned)((n_pa + 255) / 256), 256, 0, st>>>(
        pp, (long long)R * A, chunks, n_pa, static_cast<T*>(d_p_att));
    additive_attention_chunk_sum_kernel<T><<<(unsigned)((n_at + 255) / 256), 256, 0, st>>>(
        pa, (long long)R * D, chunks, n_at, static_cast<T*>(d_att));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  additive_attention_reduce_kernel<T><<<(A + 1 + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial_w), static_cast<const float*>(partial_b), B * chunks, A,
      static_cast<T*>(dw), static_cast<T*>(db));
  return cudaGetLastError();
}

inline bool shapes_ok(int B, int rows, int R, int A, int D) {
  return B >= 1 && rows >= 1 && R >= 1 && R <= kAttMaxRegions && A >= 1 && D >= 1;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. p_att (B, R, A), att_h (B * rows, A), w (A), bias (1), mask (B, R) uint8,
// att (B, R, D), out (B * rows, D); prob and weight ((B * rows, R) f32) may be null (no backward to follow).
extern "C" int sct_additive_attention(int dtype, const void* p_att, const void* att_h, const void* w, const void* bias,
                                      const void* mask, const void* att, void* out, void* prob, void* weight, int B,
                                      int rows, int R, int A, int D, void* stream) {
  if (!sct::shapes_ok(B, rows, R, A, D) || (prob == nullptr) != (weight == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)sct::launch_fwd<float>(p_att, att_h, w, bias, mask, att, out, prob, weight, B, rows, R, A, D, st);
  }
  if (dtype == 1) {
    return (int)sct::launch_fwd<__nv_bfloat16>(p_att, att_h, w, bias, mask, att, out, prob, weight, B, rows, R, A,
                                               D, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The gradients of p_att, att_h, att, w and bias (all in the compute dtype) from dout (B * rows, D) and the
// forward's prob and weight. f32 scratch, with C = ceil(rows / 16) chunks of rows per image: partial_w (B * C,
// A), partial_b (B * C), and for C > 1 part_p_att (B * C, R, A) and part_att (B * C, R, D) (else null).
extern "C" int sct_additive_attention_bwd(int dtype, const void* p_att, const void* att_h, const void* w,
                                          const void* mask, const void* att, const void* prob, const void* weight,
                                          const void* dout, void* d_p_att, void* d_att_h, void* d_att, void* dw,
                                          void* db, void* partial_w, void* partial_b, void* part_p_att,
                                          void* part_att, int B, int rows, int R, int A, int D, void* stream) {
  if (!sct::shapes_ok(B, rows, R, A, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)sct::launch_bwd<float>(p_att, att_h, w, mask, att, prob, weight, dout, d_p_att, d_att_h, d_att, dw,
                                       db, partial_w, partial_b, part_p_att, part_att, B, rows, R, A, D, st);
  }
  if (dtype == 1) {
    return (int)sct::launch_bwd<__nv_bfloat16>(p_att, att_h, w, mask, att, prob, weight, dout, d_p_att, d_att_h,
                                               d_att, dw, db, partial_w, partial_b, part_p_att, part_att, B, rows,
                                               R, A, D, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
