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
// to T where the plain version (and the JAX package) rounds on the card: the
// add, tanh (the exact tanhf), the dot, the dot + bias (F.linear's product
// and its bias add round apart), the probabilities, the masked sum, its
// floor 1e-9 and the weights; the output accumulates in f32 and rounds once
// (no-ops for f32). With a backward to follow the forward also writes p and
// weight (N, R) f32. The backward rounds where autograd of the plain version
// rounds on the card (g: d weight, u = round(w / Z'), Z' = max(Z, 1e-9)):
//   g[n, r]   = round(dout[n] . att[b, r]);  d att[b, r] = round(sum_n round(weight[n, r] dout[n]))
//   dZ'       = round(sum_r round(-g u));  dq = round(round(g / Z') + [Z >= 1e-9] dZ')
//   gp        = round(mask dq p);  ds = round(gp - p sum_r gp)      (PyTorch's CUDA softmax backward)
//   dd[a]     = round(ds w_a);  dx = round(dd round(1 - round(t t)))   (tanh_backward in T)
//   d p_att[b, r] = round(sum_n dx),  d att_h[n] = round(sum_r dx)
//   d w_a     = round(sum_{n, r} ds t),  d bias = round(sum_{n, r} ds)   (t = tanh(p_att + att_h), recomputed)
// d w and d bias are per-block partials, summed over blocks in a fixed order
// by a second kernel: no float atomics.
//
// Bound on the H100: bytes. Each image's p_att (R x A) and att (R x D) are
// read once for all its rows (serving at 1024 images x 5 beams, R = 36, A =
// 512, D = 1000, bf16: 127 MB with att_h and out, 0.038 ms); the rows x R x A
// exact tanhf (94M at that shape, about 15 instructions each, two of them on
// the special-function unit) would come to about 0.05-0.08 ms of the SMs'
// issue, above the byte bound; a table of its bf16 results costs a shared
// memory load instead.
//
// Design: the forward's held path (A and D whole 16-byte vectors, aligned
// tensors) runs one block of 192 threads per image and chunk of at most 16
// of its rows (one chunk for beams and XE captions; 4 for SCST's 60 samples),
// three such blocks an SM, so one block's scores overlap another's loads and
// weighted sum. The block stages the image's p_att, the chunk's att_h rows
// and w into shared memory with 16-byte cp.async copies (rows padded by 16
// bytes, so that lanes on other rows hit other banks) and asks for att[b] to
// be brought into L2 meanwhile. Scores: one thread per (row, region) pair,
// over A in 8-wide vectors from shared memory, no reduction across threads;
// in bf16 the add is one `add.bf16x2` for two elements and the tanh a lookup
// in a 2.8 KB table of exact tanhf results (the table takes the
// special-function unit and its long dependent chain out of the 94M-element
// loop; the bits are the plain version's by construction, and held on every
// bf16 value by a check). Softmax and renormalisation: one warp per row (R <=
// 64: two regions a lane). The weighted sum: one thread per 16-byte column
// vector of att and group of 4 rows, f32 accumulators for each, att read
// from L2 by 16-byte loads, four in flight, once per group: 5 beams or
// captions make groups of 4 and 1, so att[b] is read twice (one group of 5
// reads it once but leaves 67 of the 192 threads idle, and was slower at the
// serving shape). The phases of a block (staging, scores, weighted sum) run
// one after another; three blocks an SM overlap them only in part. Other
// shapes take the general forward: 256 threads per chunk,
// one warp per (row, region) pair with scalar loads, one thread per output
// column. The backward walks the general layout, thread per column a of
// p_att in its last phase so the chunk's rows and regions are summed in
// registers. With more than one chunk per image, the chunks' d p_att and d
// att go to f32 partials that a last kernel sums over the image's chunks in
// order and rounds once.
#include <algorithm>
#include <initializer_list>

#include "common.cuh"
#include "vec.cuh"

namespace sct {

constexpr int kAttThreads = 256;  // the general forward and the backward
constexpr int kAttWarps = kAttThreads / 32;
constexpr int kAttHeldThreads = 192;  // the held forward
constexpr int kAttMaxRegions = 64;
constexpr int kAttMaxRows = 16;
constexpr int kAttRowGroup = 4;  // rows a thread of the held weighted sum accumulates
constexpr float kRenormFloor = 1e-9f;  // up_down.py:72

// the score from the f32 dot: the product rounded, then the bias added and
// rounded (F.linear on the card rounds the two apart)
template <typename T>
__device__ __forceinline__ float score_round(float dot, float bias) {
  return round_to<T>(round_to<T>(dot) + bias);
}

// Softmax over the R (<= 64) scores of one row and the masked
// renormalisation, by one warp: s_row holds the row's scores and receives
// its weights; prob_o / weight_o (the row's R f32, may be null) receive p
// and the weights for the backward.
template <typename T>
__device__ __forceinline__ void softmax_renorm_row(float* s_row, const unsigned char* __restrict__ mask_b, int R,
                                                   float* __restrict__ prob_o, float* __restrict__ weight_o) {
  const int lane = threadIdx.x & 31;
  const bool in0 = lane < R, in1 = lane + 32 < R;
  const float v0 = in0 ? s_row[lane] : -INFINITY, v1 = in1 ? s_row[lane + 32] : -INFINITY;
  const float m = warp_max(fmaxf(v0, v1));
  const float e0 = in0 ? expf(v0 - m) : 0.f, e1 = in1 ? expf(v1 - m) : 0.f;
  const float sum = warp_sum(e0 + e1);
  const float p0 = round_to<T>(e0 / sum), p1 = round_to<T>(e1 / sum);
  const float q0 = in0 && mask_b[lane] ? p0 : 0.f;
  const float q1 = in1 && mask_b[lane + 32] ? p1 : 0.f;
  const float z = fmaxf(round_to<T>(warp_sum(q0 + q1)), round_to<T>(kRenormFloor));
  const float w0 = round_to<T>(q0 / z), w1 = round_to<T>(q1 / z);
  __syncwarp();
  if (in0) {
    s_row[lane] = w0;
    if (prob_o != nullptr) {
      prob_o[lane] = p0;
      weight_o[lane] = w0;
    }
  }
  if (in1) {
    s_row[lane + 32] = w1;
    if (prob_o != nullptr) {
      prob_o[lane + 32] = p1;
      weight_o[lane + 32] = w1;
    }
  }
}

// The bf16 tanh of the held forward, by table: every bf16 |x| in [2^-8, 8)
// has its entry, round(tanhf(x)) computed by tanhf itself when a block
// starts; below 2^-8 tanh rounds to x, from 8 on to +-1, and tanhf is odd
// (the sign is copied). `sct_bf16_tanh` runs it over any bf16 values, so that
// a check can hold it against the plain version's tanh on all 65,536.
constexpr uint32_t kTanhLo = 0x3B80u, kTanhHi = 0x4100u;  // 2^-8 and 8 as bf16 bits
constexpr int kTanhEntries = (int)(kTanhHi - kTanhLo);

__device__ __forceinline__ void fill_tanh_table(unsigned short* table) {
  for (int e = threadIdx.x; e < kTanhEntries; e += blockDim.x) {
    const __nv_bfloat16 t = __float2bfloat16_rn(tanhf(__uint_as_float((kTanhLo + e) << 16)));
    table[e] = *reinterpret_cast<const unsigned short*>(&t);
  }
}

// b: the bits of one bf16 value (NaN passes through)
__device__ __forceinline__ uint32_t tanh_bits(uint32_t b, const unsigned short* table) {
  const uint32_t a = b & 0x7FFFu, sign = b & 0x8000u;
  const uint32_t t = table[min(max((int)a - (int)kTanhLo, 0), kTanhEntries - 1)];
  return a < kTanhLo || a > 0x7F80u ? b : ((a >= kTanhHi ? 0x3F80u : t) | sign);
}

// one 16-byte vector of p_att, att_h and w (8 bf16 or 4 f32): the rounded
// add (bf16: `add.bf16x2`, one rounding of the exact sum, as the f32 add
// rounded), the rounded tanh (bf16: the table), and the products with w into
// two f32 accumulators
template <typename T>
__device__ __forceinline__ void score_vec(uint4 pv, uint4 hv, uint4 wv, float (&acc)[2], const unsigned short* tab) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w}, hw[4] = {hv.x, hv.y, hv.z, hv.w};
    const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 xs = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&pw[i]),
                                        *reinterpret_cast<const __nv_bfloat162*>(&hw[i]));
      const uint32_t xr = *reinterpret_cast<const uint32_t*>(&xs);  // the add, rounded
      const uint32_t tr = tanh_bits(xr & 0xFFFFu, tab) | (tanh_bits(xr >> 16, tab) << 16);  // the tanh, rounded
      acc[0] = fmaf(bf16_lo(tr), bf16_lo(ww[i]), acc[0]);
      acc[1] = fmaf(bf16_hi(tr), bf16_hi(ww[i]), acc[1]);
    }
  } else {
    float p[4], h[4], w[4];
    unpack16<T>(pv, p);
    unpack16<T>(hv, h);
    unpack16<T>(wv, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i & 1] = fmaf(tanhf(p[i] + h[i]), w[i], acc[i & 1]);
  }
}

// The held forward. Dynamic shared memory: p_att[b] (R rows), the chunk's
// att_h rows (min(16, img_rows) rows), each row A T's padded by 16 bytes, then w.
template <typename T>
__global__ void __launch_bounds__(kAttHeldThreads, 3)
additive_attention_fwd_held_kernel(const T* __restrict__ p_att, const T* __restrict__ att_h, const T* __restrict__ w,
                                   const T* __restrict__ bias, const unsigned char* __restrict__ mask,
                                   const T* __restrict__ att, T* __restrict__ out, float* __restrict__ prob_out,
                                   float* __restrict__ weight_out, int img_rows, int chunks, int R, int A, int D) {
  constexpr int UE = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char att_smem[];
  __shared__ float s_w[kAttMaxRows * kAttMaxRegions];  // scores, then weights
  __shared__ unsigned short tanh_s[kTanhEntries];
  const int b = blockIdx.x / chunks, tid = threadIdx.x, nt = blockDim.x, warp = tid / 32;
  if (sizeof(T) == 2) fill_tanh_table(tanh_s);
  const int first = (blockIdx.x - b * chunks) * kAttMaxRows, rows = min(kAttMaxRows, img_rows - first);
  const long long row0 = (long long)b * img_rows + first;
  const int av = A / UE, stride = A * (int)sizeof(T) + 16;
  unsigned char* ps = att_smem;
  unsigned char* hs = ps + R * stride;
  unsigned char* ws = hs + min(kAttMaxRows, img_rows) * stride;

  const T* pa = p_att + (long long)b * R * A;
  const T* ah = att_h + row0 * A;
  for (int e = tid; e < R * av; e += nt) {
    const int r = e / av, v = e - r * av;
    cp_async<16>(ps + r * stride + v * 16, pa + (long long)r * A + v * UE);
  }
  for (int e = tid; e < rows * av; e += nt) {
    const int n = e / av, v = e - n * av;
    cp_async<16>(hs + n * stride + v * 16, ah + (long long)n * A + v * UE);
  }
  for (int v = tid; v < av; v += nt) cp_async<16>(ws + v * 16, w + v * UE);
  cp_async_commit();
  const T* at = att + (long long)b * R * D;
  const long long at_bytes = (long long)R * D * sizeof(T);
  for (long long off = (long long)tid * 128; off < at_bytes; off += (long long)nt * 128)
    prefetch_l2(reinterpret_cast<const unsigned char*>(at) + off);
  cp_async_wait<0>();
  __syncthreads();

  const float bias0 = to_f(bias[0]);
  for (int pr = tid; pr < rows * R; pr += nt) {  // one (row, region) pair a thread
    const int n = pr % rows, r = pr / rows;
    const unsigned char* prow = ps + r * stride;
    const unsigned char* hrow = hs + n * stride;
    float acc[2] = {0.f, 0.f};
#pragma unroll 4
    for (int v = 0; v < av; ++v) score_vec<T>(ld16(prow + v * 16), ld16(hrow + v * 16), ld16(ws + v * 16), acc, tanh_s);
    s_w[n * R + r] = score_round<T>(acc[0] + acc[1], bias0);
  }
  __syncthreads();

  for (int n = warp; n < rows; n += nt / 32) {
    const long long o = (row0 + n) * R;
    softmax_renorm_row<T>(s_w + n * R, mask + (long long)b * R, R, prob_out != nullptr ? prob_out + o : nullptr,
                          weight_out != nullptr ? weight_out + o : nullptr);
  }
  __syncthreads();

  const int dv = D / UE, groups = (rows + kAttRowGroup - 1) / kAttRowGroup;
  for (int it = tid; it < dv * groups; it += nt) {
    const int c = it % dv, g0 = (it / dv) * kAttRowGroup;
    float acc[kAttRowGroup][UE];
#pragma unroll
    for (int j = 0; j < kAttRowGroup; ++j) {
#pragma unroll
      for (int e = 0; e < UE; ++e) acc[j][e] = 0.f;
    }
#pragma unroll 4
    for (int r = 0; r < R; ++r) {  // the weighted sum over regions
      float a[UE];
      unpack16<T>(ld16(at + (long long)r * D + c * UE), a);
#pragma unroll
      for (int j = 0; j < kAttRowGroup; ++j) {
        if (g0 + j < rows) {
          const float wt = s_w[(g0 + j) * R + r];
#pragma unroll
          for (int e = 0; e < UE; ++e) acc[j][e] = fmaf(wt, a[e], acc[j][e]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kAttRowGroup; ++j) {
      if (g0 + j < rows) st16(out + (row0 + g0 + j) * D + c * UE, pack16<T>(acc[j]));
    }
  }
}

// The general forward: any A and D, unaligned tensors.
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
    if (lane == 0) s_w[n * R + r] = score_round<T>(acc, to_f(bias[0]));
  }
  __syncthreads();

  for (int n = warp; n < rows; n += kAttWarps) {
    const long long o = (row0 + n) * R;
    softmax_renorm_row<T>(s_w + n * R, mask + (long long)b * R, R, prob_out != nullptr ? prob_out + o : nullptr,
                          weight_out != nullptr ? weight_out + o : nullptr);
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
    if (lane == 0) g_s[n * R + r] = round_to<T>(acc);
  }
  __syncthreads();

  // d att[b, r, d] = sum_n round(weight[n, r] dout[n, d])
  for (int d = threadIdx.x; d < D; d += kAttThreads) {
    float dv[kAttMaxRows];
#pragma unroll
    for (int n = 0; n < kAttMaxRows; ++n) dv[n] = n < rows ? to_f(dout[(row0 + n) * D + d]) : 0.f;
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kAttMaxRows; ++n) {
        if (n < rows) acc += round_to<T>(w_s[n * R + r] * dv[n]);
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
    const float u0 = in0 ? w_s[n * R + lane] : 0.f, u1 = in1 ? w_s[n * R + lane + 32] : 0.f;  // q / Z'
    const float z = round_to<T>(warp_sum(m0 * p0 + m1 * p1));
    const float floor_t = round_to<T>(kRenormFloor);
    const float zc = fmaxf(z, floor_t);
    // the division's gradient to Z', through the sum's clamp
    const float dzc = round_to<T>(warp_sum(round_to<T>(-g0 * round_to<T>(u0 / zc)) +
                                           round_to<T>(-g1 * round_to<T>(u1 / zc))));
    const float dz = z >= floor_t ? dzc : 0.f;
    const float dp0 = m0 * round_to<T>(round_to<T>(g0 / zc) + dz), dp1 = m1 * round_to<T>(round_to<T>(g1 / zc) + dz);
    const float gp0 = round_to<T>(dp0 * p0), gp1 = round_to<T>(dp1 * p1);
    const float gsum = warp_sum(gp0 + gp1);
    const float ds0 = in0 ? round_to<T>(fmaf(-p0, gsum, gp0)) : 0.f;
    const float ds1 = in1 ? round_to<T>(fmaf(-p1, gsum, gp1)) : 0.f;
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
          const float e = round_to<T>(round_to<T>(ds * wa) * round_to<T>(1.f - round_to<T>(t * t)));
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

// dynamic shared memory of the held forward (0: the shapes or the tensors
// take the general path); with the kernel's static arrays (the scores and the
// tanh table, which both instantiations declare) it must fit a block's limit
template <typename T>
size_t held_fwd_smem(const void* p_att, const void* att_h, const void* w, const void* att, const void* out, int rows,
                     int R, int A, int D) {
  constexpr int UE = 16 / sizeof(T);
  if (A % UE != 0 || D % UE != 0) return 0;
  for (const void* t : {p_att, att_h, w, att, out})
    if (!aligned_to(t, 16)) return 0;
  const size_t smem = (size_t)(R + std::min(kAttMaxRows, rows)) * (A * sizeof(T) + 16) + A * sizeof(T);
  const size_t fixed = sizeof(float) * kAttMaxRows * kAttMaxRegions + sizeof(unsigned short) * kTanhEntries;
  return smem + fixed <= (size_t)kBlockSmemLimit ? smem : 0;
}

template <typename T>
cudaError_t launch_fwd(const void* p_att, const void* att_h, const void* w, const void* bias, const void* mask,
                       const void* att, void* out, void* prob, void* weight, int B, int rows, int R, int A, int D,
                       cudaStream_t st) {
  const int chunks = row_chunks(rows);
  const size_t smem = held_fwd_smem<T>(p_att, att_h, w, att, out, rows, R, A, D);
  if (smem > 0) {
    auto kernel = additive_attention_fwd_held_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<B * chunks, kAttHeldThreads, smem, st>>>(
        static_cast<const T*>(p_att), static_cast<const T*>(att_h), static_cast<const T*>(w),
        static_cast<const T*>(bias), static_cast<const unsigned char*>(mask), static_cast<const T*>(att),
        static_cast<T*>(out), static_cast<float*>(prob), static_cast<float*>(weight), rows, chunks, R, A, D);
    return cudaGetLastError();
  }
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

__global__ void bf16_tanh_kernel(const unsigned short* __restrict__ x, unsigned short* __restrict__ y, int n) {
  __shared__ unsigned short table[kTanhEntries];
  fill_tanh_table(table);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    y[i] = (unsigned short)tanh_bits(x[i], table);
}

}  // namespace sct

// x, y (n,) bf16: y = the held forward's tanh of x, rounded to bf16
extern "C" int sct_bf16_tanh(const void* x, void* y, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  sct::bf16_tanh_kernel<<<64, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const unsigned short*>(x),
                                                                           static_cast<unsigned short*>(y), n);
  return (int)cudaGetLastError();
}

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
