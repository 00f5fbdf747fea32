// Shared pieces of K14 (decoder_attention.cu) and K15 (decoder_attention_bwd.cu):
// the decoder's full-sequence attention softmax(fill(q.k / sqrt(dk))) . v over
// at most 64 keys, with a key-validity vector, an optional causal rule and
// key/value rows shared by a group of query rows.
//
// bf16 (tensor cores): the scores S = Q K^T of one 16-row tile of stacked
// query rows and their softmax on the mma.sync accumulators. K14 and K15
// both call `dec_scores_mma` and `dec_softmax_mma`, so the probabilities K15
// recomputes are the ones K14 used, bit for bit (the same products in the
// same order, the same per-thread and quad sums). f32 (CUDA cores): one
// warp's softmax of a row, `dec_softmax`, shared the same way.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace sct {

using bf16 = __nv_bfloat16;

constexpr int kDecMaxLen = 64;     // keys and query positions
// staged bf16 row pitch at head width DK (144 B at 64, 80 B at 32, 48 B at
// 13, staged at 16: the 8 rows of an ldmatrix or fragment load in distinct
// banks each way)
template <int DK> constexpr int kLd = kPad<DK> + 8;

// ------------------------------------------------------------ bf16: tensor cores
// Fragment rows of the tile (lane g = lane / 4, t = lane % 4): rows g and
// g + 8; key columns 8 nt + 2 t + c of n-tile nt (c = 0, 1).

// Key validity of this lane's keys, bit 2 nt + c for key 8 nt + 2 t + c
// (valid_b null: every key below Tk valid).
template <int NS>
__device__ __forceinline__ uint32_t dec_key_bits(const unsigned char* __restrict__ valid_b, int Tk) {
  const int t = threadIdx.x & 3;
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 8 * nt + 2 * t + c;
      if (j < Tk && (valid_b == nullptr || valid_b[j] != 0)) bits |= 1u << (2 * nt + c);
    }
  }
  return bits;
}

// The keep-mask of this lane's elements, bit 4 nt + e (e = 2 r + c: row r's
// key 8 nt + 2 t + c), from the rows' Tk flags at keep_row[r] (global or
// shared memory).
template <int NS>
__device__ __forceinline__ uint32_t dec_keep_bits(const unsigned char* const keep_row[2], const bool live[2], int Tk) {
  const int t = threadIdx.x & 3;
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * nt + 2 * t + (e & 1), r = e >> 1;
      if (live[r] && j < Tk && keep_row[r][j] != 0) bits |= 1u << (4 * nt + e);
    }
  }
  return bits;
}

__device__ __forceinline__ bool key_attended(uint32_t vbits, int c, int j, int i, int causal) {
  return ((vbits >> c) & 1u) != 0 && (!causal || j <= i);
}

// S = Q K^T of the tile on the tensor cores: qr[r] the staged rows g and
// g + 8 (the zero row for a padding row), ks the Tk key rows; sacc[nt] the
// accumulators of keys 8 nt .. 8 nt + 7 (n-tiles with no key stay 0).
template <int DK, int KT>
__device__ __forceinline__ void dec_scores_mma(const bf16* const qr[2], const bf16* ks, const bf16* zero, int Tk,
                                               float sacc[2 * KT][4]) {
  constexpr int NS = 2 * KT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nsv = (Tk + 7) / 8;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < kPad<DK> / 16; ++kd) {
    const int col = 16 * kd + 2 * t;
    const uint32_t a[4] = {lds_u32(qr[0] + col), lds_u32(qr[1] + col), lds_u32(qr[0] + col + 8),
                           lds_u32(qr[1] + col + 8)};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      if (nt < nsv) {
        const int j = 8 * nt + g;
        const bf16* kr = (j < Tk ? ks + j * kLd<DK> : zero) + col;
        const uint32_t b[2] = {lds_u32(kr), lds_u32(kr + 8)};
        mma_bf16(sacc[nt], a, b);
      }
    }
  }
}

// The softmax on the accumulators, rounded where the plain version rounds:
// the product and its division by sqrt_dk to bf16 (`div_score`), -1e9 (in
// bf16) where the key may not be attended (vbits, the causal rule at the
// rows' positions pos), -inf for padding keys (j >= Tk), which take no part;
// then p = round(e / sum) with e = exp(s - max), each thread's sum in n-tile
// order, then over the quad. On return sacc holds p (0 for padding keys and
// rows that are not live). A row whose every key is masked gets the uniform
// 1 / Tk: every score is the same -1e9.
template <int KT>
__device__ __forceinline__ void dec_softmax_mma(float sacc[2 * KT][4], uint32_t vbits, const int pos[2],
                                                const bool live[2], int Tk, int causal, float sqrt_dk) {
  constexpr int NS = 2 * KT;
  const int t = threadIdx.x & 3;
  const int nsv = (Tk + 7) / 8;
  const float fill = round_to<bf16>(kNegInf);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    if (nt >= nsv) continue;  // no key there: S and P stay 0
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1, j = 8 * nt + 2 * t + c, r = e >> 1;
      float s = -INFINITY;
      if (j < Tk) {
        s = key_attended(vbits, 2 * nt + c, j, pos[r], causal)
                ? round_to<bf16>(div_score(round_to<bf16>(sacc[nt][e]), sqrt_dk))
                : fill;
      }
      sacc[nt][e] = s;
      mx[r] = fmaxf(mx[r], s);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    if (nt >= nsv) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sacc[nt][e] == -INFINITY ? 0.f : expf(sacc[nt][e] - mx[e >> 1]);
      sacc[nt][e] = x;
      sum[e >> 1] += x;
    }
  }
  float inv[2];  // p = e / sum by one reciprocal a row (div_by: the IEEE quotient)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    if (nt >= nsv) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = 8 * nt + 2 * t + (e & 1);
      sacc[nt][e] = live[r] && j < Tk ? round_to<bf16>(div_by(sacc[nt][e], sum[r], inv[r])) : 0.f;
    }
  }
}

// x's dropout: 0 where dropped, else x / keep_prob rounded to bf16 (the
// plain version's divisor, rounded to the dtype by the caller; inv_kp =
// 1 / keep_prob); x itself without a keep-mask
__device__ __forceinline__ float dec_dropped(float x, bool kept, bool dropout, float keep_prob, float inv_kp) {
  return !kept ? 0.f : !dropout ? x : round_to<bf16>(div_by(x, keep_prob, inv_kp));
}

// ------------------------------------------------------------ f32: CUDA cores
constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
// f32 row pitch (68 floats at DK = 64, 36 at 32, 20 at 13): 16-byte rows; 8 lanes reading 8 rows hit distinct banks
template <int DK> constexpr int kF32Ld = kPad<DK> + 4;
constexpr int kWideRows = 32;         // chunks of at least this many rows take 4 query rows a warp at a time
constexpr int kChunkRows = 64;        // query rows staged at a time (whole members)

__host__ __device__ inline int f32_chunk_members(int Tq, int group) {
  const int m = kChunkRows / Tq;
  return m < 1 ? 1 : (m > group ? group : m);
}
__host__ __device__ inline int f32_tk_pad(int Tk) { return 4 * ((Tk + 3) / 4); }

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// rows of DK f32 from global into rows of kF32Ld, 16 bytes a copy (the
// narrow instance element by element, padded with zeros)
template <int DK>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* __restrict__ src, int rows) {
  if constexpr (kNarrow<DK>) {
    stage_padded<DK>(dst, kF32Ld<DK>, src, rows, threadIdx.x, blockDim.x);
  } else {
    constexpr int C = DK / 4;  // 16-byte chunks of a row
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
      const int r = e / C, c = (e % C) * 4;
      *reinterpret_cast<float4*>(dst + r * kF32Ld<DK> + c) = *reinterpret_cast<const float4*>(src + r * DK + c);
    }
  }
}

// The softmax of one query row over its Tk <= 64 keys, held by one warp (lane
// owns keys lane and lane + 32; s = -inf for lanes past Tk). K14's and K15's
// f32 variants call it on the same scores and so get the same p. A row
// whose every key is masked gets the uniform 1 / Tk.
__device__ __forceinline__ void dec_softmax(const float s[2], int Tk, float p[2]) {
  const int lane = threadIdx.x & 31;
  const float m = warp_max(fmaxf(s[0], s[1]));
  const float e0 = lane < Tk ? expf(s[0] - m) : 0.f;
  const float e1 = lane + 32 < Tk ? expf(s[1] - m) : 0.f;
  const float sum = warp_sum(e0 + e1);
  p[0] = e0 / sum;
  p[1] = e1 / sum;
}

}  // namespace sct
