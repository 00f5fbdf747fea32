// Shared pieces of K14 (decoder_attention.cu) and K15 (decoder_attention_bwd.cu):
// the decoder's full-sequence attention softmax(fill(q.k / sqrt(dk))) . v over
// at most 64 keys, with a key-validity vector, an optional causal rule and
// key/value rows shared by a group of query rows.
#pragma once

#include "common.cuh"

namespace sct {

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxLen = 64;           // keys (two per lane) and, in the backward, query positions
constexpr int kDecStride = kHeadDim + 1;  // odd row stride: lane j reading row j is conflict-free

// Key j may be attended from query position i: a valid key (valid_s[j] != 0)
// and, under the causal rule, no later than i.
__device__ __forceinline__ bool dec_key_ok(const unsigned char* valid_s, int i, int j, int causal) {
  return valid_s[j] != 0 && (!causal || j <= i);
}

// One lane's score of query row `qr` (64 f32) against key row `kr`, rounded
// where the plain version rounds: the product in T, its scaling in T (exact
// for dk = 64, scale 1/8), and -1e9 in T where the key may not be attended.
template <typename T>
__device__ __forceinline__ float dec_score(const float* qr, const float* kr, float scale, bool ok) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < kHeadDim; ++d) acc = fmaf(qr[d], kr[d], acc);
  return ok ? round_to<T>(round_to<T>(acc) * scale) : round_to<T>(kNegInf);
}

// The softmax of one query row over its Tk <= 64 keys, held by one warp (lane
// owns keys lane and lane + 32): the probabilities rounded to T, as the plain
// version's softmax writes them. The forward and the backward call it with
// the same scores and so get the same bits. A row whose every key is masked
// gets the uniform 1 / Tk (every score is the same -1e9).
template <typename T>
__device__ __forceinline__ void dec_softmax(const float s[2], int Tk, float p[2]) {
  const int lane = threadIdx.x & 31;
  const float m = warp_max(fmaxf(s[0], s[1]));
  const float e0 = lane < Tk ? expf(s[0] - m) : 0.f;
  const float e1 = lane + 32 < Tk ? expf(s[1] - m) : 0.f;
  const float sum = warp_sum(e0 + e1);
  p[0] = round_to<T>(e0 / sum);
  p[1] = round_to<T>(e1 / sum);
}

// Load the block's key-validity flags (null: every key valid).
__device__ __forceinline__ void dec_load_valid(unsigned char* valid_s, const unsigned char* __restrict__ key_valid,
                                               int b, int Tk) {
  for (int j = threadIdx.x; j < Tk; j += blockDim.x) valid_s[j] = key_valid == nullptr ? 1 : key_valid[(size_t)b * Tk + j];
}

}  // namespace sct
