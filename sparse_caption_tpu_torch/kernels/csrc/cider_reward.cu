// K10: the SCST reward, CIDEr-D x 10 + BLEU-1..4, one sampled caption per block.
//
// Replaces: sparse_caption_tpu/scst/device_reward.py:282-403
// make_reward_device_fn (`_grams`, `_df_lookup`, `_score_one`, vmapped over
// the captions). Left to XLA on the TPU.
//
// For the caption in row n (T token ids) and the references of its image
// (R refs of L gram slots, precomputed on the host by build_ref_pack):
//   words  = ids before the first EOS with pad and bos skipped, each id + 1
//   grams  = G = 4T slots; slot n*T + s holds the (n+1)-gram at word s as a
//            (hi, lo) uint32 key (16 bits per word, first word most significant)
//   tf     = number of valid slots with the same key; first = no earlier one
//   df     = log(max(1, df)) from the open-addressed table (linear probe of
//            `probe` slots from mix(hi, lo) & (size - 1)), 0 when absent
//   vals   = tf * (ref_len - df);  cnorm[n] = sqrt(sum over first grams of order n of vals^2)
//   num[r][n] = sum over first grams g of order n, ref slots l with the same key:
//               min(vals[g], rval[r][l]) * rval[r][l]
//   sim[r][n] = num / (cnorm[n] * rnorm[r][n]) (0 when that is 0), times
//               exp(-(lh - rlen[r])^2 / 72) * ref_valid[r], lh = max(words - 1, 0)
//   cider  = 10 * sum_r mean_n sim[r][n] / max(n_refs, 1)
//   BLEU   = clipped matches min(tf, max ref count) over first grams, guesses
//            max(words - n, 0), (correct + 1e-15) / (guess + 1e-9) cumulative
//            products to the power 1/(n+1), the brevity penalty against the
//            closest reference length (ties to the smaller)
//   out    = cider_weight * cider + sum_n bleu_weight[n] * BLEU-(n+1) * penalty
// uint32 arithmetic wraps as in the JAX package's `_mix`; floats are f32.
//
// Radix mode (tpw > 0; ACORT's digit ids, scst/device_reward.py:235-280
// make_radix_to_word_fn, which the JAX package applies per row inside the
// jitted scorer): the row holds T radix digits (pad 0, digits 1..base,
// bos base + 1, eos base + 2). The prologue regroups them into word ids
// first: digits before the first eos with pad and bos dropped, grouped by
// tpw (a short tail filled with digit 1), each group's value sum of
// max(d - 1, 0) base^(tpw - 1 - k); value v < n_words - 1 becomes word v + 4,
// any other <unk> 1. The word row then takes the gram path above with the
// word-level eos / pad / bos ids the caller passes (3, 0, 2): its
// ceil(T / tpw) slots hold the words, then word pad 0, so the compaction
// keeps every regrouped word in order.
//
// Bound on the H100: data-dependent integer work, no floating-point peak
// applies. Per caption the G x G equality and the G x R x L match are
// 68 * 68 + 68 * 5 * 64 = 26.4k key compares (T = 17, 5 refs, L = 64);
// 960 captions: 25M compares. The bytes are the ids, the image's pack
// (5 * 64 * 16 B) and `probe` table slots per gram.
//
// Design: one block of 128 threads per caption, one thread per gram slot;
// the keys, tf, first-occurrence flags and per-(gram, ref) sums live in
// shared memory; the block's thread 0 finishes the per-n and per-r sums in a
// fixed order (no atomics, deterministic).
#include <climits>
#include <stdint.h>

#include "common.cuh"

namespace sct {

constexpr int kRewardThreads = 128;
constexpr int kMaxTok = 32;            // T <= 32, so G = 4T <= 128 slots
constexpr int kMaxSlots = 4 * kMaxTok;
constexpr int kMaxRefs = 32;

__device__ __forceinline__ uint32_t gram_mix(uint32_t hi, uint32_t lo) {
  uint32_t h = (hi * 2654435761u) ^ (lo * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

__global__ void __launch_bounds__(kRewardThreads)
cider_reward_kernel(const int* __restrict__ ids, int T, const int* __restrict__ img_idx,
                    const uint32_t* __restrict__ tbl_hi, const uint32_t* __restrict__ tbl_lo,
                    const float* __restrict__ tbl_val, int tbl_size, int probe, const uint32_t* __restrict__ rhi,
                    const uint32_t* __restrict__ rlo, const float* __restrict__ rval, const float* __restrict__ rcnt,
                    const float* __restrict__ rnorms, const float* __restrict__ rlens, const int* __restrict__ rwlens,
                    const float* __restrict__ rvalid, const float* __restrict__ nrefs, int R, int L, float ref_len,
                    int eos_id, int pad_id, int bos_id, float cider_w, float bw0, float bw1, float bw2, float bw3,
                    int with_bleu, int radix_base, int tpw, int n_words, float* __restrict__ out) {
  __shared__ uint32_t words[kMaxTok + 3];
  __shared__ int s_len;
  __shared__ uint32_t ghi[kMaxSlots], glo[kMaxSlots];
  __shared__ unsigned char gvalid[kMaxSlots];
  __shared__ float gvals[kMaxSlots], gfirst[kMaxSlots], gcorrect[kMaxSlots];
  __shared__ float per_gr[kMaxSlots][kMaxRefs];
  __shared__ float num[kMaxRefs][4];
  const int row = blockIdx.x, T_in = T;  // T_in: the row's ids (digits in the radix mode)
  const int* seq = ids + (size_t)row * T_in;
  const int img = img_idx[row];
  if (tpw > 0) T = (T_in + tpw - 1) / tpw;  // the radix row's word slots: the gram layout's T from here on
  const int G = 4 * T;

  // compact the words: stop at the first EOS, skip pad / bos anywhere
  if (threadIdx.x == 0) {
    int len = 0;
    for (int i = 0; i < kMaxTok + 3; ++i) words[i] = 0u;
    if (tpw > 0) {
      // radix mode: regroup the digits into word ids, which need no further
      // compaction (no regrouped word is the word pad, bos or eos)
      const int eos_r = radix_base + 2, bos_r = radix_base + 1;
      uint32_t v = 0u;
      int k = 0;
      for (int i = 0; i < T_in; ++i) {
        const int d = seq[i];
        if (d == eos_r) break;
        if (d == 0 || d == bos_r) continue;
        v = v * (uint32_t)radix_base + (uint32_t)(d > 1 ? d - 1 : 0);
        if (++k == tpw) {
          words[len++] = (v < (uint32_t)(n_words - 1) ? v + 4u : 1u) + 1u;
          v = 0u;
          k = 0;
        }
      }
      if (k > 0) {  // the short tail, filled with digit 1 (value 0)
        for (; k < tpw; ++k) v *= (uint32_t)radix_base;
        words[len++] = (v < (uint32_t)(n_words - 1) ? v + 4u : 1u) + 1u;
      }
    } else {
      for (int i = 0; i < T; ++i) {
        const int id = seq[i];
        if (id == eos_id) break;
        if (id != pad_id && id != bos_id) words[len++] = (uint32_t)(id + 1);
      }
    }
    s_len = len;
  }
  __syncthreads();
  const int len = s_len;

  // gram keys
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const int n = g / T, s = g % T;
    const uint32_t a0 = words[s], a1 = words[s + 1], a2 = words[s + 2], a3 = words[s + 3];
    ghi[g] = n < 2 ? 0u : n == 2 ? a0 : ((a0 << 16) | a1);
    glo[g] = n == 0 ? a0 : n == 1 ? ((a0 << 16) | a1) : n == 2 ? ((a1 << 16) | a2) : ((a2 << 16) | a3);
    gvalid[g] = s <= len - (n + 1) ? 1 : 0;
  }
  __syncthreads();

  // tf, first occurrence, df, tf-idf value, clipped cross terms per ref
  const uint32_t* img_hi = rhi + (size_t)img * R * L;
  const uint32_t* img_lo = rlo + (size_t)img * R * L;
  const float* img_val = rval + (size_t)img * R * L;
  const float* img_cnt = rcnt + (size_t)img * R * L;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const uint32_t hi = ghi[g], lo = glo[g];
    int tf = 0;
    bool earlier = false;
    if (gvalid[g]) {
      for (int o = 0; o < G; ++o) {
        if (gvalid[o] && ghi[o] == hi && glo[o] == lo) {
          ++tf;
          earlier |= o < g;
        }
      }
    }
    const bool first = gvalid[g] && !earlier;
    const uint32_t h0 = gram_mix(hi, lo) & (uint32_t)(tbl_size - 1);
    float dfv = 0.f;
    for (int p = 0; p < probe; ++p) {
      const uint32_t idx = (h0 + (uint32_t)p) & (uint32_t)(tbl_size - 1);
      const uint32_t th = tbl_hi[idx], tl = tbl_lo[idx];
      if (th == hi && tl == lo && (th | tl) != 0u) dfv += tbl_val[idx];
    }
    const float v = (float)tf * (ref_len - dfv);
    gvals[g] = v;
    gfirst[g] = first ? 1.f : 0.f;
    float max_ref = 0.f;
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
      if (first) {
        for (int l = 0; l < L; ++l) {
          const size_t e = (size_t)r * L + l;
          const uint32_t kh = img_hi[e], kl = img_lo[e];
          if (kh == hi && kl == lo && (kh | kl) != 0u) {
            const float rv = img_val[e];
            acc += fminf(v, rv) * rv;
            max_ref = fmaxf(max_ref, img_cnt[e]);
          }
        }
      }
      per_gr[g][r] = acc;
    }
    gcorrect[g] = fminf((float)tf, max_ref) * gfirst[g];
  }
  __syncthreads();

  // num[r][n]: sum over the order-n slots n*T .. n*T + T - 1, in order
  for (int k = threadIdx.x; k < 4 * R; k += blockDim.x) {
    const int r = k / 4, n = k % 4;
    float acc = 0.f;
    for (int s = 0; s < T; ++s) acc += per_gr[n * T + s][r];
    num[r][n] = acc;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float cnorm[4], correct[4];
    for (int n = 0; n < 4; ++n) {
      float sq = 0.f, c = 0.f;
      for (int s = 0; s < T; ++s) {
        const int g = n * T + s;
        sq += gfirst[g] * gvals[g] * gvals[g];
        c += gcorrect[g];
      }
      cnorm[n] = sqrtf(sq);
      correct[n] = c;
    }
    const float lh = (float)(len > 1 ? len - 1 : 0);
    const float* img_norms = rnorms + (size_t)img * R * 4;
    float cider_sum = 0.f;
    for (int r = 0; r < R; ++r) {
      const float d = lh - rlens[(size_t)img * R + r];
      const float gv = expf(-(d * d) / 72.f) * rvalid[(size_t)img * R + r];
      float sim_sum = 0.f;
      for (int n = 0; n < 4; ++n) {
        const float denom = cnorm[n] * img_norms[r * 4 + n];
        const float sim = denom > 0.f ? num[r][n] / denom : 0.f;
        sim_sum += sim * gv;
      }
      cider_sum += sim_sum / 4.f;
    }
    float total = cider_w * (10.f * cider_sum / fmaxf(nrefs[img], 1.f));
    if (with_bleu) {
      int best_key = INT_MAX, reflen = 0;  // argmin, first index on ties
      for (int r = 0; r < R; ++r) {
        const int wl = rwlens[(size_t)img * R + r];
        const int key = rvalid[(size_t)img * R + r] > 0.f ? abs(wl - len) * 2048 + wl : (1 << 20);
        if (key < best_key) {
          best_key = key;
          reflen = wl;
        }
      }
      const float ratio = ((float)len + 1e-15f) / ((float)reflen + 1e-9f);
      const float penalty = ratio < 1.f ? expf(1.f - 1.f / ratio) : 1.f;
      const float w[4] = {bw0, bw1, bw2, bw3};
      float cum = 1.f, bleu_sum = 0.f;
      for (int n = 0; n < 4; ++n) {
        const float guess = (float)(len - n > 0 ? len - n : 0);
        cum = n == 0 ? (correct[0] + 1e-15f) / (guess + 1e-9f) : cum * ((correct[n] + 1e-15f) / (guess + 1e-9f));
        bleu_sum += powf(cum, 1.f / (float)(n + 1)) * penalty * w[n];
      }
      total += bleu_sum;
    }
    out[row] = total;
  }
}

}  // namespace sct

// ids (N, T) int32; img_idx (N,) int32; table hi/lo (size,) uint32, val (size,)
// f32; pack hi/lo (B, R, L) uint32, val/cnt (B, R, L) f32, norms (B, R, 4) f32,
// lens (B, R) f32, wlens (B, R) int32, ref_valid (B, R) f32, n_refs (B,) f32.
// Radix mode: tpw > 0 digits a word in base radix_base over a word vocabulary
// of n_words + 3 entries (ids then T digits, ceil(T / tpw) <= 32 words);
// tpw = 0: word ids. Output: (N,) f32.
extern "C" int sct_cider_reward(const void* ids, int N, int T, const void* img_idx, const void* tbl_hi,
                                const void* tbl_lo, const void* tbl_val, int tbl_size, int probe, const void* rhi,
                                const void* rlo, const void* rval, const void* rcnt, const void* rnorms,
                                const void* rlens, const void* rwlens, const void* rvalid, const void* nrefs, int R,
                                int L, float ref_len, int eos_id, int pad_id, int bos_id, float cider_w, float bw0,
                                float bw1, float bw2, float bw3, int with_bleu, int radix_base, int tpw, int n_words,
                                void* out, void* stream) {
  const int word_slots = tpw > 0 ? (T + tpw - 1) / tpw : T;
  if (N <= 0 || T <= 0 || word_slots > sct::kMaxTok || R <= 0 || R > sct::kMaxRefs || L <= 0 || tbl_size <= 0 ||
      (tbl_size & (tbl_size - 1)) != 0 || tpw < 0 || (tpw > 0 && (radix_base < 2 || n_words < 1)))
    return (int)cudaErrorInvalidValue;
  sct::cider_reward_kernel<<<N, sct::kRewardThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), T, static_cast<const int*>(img_idx), static_cast<const uint32_t*>(tbl_hi),
      static_cast<const uint32_t*>(tbl_lo), static_cast<const float*>(tbl_val), tbl_size, probe,
      static_cast<const uint32_t*>(rhi), static_cast<const uint32_t*>(rlo), static_cast<const float*>(rval),
      static_cast<const float*>(rcnt), static_cast<const float*>(rnorms), static_cast<const float*>(rlens),
      static_cast<const int*>(rwlens), static_cast<const float*>(rvalid), static_cast<const float*>(nrefs), R, L,
      ref_len, eos_id, pad_id, bos_id, cider_w, bw0, bw1, bw2, bw3, with_bleu, radix_base, tpw, n_words,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
