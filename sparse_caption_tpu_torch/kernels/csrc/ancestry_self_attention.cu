// K2: one decode step of causal self-attention against a K/V cache whose rows
// are never reordered by the beam search (beam-ancestry attention).
//
// Replaces: sparse_caption_tpu/models/layers.py:280-334
// MultiHeadAttention.decode_self, ancestry branch 320-334 (left to XLA on the
// TPU, where the ancestor row is selected by contracting a one-hot map).
//
// For query row n = b*K + k and head h at step t:
//   score[t'] = q[n,h] . cache_k[b*K + anc[b,k,t'], h, t'] / sqrt(dk),  t' <= t
//   out[n,h]  = sum_t' softmax(score)[t'] * cache_v[b*K + anc[b,k,t'], h, t']
// anc == nullptr means the identity map (row n reads itself).
//
// Bound on the H100 (beam 5, 8 heads, dk 64, T_max 17): bytes. At step t the
// step must read the distinct (ancestor row, slot) pairs the map names over
// slots 0..t, K and V: at B = 2048, t = 16 and a uniform random map about
// 3.36 of an image's 5 rows a slot, 240 MB of bf16 (0.07 ms at 3.35 TB/s),
// plus q, out and the map. Slots t' > t are never read (the reference masks
// them to -1e9, whose softmax weight is exactly 0).
//
// Design: two paths, chosen by the step (k2_staged). A step's work is small
// (at most 1,024 slots of one row and head), so what bounds it is a warp's
// chain of dependent reads, its instructions, and how many sectors a read
// touches.
// - The walk (ancestry_self_attention_walk, the design this one replaced, for
//   short rows): a warp per (row, head), lanes over dims, the slots walked
//   one at a time (a shuffle for the row, a dependent read and a butterfly
//   sum a slot). Few instructions a slot, but two round trips a slot.
// - The staged path (rows of k2_staged's length and more): a warp per (row,
//   head), 8 warps a block, each staging its row's slots in its own shared
//   memory, no block barrier. The map first: lanes over slots, each slot's
//   cache row into shared memory (q in f32 beside it). Then the key and
//   value slots (K alone in the kv mode: the one array serves both passes)
//   land by 16-byte cp.async copies, lanes over (slot, 16-byte part), all at
//   once: at dk 64 and 32 a slot is whole 16-byte vectors (128 and 64 bytes
//   in bf16), copied exactly into rows of DK elements + 16 bytes (the 8 lanes
//   of a 16-byte access phase hit distinct banks); at dk 13 a slot is 26
//   bytes (52 in f32) starting only 2-byte aligned, and its 16-byte envelope
//   is copied (2 or 3 copies, vec.cuh envelope_*), the slot read at its
//   offset in it. Two dependent reads in all. Scores from shared memory,
//   lanes over slots with each slot's dims spread over 32 / slots lanes
//   where the row is short (k2_scores); QK^T is a vector-matrix product per
//   beam (one query row against its own keys), so the tensor cores (an M
//   tile of 16 query rows) would idle 15 of 16 rows: SIMT. p v: lanes over
//   dims (2 a lane at dk 64, 1 at 32 and 13). Rows past kK2ChunkSlots slots
//   (32: long caches) are staged in chunks: every chunk's scores (its K
//   slots), the softmax over the whole row, then every chunk's p v (its V
//   slots). The beams of an image stage their shared rows each (L2 serves
//   the repeats; each touched slot comes from memory once).
// On an H100 80GB HBM3 at 700 W (bf16, B = 2048 x 5, t = 16, each in one call
// with the walk alone, 0.1313 ms; PERF.md): a block an (image, head) staging the
// image's slots behind block barriers took 0.1612, lanes over slots reading
// their keys straight from memory 0.1453 (at dk 13 each of 13 reads of 2
// bytes touched a line a slot), and a persistent block pipelined three units
// deep 0.1931 (another call).
// The softmax is the plain version's, rounding point for rounding point: the
// score rounded to T (the product q k^T in T), divided by sqrt(dk) in T
// (common.cuh div_score) and rounded again; then PyTorch's warp softmax over
// the row (rows up to 1024), in its layout: each lane's max over its slots
// j*32 + lane, the butterfly max, e = exp(score - max), each lane's sum of
// its e in slot order, the butterfly sum, p = e / sum rounded to T (the
// scores and weights in shared memory); the output sums p v in f32 and
// rounds once.
// One instance a (dk, dtype): the slot count is a run-time argument.
#include "common.cuh"
#include "vec.cuh"

namespace sct {

constexpr int kK2ChunkSlots = 32;  // slots a warp stages at once
constexpr int kK2BlockWarps = 8;   // (row, head) items a block takes, one warp each

// bytes a staged slot takes: dk elements + 16 where they are whole 16-byte
// vectors, else the envelope of a slot's row
__host__ __device__ constexpr int k2_pitch(int dk, int es) {
  return dk * es % 16 == 0 ? dk * es + 16 : (dk * es + 15) / 16 * 16 + 16;
}

__host__ __device__ constexpr int k2_round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr int k2_round8(int x) { return (x + 7) / 8 * 8; }

// a warp's shared memory at step t: its key and value stages (min(t + 1, kK2ChunkSlots) slots each),
// the row's scores and the slots' cache rows (t + 1 each), q (dk floats), the slots' staged rows'
// offsets (t + 1 of 2 bytes)
__host__ __device__ inline int k2_warp_bytes(int dk, int es, int t) {
  const int cw = t + 1 < kK2ChunkSlots ? t + 1 : kK2ChunkSlots;
  return 2 * cw * k2_pitch(dk, es) + 4 * (2 * k2_round4(t + 1) + k2_round4(dk)) + 2 * k2_round8(t + 1);
}

// The scores of slots [c0, c1) from a stage (slot s's row at st + offs[s]), LS lanes a slot, each its
// ceil(DK / LS) dims from 16-byte, pair or single shared loads as the dims align, the parts summed by
// log2(LS) shuffles, 32 / LS slots a round: a short row takes one round with its dims spread over the
// lanes (the dot's work split, not repeated), a row of 32 slots or more a lane a slot.
template <int DK, typename T, int LS>
__device__ __forceinline__ void k2_scores(const unsigned char* st, const unsigned short* offs, const float* qs,
                                          float* sc, int c0, int c1, float sqrt_dk, int lane) {
  constexpr int ES = sizeof(T), VE = 16 / ES, SD = (DK + LS - 1) / LS;  // dims a lane at most
  constexpr bool kWhole = DK % LS == 0 && DK * ES % 16 == 0;            // every lane SD dims, rows 16-byte aligned
  constexpr bool kVec = kWhole && SD * ES % 16 == 0, kPair = kWhole && !kVec && SD % 2 == 0;
  const int sub = lane % LS, d0 = sub * SD;
  for (int base = c0; base < c1; base += 32 / LS) {
    const int s = base + lane / LS;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four sums in turn: a quarter of the dependent FMAs
    if (s < c1) {
      const T* kr = reinterpret_cast<const T*>(st + offs[s]) + d0;
      const float* qv = qs + d0;
      if constexpr (kVec) {
#pragma unroll
        for (int c = 0; c < SD / VE; ++c) {
          float kf[VE];
          unpack16<T>(ld16(kr + VE * c), kf);
#pragma unroll
          for (int i = 0; i < VE; i += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qv + VE * c + i);
            acc[0] = fmaf(q4.x, kf[i], acc[0]);
            acc[1] = fmaf(q4.y, kf[i + 1], acc[1]);
            acc[2] = fmaf(q4.z, kf[i + 2], acc[2]);
            acc[3] = fmaf(q4.w, kf[i + 3], acc[3]);
          }
        }
      } else if constexpr (kPair) {
#pragma unroll
        for (int c = 0; c < SD / 2; ++c) {
          const float2 kv = load2(kr + 2 * c), q2 = *reinterpret_cast<const float2*>(qv + 2 * c);
          acc[(2 * c) & 3] = fmaf(q2.x, kv.x, acc[(2 * c) & 3]);
          acc[(2 * c + 1) & 3] = fmaf(q2.y, kv.y, acc[(2 * c + 1) & 3]);
        }
      } else {
#pragma unroll
        for (int d = 0; d < SD; ++d) {
          if (d0 + d < DK) acc[d & 3] = fmaf(qv[d], to_f(kr[d]), acc[d & 3]);
        }
      }
    }
    float dot = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
    for (int o = 1; o < LS; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (s < c1 && sub == 0) sc[s] = round_to<T>(div_score(round_to<T>(dot), sqrt_dk));
  }
}

// a block's shared memory: kK2BlockWarps warps
__host__ __device__ inline int k2_smem_bytes(int dk, int es, int t) { return kK2BlockWarps * k2_warp_bytes(dk, es, t); }

// The walk of short rows (t < 32: one slot a lane). Its chain grows by two
// round trips a slot and the staged path's does not, but the staged path
// costs more a warp on a short row: the step from which it is faster was
// measured on an H100 80GB HBM3 at 700 W (bf16, B = 2048 x 5; PERF.md). In
// f32 (the SCST sampling decode's 960 rows, one wave of warps) the walk was
// faster at every step measured at dk 64, so f32 stages only rows past 32
// slots.
template <int DK, typename T>
__global__ void ancestry_self_attention_walk(const T* __restrict__ q, const T* __restrict__ cache_k,
                                             const T* __restrict__ cache_v, const int* __restrict__ anc,
                                             T* __restrict__ out, int H, int t_max, int K, int t, float sqrt_dk) {
  constexpr int PL = kLaneDims<DK>;  // dims a lane holds
  const T* __restrict__ vals = cache_v != nullptr ? cache_v : cache_k;
  const int n = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t qo = ((size_t)n * H + h) * DK + PL * lane;
  LaneDims<DK, T> qv;
  qv.load(q + qo, lane);
  const int b = n / K;
  // lane l holds slot l's cache row and, after the key walk, its score
  const int my_row = anc != nullptr && lane <= t ? b * K + anc[(size_t)n * t_max + lane] : n;
  float my_score = -INFINITY;
  const size_t head = (size_t)h * t_max * DK + PL * lane;
  for (int s = 0; s <= t; ++s) {
    const int r = __shfl_sync(0xffffffffu, my_row, s);
    LaneDims<DK, T> kv;
    kv.load(cache_k + (size_t)r * H * t_max * DK + head + (size_t)s * DK, lane);
    const float sc = round_to<T>(div_score(round_to<T>(warp_sum(qv.dot(kv))), sqrt_dk));
    if (lane == s) my_score = sc;
  }
  const float m = warp_max(my_score);
  const float e = lane <= t ? expf(my_score - m) : 0.f;
  const float p = round_to<T>(e / warp_sum(e));
  LaneDims<DK, T> acc{};
  for (int s = 0; s <= t; ++s) {
    const int r = __shfl_sync(0xffffffffu, my_row, s);
    const float ps = __shfl_sync(0xffffffffu, p, s);
    LaneDims<DK, T> vv;
    vv.load(vals + (size_t)r * H * t_max * DK + head + (size_t)s * DK, lane);
    acc.add(ps, vv);
  }
  acc.store(out + qo, lane);
}

// whether step t stages its row (else the walk): rows past 32 slots always; in bf16 from the step at
// which staging was measured faster, by head width (and the kv mode at 64); in f32 never before
__host__ __device__ inline bool k2_staged(int dk, int es, bool kv, int t) {
  if (t + 1 > kK2ChunkSlots) return true;
  if (es != 2) return false;
  const int from = dk == 64 ? (kv ? 10 : 12) : (dk == 32 ? 7 : 5);
  return t + 1 >= from;
}

// cache_v == nullptr: the kv mode, V read from the K cache
// (32 registers a thread: 8 blocks, 64 warps, an SM where the stages are small)
template <int DK, typename T>
__global__ void __launch_bounds__(32 * kK2BlockWarps, 8)
ancestry_self_attention_kernel(const T* __restrict__ q, const T* __restrict__ cache_k, const T* __restrict__ cache_v,
                               const int* __restrict__ anc, T* __restrict__ out, int N, int H, int t_max, int K, int t,
                               float sqrt_dk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ES = sizeof(T), VE = 16 / ES, RB = DK * ES;  // bytes an element, elements a vector, bytes a slot
  constexpr bool kEnv = RB % 16 != 0;                         // dk 13: a slot's envelope staged
  constexpr int PITCH = k2_pitch(DK, ES), NC = kEnv ? PITCH / 16 : RB / 16;  // copies a slot at most
  constexpr int PL = kLaneDims<DK>;                           // output dims a lane holds
  const T* __restrict__ vals = cache_v != nullptr ? cache_v : cache_k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, item = blockIdx.x * kK2BlockWarps + warp;
  if (item >= N * H) return;
  const int n = item / H, h = item - n * H, T1 = t + 1, b = n / K;
  const int CW = T1 < kK2ChunkSlots ? T1 : kK2ChunkSlots;
  const bool one = T1 <= CW;  // every slot in one stage
  unsigned char* kst = smem + (size_t)warp * k2_warp_bytes(DK, ES, t);
  unsigned char* vst = kst + CW * PITCH;
  float* sc = reinterpret_cast<float*>(vst + CW * PITCH);
  int* rows = reinterpret_cast<int*>(sc + k2_round4(T1));
  float* qs = reinterpret_cast<float*>(rows + k2_round4(T1));
  unsigned short* offs = reinterpret_cast<unsigned short*>(qs + k2_round4(DK));
  // slot s of head h of cache row r
  auto slot = [&](const T* arr, int r, int s) { return arr + (((size_t)r * H + h) * t_max + s) * DK; };
  // slots [c0, c1) of `arr` into stage `st`: lanes over (slot, 16-byte copy)
  auto issue = [&](const T* arr, unsigned char* st, int c0, int c1) {
    for (int e = lane; e < (c1 - c0) * NC; e += 32) {
      const int i = e / NC, c = e - i * NC;
      const T* src = slot(arr, rows[c0 + i], c0 + i);
      if (kEnv && c >= envelope_copies(src, RB)) continue;
      cp_async<16>(st + i * PITCH + 16 * c, envelope_lo(src) + 16 * c);
    }
  };

  for (int s = lane; s < T1; s += 32) rows[s] = anc != nullptr ? b * K + anc[(size_t)n * t_max + s] : n;
  for (int d = lane; d < DK; d += 32) qs[d] = to_f(q[((size_t)n * H + h) * DK + d]);
  __syncwarp();

  // pass 1: the scores, a chunk of slots at a time (V's slots staged with K's where they fit at once)
  for (int c0 = 0; c0 < T1; c0 += CW) {
    const int c1 = min(c0 + CW, T1);
    issue(cache_k, kst, c0, c1);
    if (one && cache_v != nullptr) issue(cache_v, vst, c0, c1);
    cp_async_commit();
    // slot s's row in a stage of slots c0..: the caches are aligned alike, so K's offset serves V's
    for (int s = c0 + lane; s < c1; s += 32) {
      offs[s] = (s - c0) * PITCH + (kEnv ? envelope_offset(slot(cache_k, rows[s], s)) : 0);
    }
    cp_async_wait<0>();
    __syncwarp();  // every lane's copies have landed
    const int n_slots = c1 - c0;  // lanes a slot: as many as leave one round
    if (n_slots > 16) {
      k2_scores<DK, T, 1>(kst, offs, qs, sc, c0, c1, sqrt_dk, lane);
    } else if (n_slots > 8) {
      k2_scores<DK, T, 2>(kst, offs, qs, sc, c0, c1, sqrt_dk, lane);
    } else if (n_slots > 4) {
      k2_scores<DK, T, 4>(kst, offs, qs, sc, c0, c1, sqrt_dk, lane);
    } else if (n_slots > 2) {
      k2_scores<DK, T, 8>(kst, offs, qs, sc, c0, c1, sqrt_dk, lane);
    } else if (n_slots > 1) {
      k2_scores<DK, T, 16>(kst, offs, qs, sc, c0, c1, sqrt_dk, lane);
    } else {
      k2_scores<DK, T, 32>(kst, offs, qs, sc, c0, c1, sqrt_dk, lane);
    }
    __syncwarp();  // the scores are in; the stage may be refilled
  }

  // the softmax of the row, in PyTorch's warp layout
  float m = -INFINITY;
  for (int s = lane; s < T1; s += 32) m = fmaxf(m, sc[s]);
  m = warp_max(m);
  float sum = 0.f;
  for (int s = lane; s < T1; s += 32) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int s = lane; s < T1; s += 32) sc[s] = round_to<T>(sc[s] / sum);
  __syncwarp();

  // pass 2: p v, lanes over dims
  const unsigned char* vsrc = one && cache_v == nullptr ? kst : vst;
  float a0 = 0.f, a1 = 0.f;  // dims PL * lane (and + 1)
  for (int c0 = 0; c0 < T1; c0 += CW) {
    const int c1 = min(c0 + CW, T1);
    if (!one) {
      issue(vals, vst, c0, c1);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
    }
    for (int s = c0; s < c1; ++s) {
      const float ps = sc[s];
      const T* vr = reinterpret_cast<const T*>(vsrc + offs[s]) + PL * lane;
      if constexpr (PL == 2) {
        const float2 v = load2(vr);
        a0 += ps * v.x;
        a1 += ps * v.y;
      } else {
        if (lane < DK) a0 += ps * to_f(*vr);
      }
    }
    if (!one) __syncwarp();  // the stage may be refilled
  }
  T* o = out + ((size_t)n * H + h) * DK + PL * lane;
  if constexpr (PL == 2) {
    store2(o, make_float2(a0, a1));
  } else {
    if (lane < DK) *o = from_f<T>(a0);
  }
}

template <int DK, typename T>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* anc, void* out, int N, int H,
                   int t_max, int K, int t, float sqrt_dk, cudaStream_t stream) {
  if (!k2_staged(DK, sizeof(T), cv == nullptr, t)) {
    if (N == 0) return cudaSuccess;
    ancestry_self_attention_walk<DK, T><<<N, H * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
        static_cast<const int*>(anc), static_cast<T*>(out), H, t_max, K, t, sqrt_dk);
    return cudaGetLastError();
  }
  if (!aligned_to(ck, 16) || !aligned_to(cv, 16)) return cudaErrorInvalidValue;
  const int smem = k2_smem_bytes(DK, sizeof(T), t);
  if (smem > kBlockSmemLimit) return cudaErrorInvalidValue;
  auto kernel = ancestry_self_attention_kernel<DK, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (N == 0) return cudaSuccess;
  const int blocks = (N * H + kK2BlockWarps - 1) / kK2BlockWarps;
  kernel<<<blocks, 32 * kK2BlockWarps, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(ck),
                                                       static_cast<const T*>(cv), static_cast<const int*>(anc),
                                                       static_cast<T*>(out), N, H, t_max, K, t, sqrt_dk);
  return cudaGetLastError();
}

int entry(int dtype, int dk, const void* q, const void* ck, const void* cv, const void* anc, void* out, int N,
          int H, int t_max, int K, int t, float sqrt_dk, void* stream) {
  if (H < 1 || H > 32 || K < 1 || N % K != 0 || t < 0 || t >= t_max || t_max > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2(DK, T) (int)launch<DK, T>(q, ck, cv, anc, out, N, H, t_max, K, t, sqrt_dk, s)
  if (dk == 64 && dtype == 0) return SCT_K2(64, float);
  if (dk == 64 && dtype == 1) return SCT_K2(64, __nv_bfloat16);
  if (dk == 32 && dtype == 0) return SCT_K2(32, float);
  if (dk == 32 && dtype == 1) return SCT_K2(32, __nv_bfloat16);
  if (dk == 13 && dtype == 0) return SCT_K2(13, float);
  if (dk == 13 && dtype == 1) return SCT_K2(13, __nv_bfloat16);
#undef SCT_K2
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16; dk: 64, 32 or 13. q/out (N, H, dk), cache_k/v
// (N, H, T_max, dk), T_max <= 1024, 16-byte aligned; anc (N / K, K, T_max) int32 or
// null; 0 <= t < T_max; sqrt_dk: the scores' divisor, sqrt(dk) rounded to the compute
// dtype.
extern "C" int sct_ancestry_self_attention(int dtype, int dk, const void* q, const void* cache_k, const void* cache_v,
                                           const void* anc, void* out, int N, int H, int t_max, int K, int t,
                                           float sqrt_dk, void* stream) {
  if (cache_v == nullptr) return (int)cudaErrorInvalidValue;
  return sct::entry(dtype, dk, q, cache_k, cache_v, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
}

// kv mode: cache (N, H, T_max, dk) is both K and V.
extern "C" int sct_ancestry_self_attention_kv(int dtype, int dk, const void* q, const void* cache, const void* anc,
                                              void* out, int N, int H, int t_max, int K, int t, float sqrt_dk,
                                              void* stream) {
  return sct::entry(dtype, dk, q, cache, nullptr, anc, out, N, H, t_max, K, t, sqrt_dk, stream);
}

// a block's shared memory at head width dk, element size es and step t (the wrapper's smem_bytes)
extern "C" long long sct_ancestry_self_attention_smem(int dk, int es, int t) { return sct::k2_smem_bytes(dk, es, t); }

// whether step t takes the staged path (1) or the walk (0): the wrapper's staged()
extern "C" long long sct_ancestry_self_attention_staged(int dk, int es, int kv, int t) {
  return sct::k2_staged(dk, es, kv != 0, t) ? 1 : 0;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
