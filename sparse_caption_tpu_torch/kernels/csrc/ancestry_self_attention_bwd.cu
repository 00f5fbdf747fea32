// K2's backward: the gradient of one decode step of causal self-attention
// against the K/V cache, f32, head width 64, for the identity map (each row
// reads its own cache row; the sampling decode) and, in the ancestry mode,
// through the beam-ancestry map (beam search: row r of image b reads slot t'
// of row b K + anc[b, r, t']).
//
// Replaces: the gradient of sparse_caption_tpu/models/layers.py:317-320
// MultiHeadAttention.decode_self (scaled_dot_attention over the cache with
// the slots t' <= t valid), which XLA's autodiff derives inside the
// differentiable decode scan of supermask SCST (engine/training.py:769,
// decoding/sample.py:161-171), and in the ancestry mode the gradient of
// layers.py:320-333 (the scores and the output through ancestry_onehot),
// which it derives inside the differentiable beam search of beam-sample
// SCST (engine/training.py:467-468,768-770); left to XLA on the TPU.
//
// For row n, head h at step t, with p = softmax(q . k_t' / sqrt(dk)) over
// t' <= t (the forward's, recomputed) and dout the output's gradient:
//   dv_t' = p_t' dout
//   ds_t' = p_t' (dout . v_t' - sum_t'' p_t'' dout . v_t'') / sqrt(dk)
//   dq    = sum_t' ds_t' k_t'           dk_t' = ds_t' q
// where k_t', v_t' are the slots the row read. In the ancestry mode slot t'
// of row j receives the sum of dk_t' / dv_t' over the image's rows r with
// anc[b, r, t'] == j, taken in the order r = 0, 1, ..., K - 1 (no atomics;
// at t' = 0 every beam descends from beam 0, so one slot takes K terms).
// The caller's cache gradient dcache (N, H, T_max, dk; the sum of the later
// steps' contributions, kernels/ancestry_self_attention.py DecodeSelfStep)
// is updated in place: slots t' < t get += dk_t' / dv_t'; slot t's total,
// dcache[t] + this step's dk_t / dv_t, is written to dk_t / dv_t (the
// gradient of the k_t / v_t this step wrote) and slot t is zeroed. The
// division by sqrt(dk) is the plain version's true division (common.cuh
// div_score) of the scores' gradient.
//
// Bound on the H100: bytes. At step t it must read q and dout, the (t + 1)
// cached key and value slots of every row, the (t + 1) slots of both
// gradient buffers, write them back and write dq, dk_t, dv_t: at the SCST
// gradient pass (960 rows, 8 heads of 64, f32) 4 x 491,520 x (5 + 6 (t + 1))
// bytes, 21.6 MB at t = 0 and 210.4 MB at t = 16 (0.006 and 0.063 ms at
// 3.35 TB/s); a few flops a byte. In the ancestry mode only the (row, slot)
// pairs the map names are read and written back (chip_smoke.py
// k2_bwd_anc_bytes counts them on the run's map).
//
// Design: as the forward, one block per row (all heads), one warp per
// (row, head), each lane holding 2 of the 64 dims, and the slot t' = j * 32 +
// lane's score, dout . v and probability in its register j (S = ceil(T_max /
// 32) registers). Pass 1 walks the slots for the scores and dout . v (one
// warp reduction each), then the softmax (the forward's order) and the sum
// D = sum p dout . v (each lane's slots, then the butterfly); pass 2 walks
// them again for dq and each slot's dk / dv, read-modify-writing the
// gradient buffers. A slot's row belongs to one warp, so there are no
// atomics and the result does not change from run to run.
//
// The ancestry mode: one block per (image, head), a warp per beam row (rows
// past 32 taken in turn). Phase 1 is pass 1 and dq of the identity kernel
// for each row r, reading slot t' from row anc[r, t'], and leaves the row's
// q, dout, p and ds in shared memory. Phase 2 gives each destination row j
// to a warp, which walks the slots and, for each, the image's rows in order,
// summing ds q and p dout of those whose map names j, then updates j's
// gradient buffers as the identity kernel does.
#include "common.cuh"

namespace sct {

template <int S>
__global__ void ancestry_self_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ cache_k,
                                                   const float* __restrict__ cache_v, const float* __restrict__ dout,
                                                   float* __restrict__ dq, float* __restrict__ dcache_k,
                                                   float* __restrict__ dcache_v, float* __restrict__ dk_t,
                                                   float* __restrict__ dv_t, int H, int t_max, int t,
                                                   float sqrt_dk) {
  constexpr int DK = 64;
  const int n = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t qo = ((size_t)n * H + h) * DK + 2 * lane;
  const float2 qv = load2(q + qo), gv = load2(dout + qo);
  const size_t head = ((size_t)n * H + h) * t_max * DK + 2 * lane;  // slot 0 of this lane's dims
  float my_score[S], my_dp[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    my_score[j] = -INFINITY;
    my_dp[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const size_t so = head + (size_t)(j * 32 + l) * DK;
      const float2 kv = load2(cache_k + so), vv = load2(cache_v + so);
      const float sc = div_score(warp_sum(qv.x * kv.x + qv.y * kv.y), sqrt_dk);
      const float dp = warp_sum(gv.x * vv.x + gv.y * vv.y);
      if (lane == l) {
        my_score[j] = sc;
        my_dp[j] = dp;
      }
    }
  }
  float m = my_score[0];
#pragma unroll
  for (int j = 1; j < S; ++j) m = fmaxf(m, my_score[j]);
  m = warp_max(m);
  float e[S], sum = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    e[j] = j * 32 + lane <= t ? expf(my_score[j] - m) : 0.f;
    sum += e[j];
  }
  sum = warp_sum(sum);
  float p[S], pdp = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    p[j] = e[j] / sum;
    pdp += p[j] * my_dp[j];
  }
  const float dsum = warp_sum(pdp);
  float ds[S];
#pragma unroll
  for (int j = 0; j < S; ++j) ds[j] = div_score(p[j] * (my_dp[j] - dsum), sqrt_dk);
  float2 dqa = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
      const int s = j * 32 + l;
      const float dss = __shfl_sync(0xffffffffu, ds[j], l);
      const float ps = __shfl_sync(0xffffffffu, p[j], l);
      const size_t so = head + (size_t)s * DK;
      const float2 kv = load2(cache_k + so);
      dqa.x += dss * kv.x;
      dqa.y += dss * kv.y;
      const float2 dkv = make_float2(dss * qv.x, dss * qv.y), dvv = make_float2(ps * gv.x, ps * gv.y);
      const float2 ck = load2(dcache_k + so), cv = load2(dcache_v + so);
      if (s < t) {
        store2(dcache_k + so, make_float2(ck.x + dkv.x, ck.y + dkv.y));
        store2(dcache_v + so, make_float2(cv.x + dvv.x, cv.y + dvv.y));
      } else {  // slot t: the later steps' sum plus this step's, to k_t / v_t; the slot is zeroed
        store2(dk_t + qo, make_float2(ck.x + dkv.x, ck.y + dkv.y));
        store2(dv_t + qo, make_float2(cv.x + dvv.x, cv.y + dvv.y));
        store2(dcache_k + so, make_float2(0.f, 0.f));
        store2(dcache_v + so, make_float2(0.f, 0.f));
      }
    }
  }
  store2(dq + qo, dqa);
}

template <int S>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* dout, void* dq, void* dck, void* dcv,
                   void* dkt, void* dvt, int N, int H, int t_max, int t, float sqrt_dk, cudaStream_t stream) {
  ancestry_self_attention_bwd_kernel<S><<<N, H * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck), static_cast<const float*>(cv),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dck), static_cast<float*>(dcv),
      static_cast<float*>(dkt), static_cast<float*>(dvt), H, t_max, t, sqrt_dk);
  return cudaGetLastError();
}


// dynamic shared memory of the ancestry mode: p, ds and the map's columns
// 0..t of the image's K rows, then their q and dout
__host__ __device__ inline size_t anc_bwd_smem_bytes(int K, int t) {
  return (size_t)K * (t + 1) * 3 * sizeof(float) + (size_t)K * 2 * 64 * sizeof(float);
}

template <int S>
__global__ void ancestry_self_attention_bwd_anc_kernel(
    const float* __restrict__ q, const float* __restrict__ cache_k, const float* __restrict__ cache_v,
    const float* __restrict__ dout, const int* __restrict__ anc, float* __restrict__ dq,
    float* __restrict__ dcache_k, float* __restrict__ dcache_v, float* __restrict__ dk_t, float* __restrict__ dv_t,
    int H, int K, int t_max, int t, float sqrt_dk) {
  constexpr int DK = 64;
  extern __shared__ __align__(16) float anc_smem[];
  const int T1 = t + 1;
  float* p_s = anc_smem;
  float* ds_s = p_s + K * T1;
  int* map_s = reinterpret_cast<int*>(ds_s + K * T1);
  float* q_s = reinterpret_cast<float*>(map_s + K * T1);
  float* g_s = q_s + K * DK;
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x / 32;
  for (int i = threadIdx.x; i < K * T1; i += blockDim.x)
    map_s[i] = anc[((size_t)b * K + i / T1) * t_max + i % T1];
  __syncthreads();

  // phase 1: each row's softmax, ds and dq, reading slot t' of row anc[r, t']
  for (int r = warp; r < K; r += nwarps) {
    const size_t qo = (((size_t)b * K + r) * H + h) * DK + 2 * lane;
    const float2 qv = load2(q + qo), gv = load2(dout + qo);
    q_s[r * DK + 2 * lane] = qv.x;
    q_s[r * DK + 2 * lane + 1] = qv.y;
    g_s[r * DK + 2 * lane] = gv.x;
    g_s[r * DK + 2 * lane + 1] = gv.y;
    auto slot = [&](int s) {  // slot s of the row the map names, this lane's dims
      return (((size_t)b * K + map_s[r * T1 + s]) * H + h) * t_max * DK + (size_t)s * DK + 2 * lane;
    };
    float my_score[S], my_dp[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      my_score[j] = -INFINITY;
      my_dp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
        const size_t so = slot(j * 32 + l);
        const float2 kv = load2(cache_k + so), vv = load2(cache_v + so);
        const float sc = div_score(warp_sum(qv.x * kv.x + qv.y * kv.y), sqrt_dk);
        const float dp = warp_sum(gv.x * vv.x + gv.y * vv.y);
        if (lane == l) {
          my_score[j] = sc;
          my_dp[j] = dp;
        }
      }
    }
    float m = my_score[0];
#pragma unroll
    for (int j = 1; j < S; ++j) m = fmaxf(m, my_score[j]);
    m = warp_max(m);
    float e[S], sum = 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      e[j] = j * 32 + lane <= t ? expf(my_score[j] - m) : 0.f;
      sum += e[j];
    }
    sum = warp_sum(sum);
    float p[S], pdp = 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      p[j] = e[j] / sum;
      pdp += p[j] * my_dp[j];
    }
    const float dsum = warp_sum(pdp);
    float ds[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      ds[j] = div_score(p[j] * (my_dp[j] - dsum), sqrt_dk);
      if (j * 32 + lane <= t) {
        p_s[r * T1 + j * 32 + lane] = p[j];
        ds_s[r * T1 + j * 32 + lane] = ds[j];
      }
    }
    float2 dqa = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
        const float dss = __shfl_sync(0xffffffffu, ds[j], l);
        const float2 kv = load2(cache_k + slot(j * 32 + l));
        dqa.x += dss * kv.x;
        dqa.y += dss * kv.y;
      }
    }
    store2(dq + qo, dqa);
  }
  __syncthreads();

  // phase 2: each destination row's slots, the readers summed in row order
  for (int jr = warp; jr < K; jr += nwarps) {
    const size_t head = (((size_t)b * K + jr) * H + h) * t_max * DK + 2 * lane;
    for (int s = 0; s <= t; ++s) {
      float2 dkv = make_float2(0.f, 0.f), dvv = make_float2(0.f, 0.f);
      bool read = false;
      for (int r = 0; r < K; ++r) {
        if (map_s[r * T1 + s] != jr) continue;
        read = true;
        const float dss = ds_s[r * T1 + s], ps = p_s[r * T1 + s];
        dkv.x += dss * q_s[r * DK + 2 * lane];
        dkv.y += dss * q_s[r * DK + 2 * lane + 1];
        dvv.x += ps * g_s[r * DK + 2 * lane];
        dvv.y += ps * g_s[r * DK + 2 * lane + 1];
      }
      const size_t so = head + (size_t)s * DK;
      if (s < t) {
        if (!read) continue;  // no row read this slot: its gradient is unchanged
        const float2 ck = load2(dcache_k + so), cv = load2(dcache_v + so);
        store2(dcache_k + so, make_float2(ck.x + dkv.x, ck.y + dkv.y));
        store2(dcache_v + so, make_float2(cv.x + dvv.x, cv.y + dvv.y));
      } else {  // slot t: the later steps' sum plus this step's, to k_t / v_t; the slot is zeroed
        const size_t to = (((size_t)b * K + jr) * H + h) * DK + 2 * lane;
        const float2 ck = load2(dcache_k + so), cv = load2(dcache_v + so);
        store2(dk_t + to, make_float2(ck.x + dkv.x, ck.y + dkv.y));
        store2(dv_t + to, make_float2(cv.x + dvv.x, cv.y + dvv.y));
        store2(dcache_k + so, make_float2(0.f, 0.f));
        store2(dcache_v + so, make_float2(0.f, 0.f));
      }
    }
  }
}

template <int S>
cudaError_t launch_anc(const void* q, const void* ck, const void* cv, const void* dout, const void* anc, void* dq,
                       void* dck, void* dcv, void* dkt, void* dvt, int N, int H, int K, int t_max, int t,
                       float sqrt_dk, cudaStream_t stream) {
  const size_t smem = anc_bwd_smem_bytes(K, t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ancestry_self_attention_bwd_anc_kernel<S>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = 32 * (K < 32 ? K : 32);
  ancestry_self_attention_bwd_anc_kernel<S><<<dim3(H, N / K), threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck), static_cast<const float*>(cv),
      static_cast<const float*>(dout), static_cast<const int*>(anc), static_cast<float*>(dq),
      static_cast<float*>(dck), static_cast<float*>(dcv), static_cast<float*>(dkt), static_cast<float*>(dvt), H, K,
      t_max, t, sqrt_dk);
  return cudaGetLastError();
}

}  // namespace sct

// dk: 64 (f32). q, dout, dq, dk_t, dv_t (N, H, dk); cache_k/v and their
// gradients dcache_k/v (N, H, T_max, dk), T_max <= 1024, the gradients
// updated in place; 0 <= t < T_max; sqrt_dk: the scores' divisor.
extern "C" int sct_ancestry_self_attention_bwd(int dk, const void* q, const void* cache_k, const void* cache_v,
                                               const void* dout, void* dq, void* dcache_k, void* dcache_v,
                                               void* dk_t, void* dv_t, int N, int H, int t_max, int t,
                                               float sqrt_dk, void* stream) {
  if (dk != 64 || N < 1 || H < 1 || H > 32 || t < 0 || t >= t_max || t_max > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2B(S) (int)sct::launch<S>(q, cache_k, cache_v, dout, dq, dcache_k, dcache_v, dk_t, dv_t, N, H, t_max, t, \
                                       sqrt_dk, s)
  if (t_max <= 32) return SCT_K2B(1);
  if (t_max <= 64) return SCT_K2B(2);
  if (t_max <= 128) return SCT_K2B(4);
  if (t_max <= 256) return SCT_K2B(8);
  if (t_max <= 512) return SCT_K2B(16);
  return SCT_K2B(32);
#undef SCT_K2B
}

// The ancestry mode: as sct_ancestry_self_attention_bwd, with anc (B, K,
// T_max) int32, N = B K, K >= 1, and the block's shared memory
// (anc_bwd_smem_bytes) within the H100's 227 KB.
extern "C" int sct_ancestry_self_attention_bwd_anc(int dk, const void* q, const void* cache_k, const void* cache_v,
                                                   const void* dout, const void* anc, void* dq, void* dcache_k,
                                                   void* dcache_v, void* dk_t, void* dv_t, int N, int H, int K,
                                                   int t_max, int t, float sqrt_dk, void* stream) {
  if (dk != 64 || K < 1 || N < K || N % K != 0 || H < 1 || t < 0 || t >= t_max || t_max > 1024 ||
      sct::anc_bwd_smem_bytes(K, t) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2BA(S) (int)sct::launch_anc<S>(q, cache_k, cache_v, dout, anc, dq, dcache_k, dcache_v, dk_t, dv_t, N, H, \
                                            K, t_max, t, sqrt_dk, s)
  if (t_max <= 32) return SCT_K2BA(1);
  if (t_max <= 64) return SCT_K2BA(2);
  if (t_max <= 128) return SCT_K2BA(4);
  if (t_max <= 256) return SCT_K2BA(8);
  if (t_max <= 512) return SCT_K2BA(16);
  return SCT_K2BA(32);
#undef SCT_K2BA
}

// the ancestry mode's shared memory a block (bytes) at K beams and step t
extern "C" long long sct_ancestry_self_attention_bwd_anc_smem(int K, int t) {
  return (long long)sct::anc_bwd_smem_bytes(K, t);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
