// K2's backward in the ancestry mode (beam-sample SCST): the gradient of
// one decode step of causal self-attention against the K/V cache through
// the beam-ancestry map (row r of image b reads slot t' of row b K +
// anc[b, r, t']), f32, head widths 64, 32 and 13, unshared K and V or in the
// kv mode (ACORT's kv-shared layers). The identity map, the formulas and
// the cache gradient's order are ancestry_self_attention_bwd.cu's; the code
// both share is in ancestry_self_attention_bwd.cuh. A library of its own,
// so that it compiles in parallel with the identity mode.
//
// Replaces: the gradient of sparse_caption_tpu/models/layers.py:320-333
// (the scores and the output through ancestry_onehot), which XLA's autodiff
// derives inside the differentiable beam search of beam-sample SCST
// (engine/training.py:467-468,768-770); left to XLA on the TPU.
//
// Slot t' of row j receives the sum of dk_t' / dv_t' (under kv their sum)
// over the image's rows r with anc[b, r, t'] == j, taken in the order r =
// 0, 1, ..., K - 1 (no atomics; at t' = 0 every beam descends from beam 0,
// so one slot takes K terms).
//
// Bound on the H100: bytes. Only the (row, slot) pairs the map names over
// slots 0..t are read and written back, each once: their cache slots in,
// their gradient slots in and out, and q, dout in and dq, dk_t (, dv_t) out
// a row (chip_smoke.py k2_bwd_anc_bytes counts them on the run's map).
//
// Design: one block per (image, head), a warp per beam row (rows
// past 32 taken in turn). Phase 1 is pass 1 and dq of the identity kernel
// for each row r, reading slot t' from row anc[r, t'], and leaves the row's
// q, dout, p and ds in shared memory. Phase 2 gives each destination row j
// to a warp, which walks the slots and, for each, the image's rows in order,
// summing ds q and p dout of those whose map names j, then updates j's
// gradient buffers as the identity kernel does. The rows' q and dout lead
// the shared memory (float2-aligned at dk 64), then p, ds and the map.
#include "ancestry_self_attention_bwd.cuh"

namespace sct {

template <int DK, int S>
__global__ void ancestry_self_attention_bwd_anc_kernel(
    const float* __restrict__ q, const float* __restrict__ cache_k, const float* __restrict__ cache_v,
    const float* __restrict__ dout, const int* __restrict__ anc, float* __restrict__ dq,
    float* __restrict__ dcache_k, float* __restrict__ dcache_v, float* __restrict__ dk_t, float* __restrict__ dv_t,
    int H, int K, int t_max, int t, float sqrt_dk) {
  using L = LaneDims<DK, float>;
  constexpr int PL = kLaneDims<DK>;
  extern __shared__ __align__(16) float anc_smem[];
  const float* __restrict__ vals = cache_v != nullptr ? cache_v : cache_k;
  const int T1 = t + 1;
  float* q_s = anc_smem;
  float* g_s = q_s + K * DK;
  float* p_s = g_s + K * DK;
  float* ds_s = p_s + K * T1;
  int* map_s = reinterpret_cast<int*>(ds_s + K * T1);
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x / 32;
  for (int i = threadIdx.x; i < K * T1; i += blockDim.x)
    map_s[i] = anc[((size_t)b * K + i / T1) * t_max + i % T1];
  __syncthreads();

  // phase 1: each row's softmax, ds and dq, reading slot t' of row anc[r, t']
  for (int r = warp; r < K; r += nwarps) {
    const size_t qo = (((size_t)b * K + r) * H + h) * DK + PL * lane;
    L qv, gv;
    qv.load(q + qo, lane);
    gv.load(dout + qo, lane);
    qv.store(q_s + r * DK + PL * lane, lane);
    gv.store(g_s + r * DK + PL * lane, lane);
    auto slot = [&](int s) {  // slot s of the row the map names, this lane's dims
      return (((size_t)b * K + map_s[r * T1 + s]) * H + h) * t_max * DK + (size_t)s * DK + PL * lane;
    };
    float p[S], ds[S];
    slot_softmax_grad<DK, S>(qv, gv, cache_k, vals, slot, lane, t, sqrt_dk, p, ds);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j * 32 + lane <= t) {
        p_s[r * T1 + j * 32 + lane] = p[j];
        ds_s[r * T1 + j * 32 + lane] = ds[j];
      }
    }
    L dqa{};
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll 4
      for (int l = 0; l < 32 && j * 32 + l <= t; ++l) {
        const float dss = __shfl_sync(0xffffffffu, ds[j], l);
        L kk;
        kk.load(cache_k + slot(j * 32 + l), lane);
        dqa.add(dss, kk);
      }
    }
    dqa.store(dq + qo, lane);
  }
  __syncthreads();

  // phase 2: each destination row's slots, the readers summed in row order
  for (int jr = warp; jr < K; jr += nwarps) {
    const size_t head = (((size_t)b * K + jr) * H + h) * t_max * DK + PL * lane;
    const size_t to = (((size_t)b * K + jr) * H + h) * DK + PL * lane;
    for (int s = 0; s <= t; ++s) {
      L dkv{}, dvv{};
      bool read = false;
      for (int r = 0; r < K; ++r) {
        if (map_s[r * T1 + s] != jr) continue;
        read = true;
        L qr, gr;
        qr.load(q_s + r * DK + PL * lane, lane);
        gr.load(g_s + r * DK + PL * lane, lane);
        dkv.add(ds_s[r * T1 + s], qr);
        dvv.add(p_s[r * T1 + s], gr);
      }
      if (s < t && !read) continue;  // no row read this slot: its gradient is unchanged
      update_slot<DK>(dcache_k, dcache_v, dk_t, dv_t, head + (size_t)s * DK, to, s == t, dkv, dvv, lane);
    }
  }
}

template <int DK, int S>
cudaError_t launch_anc(const void* q, const void* ck, const void* cv, const void* dout, const void* anc, void* dq,
                       void* dck, void* dcv, void* dkt, void* dvt, int N, int H, int K, int t_max, int t,
                       float sqrt_dk, cudaStream_t stream) {
  const size_t smem = anc_bwd_smem_bytes(DK, K, t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ancestry_self_attention_bwd_anc_kernel<DK, S>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = 32 * (K < 32 ? K : 32);
  ancestry_self_attention_bwd_anc_kernel<DK, S><<<dim3(H, N / K), threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck), static_cast<const float*>(cv),
      static_cast<const float*>(dout), static_cast<const int*>(anc), static_cast<float*>(dq),
      static_cast<float*>(dck), static_cast<float*>(dcv), static_cast<float*>(dkt), static_cast<float*>(dvt), H, K,
      t_max, t, sqrt_dk);
  return cudaGetLastError();
}

// cv == nullptr: the kv mode (dcv, dvt null too)
int entry_anc(int dk, const void* q, const void* ck, const void* cv, const void* dout, const void* anc, void* dq,
              void* dck, void* dcv, void* dkt, void* dvt, int N, int H, int K, int t_max, int t, float sqrt_dk,
              void* stream) {
  if (anc == nullptr || !k2_bwd_args_ok(dk, cv, dcv, dvt, anc, N, H, K, t_max, t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2BA_LAUNCH(DK, S) \
  launch_anc<DK, S>(q, ck, cv, dout, anc, dq, dck, dcv, dkt, dvt, N, H, K, t_max, t, sqrt_dk, s)
  SCT_K2B_DISPATCH(dk, t_max, SCT_K2BA_LAUNCH)
#undef SCT_K2BA_LAUNCH
}

}  // namespace sct

// As sct_ancestry_self_attention_bwd (ancestry_self_attention_bwd.cu), with
// anc (B, K, T_max) int32, N = B K, K >= 1, and the block's shared memory
// (anc_bwd_smem_bytes) within the H100's 227 KB.
extern "C" int sct_ancestry_self_attention_bwd_anc(int dk, const void* q, const void* cache_k, const void* cache_v,
                                                   const void* dout, const void* anc, void* dq, void* dcache_k,
                                                   void* dcache_v, void* dk_t, void* dv_t, int N, int H, int K,
                                                   int t_max, int t, float sqrt_dk, void* stream) {
  if (cache_v == nullptr) return (int)cudaErrorInvalidValue;
  return sct::entry_anc(dk, q, cache_k, cache_v, dout, anc, dq, dcache_k, dcache_v, dk_t, dv_t, N, H, K, t_max, t,
                        sqrt_dk, stream);
}

// The kv mode: cache (N, H, T_max, dk) is K and V; dcache its gradient.
extern "C" int sct_ancestry_self_attention_bwd_anc_kv(int dk, const void* q, const void* cache, const void* dout,
                                                      const void* anc, void* dq, void* dcache, void* dk_t, int N,
                                                      int H, int K, int t_max, int t, float sqrt_dk, void* stream) {
  return sct::entry_anc(dk, q, cache, nullptr, dout, anc, dq, dcache, nullptr, dk_t, nullptr, N, H, K, t_max, t,
                        sqrt_dk, stream);
}

// the ancestry mode's shared memory a block (bytes) at head width dk, K beams and step t
extern "C" long long sct_ancestry_self_attention_bwd_anc_smem(int dk, int K, int t) {
  return (long long)sct::anc_bwd_smem_bytes(dk, K, t);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
