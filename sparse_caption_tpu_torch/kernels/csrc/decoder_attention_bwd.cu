// K15: the decoder's full-sequence attention, backward.
//
// Replaces: the gradients of sparse_caption_tpu/models/layers.py:158-172
// scaled_dot_attention as :217-228 MultiHeadAttention.__call__ calls it from
// the decoder layers (left to XLA's autodiff fusions on the TPU; no Pallas
// kernel there).
//
// With K14's scores s, probabilities P (recomputed, see Design), the dropout
// Pd = P * keep / keep_prob and the output gradient dO of query row n = b *
// group + m:
//   dPd = dO . V^T;   dP = dPd * keep / keep_prob;   D_i = sum_j P_ij dP_ij
//   dS  = P (dP - D), 0 where the key was masked (the -1e9 fill cuts it off)
//   dQ  = scale dS K;   dK[b] = scale sum over the group's rows of dS^T Q;
//   dV[b] = sum over the group's rows of Pd^T dO
// rounded to T where the plain version's autograd rounds (dPd, dP, dS and its
// scaling, each product's result). D is the row sum of P dP, as PyTorch's
// softmax backward takes it (equal to dO . O in exact arithmetic, without
// reading O). A row with no valid key has dS = 0: its dQ is 0 and it adds
// nothing to dK, only its uniform P to dV.
//
// Bound on the H100 (the ORT XE step at 256 x 5 captions, bf16): bytes. It
// reads q, k, v, dO and the keep-mask and writes dq, dk, dv: 159 MB for the
// self-attention call (17 keys), 0.047 ms at 3.35 TB/s, and 111 MB for the
// cross-attention call (36 regions, one K/V row per image), 0.033 ms. The
// five 17 x Tk x 64 products per (row, head) are 1.9 and 4.0 GFLOP.
//
// Design: one block per (key row, head), as K14: K and V are staged once, and
// the block walks its group's query rows in order (one caption, or the 5
// captions / 15 samples of an image), staging each row's Q and dO. One warp
// per query position recomputes the row's scores and softmax exactly as K14
// does (no saved log-sum-exp: for a row whose keys are all masked, -1e9 +
// log(Tk) rounds to -1e9 in f32 and exp(s - lse) would give P = 1, not
// 1 / Tk), then dP, D, dS into shared memory and the row's dQ. Then each
// thread owns fixed (key, column) elements of dK and dV and adds this
// member's dS^T Q and Pd^T dO to them in shared memory, so the group's sum
// runs in a fixed order with no float atomics and is written once, rounded.
#include "decoder_attention.cuh"

namespace sct {

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decoder_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ dout, const unsigned char* __restrict__ key_valid,
                             const unsigned char* __restrict__ keep, float keep_prob, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk, int group, int causal,
                             float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* k_s = smem;                    // Tk * kDecStride
  float* v_s = k_s + Tk * kDecStride;   // Tk * kDecStride
  float* q_s = v_s + Tk * kDecStride;   // Tq * kDecStride
  float* do_s = q_s + Tq * kDecStride;  // Tq * kDecStride
  float* ds_s = do_s + Tq * kDecStride; // Tq * Tk: scale * dS, masked keys 0
  float* pd_s = ds_s + Tq * Tk;         // Tq * Tk: Pd
  float* dk_s = pd_s + Tq * Tk;         // Tk * kHeadDim
  float* dv_s = dk_s + Tk * kHeadDim;   // Tk * kHeadDim
  unsigned char* valid_s = reinterpret_cast<unsigned char*>(dv_s + Tk * kHeadDim);  // Tk

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t kv_base = ((size_t)b * H + h) * Tk * kHeadDim;
  load_tile(k_s, k + kv_base, Tk, kDecStride);
  load_tile(v_s, v + kv_base, Tk, kDecStride);
  dec_load_valid(valid_s, key_valid, b, Tk);

  for (int m = 0; m < group; ++m) {
    const size_t row0 = ((size_t)(b * group + m) * H + h) * Tq;  // (n, h, 0)
    __syncthreads();  // the previous member's tiles are no longer read
    load_tile(q_s, q + row0 * kHeadDim, Tq, kDecStride);
    load_tile(do_s, dout + row0 * kHeadDim, Tq, kDecStride);
    __syncthreads();
    for (int i = warp; i < Tq; i += kDecWarps) {
      const size_t row = row0 + i;
      const float* qr = q_s + i * kDecStride;
      const float* dr = do_s + i * kDecStride;
      float s[2], p[2], dp[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        ok[c] = j < Tk && dec_key_ok(valid_s, i, j, causal);
        s[c] = j < Tk ? dec_score<T>(qr, k_s + j * kDecStride, scale, ok[c]) : -INFINITY;
      }
      dec_softmax<T>(s, Tk, p);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        dp[c] = 0.f;
        if (j < Tk) {
          const float* vr = v_s + j * kDecStride;
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < kHeadDim; ++d) acc = fmaf(dr[d], vr[d], acc);
          float dpj = round_to<T>(acc), pd = p[c];
          if (keep != nullptr) {
            const bool kept = keep[row * Tk + j] != 0;
            dpj = kept ? round_to<T>(dpj / keep_prob) : 0.f;
            pd = kept ? round_to<T>(pd / keep_prob) : 0.f;
          }
          dp[c] = dpj;
          pd_s[i * Tk + j] = pd;
        }
      }
      const float di = warp_sum(p[0] * dp[0] + p[1] * dp[1]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < Tk) ds_s[i * Tk + j] = ok[c] ? round_to<T>(round_to<T>(p[c] * (dp[c] - di)) * scale) : 0.f;
      }
      __syncwarp();
      float2 acc = make_float2(0.f, 0.f);
      for (int j = 0; j < Tk; ++j) {
        const float dsj = ds_s[i * Tk + j];
        acc.x = fmaf(dsj, k_s[j * kDecStride + 2 * lane], acc.x);
        acc.y = fmaf(dsj, k_s[j * kDecStride + 2 * lane + 1], acc.y);
      }
      store2(dq + row * kHeadDim + 2 * lane, acc);
    }
    __syncthreads();
    // dK, dV: thread-owned (key, column) elements, members added in order
    for (int e = threadIdx.x; e < Tk * kHeadDim; e += blockDim.x) {
      const int j = e / kHeadDim, col = e - (e / kHeadDim) * kHeadDim;
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < Tq; ++i) {
        ak = fmaf(ds_s[i * Tk + j], q_s[i * kDecStride + col], ak);
        av = fmaf(pd_s[i * Tk + j], do_s[i * kDecStride + col], av);
      }
      dk_s[e] = m == 0 ? ak : dk_s[e] + ak;
      dv_s[e] = m == 0 ? av : dv_s[e] + av;
    }
  }
  // each thread wrote its own elements of dk_s / dv_s: no barrier needed
  for (int e = threadIdx.x; e < Tk * kHeadDim; e += blockDim.x) {
    dk[kv_base + e] = from_f<T>(dk_s[e]);
    dv[kv_base + e] = from_f<T>(dv_s[e]);
  }
}

inline size_t bwd_smem_bytes(int Tq, int Tk) {
  const size_t floats = 2 * (size_t)(Tk + Tq) * kDecStride + 2 * (size_t)Tq * Tk + 2 * (size_t)Tk * kHeadDim;
  return floats * sizeof(float) + Tk;
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* key_valid,
                       const void* keep, float keep_prob, void* dq, void* dk, void* dv, int Nk, int H, int Tq,
                       int Tk, int group, int causal, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(Tq, Tk);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decoder_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decoder_attention_bwd_kernel<T><<<Nk * H, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const unsigned char*>(key_valid), static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, group, causal, scale);
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. q, dout, dq (Nk * group, H, Tq, 64); k, v,
// dk, dv (Nk, H, Tk, 64); key_valid, keep, keep_prob, causal and scale as
// sct_decoder_attention took them.
extern "C" int sct_decoder_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* dout,
                                         const void* key_valid, const void* keep, float keep_prob, void* dq,
                                         void* dk, void* dv, int Nk, int H, int Tq, int Tk, int group, int causal,
                                         float scale, void* stream) {
  if (Nk < 1 || H < 1 || Tq < 1 || Tq > sct::kDecMaxLen || Tk < 1 || Tk > sct::kDecMaxLen || group < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)sct::launch_bwd<float>(q, k, v, dout, key_valid, keep, keep_prob, dq, dk, dv, Nk, H, Tq, Tk, group,
                                       causal, scale, s);
  }
  if (dtype == 1) {
    return (int)sct::launch_bwd<__nv_bfloat16>(q, k, v, dout, key_valid, keep, keep_prob, dq, dk, dv, Nk, H, Tq, Tk,
                                               group, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
