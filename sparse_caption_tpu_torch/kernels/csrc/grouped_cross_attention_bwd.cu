// K3's backward: the gradient of one decode step of cross-attention where
// the `rep` sample rows of an image share that image's projected memory
// K/V (one row per image), f32, head widths 64, 32 and 13, unshared K and V
// or in the kv mode (ACORT's kv-shared layers: one memory array read as K
// and V, sparse_caption_tpu/models/layers.py:244-248, mem_v=None).
//
// Replaces: the gradient of sparse_caption_tpu/models/layers.py:249-264
// MultiHeadAttention.decode_cross (grouped branch), which XLA's autodiff
// derives inside the differentiable decode scan of supermask SCST
// (engine/training.py:769, decoding/sample.py:161-171); left to XLA on the
// TPU.
//
// For image b, head h and its rows n = b*rep + r, with p the forward's
// probabilities (recomputed: scores q . k_s / sqrt(dk), -1e9 where the
// region is masked, softmax) and dout the output's gradient:
//   ds_s  = p_s (dout . v_s - sum_s' p_s' dout . v_s') / sqrt(dk), 0 where masked
//   dq_n  = sum_s ds_s k_s
//   dK_s  = sum_r ds_s(r) q_r          dV_s = sum_r p_s(r) dout_r
// A masked region's score gradient is 0 (the fill's backward), so it gets
// dK = 0; its dV is p dout like any region's: 0 where the image has a
// valid region (p is exactly 0 there), the uniform 1 / S share where it has
// none (every score is the fill, the softmax is uniform). In the kv mode
// the one memory's gradient is dmem_s = dK_s + dV_s.
//
// Bound on the H100: bytes. It must read q and dout (N, H, dk), the memory
// K and V (B, H, S, dk) and the mask, and write dq, dK and dV: at the SCST
// gradient pass (B = 64 images x 15 samples, 8 heads of 64, 36 regions, f32)
// 4 x (3 x 491,520 + 3 x 1,179,648) bytes = 20.1 MB, 0.006 ms at 3.35 TB/s.
//
// Design: one block per (image, head), 4 warps. The block stages the
// image's K and V rows for the head at the padded width (common.cuh kPad:
// 16 at dk 13, its pad columns zero) and row stride kPad + 1 (lane j
// reading row j hits bank (j + d) % 32), and every row's q and dout at the
// padded width, in shared memory; the kv mode stages the memory once and
// reads it as both.
// Pass 1: each warp takes rows r, r + 4, ...: a lane holds the scores of
// regions lane and lane + 32 (as the forward's warp_attend_row), the
// softmax, dout . v, their sum, the score gradients; it stores the row's p
// and ds in shared memory and writes dq (a lane's column pair, common.cuh
// owns_cols). Pass 2: each thread takes (region,
// dim) elements of dK and dV and sums the image's rows r = 0 .. rep - 1 in
// that order, so there are no atomics, any rep fits (no tile to divide),
// and the result does not change from run to run.
#include "common.cuh"

namespace sct {

constexpr int kCrossBwdThreads = 128;

// K and V (one array in the kv mode; S rows each at stride padded_width(dk)
// + 1), q and dout (rep rows each at padded_width(dk)), p and ds (rep x S),
// f32, and the S region flags
__host__ __device__ inline size_t cross_bwd_smem_bytes(int dk, int S, int rep, bool kv) {
  const int P = padded_width(dk);
  return ((size_t)(kv ? 1 : 2) * (P + 1) * S + (size_t)rep * (2 * P + 2 * S)) * sizeof(float) + S;
}

// mem_v == nullptr: the kv mode (dmk receives dK + dV, dmv unused)
template <int DK>
__global__ void __launch_bounds__(kCrossBwdThreads)
grouped_cross_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ mem_k,
                                   const float* __restrict__ mem_v, const unsigned char* __restrict__ mask,
                                   const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dmk,
                                   float* __restrict__ dmv, int H, int S, int rep, float sqrt_dk) {
  constexpr int P = kPad<DK>, KS = kKeyStride<DK>;
  extern __shared__ float smem[];
  const bool kv = mem_v == nullptr;
  const float* v_src = kv ? mem_k : mem_v;
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* k_s = smem;                                   // S x KS
  float* v_s = kv ? k_s : k_s + S * KS;                // S x KS (K itself in the kv mode)
  float* q_s = v_s + S * KS;                           // rep x P
  float* g_s = q_s + rep * P;                          // rep x P (dout)
  float* p_s = g_s + rep * P;                          // rep x S
  float* ds_s = p_s + rep * S;                         // rep x S
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(ds_s + rep * S);  // S

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t base = ((size_t)b * H + h) * S * DK;
  load_tile<DK>(k_s, mem_k + base, S, KS);
  if (!kv) load_tile<DK>(v_s, v_src + base, S, KS);
  for (int e = threadIdx.x; e < rep * P; e += blockDim.x) {
    const int r = e / P, c = e - r * P;
    const size_t o = ((size_t)(b * rep + r) * H + h) * DK;
    q_s[e] = c < DK ? q[o + c] : 0.f;
    g_s[e] = c < DK ? dout[o + c] : 0.f;
  }
  for (int e = threadIdx.x; e < S; e += blockDim.x) mask_s[e] = mask[(size_t)b * S + e];
  __syncthreads();

  // pass 1: each row's probabilities, score gradients and dq
  for (int r = warp; r < rep; r += nwarps) {
    const float* qr = q_s + r * P;
    const float* gr = g_s + r * P;
    float sc[2], dp[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      sc[c] = -INFINITY;
      dp[c] = 0.f;
      if (j < S) {
        const float* kr = k_s + j * KS;
        const float* vr = v_s + j * KS;
        float acc = 0.f, accv = 0.f;
#pragma unroll 16
        for (int d = 0; d < DK; ++d) {
          acc = fmaf(qr[d], kr[d], acc);
          accv = fmaf(gr[d], vr[d], accv);
        }
        sc[c] = mask_s[j] != 0 ? div_score(acc, sqrt_dk) : kNegInf;
        dp[c] = accv;
      }
    }
    const float m = warp_max(fmaxf(sc[0], sc[1]));
    const float e0 = lane < S ? expf(sc[0] - m) : 0.f;
    const float e1 = lane + 32 < S ? expf(sc[1] - m) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    const float p0 = e0 * inv, p1 = e1 * inv;
    const float dsum = warp_sum(p0 * dp[0] + p1 * dp[1]);
    const float pc[2] = {p0, p1};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < S) {
        p_s[r * S + j] = pc[c];
        ds_s[r * S + j] = mask_s[j] != 0 ? div_score(pc[c] * (dp[c] - dsum), sqrt_dk) : 0.f;
      }
    }
    __syncwarp();
    if (owns_cols<DK>(lane)) {
      float2 acc = make_float2(0.f, 0.f);
      for (int j = 0; j < S; ++j) {
        const float ds = ds_s[r * S + j];
        acc.x = fmaf(ds, k_s[j * KS + 2 * lane], acc.x);
        acc.y = fmaf(ds, k_s[j * KS + 2 * lane + 1], acc.y);
      }
      store_col_pair<DK>(dq + ((size_t)(b * rep + r) * H + h) * DK, 2 * lane, acc);
    }
  }
  __syncthreads();

  // pass 2: the image's dK and dV (their sum in the kv mode), its rows summed in order
  for (int e = threadIdx.x; e < S * DK; e += blockDim.x) {
    const int j = e / DK, d = e - j * DK;
    float gk = 0.f, gv = 0.f;
    for (int r = 0; r < rep; ++r) {
      gk = fmaf(ds_s[r * S + j], q_s[r * P + d], gk);
      gv = fmaf(p_s[r * S + j], g_s[r * P + d], gv);
    }
    if (kv) {
      dmk[base + e] = gk + gv;
    } else {
      dmk[base + e] = gk;
      dmv[base + e] = gv;
    }
  }
}

template <int DK>
cudaError_t launch(const void* q, const void* mem_k, const void* mem_v, const void* mask, const void* dout, void* dq,
                   void* dmk, void* dmv, int B, int H, int S, int rep, float sqrt_dk, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(grouped_cross_attention_bwd_kernel<DK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grouped_cross_attention_bwd_kernel<DK><<<B * H, kCrossBwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(mem_k), static_cast<const float*>(mem_v),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dmk), static_cast<float*>(dmv), H, S, rep, sqrt_dk);
  return cudaGetLastError();
}

// mem_v == nullptr: the kv mode
int entry(int dk, const void* q, const void* mem_k, const void* mem_v, const void* mask, const void* dout, void* dq,
          void* dmk, void* dmv, int B, int H, int S, int rep, float sqrt_dk, void* stream) {
  if (B < 1 || H < 1 || S < 1 || S > 64 || rep < 1 || (mem_v == nullptr) != (dmv == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = cross_bwd_smem_bytes(dk, S, rep, mem_v == nullptr);
  if (smem > (size_t)kBlockSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K3B(DK) (int)launch<DK>(q, mem_k, mem_v, mask, dout, dq, dmk, dmv, B, H, S, rep, sqrt_dk, smem, s)
  if (dk == 64) return SCT_K3B(64);
  if (dk == 32) return SCT_K3B(32);
  if (dk == 13) return SCT_K3B(13);
#undef SCT_K3B
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dk: 64, 32 or 13 (f32). q, dout, dq (B * rep, H, dk); mem_k, mem_v, dmk,
// dmv (B, H, S, dk), S <= 64; mask (B, S) bool; sqrt_dk: the scores' divisor.
extern "C" int sct_grouped_cross_attention_bwd(int dk, const void* q, const void* mem_k, const void* mem_v,
                                               const void* mask, const void* dout, void* dq, void* dmk, void* dmv,
                                               int B, int H, int S, int rep, float sqrt_dk, void* stream) {
  if (mem_v == nullptr) return (int)cudaErrorInvalidValue;
  return sct::entry(dk, q, mem_k, mem_v, mask, dout, dq, dmk, dmv, B, H, S, rep, sqrt_dk, stream);
}

// The kv mode: mem (B, H, S, dk) is K and V; dmem its gradient, dK + dV.
extern "C" int sct_grouped_cross_attention_bwd_kv(int dk, const void* q, const void* mem, const void* mask,
                                                  const void* dout, void* dq, void* dmem, int B, int H, int S,
                                                  int rep, float sqrt_dk, void* stream) {
  return sct::entry(dk, q, mem, nullptr, mask, dout, dq, dmem, nullptr, B, H, S, rep, sqrt_dk, stream);
}

// the kernel's shared memory at head width dk for S regions and rep rows an image (kv: 1 = the kv mode)
extern "C" long long sct_grouped_cross_attention_bwd_smem(int dk, int S, int rep, int kv) {
  return (long long)sct::cross_bwd_smem_bytes(dk, S, rep, kv != 0);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
