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
// Design: one block of 16 warps per (image, head), so that pass 1 takes
// every sample row at once (15 rows; more rows in turns). The block stages
// the image's K and V rows for the head (the kv mode: one array) at the
// padded width P (common.cuh kPad: 16 at dk 13, its pad columns zero) and
// row pitch P + 4 (lane j reading row j's 16-byte group g hits banks 4 (j
// + g), no conflict in a quarter warp), and every row's q and dout at P, by
// 16-byte cp.async spread over the block; at dk 13 the K and V spans and
// each q and dout row are copied whole over their 16-byte envelopes into a
// raw stage and repacked into the padded rows (as the forward, grouped_cross_attention.cu).
// Pass 1: a warp a row r; lane l holds regions l and l + 32, each score and
// dout . v a dot of four partial sums over the dims d = 4 g + i (chains of
// P / 4 FMAs, then (x + y) + (z + w)); the softmax, D = sum p dp and the
// score gradients as the forward's warp_attend_row lays them out (p = e /
// sum as e times 1 / sum, each lane's terms then the butterfly); p and ds go
// to shared memory. dq: lane l takes the 16-byte group g = l % (P / 4) of
// the dims over the regions j = z, z + Z, ... (z = l / (P / 4), Z = 128 / P
// slices), the slices then added by a butterfly.
// Pass 2: a thread per (region, 16-byte group of dims) of dK and dV over
// the whole block, each summing the image's rows r = 0 .. rep - 1 in that
// order (float4 reads of q and dout, one FMA a row and element), so
// there are no atomics, any rep fits (no tile to divide) and the result
// does not change from run to run; dK, dV, dq and dmem go out as 16-byte
// vectors (dk 13: its 13 real dims by element).
#include <initializer_list>

#include "common.cuh"
#include "vec.cuh"

namespace sct {

constexpr int kCrossBwdThreads = 512;

// the row pitch of staged K and V (floats): the padded width + 4
__host__ __device__ constexpr int cross_bwd_pitch(int dk) { return padded_width(dk) + 4; }
// floats of a raw stage that holds the 16-byte envelope of n f32 elements (dk 13: an offset of at most 12 bytes)
__host__ __device__ constexpr int cross_bwd_raw(int n) { return (4 * n + 12 + 15) / 16 * 4; }

// K and V (one array in the kv mode; S rows each at cross_bwd_pitch(dk)), q
// and dout (rep rows each at padded_width(dk)), at dk 13 the raw stage (the
// K and V spans' envelopes, 16 floats a q and a dout row), p and ds (rep x
// S), f32, and the S region flags
__host__ __device__ inline size_t cross_bwd_smem_bytes(int dk, int S, int rep, bool kv) {
  const int P = padded_width(dk), arrays = kv ? 1 : 2;
  const size_t raw = dk % 4 == 0 ? 0 : (size_t)arrays * cross_bwd_raw(S * dk) + (size_t)2 * rep * 16;
  return ((size_t)arrays * S * cross_bwd_pitch(dk) + (size_t)2 * rep * P + raw + (size_t)2 * rep * S) *
             sizeof(float) + S;
}

// the W (4, or the dims left below DK) real dims of a padded group at column c of a row, as a float4 or by element
template <int DK>
__device__ __forceinline__ void store_group(float* row, int c, float4 v) {
  if constexpr (DK % 4 == 0) {
    *reinterpret_cast<float4*>(row + c) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < DK) row[c + i] = e[i];
  }
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void fma4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// a . b over P padded dims in shared memory: four partial sums, then (x + y) + (z + w)
template <int P>
__device__ __forceinline__ float dot_padded(const float* a, const float* b) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int g = 0; g < P / 4; ++g) {
    const float4 x = lds4(a + 4 * g), y = lds4(b + 4 * g);
    acc.x = fmaf(x.x, y.x, acc.x);
    acc.y = fmaf(x.y, y.y, acc.y);
    acc.z = fmaf(x.z, y.z, acc.z);
    acc.w = fmaf(x.w, y.w, acc.w);
  }
  return (acc.x + acc.y) + (acc.z + acc.w);
}

// mem_v == nullptr: the kv mode (dmk receives dK + dV, dmv unused)
template <int DK>
__global__ void __launch_bounds__(kCrossBwdThreads, 2)
grouped_cross_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ mem_k,
                                   const float* __restrict__ mem_v, const unsigned char* __restrict__ mask,
                                   const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dmk,
                                   float* __restrict__ dmv, int H, int S, int rep, float sqrt_dk) {
  constexpr int P = kPad<DK>, PK = cross_bwd_pitch(DK), G = P / 4, Z = 32 / G;
  extern __shared__ __align__(16) float smem[];
  const bool kv = mem_v == nullptr;
  const int nt = blockDim.x, tid = threadIdx.x, nwarps = nt / 32, warp = tid / 32, lane = tid & 31;
  float* k_s = smem;                                   // S x PK
  float* v_s = kv ? k_s : k_s + S * PK;                // S x PK (K itself in the kv mode)
  float* q_s = k_s + (kv ? 1 : 2) * S * PK;            // rep x P
  float* g_s = q_s + rep * P;                          // rep x P (dout)
  float* raw = g_s + rep * P;                          // dk 13: the envelopes of the K, V spans and the q, dout rows
  const int raw_mem = cross_bwd_raw(S * DK);
  float* p_s = raw + (DK % 4 == 0 ? 0 : (kv ? 1 : 2) * raw_mem + 2 * rep * 16);  // rep x S
  float* ds_s = p_s + rep * S;                         // rep x S
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(ds_s + rep * S);  // S

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t base = ((size_t)b * H + h) * S * DK;
  auto row_q = [&](const float* x, int r) { return x + ((size_t)(b * rep + r) * H + h) * DK; };
  if constexpr (DK % 4 == 0) {  // the rows themselves, 16 bytes a copy
    constexpr int NV = DK / 4;
    for (int i = tid; i < S * NV; i += nt) {
      const int j = i / NV, v = i - j * NV;
      cp_async<16>(k_s + j * PK + 4 * v, mem_k + base + j * DK + 4 * v);
      if (!kv) cp_async<16>(v_s + j * PK + 4 * v, mem_v + base + j * DK + 4 * v);
    }
    for (int i = tid; i < rep * NV; i += nt) {
      const int r = i / NV, v = i - r * NV;
      cp_async<16>(q_s + r * P + 4 * v, row_q(q, r) + 4 * v);
      cp_async<16>(g_s + r * P + 4 * v, row_q(dout, r) + 4 * v);
    }
  } else {  // the envelopes, 16 bytes a copy, into the raw stage
    const int nk = envelope_copies(mem_k + base, S * DK * 4);
    const int nv = kv ? 0 : envelope_copies(mem_v + base, S * DK * 4);
    for (int i = tid; i < nk + nv; i += nt) {
      const bool is_v = i >= nk;
      const int c = is_v ? i - nk : i;
      cp_async<16>(raw + (is_v ? raw_mem : 0) + 4 * c, envelope_lo(is_v ? mem_v + base : mem_k + base) + 16 * c);
    }
    float* raw_q = raw + (kv ? 1 : 2) * raw_mem;
    for (int i = tid; i < rep * 8; i += nt) {
      const int r = i / 8, c = i % 8, v = c % 4;
      const float* src = row_q(c < 4 ? q : dout, r);
      cp_async<16>(raw_q + (c < 4 ? 0 : rep * 16) + r * 16 + 4 * v, envelope_lo(src) + 16 * v);
    }
  }
  for (int e = tid; e < S; e += nt) mask_s[e] = mask[(size_t)b * S + e];
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (DK % 4 != 0) {  // repacked at the padded width, the pad columns zero
    const int ok = envelope_offset(mem_k + base) / 4;
    const int ov = kv ? ok : envelope_offset(mem_v + base) / 4;
    for (int i = tid; i < S * P; i += nt) {
      const int j = i / P, d = i - j * P;
      k_s[j * PK + d] = d < DK ? raw[ok + j * DK + d] : 0.f;
      if (!kv) v_s[j * PK + d] = d < DK ? raw[raw_mem + ov + j * DK + d] : 0.f;
    }
    const float* raw_q = raw + (kv ? 1 : 2) * raw_mem;
    for (int i = tid; i < rep * P; i += nt) {
      const int r = i / P, d = i - r * P;
      q_s[i] = d < DK ? raw_q[r * 16 + envelope_offset(row_q(q, r)) / 4 + d] : 0.f;
      g_s[i] = d < DK ? raw_q[rep * 16 + r * 16 + envelope_offset(row_q(dout, r)) / 4 + d] : 0.f;
    }
    __syncthreads();
  }

  // pass 1: each row's probabilities, score gradients and dq, a warp a row
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
        sc[c] = mask_s[j] != 0 ? div_score(dot_padded<P>(qr, k_s + j * PK), sqrt_dk) : kNegInf;
        dp[c] = dot_padded<P>(gr, v_s + j * PK);
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
    // dq: lane (slice z, group g) sums the regions z, z + Z, ..., then the slices' butterfly
    const int g = lane % G, z = lane / G;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = z; j < S; j += Z) fma4(ds_s[r * S + j], lds4(k_s + j * PK + 4 * g), acc);
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (z == 0) store_group<DK>(dq + ((size_t)(b * rep + r) * H + h) * DK, 4 * g, acc);
  }
  __syncthreads();

  // pass 2: the image's dK and dV (their sum in the kv mode), a thread a (region, group of dims), its rows in order
  for (int e = tid; e < S * G; e += nt) {
    const int j = e / G, g = e - j * G;
    float4 gk = make_float4(0.f, 0.f, 0.f, 0.f), gv = gk;
    for (int r = 0; r < rep; ++r) {
      fma4(ds_s[r * S + j], lds4(q_s + r * P + 4 * g), gk);
      fma4(p_s[r * S + j], lds4(g_s + r * P + 4 * g), gv);
    }
    float* out = dmk + base + (size_t)j * DK;
    if (kv) {
      store_group<DK>(out, 4 * g, make_float4(gk.x + gv.x, gk.y + gv.y, gk.z + gv.z, gk.w + gv.w));
    } else {
      store_group<DK>(out, 4 * g, gk);
      store_group<DK>(dmv + base + (size_t)j * DK, 4 * g, gv);
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
  if (dk % 4 == 0) {  // 16-byte copies and stores
    for (const void* p : std::initializer_list<const void*>{q, mem_k, mem_v, dout, dq, dmk, dmv})
      if (!aligned_to(p, 16)) return (int)cudaErrorInvalidValue;
  }
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
