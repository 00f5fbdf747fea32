// K7: ORT box-relation self-attention, backward.
//
// Replaces: the gradients of sparse_caption_tpu/models/layers.py:338-365
// box_relational_embedding and :406-439 BoxMultiHeadAttention.__call__ (left to
// XLA's autodiff fusions on the TPU; no Pallas kernel there).
//
// With S = fill(q.k * scale, mask, -1e9) + log(w_g), P = softmax(S) (from the
// forward's saved f32 log-sum-exp), Pd = P * keep / keep_prob and O = Pd.V:
//   dV = Pd^T dO;  dP = (dO.V^T) * keep / keep_prob;  D_i = dO_i . O_i
//   dS = P (dP - D);  dQ = scale dS_unmasked K;  dK = scale dS_unmasked^T Q
//   d log(w_g) = dS;  dz = dS / w_g where w_g = relu(z) > 1e-6, else 0
//   d wg_w[h, g] = sum over images and pairs of dz[h] * geo[g]; d wg_b[h] = sum dz[h]
// with K1's cast points (trig in f32, geometry rounded to T before wg; w_g and
// its log in T); the rest of the arithmetic in f32, results rounded to T.
// The gradient of log(max(relu(z), 1e-6)) is 1/z above the clamp: as
// ill-conditioned at the kink as K1's forward, though P = z exp(qk) / sum
// keeps dS / z bounded.
//
// Bound on the H100: bytes or sincosf. At batch 256, f32, it reads q, k, v, O,
// dO (5 x 256 x 8 x 36 x 64 x 4 B = 94 MB) and writes dq, dk, dv (57 MB):
// 0.045 ms at 3.35 TB/s. It recomputes the geometry twice per image (2 x 1296
// pairs x 32 sincosf), as K1 computes it once.
//
// Design: one block per image over all heads, as K1. Phase A recomputes the
// (h, R, R) clamped w_g into shared memory; phase B, head by head, stages q,
// k, v, dO in shared memory, and each warp takes one query row: scores, P,
// dS (kept in shared memory), dz (overwriting w_g) and dq; after a barrier
// each warp takes one key row for dk and dv. Phase C recomputes the trig
// features pair by pair, one (coordinate, frequency) per lane, and
// accumulates dz * geo for every head in registers; the block's warps fold in
// a fixed order and write one (h, 65) partial per image, which a second kernel
// sums over images in order. The (B, R, R, 64) geometry never leaves the SM,
// and no float atomics are used.
#include "box_geometry.cuh"

namespace sct {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kStride = kHeadDim + 1;  // odd row stride: conflict-free column walks

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
box_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ boxes, const T* __restrict__ wg_w, const T* __restrict__ wg_b,
                         const float* __restrict__ freq, const unsigned char* __restrict__ mask,
                         const unsigned char* __restrict__ keep, float keep_prob, T* __restrict__ dq,
                         T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ wg_partial, int H, int R,
                         float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* wz_s = smem;                  // H * R * R: w_g, then dz
  float* q_s = wz_s + H * R * R;       // R * kStride
  float* k_s = q_s + R * kStride;      // R * kStride
  float* v_s = k_s + R * kStride;      // R * kStride
  float* do_s = v_s + R * kStride;     // R * kStride
  float* ds_s = do_s + R * kStride;    // R * R: dS with padded keys zeroed
  float* pd_s = ds_s + R * R;          // R * R: P * keep / keep_prob
  float* box_s = pd_s + R * R;         // R * 4
  float* w_s = box_s + R * 4;          // H * 64
  float* wb_s = w_s + H * 64;          // H
  float* freq_s = wb_s + H;            // kFreqs
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(freq_s + kFreqs);  // R

  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < R * 4; e += blockDim.x) box_s[e] = boxes[(size_t)b * R * 4 + e];
  for (int e = threadIdx.x; e < H * 64; e += blockDim.x) w_s[e] = to_f(wg_w[e]);
  for (int e = threadIdx.x; e < H; e += blockDim.x) wb_s[e] = to_f(wg_b[e]);
  for (int e = threadIdx.x; e < kFreqs; e += blockDim.x) freq_s[e] = freq[e];
  for (int e = threadIdx.x; e < R; e += blockDim.x) mask_s[e] = mask[(size_t)b * R + e];
  __syncthreads();

  // phase A: clamped w_g of every (head, i, j)
  for (int p = threadIdx.x; p < R * R; p += blockDim.x) {
    const int i = p / R, j = p - (p / R) * R;
    float wg[kMaxHeads];
    pair_wg<T>(box_s + 4 * i, box_s + 4 * j, w_s, wb_s, freq_s, H, wg);
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh < H) wz_s[hh * R * R + p] = wg[hh];
    }
  }

  // phase B: per head, dq row by row, then dk / dv row by row
  const float min_wg = round_to<T>(1e-6f);
  for (int hh = 0; hh < H; ++hh) {
    const size_t base = ((size_t)b * H + hh) * R * kHeadDim;
    __syncthreads();  // w_g done / the previous head's tiles no longer read
    load_tile(q_s, q + base, R, kStride);
    load_tile(k_s, k + base, R, kStride);
    load_tile(v_s, v + base, R, kStride);
    load_tile(do_s, dout + base, R, kStride);
    __syncthreads();
    float* wz = wz_s + hh * R * R;
    for (int i = warp; i < R; i += kBwdWarps) {
      const size_t row = ((size_t)b * H + hh) * R + i;
      const float2 ov = load2(o + base + (size_t)i * kHeadDim + 2 * lane);
      const float di = warp_sum(ov.x * do_s[i * kStride + 2 * lane] + ov.y * do_s[i * kStride + 2 * lane + 1]);
      const float lse_i = lse[row];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < R) {
          const float* qr = q_s + i * kStride;
          const float* kr = k_s + j * kStride;
          const float* dr = do_s + i * kStride;
          const float* vr = v_s + j * kStride;
          float acc = 0.f, dpd = 0.f;
#pragma unroll 16
          for (int d = 0; d < kHeadDim; ++d) {
            acc = fmaf(qr[d], kr[d], acc);
            dpd = fmaf(dr[d], vr[d], dpd);
          }
          float s = acc * scale;
          if (mask_s[j] == 0) s = kNegInf;
          const float w = wz[i * R + j];
          s += round_to<T>(logf(w));
          const float p = expf(s - lse_i);
          const bool kept = keep == nullptr || keep[row * R + j] != 0;
          const float dp = kept ? dpd / keep_prob : 0.f;
          const float ds = p * (dp - di);
          pd_s[i * R + j] = kept ? p / keep_prob : 0.f;
          ds_s[i * R + j] = mask_s[j] ? ds : 0.f;
          wz[i * R + j] = w > min_wg ? ds / w : 0.f;
        }
      }
      __syncwarp();
      float2 acc = make_float2(0.f, 0.f);
      for (int j = 0; j < R; ++j) {
        const float ds = ds_s[i * R + j];
        acc.x = fmaf(ds, k_s[j * kStride + 2 * lane], acc.x);
        acc.y = fmaf(ds, k_s[j * kStride + 2 * lane + 1], acc.y);
      }
      store2(dq + base + (size_t)i * kHeadDim + 2 * lane, make_float2(acc.x * scale, acc.y * scale));
    }
    __syncthreads();
    for (int j = warp; j < R; j += kBwdWarps) {
      float2 ak = make_float2(0.f, 0.f), av = make_float2(0.f, 0.f);
      for (int i = 0; i < R; ++i) {
        const float ds = ds_s[i * R + j], pd = pd_s[i * R + j];
        ak.x = fmaf(ds, q_s[i * kStride + 2 * lane], ak.x);
        ak.y = fmaf(ds, q_s[i * kStride + 2 * lane + 1], ak.y);
        av.x = fmaf(pd, do_s[i * kStride + 2 * lane], av.x);
        av.y = fmaf(pd, do_s[i * kStride + 2 * lane + 1], av.y);
      }
      store2(dk + base + (size_t)j * kHeadDim + 2 * lane, make_float2(ak.x * scale, ak.y * scale));
      store2(dv + base + (size_t)j * kHeadDim + 2 * lane, av);
    }
  }
  __syncthreads();

  // phase C: d wg partials. Lane = (coordinate c, frequency f); warp = pair slice.
  const int c = lane / kFreqs, f = lane % kFreqs;
  float acc_s[kMaxHeads], acc_c[kMaxHeads], acc_b[kMaxHeads];
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) acc_s[hh] = acc_c[hh] = acc_b[hh] = 0.f;
  for (int p = warp; p < R * R; p += kBwdWarps) {
    const int i = p / R, j = p - (p / R) * R;
    float pos[4];
    pair_deltas(box_s + 4 * i, box_s + 4 * j, pos);
    float sn, cs;
    trig_feature<T>(pos[c], freq_s[f], sn, cs);
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh < H) {
        const float dz = wz_s[hh * R * R + p];
        acc_s[hh] = fmaf(dz, sn, acc_s[hh]);
        acc_c[hh] = fmaf(dz, cs, acc_c[hh]);
        acc_b[hh] += dz;
      }
    }
  }
  // fold the warps in order into (H, 65) = [sin features 0..31 | cos 32..63 | bias]
  float* fold = q_s;  // H * 65 floats; q_s and what follows it are free once all warps are here
  __syncthreads();
  for (int w = 0; w < kBwdWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) {
        if (hh < H) {
          float* fr = fold + hh * 65;
          fr[lane] = (w == 0 ? 0.f : fr[lane]) + acc_s[hh];
          fr[32 + lane] = (w == 0 ? 0.f : fr[32 + lane]) + acc_c[hh];
          if (lane == 0) fr[64] = (w == 0 ? 0.f : fr[64]) + acc_b[hh];
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < H * 65; e += blockDim.x) wg_partial[(size_t)b * H * 65 + e] = fold[e];
}

// d wg_w (H, 64) and d wg_b (H,): sums of the per-image partials, in image order
template <typename T>
__global__ void wg_reduce_kernel(const float* __restrict__ partial, int B, int H, T* __restrict__ dwg_w,
                                 T* __restrict__ dwg_b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * 65) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += partial[(size_t)b * H * 65 + e];
  const int hh = e / 65, g = e - hh * 65;
  if (g < 64) dwg_w[hh * 64 + g] = from_f<T>(acc);
  else dwg_b[hh] = from_f<T>(acc);
}

inline size_t bwd_smem_bytes(int H, int R) {
  const size_t floats = (size_t)H * R * R + 4 * (size_t)R * kStride + 2 * (size_t)R * R + (size_t)R * 4 +
                        (size_t)H * 64 + H + kFreqs;
  return floats * sizeof(float) + R;
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                       const void* boxes, const void* wg_w, const void* wg_b, const void* freq, const void* mask,
                       const void* keep, float keep_prob, void* dq, void* dk, void* dv, void* dwg_w, void* dwg_b,
                       void* partial, int B, int H, int R, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(H, R);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(box_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  box_attention_bwd_kernel<T><<<B, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(boxes),
      static_cast<const T*>(wg_w), static_cast<const T*>(wg_b), static_cast<const float*>(freq),
      static_cast<const unsigned char*>(mask), static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(partial), H, R, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wg_reduce_kernel<T><<<(H * 65 + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(partial), B, H,
                                                                static_cast<T*>(dwg_w), static_cast<T*>(dwg_b));
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq, dk, dv (B, H, R, 64);
// lse (B, H, R) f32 from sct_box_attention_train; boxes (B, R, 4) f32; wg_w
// (H, 64), wg_b (H,), dwg_w, dwg_b in the compute dtype; freq (8,) f32; mask
// (B, R) bool; keep (B, H, R, R) bool or null; partial (B, H, 65) f32 scratch.
extern "C" int sct_box_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, const void* boxes, const void* wg_w,
                                     const void* wg_b, const void* freq, const void* mask, const void* keep,
                                     float keep_prob, void* dq, void* dk, void* dv, void* dwg_w, void* dwg_b,
                                     void* partial, int B, int H, int R, float scale, void* stream) {
  if (H < 1 || H > sct::kMaxHeads || R < 1 || R > 64 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)sct::launch_bwd<float>(q, k, v, o, dout, lse, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, dq, dk,
                                       dv, dwg_w, dwg_b, partial, B, H, R, scale, s);
  }
  if (dtype == 1) {
    return (int)sct::launch_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, boxes, wg_w, wg_b, freq, mask, keep, keep_prob,
                                               dq, dk, dv, dwg_w, dwg_b, partial, B, H, R, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
