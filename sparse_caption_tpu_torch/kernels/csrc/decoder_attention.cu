// K14: the decoder's full-sequence attention, forward.
//
// Replaces: sparse_caption_tpu/models/layers.py:158-172 scaled_dot_attention,
// reached through :217-228 MultiHeadAttention.__call__ from the decoder layers
// (models/transformer.py:95-106: causal self-attention over the caption,
// cross-attention over the regions); left to XLA's fusions on the TPU, no
// Pallas kernel there.
//
// For query row n = b * group + m (head h, position i) and key row b:
//   s[i,j]   = fill(q[n,h,i] . k[b,h,j] / sqrt(dk), valid(i, j), -1e9)
//   valid    = key_valid[b, j] (null: all keys) and, causal, j <= i
//   p        = softmax_j(s);   pd = p * keep[n,h,i,j] / keep_prob (optional dropout)
//   out[n,h,i] = sum_j pd[i,j] v[b,h,j]
// rounded to the compute dtype T where the plain version (ops/attention.py)
// rounds on the card: the product and its scaling, the -1e9 fill, p =
// round(e / sum), the dropout quotient round(p / keep_prob), and the output
// once after f32 sums. A row with no valid key averages every value
// uniformly, as the -1e9 fill makes the plain version do.
//
// Bound on the H100 (8 heads of 64, 17 query positions; the ORT XE step at
// 256 x 5 captions, bf16): bytes. Self-attention (17 keys) reads q, k, v and
// the keep-mask and writes out: 92 MB, 0.027 ms at 3.35 TB/s; cross-attention
// (36 regions, 5 captions per image) reads one K/V row per image: 70 MB,
// 0.021 ms. The products are 0.8 and 1.6 GFLOP.
//
// Design: in bf16 (tensor cores, mma.sync.m16n8k16 with f32 accumulators),
// K15's: a persistent grid of blocks walks the (K/V row, head) units. A
// unit's K, V and the q rows of its whole group (one caption, or an image's
// 5 captions stacked as 85 rows) are copied by 16-byte cp.async into bf16
// rows of 144 bytes, each member's keep flags (Tq x Tk contiguous bytes) by
// 16-byte cp.async where aligned; two stages deep, so the next unit lands
// while this one computes. One 16-row tile of the stacked rows per warp
// (row r is member r / Tq, position r % Tq): S = Q K^T and its softmax come
// from decoder_attention.cuh, the code K15 recomputes P with, so the two
// agree bit for bit. P~ is packed to bf16 from the accumulators as the A
// operand of O = P~ V (V's B fragments by ldmatrix.trans); O goes through
// the warp's own q rows in shared memory and out as 16-byte row stores.
// Padding keys of the last key tile read a shared zero row.
// In f32 (the SCST replay; no TF32), K15's f32 layout: CUDA cores, one block
// per (K/V row, head), K and V staged once in f32 rows of 68 floats (16-byte
// loads), the group's query rows in chunks of whole members (at most 64
// rows). Each warp takes 4 query rows at a time (one when the chunk has fewer
// than 32 rows), so every 16-byte load of a key row feeds 16 FMAs; the
// weighted sum of V reads P~ by 16-byte loads. Each row's dot products and
// sums run in the order of K15's f32 variant.
//
// kv mode (sct_decoder_attention_kv; ACORT's kv-shared decoder layers, where
// V is the K tensor): both kernels stage the one tensor's rows once and read
// them for S = Q K^T and for O = P~ V (the bf16 stage is Tk + group x Tq rows
// instead of 2 Tk + group x Tq).
// Head width 13 (ORT-xsmall): rows staged element by element at width 16,
// columns 13-15 zero (common.cuh kPad), and only the 13 real columns written.
#include "decoder_attention.cuh"
#include "vec.cuh"

namespace sct {

// ------------------------------------------------------------ bf16: tensor cores
constexpr int kMaxTeam = 8;  // warps of a block

// a member's keep flags (Tq x Tk bytes) in a region of this pitch, at the
// offset that keeps them congruent to their global address mod 16
__host__ __device__ inline int keep_pitch(int Tq, int Tk) { return 16 * ((Tq * Tk + 15 + 15) / 16); }
// the unit's stage at head width dk (rows of padded_width(dk) + 8): K (Tk
// rows), V (Tk; not in the kv mode), Q (group * Tq) | keep flags (group regions)
__host__ __device__ inline int fwd_stage_bytes(int dk, int Tq, int Tk, int group, int keep, int kv) {
  return ((kv ? 1 : 2) * Tk + group * Tq) * (padded_width(dk) + 8) * (int)sizeof(bf16) +
         (keep ? group * keep_pitch(Tq, Tk) : 0);
}
// stages | a zero row
inline size_t fwd_smem_bytes(int dk, int Tq, int Tk, int group, int keep, int kv, int stages) {
  return (size_t)stages * fwd_stage_bytes(dk, Tq, Tk, group, keep, kv) + (padded_width(dk) + 8) * sizeof(bf16);
}
// the stages that fit (2, else 1; 0: none)
inline int fwd_stages(int dk, int Tq, int Tk, int group, int keep, int kv) {
  if (fwd_smem_bytes(dk, Tq, Tk, group, keep, kv, 2) <= (size_t)kBlockSmemLimit) return 2;
  return fwd_smem_bytes(dk, Tq, Tk, group, keep, kv, 1) <= (size_t)kBlockSmemLimit ? 1 : 0;
}

// One 16-row tile mt of the unit's stacked rows: S, P, P~ on the
// accumulators, O = P~ V, written through the tile's own q rows.
template <int DK, int KT>
__device__ __forceinline__ void fwd_query_tile(const bf16* ks, const bf16* vs, bf16* qs, const bf16* zero,
                                               const unsigned char* keep_s,
                                               const unsigned char* __restrict__ valid_b,
                                               const unsigned char* __restrict__ keep, float keep_prob,
                                               bf16* __restrict__ out, int b, int h, int H, int Tq, int Tk, int group,
                                               int causal, float sqrt_dk, int mt) {
  constexpr int NS = 2 * KT, LD = kLd<DK>, ND = kPad<DK> / 8;  // ND: output n-tiles over d
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows = group * Tq, kp = keep_pitch(Tq, Tk);
  bool live[2];
  int pos[2];
  const bf16* qr[2];
  const unsigned char* krow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sr = 16 * mt + g + 8 * r;
    live[r] = sr < rows;
    const int m = live[r] ? sr / Tq : 0;
    pos[r] = live[r] ? sr - m * Tq : 0;
    qr[r] = live[r] ? qs + sr * LD : zero;
    const size_t base = (((size_t)b * group + m) * H + h) * Tq * Tk;  // the member's keep flags
    krow[r] = keep_s == nullptr ? nullptr
                                : keep_s + m * kp + (reinterpret_cast<uintptr_t>(keep + base) & 15) + pos[r] * Tk;
  }
  const uint32_t vbits = dec_key_bits<NS>(valid_b, Tk);
  const uint32_t kbits = keep_s == nullptr ? 0xffffffffu : dec_keep_bits<NS>(krow, live, Tk);
  float sacc[NS][4];
  dec_scores_mma<DK, KT>(qr, ks, zero, Tk, sacc);
  dec_softmax_mma<KT>(sacc, vbits, pos, live, Tk, causal, sqrt_dk);
  const float inv_kp = 1.f / keep_prob;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sacc[nt][e] = dec_dropped(sacc[nt][e], ((kbits >> (4 * nt + e)) & 1u) != 0, keep_s != nullptr, keep_prob, inv_kp);
    }
  }
  // O = P~ V: P~'s accumulators as A, V's B fragments by ldmatrix.trans
  float oacc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]), pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                           pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                           pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
    const int j = 16 * kk + (lane & 15);
    const bf16* vr = (j < Tk ? vs + j * LD : zero) + (lane >> 4) * 8;
#pragma unroll
    for (int jn = 0; jn < kPad<DK> / 16; ++jn) {
      uint32_t rr[4];
      ldmatrix_x4_trans(rr, vr + 16 * jn);
      const uint32_t b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
      mma_bf16(oacc[2 * jn], a, b0);
      mma_bf16(oacc[2 * jn + 1], a, b1);
    }
  }
  // the tile's q rows are read: O rounded to bf16 into them, then out by 16-byte row stores
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (live[r]) {
        *reinterpret_cast<uint32_t*>(qs + (16 * mt + g + 8 * r) * LD + 8 * nt + 2 * t) =
            pack_bf16(oacc[nt][2 * r], oacc[nt][2 * r + 1]);
      }
    }
  }
  __syncwarp();
  if constexpr (kNarrow<DK>) {  // the real columns, one element a store
    for (int x = lane; x < 16 * DK; x += 32) {
      const int sr = 16 * mt + x / DK, c = x % DK;
      if (sr < rows) {
        const int m = sr / Tq, i = sr - (sr / Tq) * Tq;
        out[((((size_t)b * group + m) * H + h) * Tq + i) * DK + c] = qs[sr * LD + c];
      }
    }
  } else {
    constexpr int RC = DK / 8;  // 16-byte chunks of a row
#pragma unroll
    for (int x = lane; x < 16 * RC; x += 32) {
      const int sr = 16 * mt + x / RC, part = (x % RC) * 8;
      if (sr < rows) {
        const int m = sr / Tq, i = sr - (sr / Tq) * Tq;
        st16(out + ((((size_t)b * group + m) * H + h) * Tq + i) * DK + part, ld16(qs + sr * LD + part));
      }
    }
  }
}

template <int DK, int KT>
__global__ void __launch_bounds__(32 * kMaxTeam)
decoder_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const unsigned char* __restrict__ key_valid, const unsigned char* __restrict__ keep,
                             float keep_prob, bf16* __restrict__ out, int units, int H, int Tq, int Tk, int group,
                             int causal, float sqrt_dk, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int LD = kLd<DK>, RC = DK / 8, P = kPad<DK>;  // RC: 16-byte chunks of a row
  const int kv = v == nullptr, nkv = kv ? 1 : 2;  // the kv mode stages K alone and reads it as V
  const int rows = group * Tq, sb = fwd_stage_bytes(DK, Tq, Tk, group, keep != nullptr, kv), kp = keep_pitch(Tq, Tk);
  const int row_bytes = (nkv * Tk + rows) * LD * (int)sizeof(bf16);  // K, V, Q of a stage; its keep flags follow
  bf16* zero = reinterpret_cast<bf16*>(smem_raw + (size_t)stages * sb);
  const int team = blockDim.x / 32, warp = threadIdx.x / 32;
  for (int e = threadIdx.x; e < LD; e += blockDim.x) zero[e] = __float2bfloat16_rn(0.f);

  auto issue = [&](int u, int s) {  // unit u into stage s, 16 bytes a copy (the narrow instance: one element a thread)
    const int b = u / H, h = u - (u / H) * H;
    bf16* st = reinterpret_cast<bf16*>(smem_raw + (size_t)s * sb);
    auto row_src = [&](int r) -> const bf16* {  // staged row r: K, V (not in the kv mode), then the group's q rows
      if (r < nkv * Tk) return (r < Tk ? k : v) + (((size_t)b * H + h) * Tk + (r < Tk ? r : r - Tk)) * DK;
      const int sr = r - nkv * Tk, m = sr / Tq, i = sr - (sr / Tq) * Tq;
      return q + ((((size_t)b * group + m) * H + h) * Tq + i) * DK;
    };
    if constexpr (kNarrow<DK>) {
      for (int e = threadIdx.x; e < (nkv * Tk + rows) * P; e += blockDim.x) {
        const int r = e / P, c = e - (e / P) * P;
        st[r * LD + c] = padded_elem<DK>(row_src(r), c);
      }
    } else {
      for (int c = threadIdx.x; c < (nkv * Tk + rows) * RC; c += blockDim.x) {
        const int r = c / RC, part = (c % RC) * 8;
        cp_async<16>(st + r * LD + part, row_src(r) + part);
      }
    }
    if (keep == nullptr) return;
    const int n = Tq * Tk;
    for (int m = 0; m < group; ++m) {  // the member's flags: a head, 16-byte chunks, a tail
      const unsigned char* src = keep + (((size_t)b * group + m) * H + h) * n;
      const int off = (int)(reinterpret_cast<uintptr_t>(src) & 15), head = min((16 - off) & 15, n);
      const int chunks = (n - head) / 16, tail = n - head - 16 * chunks;
      unsigned char* dst = smem_raw + (size_t)s * sb + row_bytes + m * kp + off;
      for (int x = threadIdx.x; x < head + chunks + tail; x += blockDim.x) {
        if (x < head) {
          dst[x] = src[x];
        } else if (x < head + chunks) {
          const int o = head + 16 * (x - head);
          cp_async<16>(dst + o, src + o);
        } else {
          const int o = head + 16 * chunks + (x - head - chunks);
          dst[o] = src[o];
        }
      }
    }
  };

  if (stages == 2 && (int)blockIdx.x < units) issue(blockIdx.x, 0);
  cp_async_commit();
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    int s = 0;
    if (stages == 2) {
      s = it & 1;
      if (u + (int)gridDim.x < units) issue(u + gridDim.x, s ^ 1);  // stage s ^ 1 was freed by the last barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      issue(u, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this unit have landed
    const int b = u / H, h = u - (u / H) * H;
    unsigned char* st = smem_raw + (size_t)s * sb;
    const bf16* ks = reinterpret_cast<const bf16*>(st);
    const bf16* vs = kv ? ks : ks + Tk * LD;
    bf16* qs = reinterpret_cast<bf16*>(st) + nkv * Tk * LD;
    const unsigned char* keep_s = keep == nullptr ? nullptr : st + row_bytes;
    for (int mt = warp; 16 * mt < rows; mt += team) {
      fwd_query_tile<DK, KT>(ks, vs, qs, zero, keep_s, key_valid == nullptr ? nullptr : key_valid + (size_t)b * Tk,
                             keep, keep_prob, out, b, h, H, Tq, Tk, group, causal, sqrt_dk, mt);
    }
    __syncthreads();  // the stage may be overwritten
  }
  cp_async_wait<0>();
}

template <int DK, int KT>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const void* key_valid, const void* keep,
                           float keep_prob, void* out, int Nk, int H, int Tq, int Tk, int group, int causal,
                           float sqrt_dk, cudaStream_t stream) {
  const int kv = v == nullptr;
  const int stages = fwd_stages(DK, Tq, Tk, group, keep != nullptr, kv);
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(DK, Tq, Tk, group, keep != nullptr, kv, stages);
  auto kernel = decoder_attention_mma_kernel<DK, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int mtiles = (group * Tq + 15) / 16;
  const int team = mtiles < kMaxTeam ? mtiles : kMaxTeam;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * team, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int units = Nk * H, cap = sm_count() * per_sm;
  kernel<<<units < cap ? units : cap, 32 * team, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<bf16*>(out), units, H, Tq, Tk, group, causal, sqrt_dk, stages);
  return cudaGetLastError();
}

// ------------------------------------------------------------ f32: CUDA cores
// k_s, v_s (Tk rows; not in the kv mode) | q_s (chunk rows) | pd_s (chunk rows x Tk padded to 4)
template <int DK>
inline size_t f32_fwd_smem_bytes(int Tq, int Tk, int group, int kv) {
  const int cr = f32_chunk_members(Tq, group) * Tq;
  return ((size_t)((kv ? 1 : 2) * Tk + cr) * kF32Ld<DK> + (size_t)cr * f32_tk_pad(Tk)) * sizeof(float);
}

// kRowTile: query rows a warp takes at a time (4, or 1 for chunks of fewer
// than 32 rows, so that all 8 warps share them)
template <int DK, int kRowTile>
__global__ void __launch_bounds__(kF32Threads, kRowTile == 1 ? 4 : 2)
decoder_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const unsigned char* __restrict__ key_valid, const unsigned char* __restrict__ keep,
                             float keep_prob, float* __restrict__ out, int H, int Tq, int Tk, int group, int causal,
                             float sqrt_dk) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int LDF = kF32Ld<DK>;
  const int cm = f32_chunk_members(Tq, group), cr_max = cm * Tq, tkp = f32_tk_pad(Tk);
  float* k_s = fsm;
  float* v_s = v == nullptr ? k_s : k_s + Tk * LDF;  // the kv mode reads the K rows as V
  float* q_s = v_s + Tk * LDF;
  float* pd_s = q_s + cr_max * LDF;  // P~; columns past Tk 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t kv0 = ((size_t)b * H + h) * Tk * DK;
  stage_rows_f32<DK>(k_s, k + kv0, Tk);
  if (v != nullptr) stage_rows_f32<DK>(v_s, v + kv0, Tk);
  const bool v0 = lane < Tk && (key_valid == nullptr || key_valid[(size_t)b * Tk + lane] != 0);
  const bool v1 = lane + 32 < Tk && (key_valid == nullptr || key_valid[(size_t)b * Tk + lane + 32] != 0);

  for (int m0 = 0; m0 < group; m0 += cm) {
    const int members = group - m0 < cm ? group - m0 : cm, cr = members * Tq;
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int m = 0; m < members; ++m) {
      stage_rows_f32<DK>(q_s + m * Tq * LDF, q + (((size_t)b * group + m0 + m) * H + h) * Tq * DK, Tq);
    }
    __syncthreads();
    for (int r0 = kRowTile * warp; r0 < cr; r0 += kRowTile * kF32Warps) {
      float s[kRowTile][2];
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) s[rr][0] = s[rr][1] = 0.f;
      const int r_last = cr - 1;
      const float* kr0 = k_s + (lane < Tk ? lane : 0) * LDF;
      const float* kr1 = k_s + (lane + 32 < Tk ? lane + 32 : 0) * LDF;
      const bool two = Tk > 32;
#pragma unroll 4
      for (int d = 0; d < kPad<DK>; d += 4) {
        const float4 k0 = lds4(kr0 + d);
        const float4 k1 = two ? lds4(kr1 + d) : k0;
#pragma unroll
        for (int rr = 0; rr < kRowTile; ++rr) {
          const float4 qv = lds4(q_s + (r0 + rr < cr ? r0 + rr : r_last) * LDF + d);
          s[rr][0] = dot4(qv, k0, s[rr][0]);
          if (two) s[rr][1] = dot4(qv, k1, s[rr][1]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) {
        const int row = r0 + rr;
        if (row >= cr) break;  // warp-uniform
        const int m = row / Tq, i = row - (row / Tq) * Tq;
        const size_t grow = (((size_t)b * group + m0 + m) * H + h) * Tq + i;
        const bool ok0 = v0 && (!causal || lane <= i), ok1 = v1 && (!causal || lane + 32 <= i);
        const float sv[2] = {lane < Tk ? (ok0 ? div_score(s[rr][0], sqrt_dk) : kNegInf) : -INFINITY,
                             lane + 32 < Tk ? (ok1 ? div_score(s[rr][1], sqrt_dk) : kNegInf) : -INFINITY};
        float p[2];
        dec_softmax(sv, Tk, p);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          const bool kept = j < Tk && (keep == nullptr || keep[grow * Tk + j] != 0);
          if (j < tkp) pd_s[row * tkp + j] = kept ? (keep != nullptr ? p[c] / keep_prob : p[c]) : 0.f;
        }
      }
      __syncwarp();
      // O for the rows: lane owns columns 2 lane, 2 lane + 1 (owns_cols); keys in order
      if (!owns_cols<DK>(lane)) continue;
      float2 acc[kRowTile];
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) acc[rr] = make_float2(0.f, 0.f);
      for (int j = 0; j < tkp; j += 4) {
        float2 vc[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          vc[x] = j + x < Tk ? *reinterpret_cast<const float2*>(v_s + (j + x) * LDF + 2 * lane) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int rr = 0; rr < kRowTile; ++rr) {
          const float4 d4 = lds4(pd_s + (r0 + rr < cr ? r0 + rr : r_last) * tkp + j);
          acc[rr].x = fmaf(d4.w, vc[3].x, fmaf(d4.z, vc[2].x, fmaf(d4.y, vc[1].x, fmaf(d4.x, vc[0].x, acc[rr].x))));
          acc[rr].y = fmaf(d4.w, vc[3].y, fmaf(d4.z, vc[2].y, fmaf(d4.y, vc[1].y, fmaf(d4.x, vc[0].y, acc[rr].y))));
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) {
        const int row = r0 + rr;
        if (row < cr) {
          const int m = row / Tq, i = row - (row / Tq) * Tq;
          const size_t grow = (((size_t)b * group + m0 + m) * H + h) * Tq + i;
          store_col_pair<DK>(out + grow * DK, 2 * lane, acc[rr]);
        }
      }
    }
  }
}

template <int DK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* key_valid, const void* keep,
                       float keep_prob, void* out, int Nk, int H, int Tq, int Tk, int group, int causal, float sqrt_dk,
                       cudaStream_t stream) {
  const size_t smem = f32_fwd_smem_bytes<DK>(Tq, Tk, group, v == nullptr);
  if (smem > (size_t)kBlockSmemLimit) return cudaErrorInvalidValue;
  auto kernel = f32_chunk_members(Tq, group) * Tq >= kWideRows ? decoder_attention_f32_kernel<DK, 4>
                                                               : decoder_attention_f32_kernel<DK, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<Nk * H, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<float*>(out), H, Tq, Tk, group, causal, sqrt_dk);
  return cudaGetLastError();
}

template <int DK>
int entry(int dtype, const void* q, const void* k, const void* v, const void* key_valid, const void* keep,
          float keep_prob, void* out, int Nk, int H, int Tq, int Tk, int group, int causal, float sqrt_dk,
          cudaStream_t s) {
  if (dtype == 0) {
    return (int)launch_f32<DK>(q, k, v, key_valid, keep, keep_prob, out, Nk, H, Tq, Tk, group, causal, sqrt_dk, s);
  }
  if (dtype == 1) {
#define SCT_FWD(KT) \
  launch_fwd_mma<DK, KT>(q, k, v, key_valid, keep, keep_prob, out, Nk, H, Tq, Tk, group, causal, sqrt_dk, s)
    if (Tk <= 16) return (int)SCT_FWD(1);
    if (Tk <= 32) return (int)SCT_FWD(2);
    if (Tk <= 48) return (int)SCT_FWD(3);
    return (int)SCT_FWD(4);
#undef SCT_FWD
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16; dk: 64, 32 or 13. q/out (Nk * group, H,
// Tq, dk); k/v (Nk, H, Tk, dk), every one 16-byte aligned; key_valid (Nk,
// Tk) bool or null (every key valid); keep (Nk * group, H, Tq, Tk) bool or
// null (no dropout) with keep_prob (rounded to the compute dtype by the
// caller); causal: query position i attends keys j <= i; sqrt_dk: the
// scores' divisor, sqrt(dk) rounded to the compute dtype.
namespace sct {
int decoder_attention_entry(int dtype, int dk, const void* q, const void* k, const void* v, const void* key_valid,
                            const void* keep, float keep_prob, void* out, int Nk, int H, int Tq, int Tk, int group,
                            int causal, float sqrt_dk, void* stream) {
  if (Nk < 1 || H < 1 || Tq < 1 || Tq > kDecMaxLen || Tk < 1 || Tk > kDecMaxLen || group < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {q, k, v == nullptr ? k : v, out};
  for (const void* p : ptrs) {
    if (!aligned_to(p, 16)) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_DK(DK) entry<DK>(dtype, q, k, v, key_valid, keep, keep_prob, out, Nk, H, Tq, Tk, group, causal, sqrt_dk, s)
  if (dk == 64) return SCT_DK(64);
  if (dk == 32) return SCT_DK(32);
  if (dk == 13) return SCT_DK(13);
#undef SCT_DK
  return (int)cudaErrorInvalidValue;
}
}  // namespace sct

extern "C" int sct_decoder_attention(int dtype, int dk, const void* q, const void* k, const void* v,
                                     const void* key_valid, const void* keep, float keep_prob, void* out, int Nk,
                                     int H, int Tq, int Tk, int group, int causal, float sqrt_dk, void* stream) {
  if (v == nullptr) return (int)cudaErrorInvalidValue;
  return sct::decoder_attention_entry(dtype, dk, q, k, v, key_valid, keep, keep_prob, out, Nk, H, Tq, Tk, group,
                                      causal, sqrt_dk, stream);
}

// kv mode: kv (Nk, H, Tk, dk) is both K and V, staged once.
extern "C" int sct_decoder_attention_kv(int dtype, int dk, const void* q, const void* kv, const void* key_valid,
                                        const void* keep, float keep_prob, void* out, int Nk, int H, int Tq, int Tk,
                                        int group, int causal, float sqrt_dk, void* stream) {
  return sct::decoder_attention_entry(dtype, dk, q, kv, nullptr, key_valid, keep, keep_prob, out, Nk, H, Tq, Tk,
                                      group, causal, sqrt_dk, stream);
}

// the bf16 kernel's shared memory at head width dk for (Tq, Tk, group,
// keep-mask given, kv mode) at its stage count; 0 if none fits
extern "C" long long sct_decoder_attention_smem(int dk, int Tq, int Tk, int group, int keep, int kv) {
  const int stages = sct::fwd_stages(dk, Tq, Tk, group, keep, kv);
  return stages == 0 ? 0 : (long long)sct::fwd_smem_bytes(dk, Tq, Tk, group, keep, kv, stages);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
