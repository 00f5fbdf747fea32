// K15: the decoder's full-sequence attention, backward.
//
// Replaces: the gradients of sparse_caption_tpu/models/layers.py:158-172
// scaled_dot_attention as :217-228 MultiHeadAttention.__call__ calls it from
// the decoder layers (left to XLA's autodiff fusions on the TPU; no Pallas
// kernel there).
//
// With K14's scores s, probabilities P (recomputed, see Design), the dropout
// P~ = P * keep / keep_prob and the output gradient dO of query row n = b *
// group + m, and round() the rounding to the compute dtype T where the plain
// version's autograd on the card rounds (a no-op in f32):
//   dPd = round(dO V^T);  dP = round(dPd * keep / keep_prob)
//   g = round(dP P);  D_i = sum_j g_ij;  dS = round(g - P D)   (PyTorch's CUDA softmax
//   backward: the product rounded to T first, then f32), 0 where the key was
//   masked (the -1e9 fill cuts it off)
//   dQ = round(round(dS / sqrt_dk) K)   (sqrt_dk: sqrt(dk) rounded to T, the forward's divisor)
//   dK[b] = round(sum over the group's members m, in order, of round(round(dS_m / sqrt_dk)^T Q_m))
//   dV[b] = round(sum over the group's members m, in order, of round(P~_m^T dO_m))
// The plain version repeats K and V to the query rows, so autograd rounds
// each member's product and sums the copies in f32. A row with no valid key
// has dS = 0: its dQ is 0 and it adds nothing to dK, only its uniform P to dV.
//
// Bound on the H100 (the ORT XE step at 256 x 5 captions, bf16): bytes. It
// reads q, k, v, dO and the keep-mask and writes dq, dk, dv: 159 MB for the
// self-attention call (17 keys), 0.047 ms at 3.35 TB/s, and 111 MB for the
// cross-attention call (36 regions, one K/V row per image), 0.033 ms. The
// five 17 x Tk x 64 products per (row, head) are 1.9 and 4.0 GFLOP, little
// on the tensor cores.
//
// Design: in bf16 (tensor cores, mma.sync.m16n8k16 with f32 accumulators),
// a persistent grid of blocks, one team of warps a block, walks the (K/V row,
// head) units. A unit's K, V and the q and dO rows of its whole group (one
// caption, or an image's 5 captions stacked as 85 rows) are copied by 16-byte
// cp.async into bf16 rows of 144 bytes (ldmatrix rows in distinct banks),
// two stages deep: the next unit lands while this one computes. Query side,
// one 16-row tile of the stacked rows per warp: S = Q K^T and dPd = dO V^T on
// the tensor cores, the softmax recomputed on the accumulators by K14's own
// code (decoder_attention.cuh: the same P, bit for bit; no saved
// log-sum-exp: for a row whose keys are all masked,
// -1e9 + log(Tk) rounds to -1e9 in f32 and exp(s - lse) would give P = 1,
// not 1 / Tk), dS in registers, dQ = dS K with dS's accumulators as the A
// operand; dS and P~ go to shared memory in bf16, each member's rows in a
// block of 16-aligned rows of its own. Key side, one (16 keys, dK or dV) tile per
// warp: each member's dS_m^T Q_m (or P~_m^T dO_m) contracts over that
// member's rows alone, is rounded to bf16 and added in member order to f32
// sums kept in registers, so the group's sum needs no float atomics and no
// walk over members with a barrier each. Padding rows and keys read one
// shared zero row.
// In f32 (the SCST replay; no TF32): CUDA cores, one block per (K/V
// row, head), K and V staged once in f32 rows of 68 floats (16-byte loads,
// 8 lanes in distinct banks); the group's query rows in chunks of whole
// members (at most 64 rows). Each warp takes 4 query rows at a time (one
// when the chunk has fewer than 32 rows, so that all 8 warps share them), so
// every 16-byte load of a key or value row feeds 16 FMAs; then each thread
// owns 2 keys x 4 columns of dK and dV across the chunks and reads q, dO, dS
// and P~ by 8- and 16-byte loads.
//
// kv mode (sct_decoder_attention_bwd_kv; ACORT's kv-shared decoder layers, V
// is the K tensor): the stages hold K, Q and dO (K read as V in dPd = dO
// V^T), and the key side writes one gradient,
//   dKV[b] = round(round(dK[b]) + round(dV[b])),
// dK and dV each summed over the members and rounded as above, then added:
// the plain version passes the tensor as k and as v, and autograd rounds each
// use's gradient to T before it adds the two (in f32, dK + dV). Adding in f32
// and rounding once differs in the last bit. A bf16 key-side item takes both
// products of its 16 keys.
// Head width 13 (ORT-xsmall): rows staged element by element at width 16,
// columns 13-15 zero (common.cuh kPad), and only the 13 real columns of dQ,
// dK, dV (dKV) written.
#include "decoder_attention.cuh"
#include "vec.cuh"

namespace sct {

// ------------------------------------------------------------ bf16: tensor cores
constexpr int kMaxTeam = 8;  // warps of a block

// the unit's stage at head width dk (rows of padded_width(dk) + 8): K (Tk
// rows), V (Tk; not in the kv mode), Q (group * Tq), dO (group * Tq)
__host__ __device__ inline int stage_elems(int dk, int Tq, int Tk, int group, int kv) {
  return ((kv ? 1 : 2) * Tk + 2 * group * Tq) * (padded_width(dk) + 8);
}
__host__ __device__ inline int member_cols(int Tq) { return 16 * ((Tq + 15) / 16); }
__host__ __device__ inline int ds_ld(int Tk) { return 16 * ((Tk + 15) / 16) + 8; }  // keys padded to 16, + 8

// stages | a zero row | dS and P~ (group x member_cols rows of ds_ld each)
inline size_t mma_smem_bytes(int dk, int Tq, int Tk, int group, int kv, int stages) {
  return ((size_t)stages * stage_elems(dk, Tq, Tk, group, kv) + (padded_width(dk) + 8) +
          2 * (size_t)group * member_cols(Tq) * ds_ld(Tk)) *
         sizeof(bf16);
}

// Query side of one 16-row tile mt of the unit's stacked rows (row sr is
// member sr / Tq, position sr % Tq): dS and P~ into dS_s / P_s (row
// member * qp + position, keys along the row), dQ to global.
template <int DK, int KT>
__device__ __forceinline__ void query_tile_mma(const bf16* ks, const bf16* vs, const bf16* qs, const bf16* dos,
                                               const bf16* zero, bf16* ds_s, bf16* p_s, int qp,
                                               const unsigned char* __restrict__ valid_b,
                                               const unsigned char* __restrict__ keep, float keep_prob,
                                               bf16* __restrict__ dq, int b, int h, int H, int Tq, int Tk, int group,
                                               int causal, float sqrt_dk, int mt) {
  constexpr int NS = 2 * KT, LD = kLd<DK>, ND = kPad<DK> / 8;  // ND: dQ's n-tiles over d
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows = group * Tq;
  bool live[2];
  int mem[2], pos[2];
  size_t grow[2];  // (n, h, i) row index of q / dO / dq
  const bf16* qr[2];
  const bf16* dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sr = 16 * mt + g + 8 * r;
    live[r] = sr < rows;
    mem[r] = live[r] ? sr / Tq : 0;
    pos[r] = live[r] ? sr - mem[r] * Tq : 0;
    grow[r] = (((size_t)b * group + mem[r]) * H + h) * Tq + pos[r];
    qr[r] = live[r] ? qs + sr * LD : zero;
    dr[r] = live[r] ? dos + sr * LD : zero;
  }
  // rows g + 8 of the tile hold a live row (warp-uniform); else their elementwise work is skipped
  const bool half1 = 16 * mt + 8 < rows;
  // the flags this lane needs, read before the products (decoder_attention.cuh)
  const uint32_t vbits = dec_key_bits<NS>(valid_b, Tk);
  uint32_t kbits = 0xffffffffu;
  if (keep != nullptr) {
    const unsigned char* krow[2] = {keep + grow[0] * Tk, keep + grow[1] * Tk};
    kbits = dec_keep_bits<NS>(krow, live, Tk);
  }
  const int nsv = (Tk + 7) / 8;  // key n-tiles that hold keys; the rest of S stays 0 and P 0
  // K14's scores and softmax (decoder_attention.cuh): p in sacc
  float sacc[NS][4], dacc[NS][4];
  dec_scores_mma<DK, KT>(qr, ks, zero, Tk, sacc);
  // dPd = dO V^T
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) dacc[nt][0] = dacc[nt][1] = dacc[nt][2] = dacc[nt][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < kPad<DK> / 16; ++kd) {
    const int col = 16 * kd + 2 * t;
    const uint32_t ad[4] = {lds_u32(dr[0] + col), lds_u32(dr[1] + col), lds_u32(dr[0] + col + 8),
                            lds_u32(dr[1] + col + 8)};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      if (nt < nsv) {
        const int j = 8 * nt + g;
        const bf16* vr = (j < Tk ? vs + j * LD : zero) + col;
        const uint32_t bv[2] = {lds_u32(vr), lds_u32(vr + 8)};
        mma_bf16(dacc[nt], ad, bv);
      }
    }
  }
  dec_softmax_mma<KT>(sacc, vbits, pos, live, Tk, causal, sqrt_dk);
  const float inv_kp = 1.f / keep_prob;
  const int ldk = 16 * KT + 8;
  int srow[2];  // the rows' shared-memory row in dS_s / P_s
#pragma unroll
  for (int r = 0; r < 2; ++r) srow[r] = (mem[r] * qp + pos[r]) * ldk + 2 * t;
  // p; P~ into P_s; g = round(dP p) (in dacc); D = the row sum of g
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    if (nt >= nsv) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !half1) continue;
      float pk2[2];  // P~
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * r + c, j = 8 * nt + 2 * t + c;
        const bool real = live[r] && j < Tk;
        const float p = sacc[nt][e];
        const bool kept = real && ((kbits >> (4 * nt + e)) & 1u) != 0;
        const float dpk = dec_dropped(round_to<bf16>(dacc[nt][e]), kept, keep != nullptr, keep_prob, inv_kp);
        pk2[c] = dec_dropped(p, kept, keep != nullptr, keep_prob, inv_kp);
        const float gp = round_to<bf16>(dpk * p);
        dacc[nt][e] = gp;
        dsum[r] += gp;
      }
      if (live[r]) *reinterpret_cast<uint32_t*>(p_s + srow[r] + 8 * nt) = pack_bf16(pk2[0], pk2[1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
  }
  // dS = round(g - p D); dS / sqrt_dk with masked keys zeroed into dS_s and sacc (dQ's A operand)
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    if (nt >= nsv) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !half1) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * r + c, j = 8 * nt + 2 * t + c;
        const bool real = live[r] && j < Tk;
        const float ds = real ? round_to<bf16>(fmaf(-sacc[nt][e], dsum[r], dacc[nt][e])) : 0.f;
        sacc[nt][e] =
            real && key_attended(vbits, 2 * nt + c, j, pos[r], causal) ? round_to<bf16>(div_score(ds, sqrt_dk)) : 0.f;
      }
      if (live[r]) {
        *reinterpret_cast<uint32_t*>(ds_s + srow[r] + 8 * nt) = pack_bf16(sacc[nt][2 * r], sacc[nt][2 * r + 1]);
      }
    }
  }
  // dQ = dS K: dS's accumulators as A, K's B fragments by ldmatrix.trans
  float qacc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) qacc[nt][0] = qacc[nt][1] = qacc[nt][2] = qacc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]), pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                           pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                           pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
    const int j = 16 * kk + (lane & 15);
    const bf16* kr = (j < Tk ? ks + j * LD : zero) + (lane >> 4) * 8;
#pragma unroll
    for (int jn = 0; jn < kPad<DK> / 16; ++jn) {
      uint32_t rr[4];
      ldmatrix_x4_trans(rr, kr + 16 * jn);
      const uint32_t b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
      mma_bf16(qacc[2 * jn], a, b0);
      mma_bf16(qacc[2 * jn + 1], a, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    const int col = 8 * nt + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (live[r]) store_col_pair<DK>(dq + grow[r] * DK, col, make_float2(qacc[nt][2 * r], qacc[nt][2 * r + 1]));
    }
  }
}

// Key side of key tile km: dK (A = dS^T, B = Q) or dV (A = P~^T, B = dO) of
// the unit into tot, each member's product over its own rows rounded to bf16
// and added in member order to f32 sums. A's fragments come from dS_s / P_s
// (query rows by keys) by ldmatrix.trans.
template <int DK>
__device__ __forceinline__ void key_tile_sum(const bf16* as, const bf16* bs, const bf16* zero, int ldk, int qp,
                                             int Tq, int group, int km, float tot[kPad<DK> / 8][4]) {
  const int lane = threadIdx.x & 31;
  constexpr int LD = kLd<DK>, ND = kPad<DK> / 8;  // ND: n-tiles over d
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) tot[nt][0] = tot[nt][1] = tot[nt][2] = tot[nt][3] = 0.f;
  for (int m = 0; m < group; ++m) {
    float acc[ND][4];
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int kk = 0; kk < qp / 16; ++kk) {
      // matrix l / 8 of A: query rows + 8 (l / 16), keys + 8 (l / 8 % 2)
      uint32_t a[4];
      ldmatrix_x4_trans(a, as + (m * qp + 16 * kk + (lane & 7) + 8 * ((lane >> 4) & 1)) * ldk + 16 * km +
                               8 * ((lane >> 3) & 1));
      const int i = 16 * kk + (lane & 15);
      const bf16* br = (i < Tq ? bs + (m * Tq + i) * LD : zero) + (lane >> 4) * 8;
#pragma unroll
      for (int jn = 0; jn < kPad<DK> / 16; ++jn) {
        uint32_t rr[4];
        ldmatrix_x4_trans(rr, br + 16 * jn);
        const uint32_t b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
        mma_bf16(acc[2 * jn], a, b0);
        mma_bf16(acc[2 * jn + 1], a, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[nt][e] += round_to<bf16>(acc[nt][e]);
    }
  }
}

// Key tile km's gradient(s), written once, rounded: dK into dk and dV into dv;
// in the kv mode (dv null) dKV = round(round(dK) + round(dV)) into dk
template <int DK>
__device__ __forceinline__ void key_tile_mma(const bf16* ds_s, const bf16* p_s, const bf16* qs, const bf16* dos,
                                             const bf16* zero, int ldk, int qp, bf16* __restrict__ dk,
                                             bf16* __restrict__ dv, int Tq, int Tk, int group, int km, bool is_v) {
  constexpr int ND = kPad<DK> / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int keys[2] = {16 * km + g, 16 * km + g + 8};
  float tot[ND][4];
  key_tile_sum<DK>(is_v ? p_s : ds_s, is_v ? dos : qs, zero, ldk, qp, Tq, group, km, tot);
  if (dv == nullptr) {
    float tv[ND][4];
    key_tile_sum<DK>(p_s, dos, zero, ldk, qp, Tq, group, km, tv);
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[nt][e] = round_to<bf16>(round_to<bf16>(tot[nt][e]) + round_to<bf16>(tv[nt][e]));
    }
  }
  bf16* dst = is_v ? dv : dk;
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    const int col = 8 * nt + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] < Tk) store_col_pair<DK>(dst + keys[r] * DK, col, make_float2(tot[nt][2 * r], tot[nt][2 * r + 1]));
    }
  }
}

template <int DK, int KT>
__global__ void __launch_bounds__(32 * kMaxTeam)
decoder_attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                                 const bf16* __restrict__ dout, const unsigned char* __restrict__ key_valid,
                                 const unsigned char* __restrict__ keep, float keep_prob, bf16* __restrict__ dq,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int units, int H, int Tq, int Tk,
                                 int group, int causal, float sqrt_dk, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int LD = kLd<DK>, RC = DK / 8, P = kPad<DK>;  // RC: 16-byte chunks of a row
  const int kv = v == nullptr, nkv = kv ? 1 : 2;  // the kv mode stages K alone and reads it as V
  const int rows = group * Tq, se = stage_elems(DK, Tq, Tk, group, kv), qp = member_cols(Tq), ldk = ds_ld(Tk);
  bf16* zero = smem + stages * se;
  bf16* ds_s = zero + LD;
  bf16* p_s = ds_s + group * qp * ldk;
  const int team = blockDim.x / 32, warp = threadIdx.x / 32;
  // the zero row, and dS_s / P_s whose padding rows and keys are never written
  for (int e = threadIdx.x; e < LD + 2 * group * qp * ldk; e += blockDim.x) zero[e] = __float2bfloat16_rn(0.f);

  auto issue = [&](int u, int s) {  // unit u's rows into stage s, 16 bytes a copy (the narrow instance: one element)
    const int b = u / H, h = u - (u / H) * H;
    bf16* st = smem + s * se;
    auto row_src = [&](int r) -> const bf16* {  // staged row r: K, V (not in the kv mode), the q rows, the dO rows
      if (r < nkv * Tk) return (r < Tk ? k : v) + (((size_t)b * H + h) * Tk + (r < Tk ? r : r - Tk)) * DK;
      const int sr = r - nkv * Tk, qr = sr < rows ? sr : sr - rows;
      const int m = qr / Tq, i = qr - (qr / Tq) * Tq;
      return (sr < rows ? q : dout) + ((((size_t)b * group + m) * H + h) * Tq + i) * DK;
    };
    if constexpr (kNarrow<DK>) {
      for (int e = threadIdx.x; e < (nkv * Tk + 2 * rows) * P; e += blockDim.x) {
        const int r = e / P, c = e - (e / P) * P;
        st[r * LD + c] = padded_elem<DK>(row_src(r), c);
      }
    } else {
      for (int c = threadIdx.x; c < (nkv * Tk + 2 * rows) * RC; c += blockDim.x) {
        const int r = c / RC, part = (c % RC) * 8;
        cp_async<16>(st + r * LD + part, row_src(r) + part);
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
    const bf16* ks = smem + s * se;
    const bf16* vs = kv ? ks : ks + Tk * LD;
    const bf16* qs = ks + nkv * Tk * LD;
    const bf16* dos = qs + rows * LD;
    for (int mt = warp; 16 * mt < rows; mt += team) {
      query_tile_mma<DK, KT>(ks, vs, qs, dos, zero, ds_s, p_s, qp,
                         key_valid == nullptr ? nullptr : key_valid + (size_t)b * Tk, keep, keep_prob, dq, b, h, H, Tq,
                         Tk, group, causal, sqrt_dk, mt);
    }
    __syncthreads();  // dS_s and P_s complete
    const size_t kv0 = ((size_t)b * H + h) * Tk * DK;
    for (int item = warp; item < nkv * KT; item += team) {  // the kv mode: one item takes dK and dV of its keys
      const bool is_v = item >= KT;
      key_tile_mma<DK>(ds_s, p_s, qs, dos, zero, ldk, qp, dk + kv0, kv ? nullptr : dv + kv0, Tq, Tk, group,
                       is_v ? item - KT : item, is_v);
    }
    __syncthreads();  // the stage and dS_s / P_s may be overwritten
  }
  cp_async_wait<0>();
}

// the stages that fit (2, else 1; 0: none)
inline int mma_stages(int dk, int Tq, int Tk, int group, int kv) {
  if (mma_smem_bytes(dk, Tq, Tk, group, kv, 2) <= (size_t)kBlockSmemLimit) return 2;
  return mma_smem_bytes(dk, Tq, Tk, group, kv, 1) <= (size_t)kBlockSmemLimit ? 1 : 0;
}

template <int DK, int KT>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout, const void* key_valid,
                           const void* keep, float keep_prob, void* dq, void* dk, void* dv, int Nk, int H, int Tq,
                           int Tk, int group, int causal, float sqrt_dk, cudaStream_t stream) {
  const int kv = v == nullptr;
  const int stages = mma_stages(DK, Tq, Tk, group, kv);
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(DK, Tq, Tk, group, kv, stages);
  auto kernel = decoder_attention_bwd_mma_kernel<DK, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int mtiles = (group * Tq + 15) / 16;
  int team = mtiles > KT ? mtiles : KT;
  if (team > kMaxTeam) team = kMaxTeam;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * team, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int units = Nk * H;
  const int cap = sm_count() * per_sm;
  kernel<<<units < cap ? units : cap, 32 * team, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const unsigned char*>(key_valid),
      static_cast<const unsigned char*>(keep), keep_prob, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), units, H, Tq, Tk, group, causal, sqrt_dk, stages);
  return cudaGetLastError();
}

// ------------------------------------------------------------ f32: CUDA cores
constexpr int kOwn = 2;  // (2 keys x 4 columns) items a thread owns, of dK and of dV

// k_s, v_s (Tk rows; not in the kv mode) | q_s, do_s (chunk rows) | ds_s, pd_s (chunk rows x Tk padded to 4)
template <int DK>
inline size_t f32_smem_bytes(int Tq, int Tk, int group, int kv) {
  const int cr = f32_chunk_members(Tq, group) * Tq;
  return ((size_t)((kv ? 1 : 2) * Tk + 2 * cr) * kF32Ld<DK> + 2 * (size_t)cr * f32_tk_pad(Tk)) * sizeof(float);
}

// kRowTile: query rows a warp takes at a time. With one row, at most 64
// registers, so that 4 blocks share an SM: the self call's many small blocks
// (one caption each) are bound by how many are in flight.
template <int DK, int kRowTile>
__global__ void __launch_bounds__(kF32Threads, kRowTile == 1 ? 4 : 2)
decoder_attention_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                                 const float* __restrict__ dout, const unsigned char* __restrict__ key_valid,
                                 const unsigned char* __restrict__ keep, float keep_prob, float* __restrict__ dq,
                                 float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk, int group,
                                 int causal, float sqrt_dk) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int LDF = kF32Ld<DK>, CG = kPad<DK> / 4;  // CG: 4-column groups of a row
  const int cm = f32_chunk_members(Tq, group), cr_max = cm * Tq, tkp = f32_tk_pad(Tk);
  float* k_s = fsm;
  float* v_s = v == nullptr ? k_s : k_s + Tk * LDF;  // the kv mode reads the K rows as V
  float* q_s = v_s + Tk * LDF;
  float* do_s = q_s + cr_max * LDF;
  float* ds_s = do_s + cr_max * LDF;  // dS / sqrt_dk, masked keys 0; columns past Tk 0
  float* pd_s = ds_s + cr_max * tkp;     // P~
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t kv0 = ((size_t)b * H + h) * Tk * DK;
  stage_rows_f32<DK>(k_s, k + kv0, Tk);
  if (v != nullptr) stage_rows_f32<DK>(v_s, v + kv0, Tk);
  const bool v0 = lane < Tk && (key_valid == nullptr || key_valid[(size_t)b * Tk + lane] != 0);
  const bool v1 = lane + 32 < Tk && (key_valid == nullptr || key_valid[(size_t)b * Tk + lane + 32] != 0);
  const int kpairs = (Tk + 1) / 2;
  float ak[kOwn][2][4], av[kOwn][2][4];
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) ak[o][x][y] = av[o][x][y] = 0.f;
    }
  }

  for (int m0 = 0; m0 < group; m0 += cm) {
    const int members = group - m0 < cm ? group - m0 : cm, cr = members * Tq;
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int m = 0; m < members; ++m) {
      const size_t row0 = (((size_t)b * group + m0 + m) * H + h) * Tq;
      stage_rows_f32<DK>(q_s + m * Tq * LDF, q + row0 * DK, Tq);
      stage_rows_f32<DK>(do_s + m * Tq * LDF, dout + row0 * DK, Tq);
    }
    __syncthreads();
    // query side: 4 rows at a time per warp; lane owns keys lane and lane + 32
    for (int r0 = kRowTile * warp; r0 < cr; r0 += kRowTile * kF32Warps) {
      float s[kRowTile][2], dp[kRowTile][2];
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) s[rr][0] = s[rr][1] = dp[rr][0] = dp[rr][1] = 0.f;
      const int r_last = cr - 1;
      const float* kr0 = k_s + (lane < Tk ? lane : 0) * LDF;
      const float* kr1 = k_s + (lane + 32 < Tk ? lane + 32 : 0) * LDF;
      const float* vr0 = v_s + (lane < Tk ? lane : 0) * LDF;
      const float* vr1 = v_s + (lane + 32 < Tk ? lane + 32 : 0) * LDF;
      const bool two = Tk > 32;
#pragma unroll 4
      for (int d = 0; d < kPad<DK>; d += 4) {
        const float4 k0 = lds4(kr0 + d), w0 = lds4(vr0 + d);
        const float4 k1 = two ? lds4(kr1 + d) : k0, w1 = two ? lds4(vr1 + d) : w0;
#pragma unroll
        for (int rr = 0; rr < kRowTile; ++rr) {
          const int row = r0 + rr < cr ? r0 + rr : r_last;
          const float4 qv = lds4(q_s + row * LDF + d), dv4 = lds4(do_s + row * LDF + d);
          s[rr][0] = dot4(qv, k0, s[rr][0]);
          dp[rr][0] = dot4(dv4, w0, dp[rr][0]);
          if (two) {
            s[rr][1] = dot4(qv, k1, s[rr][1]);
            dp[rr][1] = dot4(dv4, w1, dp[rr][1]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) {
        const int row = r0 + rr;
        if (row >= cr) break;  // warp-uniform
        const int m = row / Tq, i = row - (row / Tq) * Tq;
        const size_t grow = (((size_t)b * group + m0 + m) * H + h) * Tq + i;
        const bool ok0 = v0 && (!causal || lane <= i), ok1 = v1 && (!causal || lane + 32 <= i);
        const float s0 = lane < Tk ? (ok0 ? div_score(s[rr][0], sqrt_dk) : kNegInf) : -INFINITY;
        const float s1 = lane + 32 < Tk ? (ok1 ? div_score(s[rr][1], sqrt_dk) : kNegInf) : -INFINITY;
        const float sv[2] = {s0, s1};
        float p[2];
        dec_softmax(sv, Tk, p);
        float pk[2], dpk[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          bool kept = j < Tk;
          if (kept && keep != nullptr) kept = keep[grow * Tk + j] != 0;
          pk[c] = kept ? (keep != nullptr ? p[c] / keep_prob : p[c]) : 0.f;
          dpk[c] = kept ? (keep != nullptr ? dp[rr][c] / keep_prob : dp[rr][c]) : 0.f;
        }
        const float gp0 = dpk[0] * p[0], gp1 = dpk[1] * p[1];
        const float di = warp_sum(gp0 + gp1);
        if (lane < tkp) {
          ds_s[row * tkp + lane] = ok0 && lane < Tk ? div_score(fmaf(-p[0], di, gp0), sqrt_dk) : 0.f;
          pd_s[row * tkp + lane] = pk[0];
        }
        if (lane + 32 < tkp) {
          ds_s[row * tkp + lane + 32] = ok1 && lane + 32 < Tk ? div_score(fmaf(-p[1], di, gp1), sqrt_dk) : 0.f;
          pd_s[row * tkp + lane + 32] = pk[1];
        }
      }
      __syncwarp();
      // dQ for the 4 rows: lane owns columns 2 lane, 2 lane + 1 (owns_cols)
      if (!owns_cols<DK>(lane)) continue;
      float2 acc[kRowTile];
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) acc[rr] = make_float2(0.f, 0.f);
      for (int j = 0; j < tkp; j += 4) {
        float2 kc[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          kc[x] = j + x < Tk ? *reinterpret_cast<const float2*>(k_s + (j + x) * LDF + 2 * lane) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int rr = 0; rr < kRowTile; ++rr) {
          const int row = r0 + rr < cr ? r0 + rr : r_last;
          const float4 d4 = lds4(ds_s + row * tkp + j);
          acc[rr].x = fmaf(d4.w, kc[3].x, fmaf(d4.z, kc[2].x, fmaf(d4.y, kc[1].x, fmaf(d4.x, kc[0].x, acc[rr].x))));
          acc[rr].y = fmaf(d4.w, kc[3].y, fmaf(d4.z, kc[2].y, fmaf(d4.y, kc[1].y, fmaf(d4.x, kc[0].y, acc[rr].y))));
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) {
        const int row = r0 + rr;
        if (row < cr) {
          const int m = row / Tq, i = row - (row / Tq) * Tq;
          const size_t grow = (((size_t)b * group + m0 + m) * H + h) * Tq + i;
          store_col_pair<DK>(dq + grow * DK, 2 * lane, acc[rr]);
        }
      }
    }
    __syncthreads();  // ds_s / pd_s complete
    // key side: thread-owned (2 keys, 4 columns) items, the chunk's rows added in order
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int item = threadIdx.x + o * kF32Threads;
      const int kp = item / CG, c4 = (item % CG) * 4;
      if (kp < kpairs) {
        for (int row = 0; row < cr; ++row) {
          const float4 qv = lds4(q_s + row * LDF + c4), dv4 = lds4(do_s + row * LDF + c4);
          const float2 ds2 = *reinterpret_cast<const float2*>(ds_s + row * tkp + 2 * kp);
          const float2 pd2 = *reinterpret_cast<const float2*>(pd_s + row * tkp + 2 * kp);
          const float qa[4] = {qv.x, qv.y, qv.z, qv.w}, da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            ak[o][0][y] = fmaf(ds2.x, qa[y], ak[o][0][y]);
            ak[o][1][y] = fmaf(ds2.y, qa[y], ak[o][1][y]);
            av[o][0][y] = fmaf(pd2.x, da[y], av[o][0][y]);
            av[o][1][y] = fmaf(pd2.y, da[y], av[o][1][y]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int item = threadIdx.x + o * kF32Threads;
    const int kp = item / CG, c4 = (item % CG) * 4;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = 2 * kp + x;
      if (kp < kpairs && j < Tk) {
        if (dv == nullptr) {  // the kv mode: d(k as K) + d(k as V)
#pragma unroll
          for (int y = 0; y < 4; ++y) ak[o][x][y] += av[o][x][y];
        }
        float* dkr = dk + kv0 + j * DK;
        if constexpr (kNarrow<DK>) {
          store_col_pair<DK>(dkr, c4, make_float2(ak[o][x][0], ak[o][x][1]));
          store_col_pair<DK>(dkr, c4 + 2, make_float2(ak[o][x][2], ak[o][x][3]));
        } else {
          *reinterpret_cast<float4*>(dkr + c4) = make_float4(ak[o][x][0], ak[o][x][1], ak[o][x][2], ak[o][x][3]);
        }
        if (dv == nullptr) continue;
        float* dvr = dv + kv0 + j * DK;
        if constexpr (kNarrow<DK>) {
          store_col_pair<DK>(dvr, c4, make_float2(av[o][x][0], av[o][x][1]));
          store_col_pair<DK>(dvr, c4 + 2, make_float2(av[o][x][2], av[o][x][3]));
        } else {
          *reinterpret_cast<float4*>(dvr + c4) = make_float4(av[o][x][0], av[o][x][1], av[o][x][2], av[o][x][3]);
        }
      }
    }
  }
}

template <int DK>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* key_valid,
                           const void* keep, float keep_prob, void* dq, void* dk, void* dv, int Nk, int H, int Tq,
                           int Tk, int group, int causal, float sqrt_dk, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<DK>(Tq, Tk, group, v == nullptr);
  if (smem > (size_t)kBlockSmemLimit || (kPad<DK> / 4) * ((Tk + 1) / 2) > kOwn * kF32Threads) {
    return cudaErrorInvalidValue;
  }
  // a chunk of fewer rows (the self call's one caption) spreads them one a warp over all 8 warps
  auto kernel = f32_chunk_members(Tq, group) * Tq >= kWideRows ? decoder_attention_bwd_f32_kernel<DK, 4>
                                                               : decoder_attention_bwd_f32_kernel<DK, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<Nk * H, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const unsigned char*>(key_valid),
      static_cast<const unsigned char*>(keep), keep_prob, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, group, causal, sqrt_dk);
  return cudaGetLastError();
}

template <int DK>
int entry(int dtype, const void* q, const void* k, const void* v, const void* dout, const void* key_valid,
          const void* keep, float keep_prob, void* dq, void* dk, void* dv, int Nk, int H, int Tq, int Tk, int group,
          int causal, float sqrt_dk, cudaStream_t s) {
  if (dtype == 0) {
    return (int)launch_bwd_f32<DK>(q, k, v, dout, key_valid, keep, keep_prob, dq, dk, dv, Nk, H, Tq, Tk, group,
                                   causal, sqrt_dk, s);
  }
  if (dtype == 1) {
#define SCT_BWD(KT)                                                                                                  \
  launch_bwd_mma<DK, KT>(q, k, v, dout, key_valid, keep, keep_prob, dq, dk, dv, Nk, H, Tq, Tk, group, causal, sqrt_dk, \
                         s)
    if (Tk <= 16) return (int)SCT_BWD(1);
    if (Tk <= 32) return (int)SCT_BWD(2);
    if (Tk <= 48) return (int)SCT_BWD(3);
    return (int)SCT_BWD(4);
#undef SCT_BWD
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16; dk_width: 64, 32 or 13. q, dout, dq (Nk
// * group, H, Tq, dk); k, v, dk, dv (Nk, H, Tk, dk), every pointer 16-byte
// aligned; key_valid, keep, keep_prob, causal and sqrt_dk as
// sct_decoder_attention took them.
namespace sct {
int decoder_attention_bwd_entry(int dtype, int dk_width, const void* q, const void* k, const void* v,
                                const void* dout, const void* key_valid, const void* keep, float keep_prob, void* dq,
                                void* dk, void* dv, int Nk, int H, int Tq, int Tk, int group, int causal,
                                float sqrt_dk, void* stream) {
  if (Nk < 1 || H < 1 || Tq < 1 || Tq > kDecMaxLen || Tk < 1 || Tk > kDecMaxLen || group < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {q, k, v == nullptr ? k : v, dout, dq, dk, dv == nullptr ? dk : dv};
  for (const void* p : ptrs) {
    if (!aligned_to(p, 16)) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_DK(DK) \
  entry<DK>(dtype, q, k, v, dout, key_valid, keep, keep_prob, dq, dk, dv, Nk, H, Tq, Tk, group, causal, sqrt_dk, s)
  if (dk_width == 64) return SCT_DK(64);
  if (dk_width == 32) return SCT_DK(32);
  if (dk_width == 13) return SCT_DK(13);
#undef SCT_DK
  return (int)cudaErrorInvalidValue;
}
}  // namespace sct

extern "C" int sct_decoder_attention_bwd(int dtype, int dk_width, const void* q, const void* k, const void* v,
                                         const void* dout, const void* key_valid, const void* keep, float keep_prob,
                                         void* dq, void* dk, void* dv, int Nk, int H, int Tq, int Tk, int group,
                                         int causal, float sqrt_dk, void* stream) {
  if (v == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return sct::decoder_attention_bwd_entry(dtype, dk_width, q, k, v, dout, key_valid, keep, keep_prob, dq, dk, dv, Nk,
                                          H, Tq, Tk, group, causal, sqrt_dk, stream);
}

// kv mode: kv (Nk, H, Tk, dk) is both K and V; dkv (Nk, H, Tk, dk) receives its one gradient.
extern "C" int sct_decoder_attention_bwd_kv(int dtype, int dk_width, const void* q, const void* kv,
                                            const void* dout, const void* key_valid, const void* keep,
                                            float keep_prob, void* dq, void* dkv, int Nk, int H, int Tq, int Tk,
                                            int group, int causal, float sqrt_dk, void* stream) {
  return sct::decoder_attention_bwd_entry(dtype, dk_width, q, kv, nullptr, dout, key_valid, keep, keep_prob, dq, dkv,
                                          nullptr, Nk, H, Tq, Tk, group, causal, sqrt_dk, stream);
}

// the bf16 kernel's shared memory at head width dk for (Tq, Tk, group, kv mode) at its stage count; 0 if none fits
extern "C" long long sct_decoder_attention_bwd_smem(int dk, int Tq, int Tk, int group, int kv) {
  const int stages = sct::mma_stages(dk, Tq, Tk, group, kv);
  return stages == 0 ? 0 : (long long)sct::mma_smem_bytes(dk, Tq, Tk, group, kv, stages);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
