// K7: ORT box-relation self-attention, backward.
//
// Replaces: the gradients of sparse_caption_tpu/models/layers.py:338-365
// box_relational_embedding and :406-439 BoxMultiHeadAttention.__call__ (left to
// XLA's autodiff fusions on the TPU; no Pallas kernel there).
//
// With K1's forward (box_attention.cu: s, p, the dropout-kept P~ = round(p *
// keep / keep_prob)) recomputed here, and round() the rounding to the compute
// dtype T where the plain version's autograd rounds (a no-op in f32):
//   dV  = round(P~^T dO);  dP = round(dO V^T);  dP~ = round(dP * keep / keep_prob)
//   g = round(dP~ p);  D_i = sum_j g_ij;  dS = round(g - p D)   (PyTorch's CUDA softmax
//   backward: the product rounded to T first, then f32)
//   dQ  = round(round(dS_unmasked / sqrt_dk) K);  dK = round(round(dS_unmasked / sqrt_dk)^T Q)
//   d log(w_g) = dS;  dz = round(dS / w_g) where w_g = relu(z) > 1e-6, else 0
//   d wg_w[h, g] = round(sum over images and pairs of dz[h] geo[g]); d wg_b[h] = round(sum dz[h])
// The gradient of log(max(relu(z), 1e-6)) is 1/z above the clamp: as
// ill-conditioned at the kink as K1's forward.
// The row statistics (max, sum) are recomputed from S, not saved by K1: an
// image with no valid region has s = -1e9 + bias, which rounds to -1e9 for
// every key, and the plain version then averages every key; a saved f32
// log-sum-exp (-1e9 + log R rounds to -1e9) would give exp(s - lse) = 1.
//
// Bound on the H100: bytes, then the trig. At batch 256, bf16, it reads q, k,
// v, dO and the keep-mask and writes dq, dk, dv (7 x 256 x 8 x 36 x 64 x 2 B +
// 2.8 MB = 69 MB): 0.021 ms at 3.35 TB/s; the geometry's sincosf, twice per
// image, is the larger cost.
//
// Design: one block of 4 warps per (image, group of up to 4 heads), so B = 256
// gives 512 blocks (one block per image gave 256, under one wave). In bf16 the
// blocks of an image form a thread-block cluster and share the geometry
// through distributed shared memory: each computes the w_g of every head for
// its share of the pair tiles and writes them into the block of the head's
// group, and for d wg each takes its share of the pairs for every head,
// reading the other groups' dz from their blocks. So the image's trig is
// computed twice (w_g, then the features of d wg), as by one block per image,
// and not once per group. In f32 each block computes its group's geometry
// itself (twice the trig per image for 8 heads).
// bf16 on tensor cores (mma.sync.m16n8k16, f32 accumulators, tiles in bf16
// in shared memory):
// - Phase A: the clamped w_g by K1's geometry product (box_geometry.cuh
//   geometry_tile_bf16), into the shared memory of each head's block.
// - Phase B, head by head, q, k, v and dO staged by 1-D TMA on mbarriers,
//   double-buffered (head + 2 loads once every tile of the head is done).
//   Query side (16 query rows a tile): S = QK^T and dP = dO V^T as products, the softmax recomputed on
//   the accumulators, dS and dz in registers, dQ = dS K with dS's
//   accumulators as the A operand and K's B fragments by ldmatrix.trans;
//   dS^T and P~^T go to shared memory (bf16). Key side (16 key rows each):
//   dK = dS^T Q and dV = P~^T dO, Q's and dO's B fragments by ldmatrix.trans.
//   w_g, then dz, are kept in bf16 (their values are bf16 values).
//   The query and key tiles of the heads go to the 4 warps in turn (one
//   mbarrier per head says a head's query tiles are done; rows past R read
//   one shared zero row). Shared memory at R = 36: 73 KB, three blocks per SM.
// - Phase C: d wg as one product dz (heads padded to 16 rows x pairs) times
//   geo (pairs x 64 features, plus a column of ones for d wg_b), 81 k-steps
//   of 16 pairs at R = 36 over the image's blocks; each lane computes the features
//   of its B fragments (4 pairs x 4 coordinates, one frequency) and shares
//   the log-deltas with the lanes of the same pairs by shuffles. The warps
//   fold in a fixed order into one (h, 65) partial per block, and a second
//   kernel sums the partials over images and blocks in order: no float atomics.
// f32 (the SCST path, exact f32 FMAs on the CUDA cores): the same grid, 8
// warps a block; the block computes w_g pair by pair, then per head each warp
// takes 4 query rows (scores and dP with each key and value row read once by
// 128-bit loads for the 4 rows, softmax, dS, dz, dq) and then 4 key rows (dk,
// dv, each q and dO pair read once for the 4 rows), and the d wg partials
// come from the trig recomputed one (coordinate, frequency) per lane.
//
// kv mode (sct_box_attention_bwd_kv; ACORT's kv-shared encoder layers, V is
// the K tensor): the stages hold q, k and dO (3 tiles instead of 4), the k
// tile serves as V in dP = dO V^T, and the key side writes one gradient,
// dKV = round(round(dK) + round(dV)): the plain version's autograd rounds
// each use's product to T and then adds the two in T (in f32, dK + dV).
// Adding in f32 and rounding once differs in the last bit.
// Head width 13 (ORT-xsmall): tiles staged at width 16 with columns 13-15
// zero (common.cuh kPad), by the loading warp's element copies and its own
// arrival (26-byte rows take no TMA); only the 13 real columns of dq, dk, dv
// (dkv) written.
// Raw geometry (dg = 4, a run-time argument of every instance): phase A
// computes w_g pair by pair (box_geometry.cuh pair_wg_raw) over the image's
// blocks; d wg_w[h, c] = round(sum dz[h] geo_c) and d wg_b[h] = round(sum
// dz[h]) over the pairs, geo_c the log-delta rounded to T: in bf16 each
// block's threads take (head, column, run of the block's pairs), reading dz
// from its group's block (DSMEM), and fold the runs in order; in f32 lanes
// 0-3 take the four log-deltas in the trig fold's place. The bf16 raw
// phases are functions of their own (raw_wg_to_groups, raw_wg_partials), so
// that the trig path's code stays as it was. The partial rows
// keep their 65 columns (4 used, then the bias at 64); the second pass sums
// them in the same fixed order.
#include <cooperative_groups.h>

#include "box_geometry.cuh"

namespace sct {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

constexpr int kGroupHeads = 4;  // heads per block
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
// staged row stride in bf16 at head width DK (144 B at 64, 80 B at 32, 48 B at 13)
template <int DK> constexpr int kLd = kPad<DK> + 8;
constexpr int kWgCols = 64 + 1;  // a partial row: the 64 geometry features (dim_g, not dk), then the bias

inline int padded_rows(int R) { return 16 * ((R + 15) / 16); }

// dynamic shared memory: 3 mbarriers per group head | 2 stages x (q, k, v, dO)
// x R rows | a zero row | w_g, then dz (group x P, bf16) | per stage dS^T and
// P~^T (RP x (RP + 8) bf16 each) | boxes | wg_b | mask; at the end the fold of
// the d wg partials (kBwdWarps x kMaxHeads x 72 f32) reuses it from the stages
// on, so at small R it sets the size
inline size_t bwd_mma_smem_bytes(int dk, int R, bool kv) {
  const int rp = padded_rows(R);
  const size_t bars = 3 * kGroupHeads * sizeof(uint64_t);
  const size_t parts = (2 * (kv ? 3 : 4) * (size_t)R + 1) * (padded_width(dk) + 8) * sizeof(bf16) +
                       ((kGroupHeads * (size_t)R * R + 7) / 8) * 8 * sizeof(bf16) +
                       2 * 2 * (size_t)rp * (rp + 8) * sizeof(bf16) + (size_t)R * 4 * sizeof(float) +
                       kMaxHeads * sizeof(float) + R;
  const size_t fold = (size_t)kBwdWarps * kMaxHeads * 72 * sizeof(float);
  return bars + (parts > fold ? parts : fold);
}

template <int DK>
__device__ __forceinline__ const bf16* tile_row(const bf16* tile, int r, int R, const bf16* zero) {
  return r < R ? tile + r * kLd<DK> : zero;
}

// 16 rows of DK (C fragments of kPad / 8 n-tiles, rows row0 + g and + 8) to global memory; rows >= R and
// the pad columns dropped
template <int DK>
__device__ __forceinline__ void store_rows_bf16(const float acc[kPad<DK> / 8][4], bf16* __restrict__ dst, int row0,
                                                int R) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kPad<DK> / 8; ++nt) {
    const int col = 8 * nt + 2 * t;
    if (row0 + g < R) store_col_pair<DK>(dst + (row0 + g) * DK, col, make_float2(acc[nt][0], acc[nt][1]));
    if (row0 + g + 8 < R) store_col_pair<DK>(dst + (row0 + g + 8) * DK, col, make_float2(acc[nt][2], acc[nt][3]));
  }
}

// query side of one head for query tile mt: dS, dz (into wz), dQ, and dS^T / P~^T into shared memory
template <int DK, int RP>
__device__ __forceinline__ void query_tile_bf16(const bf16* qs, const bf16* ks, const bf16* vs, const bf16* dos,
                                                const bf16* zero, bf16* wz, bf16* dsT, bf16* pT,
                                                const unsigned char* mask_s, const unsigned char* __restrict__ keep_h,
                                                float keep_prob, bf16* __restrict__ dq_h, int R, int mt, float sqrt_dk) {
  constexpr int KS = RP / 16, NS = 2 * KS, LDT = RP + 8, ND = kPad<DK> / 8;  // ND: dQ's n-tiles over d
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows[2] = {16 * mt + g, 16 * mt + g + 8};
  const int nsv = (R + 7) / 8;  // key n-tiles that hold keys; the rest of S stays 0 and P 0
  float sacc[NS][4], dacc[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[nt][e] = dacc[nt][e] = 0.f;
  }
#pragma unroll
  for (int kd = 0; kd < kPad<DK> / 16; ++kd) {
    const int col = 16 * kd + 2 * t;
    const bf16* q0 = tile_row<DK>(qs, rows[0], R, zero) + col;
    const bf16* q1 = tile_row<DK>(qs, rows[1], R, zero) + col;
    const bf16* d0 = tile_row<DK>(dos, rows[0], R, zero) + col;
    const bf16* d1 = tile_row<DK>(dos, rows[1], R, zero) + col;
    const uint32_t aq[4] = {lds_u32(q0), lds_u32(q1), lds_u32(q0 + 8), lds_u32(q1 + 8)};
    const uint32_t ad[4] = {lds_u32(d0), lds_u32(d1), lds_u32(d0 + 8), lds_u32(d1 + 8)};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      if (nt < nsv) {
        const bf16* kr = tile_row<DK>(ks, 8 * nt + g, R, zero) + col;
        const bf16* vr = tile_row<DK>(vs, 8 * nt + g, R, zero) + col;
        const uint32_t bk[2] = {lds_u32(kr), lds_u32(kr + 8)};
        const uint32_t bv[2] = {lds_u32(vr), lds_u32(vr + 8)};
        mma_bf16(sacc[nt], aq, bk);
        mma_bf16(dacc[nt], ad, bv);
      }
    }
  }
  // K1's scores and softmax (box_attention.cu attend_tile_bf16), bias = round(log(w_g))
  const float fill = round_to<bf16>(kNegInf);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * nt + 2 * t + (e & 1), row = rows[e >> 1];
      float s = -INFINITY;
      if (j < R) {
        s = round_to<bf16>(div_score(round_to<bf16>(sacc[nt][e]), sqrt_dk));
        if (mask_s[j] == 0) s = fill;
        if (row < R) s = round_to<bf16>(s + round_to<bf16>(logf(__bfloat162float(wz[row * R + j]))));
      }
      sacc[nt][e] = s;
      mx[e >> 1] = fmaxf(mx[e >> 1], s);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sacc[nt][e] == -INFINITY ? 0.f : expf(sacc[nt][e] - mx[e >> 1]);
      sacc[nt][e] = x;
      sum[e >> 1] += x;
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = 1.f / sum[r];
  }
  // p, P~ (into P~^T), g = round(dP~ p) (in dacc), D = sum of g
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * nt + 2 * t + (e & 1), row = rows[e >> 1];
      const bool real = row < R && j < R;
      const float p = real ? round_to<bf16>(div_by(sacc[nt][e], sum[e >> 1], inv[e >> 1])) : 0.f;
      const bool kept = real && (keep_h == nullptr || keep_h[row * R + j] != 0);
      const float dp = round_to<bf16>(dacc[nt][e]);
      const float dpk = !kept ? 0.f : keep_h == nullptr ? dp : round_to<bf16>(dp / keep_prob);
      const float pk = !kept ? 0.f : keep_h == nullptr ? p : round_to<bf16>(p / keep_prob);
      pT[j * LDT + row] = __float2bfloat16_rn(pk);
      const float gp = round_to<bf16>(dpk * p);
      sacc[nt][e] = p;
      dacc[nt][e] = gp;
      dsum[e >> 1] += gp;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
  }
  // dS, dz, and dS / sqrt_dk with masked keys zeroed (in sacc, the A operand of dQ)
  const float min_wg = round_to<bf16>(1e-6f);
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * nt + 2 * t + (e & 1), row = rows[e >> 1];
      const bool real = row < R && j < R;
      const float ds = real ? round_to<bf16>(fmaf(-sacc[nt][e], dsum[e >> 1], dacc[nt][e])) : 0.f;
      if (real) {
        const float w = __bfloat162float(wz[row * R + j]);
        wz[row * R + j] = __float2bfloat16_rn(w > min_wg ? ds / w : 0.f);
      }
      const float dsm = real && mask_s[j] != 0 ? round_to<bf16>(div_score(ds, sqrt_dk)) : 0.f;
      dsT[j * LDT + row] = __float2bfloat16_rn(dsm);
      sacc[nt][e] = dsm;
    }
  }
  // dQ = dS K: dS's accumulators as A, K's B fragments by ldmatrix.trans
  float qacc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) qacc[nt][0] = qacc[nt][1] = qacc[nt][2] = qacc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]), pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                           pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                           pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
    for (int jn = 0; jn < kPad<DK> / 16; ++jn) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, tile_row<DK>(ks, 16 * kk + (lane & 15), R, zero) + 16 * jn + (lane >> 4) * 8);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(qacc[2 * jn], a, b0);
      mma_bf16(qacc[2 * jn + 1], a, b1);
    }
  }
  store_rows_bf16<DK>(qacc, dq_h, 16 * mt, R);
}

// key side of one head for key tile mk: dK = dS^T Q and dV = P~^T dO (the kv
// mode: their sum, each rounded first, into dk_h)
template <int DK, int RP, bool KV>
__device__ __forceinline__ void key_tile_bf16(const bf16* qs, const bf16* dos, const bf16* zero, const bf16* dsT,
                                              const bf16* pT, bf16* __restrict__ dk_h, bf16* __restrict__ dv_h, int R,
                                              int mk) {
  constexpr int KS = RP / 16, LDT = RP + 8, ND = kPad<DK> / 8;  // ND: n-tiles over d
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int keys[2] = {16 * mk + g, 16 * mk + g + 8};
  float kacc[ND][4], vacc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) kacc[nt][e] = vacc[nt][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int col = 16 * kk + 2 * t;
    const uint32_t as[4] = {lds_u32(dsT + keys[0] * LDT + col), lds_u32(dsT + keys[1] * LDT + col),
                            lds_u32(dsT + keys[0] * LDT + col + 8), lds_u32(dsT + keys[1] * LDT + col + 8)};
    const uint32_t ap[4] = {lds_u32(pT + keys[0] * LDT + col), lds_u32(pT + keys[1] * LDT + col),
                            lds_u32(pT + keys[0] * LDT + col + 8), lds_u32(pT + keys[1] * LDT + col + 8)};
    const int row = 16 * kk + (lane & 15), coff = (lane >> 4) * 8;
#pragma unroll
    for (int jn = 0; jn < kPad<DK> / 16; ++jn) {
      uint32_t rq[4], rd[4];
      ldmatrix_x4_trans(rq, tile_row<DK>(qs, row, R, zero) + 16 * jn + coff);
      ldmatrix_x4_trans(rd, tile_row<DK>(dos, row, R, zero) + 16 * jn + coff);
      const uint32_t bq0[2] = {rq[0], rq[1]}, bq1[2] = {rq[2], rq[3]};
      const uint32_t bd0[2] = {rd[0], rd[1]}, bd1[2] = {rd[2], rd[3]};
      mma_bf16(kacc[2 * jn], as, bq0);
      mma_bf16(kacc[2 * jn + 1], as, bq1);
      mma_bf16(vacc[2 * jn], ap, bd0);
      mma_bf16(vacc[2 * jn + 1], ap, bd1);
    }
  }
  if (KV) {
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) kacc[nt][e] = round_to<bf16>(round_to<bf16>(kacc[nt][e]) + round_to<bf16>(vacc[nt][e]));
    }
    store_rows_bf16<DK>(kacc, dk_h, 16 * mk, R);
    return;
  }
  store_rows_bf16<DK>(kacc, dk_h, 16 * mk, R);
  store_rows_bf16<DK>(vacc, dv_h, 16 * mk, R);
}

// The raw geometry's phase A (module notes): w_g of every head for this
// block's share of the pairs, each value into the block of its head's group.
__device__ __noinline__ void raw_wg_to_groups(const float* box_s, const bf16* wg_w, const float* wb_s, int H, int R,
                                              bf16* wz_s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), groups = (int)cluster.num_blocks(), P = R * R;
  for (int p = rank * kBwdThreads + threadIdx.x; p < P; p += groups * kBwdThreads) {
    const int i = p / R, j = p - (p / R) * R;
    float wgr[kMaxHeads];
    pair_wg_raw<bf16>(box_s + 4 * i, box_s + 4 * j, wg_w, wb_s, H, wgr);
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh < H) {
        bf16* dst = cluster.map_shared_rank(wz_s, hh / kGroupHeads);
        dst[(hh % kGroupHeads) * P + p] = __float2bfloat16_rn(wgr[hh]);
      }
    }
  }
}

// The raw geometry's d wg partials: combo (head hh, column c) sums dz of head
// hh times log-delta c (rounded to bf16; the bias's column: 1) over this
// block's pairs (rank, rank + groups, ...), each of `parts` threads a
// contiguous run of them in order, then the runs folded in order (fold:
// kBwdThreads floats of shared memory).
__device__ __noinline__ void raw_wg_partials(const float* box_s, const bf16* wz_s, float* fold, float* wg_partial,
                                             int H, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), groups = (int)cluster.num_blocks(), P = R * R, b = blockIdx.x;
  const int combos = H * (kRawG + 1), parts = kBwdThreads / combos;
  const int e = threadIdx.x, combo = e % combos, part = e / combos;
  const int hh = combo / (kRawG + 1), c = combo - hh * (kRawG + 1);
  const int nq = (P - rank + groups - 1) / groups, len = (nq + parts - 1) / parts;
  if (part < parts) {
    const bf16* dz = cluster.map_shared_rank(wz_s, hh / kGroupHeads) + (hh % kGroupHeads) * P;
    float acc = 0.f;
    const int q1 = min((part + 1) * len, nq);
#pragma unroll 4
    for (int qq = part * len; qq < q1; ++qq) {
      const int p = rank + groups * qq, i = p / R, j = p - (p / R) * R;
      const float f = c < kRawG ? round_to<bf16>(pair_delta(box_s + 4 * i, box_s + 4 * j, c)) : 1.f;
      acc = fmaf(__bfloat162float(dz[p]), f, acc);
    }
    fold[part * combos + combo] = acc;
  }
  __syncthreads();
  if (e < combos) {
    float sum = 0.f;
    for (int k = 0; k < parts; ++k) sum += fold[k * combos + e];
    wg_partial[(((size_t)b * groups + rank) * H + hh) * kWgCols + (c < kRawG ? c : 64)] = sum;
  }
}

template <int DK, int RP, bool KV>
__global__ void __launch_bounds__(kBwdThreads)
box_attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const bf16* __restrict__ dout, const float* __restrict__ boxes,
                             const bf16* __restrict__ wg_w, const bf16* __restrict__ wg_b,
                             const float* __restrict__ freq, const unsigned char* __restrict__ mask,
                             const unsigned char* __restrict__ keep, float keep_prob, bf16* __restrict__ dq,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ wg_partial, int H,
                             int R, float sqrt_dk, int dg) {
  constexpr int LDT = RP + 8, MT = RP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // per group head: its tiles have landed
  uint64_t* qdone = full + kGroupHeads;                // its query tiles are done (dS^T, P~^T written)
  uint64_t* kdone = qdone + kGroupHeads;               // its key tiles are done (the stage is free)
  constexpr int NT = KV ? 3 : 4;  // tiles a stage: q, k, v (not in the kv mode), dO
  constexpr int LD = kLd<DK>;
  bf16* tiles = reinterpret_cast<bf16*>(kdone + kGroupHeads);  // [stage][q, k, v, dO][R][LD]
  const int P = R * R;
  bf16* zero = tiles + 2 * NT * R * LD;
  bf16* wz_s = zero + LD;  // [group head][P]: w_g, then dz
  bf16* ds_s = wz_s + ((kGroupHeads * P + 7) / 8) * 8;  // [stage][dS^T, P~^T][RP][LDT]
  float* box_s = reinterpret_cast<float*>(ds_s + 2 * 2 * RP * LDT);
  float* wb_s = box_s + R * 4;
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(wb_s + kMaxHeads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  cg::cluster_group cluster = cg::this_cluster();  // the image's head groups, rank = blockIdx.y
  const int rank = (int)cluster.block_rank(), groups = (int)cluster.num_blocks();
  const int b = blockIdx.x, h0 = kGroupHeads * rank, G = min(kGroupHeads, H - h0);
  // which: 0 q, 1 k, 2 v, 3 dO; the kv mode reads the k tile as v
  auto tile = [&](int stage, int which) {
    return tiles + (stage * NT + (!KV ? which : which == 3 ? 2 : which == 2 ? 1 : which)) * R * LD;
  };

  if (threadIdx.x == 0) {
    for (int hl = 0; hl < G; ++hl) {
      mbar_init(&full[hl], 1);
      mbar_init(&qdone[hl], MT);
      mbar_init(&kdone[hl], MT);
    }
    mbar_fence_init();
  }
  for (int e = threadIdx.x; e < LD; e += blockDim.x) zero[e] = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < 2 * 2 * RP * LDT; e += blockDim.x) ds_s[e] = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < R * 4; e += blockDim.x) box_s[e] = boxes[(size_t)b * R * 4 + e];
  for (int e = threadIdx.x; e < kMaxHeads; e += blockDim.x) wb_s[e] = e < H ? __bfloat162float(wg_b[e]) : 0.f;
  for (int e = threadIdx.x; e < R; e += blockDim.x) mask_s[e] = mask[(size_t)b * R + e];
  cluster.sync();  // every block of the image has started: its shared memory may be written

  const size_t head_elems = (size_t)R * DK;
  auto load_head = [&](int hl) {  // one warp: head h0 + hl's q, k, v (not in the kv mode), dO into stage hl % 2
    const int s = hl & 1;
    const size_t base = ((size_t)b * H + h0 + hl) * head_elems;
    if constexpr (kNarrow<DK>) {  // 26-byte rows: the warp's own element copies, then its arrival
      stage_padded<DK>(tile(s, 0), LD, q + base, R, lane, 32);
      stage_padded<DK>(tile(s, 1), LD, k + base, R, lane, 32);
      if (!KV) stage_padded<DK>(tile(s, 2), LD, v + base, R, lane, 32);
      stage_padded<DK>(tile(s, 3), LD, dout + base, R, lane, 32);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[hl]);
    } else {
      if (lane == 0) mbar_arrive_expect_tx(&full[hl], (unsigned)NT * R * DK * sizeof(bf16));
      __syncwarp();
      for (int r = lane; r < R; r += 32) {
        tma_load_1d(tile(s, 0) + r * LD, q + base + r * DK, DK * sizeof(bf16), &full[hl]);
        tma_load_1d(tile(s, 1) + r * LD, k + base + r * DK, DK * sizeof(bf16), &full[hl]);
        if (!KV) tma_load_1d(tile(s, 2) + r * LD, v + base + r * DK, DK * sizeof(bf16), &full[hl]);
        tma_load_1d(tile(s, 3) + r * LD, dout + base + r * DK, DK * sizeof(bf16), &full[hl]);
      }
    }
  };
  if (warp == 0) load_head(0);
  if (warp == 1 && G > 1) load_head(1);

  // phase A: clamped w_g of every head, the pairs (raw geometry) or pair
  // tiles (trig features) shared out over the image's blocks; each value goes
  // to the block of its head's group
  if (dg == kRawG) {
    raw_wg_to_groups(box_s, wg_w, wb_s, H, R, wz_s);
  } else {
    uint32_t wfrag[kHeadTiles][4][2];
    load_wg_frags(wg_w, H, wfrag);
    const float fq[2] = {freq[2 * t], freq[2 * t + 1]};
    for (int mt = rank + groups * warp; 16 * mt < P; mt += groups * kBwdWarps) {
      float wgc[kHeadTiles][4];
      geometry_tile_bf16(box_s, R, mt, fq, wfrag, H, wb_s, wgc);
#pragma unroll
      for (int nt = 0; nt < kHeadTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int head = 8 * nt + 2 * t + (e & 1), p = 16 * mt + g + 8 * (e >> 1);
          if (head < H && p < P) {
            bf16* dst = cluster.map_shared_rank(wz_s, head / kGroupHeads);
            dst[(head % kGroupHeads) * P + p] = __float2bfloat16_rn(wgc[nt][e]);
          }
        }
      }
    }
  }
  cluster.sync();

  // phase B: per head, its MT query tiles, then its MT key tiles, the units in
  // order over all warps; the warp of a head's last key tile waits for the
  // others and loads head hl + 2 into the stage
  for (int u = warp; u < G * 2 * MT; u += kBwdWarps) {
    const int hl = u / (2 * MT), part = u - hl * 2 * MT, s = hl & 1;
    bf16* dsT = ds_s + 2 * s * RP * LDT;
    bf16* pT = dsT + RP * LDT;
    const size_t row0 = ((size_t)b * H + h0 + hl) * R;
    if (part < MT) {
      mbar_wait(&full[hl], 0);
      query_tile_bf16<DK, RP>(tile(s, 0), tile(s, 1), tile(s, 2), tile(s, 3), zero, wz_s + hl * P, dsT, pT, mask_s,
                              keep == nullptr ? nullptr : keep + row0 * R, keep_prob, dq + row0 * DK, R, part,
                              sqrt_dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&qdone[hl]);
    } else {
      mbar_wait(&qdone[hl], 0);
      key_tile_bf16<DK, RP, KV>(tile(s, 0), tile(s, 3), zero, dsT, pT, dk + row0 * DK,
                                KV ? nullptr : dv + row0 * DK, R, part - MT);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kdone[hl]);
      if (part == 2 * MT - 1 && hl + 2 < G) {
        mbar_wait(&kdone[hl], 0);
        load_head(hl + 2);
      }
    }
  }
  cluster.sync();  // every group's dz is final

  if (dg == kRawG) {
    raw_wg_partials(box_s, wz_s, reinterpret_cast<float*>(ds_s), wg_partial, H, R);  // ds_s is free since phase B
    cluster.sync();  // no block leaves while another still reads its dz
    return;
  }

  // phase C: d wg partials = dz (heads x pairs) . [geo | 1] (pairs x 65), k-steps
  // of 16 pairs shared out over the image's blocks, every head's dz read from
  // the block of its group
  float acc[9][4];
#pragma unroll
  for (int nt = 0; nt < 9; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const float fg = freq[g];
  const bf16* dz_lo = g < H ? cluster.map_shared_rank(wz_s, g / kGroupHeads) + (g % kGroupHeads) * P : nullptr;
  const bf16* dz_hi = g + 8 < H ? cluster.map_shared_rank(wz_s, (g + 8) / kGroupHeads) + ((g + 8) % kGroupHeads) * P
                                : nullptr;
  for (int kt = rank + groups * warp; 16 * kt < P; kt += groups * kBwdWarps) {
    // this lane's pairs: 16 kt + 2t + {0, 1, 8, 9}; lane (g, t) computes coordinates
    // 2 (g & 1) + {0, 1} of pair g >> 1 and shares them with the lanes of the same t
    float mine[2];
    {
      int p = 16 * kt + 2 * t + ((g >> 1) & 1) + 8 * (g >> 2);
      if (p >= P) p = 0;
      const int i = p / R, j = p - (p / R) * R;
      mine[0] = pair_delta(box_s + 4 * i, box_s + 4 * j, 2 * (g & 1));
      mine[1] = pair_delta(box_s + 4 * i, box_s + 4 * j, 2 * (g & 1) + 1);
    }
    float feat[4][8];  // [pair 0, 1, 8, 9][sin c = 0..3, cos c = 0..3]
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int owner = 4 * (2 * pp + (c >> 1)) + t;  // the lane (g = 2 pp + c / 2, t) computed it
        const float pos = __shfl_sync(0xffffffffu, (c & 1) ? mine[1] : mine[0], owner);
        float sn, cs;
        trig_feature<float>(pos, fg, sn, cs);  // rounded to bf16 as it is packed below
        const int p = 16 * kt + 2 * t + (pp & 1) + 8 * (pp >> 1);
        feat[pp][c] = p < P ? sn : 0.f;
        feat[pp][4 + c] = p < P ? cs : 0.f;
      }
    }
    uint32_t a[4];
    {
      const int p = 16 * kt + 2 * t;
      auto at = [&](const bf16* dz, int pp) { return dz != nullptr && pp < P ? __bfloat162float(dz[pp]) : 0.f; };
      a[0] = pack_bf16(at(dz_lo, p), at(dz_lo, p + 1));
      a[1] = pack_bf16(at(dz_hi, p), at(dz_hi, p + 1));
      a[2] = pack_bf16(at(dz_lo, p + 8), at(dz_lo, p + 9));
      a[3] = pack_bf16(at(dz_hi, p + 8), at(dz_hi, p + 9));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t bb[2] = {pack_bf16(feat[0][nt], feat[1][nt]), pack_bf16(feat[2][nt], feat[3][nt])};
      mma_bf16(acc[nt], a, bb);
    }
    {
      const int p = 16 * kt + 2 * t;
      const uint32_t bb[2] = {g == 0 ? pack_bf16(p < P ? 1.f : 0.f, p + 1 < P ? 1.f : 0.f) : 0u,
                              g == 0 ? pack_bf16(p + 8 < P ? 1.f : 0.f, p + 9 < P ? 1.f : 0.f) : 0u};
      mma_bf16(acc[8], a, bb);
    }
  }
  cluster.sync();  // no block leaves while another still reads its dz
  // fold the warps in order: accumulator rows g and g + 8 hold heads g and g + 8's
  // features 8 nt + 2t, + 1 (nt < 8) and, at column 0 of n-tile 8, the bias sum
  float* fold = reinterpret_cast<float*>(tiles);  // kBwdWarps x 16 heads x 72, the stages are free now
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int head = g + 8 * half;
    if (head < H) {
#pragma unroll
      for (int nt = 0; nt < 9; ++nt) {
        float* f = fold + (warp * kMaxHeads + head) * 72 + 8 * nt + 2 * t;
        f[0] = acc[nt][2 * half];
        f[1] = acc[nt][2 * half + 1];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * kWgCols; e += blockDim.x) {
    const int hh = e / kWgCols, col = e - hh * kWgCols;
    float sum_w = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) sum_w += fold[(w * kMaxHeads + hh) * 72 + col];
    wg_partial[(((size_t)b * groups + rank) * H + hh) * kWgCols + col] = sum_w;
  }
}

// ------------------------------------------------------------ f32: CUDA cores
constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kRows = 4;               // query (key) rows a warp takes at once, sharing each load
// f32 row stride (68 / 36 / 20 floats): 128-bit loads of 8 lanes hit distinct banks
template <int DK> constexpr int kRowLd = kPad<DK> + 4;

inline size_t bwd_f32_smem_bytes(int dk, int R, bool kv) {
  const size_t floats = ((kGroupHeads * (size_t)R * R + 3) / 4) * 4 + (kv ? 3 : 4) * (size_t)R * (padded_width(dk) + 4) +
                        2 * (size_t)R * R +
                        (size_t)R * 4 + (size_t)kMaxHeads * 64 + kMaxHeads + kFreqs;
  return floats * sizeof(float) + R;
}

template <int DK, bool KV>
__global__ void __launch_bounds__(kF32Threads)
box_attention_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ dout, const float* __restrict__ boxes,
                             const float* __restrict__ wg_w, const float* __restrict__ wg_b,
                             const float* __restrict__ freq, const unsigned char* __restrict__ mask,
                             const unsigned char* __restrict__ keep, float keep_prob, float* __restrict__ dq,
                             float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ wg_partial, int H,
                             int R, float sqrt_dk, int dg) {
  extern __shared__ __align__(16) float smem_f[];
  constexpr int RLD = kRowLd<DK>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int b = blockIdx.x, h0 = kGroupHeads * blockIdx.y, G = min(kGroupHeads, H - h0);
  float* wz_s = smem_f;                                          // G * R * R: w_g, then dz
  float* q_s = wz_s + ((kGroupHeads * R * R + 3) / 4) * 4;       // R * RLD
  float* k_s = q_s + R * RLD;
  float* v_s = KV ? k_s : k_s + R * RLD;  // the kv mode reads the k rows as v
  float* do_s = v_s + R * RLD;
  float* ds_s = do_s + R * RLD;  // R * R: dS / sqrt_dk, masked keys zeroed
  float* pd_s = ds_s + R * R;       // R * R: P~
  float* box_s = pd_s + R * R;
  float* w_s = box_s + R * 4;       // H * dg (room for 16 * 64)
  float* wb_s = w_s + kMaxHeads * 64;
  float* freq_s = wb_s + kMaxHeads;
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(freq_s + kFreqs);
  for (int e = threadIdx.x; e < R * 4; e += blockDim.x) box_s[e] = boxes[(size_t)b * R * 4 + e];
  for (int e = threadIdx.x; e < H * dg; e += blockDim.x) w_s[e] = wg_w[e];
  for (int e = threadIdx.x; e < H; e += blockDim.x) wb_s[e] = wg_b[e];
  for (int e = threadIdx.x; e < kFreqs; e += blockDim.x) freq_s[e] = freq[e];
  for (int e = threadIdx.x; e < R; e += blockDim.x) mask_s[e] = mask[(size_t)b * R + e];
  __syncthreads();

  for (int p = threadIdx.x; p < R * R; p += blockDim.x) {
    const int i = p / R, j = p - (p / R) * R;
    float wg[kMaxHeads];
    if (dg == kRawG) {
      pair_wg_raw<float>(box_s + 4 * i, box_s + 4 * j, w_s, wb_s, H, wg);
    } else {
      pair_wg<float>(box_s + 4 * i, box_s + 4 * j, w_s, wb_s, freq_s, H, wg);
    }
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh >= h0 && hh < h0 + G) wz_s[(hh - h0) * R * R + p] = wg[hh];
    }
  }

  const float min_wg = 1e-6f;
  const int j0 = lane < R ? lane : 0, j1 = lane + 32 < R ? lane + 32 : 0;  // this lane's keys (clamped)
  for (int hl = 0; hl < G; ++hl) {
    const size_t base = ((size_t)b * H + h0 + hl) * R * DK;
    __syncthreads();  // w_g done / the previous head's tiles no longer read
    if constexpr (kNarrow<DK>) {
      stage_padded<DK>(q_s, RLD, q + base, R, threadIdx.x, blockDim.x);
      stage_padded<DK>(k_s, RLD, k + base, R, threadIdx.x, blockDim.x);
      if (!KV) stage_padded<DK>(v_s, RLD, v + base, R, threadIdx.x, blockDim.x);
      stage_padded<DK>(do_s, RLD, dout + base, R, threadIdx.x, blockDim.x);
    } else {
      for (int e = threadIdx.x; e < R * (DK / 4); e += blockDim.x) {
        const int r = e / (DK / 4), c = 4 * (e % (DK / 4));
        *reinterpret_cast<float4*>(q_s + r * RLD + c) = *reinterpret_cast<const float4*>(q + base + r * DK + c);
        *reinterpret_cast<float4*>(k_s + r * RLD + c) = *reinterpret_cast<const float4*>(k + base + r * DK + c);
        if (!KV) *reinterpret_cast<float4*>(v_s + r * RLD + c) = *reinterpret_cast<const float4*>(v + base + r * DK + c);
        *reinterpret_cast<float4*>(do_s + r * RLD + c) =
            *reinterpret_cast<const float4*>(dout + base + r * DK + c);
      }
    }
    __syncthreads();
    float* wz = wz_s + hl * R * R;
    // query side, 4 rows a warp: scores and dP for the lane's keys, one k / v load for the 4 rows
    for (int i0 = kRows * warp; i0 < R; i0 += kRows * kF32Warps) {
      float qk[kRows][2], pv[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qk[r][0] = qk[r][1] = pv[r][0] = pv[r][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kPad<DK>; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(k_s + j0 * RLD + d);
        const float4 k1 = *reinterpret_cast<const float4*>(k_s + j1 * RLD + d);
        const float4 v0 = *reinterpret_cast<const float4*>(v_s + j0 * RLD + d);
        const float4 v1 = *reinterpret_cast<const float4*>(v_s + j1 * RLD + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = min(i0 + r, R - 1);
          const float4 qv = *reinterpret_cast<const float4*>(q_s + i * RLD + d);   // broadcast
          const float4 dov = *reinterpret_cast<const float4*>(do_s + i * RLD + d);  // broadcast
          qk[r][0] = fmaf(qv.w, k0.w, fmaf(qv.z, k0.z, fmaf(qv.y, k0.y, fmaf(qv.x, k0.x, qk[r][0]))));
          qk[r][1] = fmaf(qv.w, k1.w, fmaf(qv.z, k1.z, fmaf(qv.y, k1.y, fmaf(qv.x, k1.x, qk[r][1]))));
          pv[r][0] = fmaf(dov.w, v0.w, fmaf(dov.z, v0.z, fmaf(dov.y, v0.y, fmaf(dov.x, v0.x, pv[r][0]))));
          pv[r][1] = fmaf(dov.w, v1.w, fmaf(dov.z, v1.z, fmaf(dov.y, v1.y, fmaf(dov.x, v1.x, pv[r][1]))));
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i >= R) break;  // warp-uniform
        const unsigned char* kr = keep == nullptr ? nullptr : keep + (((size_t)b * H + h0 + hl) * R + i) * R;
        float s[2], dpk[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          s[c] = -INFINITY;
          dpk[c] = 0.f;
          if (j < R) {
            s[c] = div_score(qk[r][c], sqrt_dk);
            if (mask_s[j] == 0) s[c] = kNegInf;
            s[c] += logf(wz[i * R + j]);
            dpk[c] = kr == nullptr ? pv[r][c] : kr[j] ? pv[r][c] / keep_prob : 0.f;
          }
        }
        const float m = warp_max(fmaxf(s[0], s[1]));
        const float e0 = lane < R ? expf(s[0] - m) : 0.f;
        const float e1 = lane + 32 < R ? expf(s[1] - m) : 0.f;
        const float sum = warp_sum(e0 + e1);
        const float p[2] = {e0 / sum, e1 / sum};
        const float gp[2] = {dpk[0] * p[0], dpk[1] * p[1]};
        const float di = warp_sum(gp[0] + gp[1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          if (j < R) {
            const float ds = fmaf(-p[c], di, gp[c]);
            pd_s[i * R + j] = kr == nullptr ? p[c] : kr[j] ? p[c] / keep_prob : 0.f;
            ds_s[i * R + j] = mask_s[j] ? div_score(ds, sqrt_dk) : 0.f;
            const float w = wz[i * R + j];
            wz[i * R + j] = w > min_wg ? ds / w : 0.f;
          }
        }
      }
      __syncwarp();
      // dq of the 4 rows: lane = a pair of columns (owns_cols), one k load for the 4 rows
      if (owns_cols<DK>(lane)) {
        float2 acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = make_float2(0.f, 0.f);
        for (int j = 0; j < R; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(k_s + j * RLD + 2 * lane);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float ds = ds_s[min(i0 + r, R - 1) * R + j];
            acc[r].x = fmaf(ds, kv.x, acc[r].x);
            acc[r].y = fmaf(ds, kv.y, acc[r].y);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (i0 + r < R) store_col_pair<DK>(dq + base + (size_t)(i0 + r) * DK, 2 * lane, acc[r]);
        }
      }
    }
    __syncthreads();
    // key side, 4 key rows a warp: dk and dv, one q / dO load for the 4 rows
    for (int jb = kRows * warp; jb < R && owns_cols<DK>(lane); jb += kRows * kF32Warps) {
      float2 ak[kRows], av[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ak[r] = av[r] = make_float2(0.f, 0.f);
      for (int i = 0; i < R; ++i) {
        const float2 qv = *reinterpret_cast<const float2*>(q_s + i * RLD + 2 * lane);
        const float2 dov = *reinterpret_cast<const float2*>(do_s + i * RLD + 2 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = min(jb + r, R - 1);
          const float ds = ds_s[i * R + j], pd = pd_s[i * R + j];
          ak[r].x = fmaf(ds, qv.x, ak[r].x);
          ak[r].y = fmaf(ds, qv.y, ak[r].y);
          av[r].x = fmaf(pd, dov.x, av[r].x);
          av[r].y = fmaf(pd, dov.y, av[r].y);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (jb + r < R && KV) {  // d(k as K) + d(k as V)
          store_col_pair<DK>(dk + base + (size_t)(jb + r) * DK, 2 * lane,
                             make_float2(ak[r].x + av[r].x, ak[r].y + av[r].y));
        } else if (jb + r < R) {
          store_col_pair<DK>(dk + base + (size_t)(jb + r) * DK, 2 * lane, ak[r]);
          store_col_pair<DK>(dv + base + (size_t)(jb + r) * DK, 2 * lane, av[r]);
        }
      }
    }
  }
  __syncthreads();

  // d wg partials. Lane = (coordinate c, frequency f); warp = pair slice. The
  // raw geometry: lane c < 4 takes log-delta c (column c), the other lanes 0.
  const int c = lane / kFreqs, f = lane % kFreqs;
  float acc_s[kGroupHeads], acc_c[kGroupHeads], acc_b[kGroupHeads];
#pragma unroll
  for (int hl = 0; hl < kGroupHeads; ++hl) acc_s[hl] = acc_c[hl] = acc_b[hl] = 0.f;
  if (dg == kRawG) {
    for (int p = warp; p < R * R; p += kF32Warps) {
      const int i = p / R, j = p - (p / R) * R;
      const float sn = lane < kRawG ? pair_delta(box_s + 4 * i, box_s + 4 * j, lane) : 0.f;
#pragma unroll
      for (int hl = 0; hl < kGroupHeads; ++hl) {
        if (hl < G) {
          const float dz = wz_s[hl * R * R + p];
          acc_s[hl] = fmaf(dz, sn, acc_s[hl]);
          acc_b[hl] += dz;
        }
      }
    }
  } else {
    for (int p = warp; p < R * R; p += kF32Warps) {
      const int i = p / R, j = p - (p / R) * R;
      float sn, cs;
      trig_feature<float>(pair_delta(box_s + 4 * i, box_s + 4 * j, c), freq_s[f], sn, cs);
#pragma unroll
      for (int hl = 0; hl < kGroupHeads; ++hl) {
        if (hl < G) {
          const float dz = wz_s[hl * R * R + p];
          acc_s[hl] = fmaf(dz, sn, acc_s[hl]);
          acc_c[hl] = fmaf(dz, cs, acc_c[hl]);
          acc_b[hl] += dz;
        }
      }
    }
  }
  // fold the warps in order into (G, 65) = [sin features 0..31 | cos 32..63 | bias]
  float* fold = q_s;  // free once all warps are here
  for (int w = 0; w < kF32Warps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int hl = 0; hl < kGroupHeads; ++hl) {
        if (hl < G) {
          float* fr = fold + hl * kWgCols;
          fr[lane] = (w == 0 ? 0.f : fr[lane]) + acc_s[hl];
          fr[32 + lane] = (w == 0 ? 0.f : fr[32 + lane]) + acc_c[hl];
          if (lane == 0) fr[64] = (w == 0 ? 0.f : fr[64]) + acc_b[hl];
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < G * kWgCols; e += blockDim.x) {
    wg_partial[((size_t)b * H + h0) * kWgCols + e] = fold[e];
  }
}

// d wg_w (H, dg) and d wg_b (H,): sums of the partials (B, Y, H, 65), in
// order; at dg 4 a partial row's columns 4..63 are not read
template <typename T>
__global__ void wg_reduce_kernel(const float* __restrict__ partial, int B, int Y, int H, int dg,
                                 T* __restrict__ dwg_w, T* __restrict__ dwg_b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * kWgCols) return;
  const int hh = e / kWgCols, g = e - hh * kWgCols;
  if (g >= dg && g < 64) return;
  float acc = 0.f;
  for (int by = 0; by < B * Y; ++by) acc += partial[(size_t)by * H * kWgCols + e];
  if (g < 64) dwg_w[hh * dg + g] = from_f<T>(acc);
  else dwg_b[hh] = from_f<T>(acc);
}

template <typename T>
cudaError_t launch_reduce(void* partial, int B, int Y, int H, int dg, void* dwg_w, void* dwg_b, cudaStream_t stream) {
  wg_reduce_kernel<T><<<(H * kWgCols + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(partial), B, Y, H, dg,
                                                                     static_cast<T*>(dwg_w), static_cast<T*>(dwg_b));
  return cudaGetLastError();
}

template <int DK, bool KV>
int bwd_entry(int dtype, const void* q, const void* k, const void* v, const void* dout, const void* boxes,
              const void* wg_w, const void* wg_b, const void* freq, const void* mask, const void* keep,
              float keep_prob, void* dq, void* dk, void* dv, void* dwg_w, void* dwg_b, void* partial, int B, int H,
              int R, float sqrt_dk, int dg, void* stream) {
  if (H < 1 || H > kMaxHeads || R < 1 || R > 64 || B < 1 || (dg != kTrigG && dg != kRawG))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, (H + kGroupHeads - 1) / kGroupHeads);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    const size_t smem = bwd_f32_smem_bytes(DK, R, KV);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(box_attention_bwd_f32_kernel<DK, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    box_attention_bwd_f32_kernel<DK, KV><<<grid, kF32Threads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(boxes), static_cast<const float*>(wg_w),
        static_cast<const float*>(wg_b), static_cast<const float*>(freq), mk, kp, keep_prob, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), part, H, R, sqrt_dk, dg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_reduce<float>(partial, B, 1, H, dg, dwg_w, dwg_b, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_mma_smem_bytes(DK, R, KV);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int rp = padded_rows(R);
  auto kernel = rp == 16 ? box_attention_bwd_mma_kernel<DK, 16, KV>
                : rp == 32 ? box_attention_bwd_mma_kernel<DK, 32, KV>
                : rp == 48 ? box_attention_bwd_mma_kernel<DK, 48, KV>
                           : box_attention_bwd_mma_kernel<DK, 64, KV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kBwdThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = grid.y;  // an image's head groups share its geometry
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                           static_cast<const float*>(boxes), static_cast<const bf16*>(wg_w),
                           static_cast<const bf16*>(wg_b), static_cast<const float*>(freq), mk, kp, keep_prob,
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, H, R,
                           sqrt_dk, dg);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce<bf16>(partial, B, grid.y, H, dg, dwg_w, dwg_b, s);
}

// the instance of head width dk (64, 32 or 13)
template <bool KV>
int bwd_entry_dk(int dtype, int dk_width, int dg, const void* q, const void* k, const void* v, const void* dout,
                 const void* boxes, const void* wg_w, const void* wg_b, const void* freq, const void* mask,
                 const void* keep, float keep_prob, void* dq, void* dk, void* dv, void* dwg_w, void* dwg_b,
                 void* partial, int B, int H, int R, float sqrt_dk, void* stream) {
#define SCT_DK(DK)                                                                                                   \
  bwd_entry<DK, KV>(dtype, q, k, v, dout, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, dq, dk, dv, dwg_w, dwg_b, \
                    partial, B, H, R, sqrt_dk, dg, stream)
  if (dk_width == 64) return SCT_DK(64);
  if (dk_width == 32) return SCT_DK(32);
  if (dk_width == 13) return SCT_DK(13);
#undef SCT_DK
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16; dk_width: the head width, 64, 32 or 13; dg: the geometry's width, 64 or 4.
// q, k, v, dout, dq, dk, dv (B, H, R, dk); boxes (B, R, 4) f32; wg_w (H, dg), wg_b (H,), dwg_w, dwg_b in the
// compute dtype; freq (8,) f32 (read at dg 64); mask (B, R) bool; keep (B, H, R, R) bool or null with
// keep_prob (the divisor, rounded to the compute dtype); partial (B, ceil(H / 4), H, 65) f32 scratch;
// sqrt_dk as sct_box_attention took it.
extern "C" int sct_box_attention_bwd(int dtype, int dk_width, int dg, const void* q, const void* k, const void* v,
                                     const void* dout, const void* boxes, const void* wg_w, const void* wg_b,
                                     const void* freq, const void* mask, const void* keep, float keep_prob, void* dq,
                                     void* dk, void* dv, void* dwg_w, void* dwg_b, void* partial, int B, int H, int R,
                                     float sqrt_dk, void* stream) {
  return sct::bwd_entry_dk<false>(dtype, dk_width, dg, q, k, v, dout, boxes, wg_w, wg_b, freq, mask, keep, keep_prob,
                                  dq, dk, dv, dwg_w, dwg_b, partial, B, H, R, sqrt_dk, stream);
}

// kv mode: k is also V; dkv (B, H, R, dk) receives its one gradient.
extern "C" int sct_box_attention_bwd_kv(int dtype, int dk_width, int dg, const void* q, const void* k,
                                        const void* dout, const void* boxes, const void* wg_w, const void* wg_b,
                                        const void* freq, const void* mask, const void* keep, float keep_prob,
                                        void* dq, void* dkv, void* dwg_w, void* dwg_b, void* partial, int B, int H,
                                        int R, float sqrt_dk, void* stream) {
  return sct::bwd_entry_dk<true>(dtype, dk_width, dg, q, k, k, dout, boxes, wg_w, wg_b, freq, mask, keep, keep_prob,
                                 dq, dkv, nullptr, dwg_w, dwg_b, partial, B, H, R, sqrt_dk, stream);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
