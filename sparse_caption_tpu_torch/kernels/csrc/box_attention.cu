// K1: fused ORT box-relation self-attention, forward.
//
// Replaces: sparse_caption_tpu/models/layers.py:338-365 box_relational_embedding
// and :406-439 BoxMultiHeadAttention.__call__ (left to XLA's fusions on the
// TPU; no Pallas kernel there).
//
// Computes, for each image b and head h, with the cast points of the plain
// version (layers.py:425-435, ops/attention.py):
//   geo[i,j]   = sin/cos(100 * log-delta(box_i, box_j) * freq)      (f32 trig, rounded to T)
//   w_g[i,j,h] = max(relu(round(round(geo . wg[h]) + wg_b[h])), 1e-6)
//   bias       = round(log(w_g))
//   s          = round(fill(round(round(q.k) / sqrt_dk), mask, -1e9) + bias)   (sqrt_dk = sqrt(dk) in T)
//   p          = round(softmax(s))    (f32 max, exp and sum)
//   out        = round(p . v)
// where round() is the rounding to the compute dtype T (a no-op in f32).
//
// Bound on the H100 (d_model 512, 8 heads, R = 36): bytes, then the trig.
// q, k, v and out are 4 * B * 8 * 36 * 64 elements (302 MB in bf16 at B =
// 2048, 0.09 ms at 3.35 TB/s); the geometry is 1296 x 32 sincosf per image
// (about 0.1 ms on the CUDA cores at B = 2048); the products (QK, PV, the
// 64-wide wg dot per pair and head) are under 10 GFLOP. The geometry tensor
// (B, R, R, 64) and the bias (B, h, R, R) never leave the SM.
//
// Design: in bf16 (the serving and XE path), one block of 8 warps per image,
// everything on tensor cores with mma.sync.m16n8k16 (f32 accumulators).
// - Geometry as a product (box_geometry.cuh geometry_tile_bf16): each warp
//   takes tiles of 16 pairs, computes the trig features of its A fragments in
//   registers (one sincosf per pair, coordinate and frequency), multiplies
//   them by wg^T (one n-tile = 8 heads, four k-steps) and writes the rounded
//   log-bias of every head into shared memory (bf16, H * R * R).
// - Loads: each head's q, k and v tiles (R rows of 128 B each) arrive by 1-D
//   TMA (cp.async.bulk, one copy per row into rows padded to 144 B, so that
//   the fragment loads below hit 32 distinct banks) on the head's mbarrier,
//   in 3 stages: heads 0-2 load while the block computes the geometry, head
//   h + 3 as soon as every tile of head h is done (a second mbarrier per
//   head). Rows past R read one shared zero row.
// - Attention: the (head, 16-row query tile) units, H * ceil(R / 16) of them,
//   go to the 8 warps in turn (R padded to RP = 16 * ceil(R / 16)). S = QK^T
//   (4 k-steps over d = 64, 2 RP / 16
//   n-tiles of keys) stays in the accumulators; the division, fill, bias and
//   the f32 softmax (row max and sum over the quad by shuffles) run there;
//   P is rounded to bf16 and reused in registers as the A operand of P.V
//   (V's B fragments by ldmatrix.trans, 8 n-tiles over d); the result goes
//   through the warp's own rows of the q tile to 16-byte stores.
// - mma.sync and not wgmma: the tiles are 36 x 36 x 64, far below what a
//   64-row warpgroup tile would fill, and the kernel is bound by bytes and
//   trig, not by the tensor cores. Shared memory per block at R = 36, h = 8:
//   46.8 KB of staged tiles + 20.7 KB of bias + 1 KB = 69 KB, so three
//   blocks (24 warps) per SM, as the registers (80 a thread, held to 85 by
//   the launch bounds) allow.
// In f32 (the SCST path; TF32 is never used), one block of 8 warps per
// image on the CUDA cores with exact f32 FMAs. The geometry is computed pair
// by pair (box_geometry.cuh pair_wg); then, head by head, each warp takes 4
// query rows at a time: every lane holds one key (two for R > 32) and reads it
// with 128-bit loads shared by the 4 rows, and P.V reads each value pair once
// for the 4 rows.
//
// Train variant (sct_box_attention_train): the same kernels also apply the
// attention-probability dropout keep-mask (B, h, R, R) as
// round(p / keep_prob) where kept, 0 elsewhere (layers.py:437-438). K7
// (box_attention_bwd.cu) recomputes the probabilities itself, with this
// arithmetic, so nothing else is saved.
// Check output (bias_out of sct_box_attention, null on the main path): the
// (B, h, R, R) log-bias in T.
//
// kv mode (sct_box_attention_kv, sct_box_attention_train_kv; ACORT's
// kv-shared encoder layers, where V is the K tensor): the bf16 kernel stages
// q and k of each head (2 tiles a stage instead of 3) and feeds the k tile
// to both products, S = QK^T and O = PV (V's B fragments by ldmatrix.trans
// from the k rows); the f32 kernel stages k once and reads its rows as V.
// Bytes at ACORT's serving shape (B = 2048, 8 heads, R = 36): 226 MB instead
// of 302.
// Head width 13 (ORT-xsmall's d104 over 8 heads): the tiles are staged at
// width 16 with columns 13-15 zero (common.cuh kPad), one mma k-step over d;
// its 26-byte rows take no TMA, so the loading warp copies them element by
// element and arrives on the head's mbarrier itself; only the 13 real
// columns of out are written.
// Raw geometry (dg = 4, --no_box_trigonometric_embedding; a run-time
// argument, every instance above takes it): geo[i,j] is the four log-deltas
// rounded to T, and w_g[i,j,h] = max(relu(round(round(geo . wg[h]) +
// wg_b[h])), 1e-6) with the dot as four FMAs in coordinate order
// (box_geometry.cuh pair_wg_raw), pair by pair over the block's threads in
// both dtypes (no trig, no product on the tensor cores; in bf16 a function
// of its own, raw_log_bias, so that the trig path's code stays as it was);
// the attention is unchanged. wg_w is then (H, 4).
#include "box_geometry.cuh"

namespace sct {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16: tensor cores
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kStages = 3;  // heads in flight: 3 x ceil(36 / 16) = 9 query tiles for the 8 warps
// staged row stride in bf16 at head width DK (144 B at 64, 80 B at 32, 48 B
// at 13: the 8 rows of a fragment or ldmatrix load in distinct banks; 16-byte
// aligned for TMA)
template <int DK> constexpr int kLd = kPad<DK> + 8;

inline int padded_rows(int R) { return 16 * ((R + 15) / 16); }

// dynamic shared memory: 2 mbarriers per head | kStages x (q, k, v) x R rows
// ((q, k) in the kv mode) | a zero row (every padded row reads it) | bias |
// boxes | wg_b | mask
inline size_t mma_smem_bytes(int dk, int H, int R, bool kv) {
  const size_t tiles = (kStages * (kv ? 2 : 3) * (size_t)R + 1) * (padded_width(dk) + 8) * sizeof(bf16);
  const size_t bias = (((size_t)H * R * R + 7) / 8) * 8 * sizeof(bf16);
  return 2 * kMaxHeads * sizeof(uint64_t) + tiles + bias + (size_t)R * 4 * sizeof(float) +
         kMaxHeads * sizeof(float) + R;
}

// row r of a staged tile, or the zero row for the padding rows r >= R
template <int DK>
__device__ __forceinline__ const bf16* tile_row(const bf16* tile, int r, int R, const bf16* zero) {
  return r < R ? tile + r * kLd<DK> : zero;
}

template <int DK, int RP>
__device__ __forceinline__ void attend_tile_bf16(bf16* qs, const bf16* ks, const bf16* vs, const bf16* zero,
                                                 const bf16* bias_h, const unsigned char* mask_s,
                                                 const unsigned char* __restrict__ keep_h, float keep_prob,
                                                 bf16* __restrict__ out_h, int R, int mt, float sqrt_dk) {
  constexpr int KS = RP / 16;  // key k-steps of P.V
  constexpr int NS = 2 * KS;   // key n-tiles of S
  constexpr int LD = kLd<DK>, ND = kPad<DK> / 8;  // ND: output n-tiles over d
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows[2] = {16 * mt + g, 16 * mt + g + 8};
  const int nsv = (R + 7) / 8;  // key n-tiles that hold keys; the rest of S stays 0 and P 0

  float sacc[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < kPad<DK> / 16; ++kd) {
    const int col = 16 * kd + 2 * t;
    const bf16* q0 = tile_row<DK>(qs, rows[0], R, zero) + col;
    const bf16* q1 = tile_row<DK>(qs, rows[1], R, zero) + col;
    const uint32_t a[4] = {lds_u32(q0), lds_u32(q1), lds_u32(q0 + 8), lds_u32(q1 + 8)};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      if (nt < nsv) {
        const bf16* kr = tile_row<DK>(ks, 8 * nt + g, R, zero) + col;
        const uint32_t b[2] = {lds_u32(kr), lds_u32(kr + 8)};
        mma_bf16(sacc[nt], a, b);
      }
    }
  }

  // scores, then the softmax of each row over its quad
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
        if (row < R) s = round_to<bf16>(s + __bfloat162float(bias_h[row * R + j]));
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
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * nt + 2 * t + (e & 1), row = rows[e >> 1];
      float p = round_to<bf16>(div_by(sacc[nt][e], sum[e >> 1], inv[e >> 1]));  // P rounded where the plain softmax writes it
      if (keep_h != nullptr) p = row < R && j < R && keep_h[row * R + j] ? round_to<bf16>(p / keep_prob) : 0.f;
      sacc[nt][e] = p;
    }
  }

  // P.V: P's accumulators are the A fragments; V's B fragments by ldmatrix.trans
  float oacc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]), pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                           pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                           pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
    for (int jn = 0; jn < kPad<DK> / 16; ++jn) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, tile_row<DK>(vs, 16 * kk + (lane & 15), R, zero) + 16 * jn + (lane >> 4) * 8);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(oacc[2 * jn], a, b0);
      mma_bf16(oacc[2 * jn + 1], a, b1);
    }
  }

  // out: through this warp's own 16 rows of the q tile, then 16-byte stores
  __syncwarp();  // every lane is done reading those q rows
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    const int col = 8 * nt + 2 * t;
    if (rows[0] < R) *reinterpret_cast<uint32_t*>(qs + rows[0] * LD + col) = pack_bf16(oacc[nt][0], oacc[nt][1]);
    if (rows[1] < R) *reinterpret_cast<uint32_t*>(qs + rows[1] * LD + col) = pack_bf16(oacc[nt][2], oacc[nt][3]);
  }
  __syncwarp();
  if constexpr (kNarrow<DK>) {  // the real columns, one element a store
    const int live = R - 16 * mt < 16 ? R - 16 * mt : 16;
    store_unpadded<DK>(out_h + 16 * mt * DK, qs + 16 * mt * LD, LD, live, lane, 32);
  } else {
    for (int c = lane; c < 16 * (DK / 8); c += 32) {
      const int row = 16 * mt + c / (DK / 8), col = 8 * (c % (DK / 8));
      if (row < R) {
        *reinterpret_cast<uint4*>(out_h + row * DK + col) = *reinterpret_cast<const uint4*>(qs + row * LD + col);
      }
    }
  }
}

// three blocks an SM: at most 85 registers a thread (the kv mode took 91,
// and two blocks an SM, when left free)
template <int DK, int RP, bool KV>
__global__ void __launch_bounds__(kMmaThreads, 3)
box_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const float* __restrict__ boxes, const bf16* __restrict__ wg_w,
                         const bf16* __restrict__ wg_b, const float* __restrict__ freq,
                         const unsigned char* __restrict__ mask, const unsigned char* __restrict__ keep,
                         float keep_prob, bf16* __restrict__ out, bf16* __restrict__ bias_out, int H, int R,
                         float sqrt_dk, int dg) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // per head: its tiles have landed
  uint64_t* empty = full + kMaxHeads;                  // per head: its query tiles are done
  constexpr int NT = KV ? 2 : 3;  // tiles a stage: q, k and, but in the kv mode, v
  constexpr int LD = kLd<DK>;
  bf16* tiles = reinterpret_cast<bf16*>(empty + kMaxHeads);  // [stage][q, k, v][R][LD]
  const int P = R * R, MT = RP / 16;
  bf16* zero = tiles + kStages * NT * R * LD;  // LD zeros
  bf16* bias_s = zero + LD;             // [H][R][R]
  float* box_s = reinterpret_cast<float*>(bias_s + ((H * P + 7) / 8) * 8);
  float* wb_s = box_s + R * 4;
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(wb_s + kMaxHeads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const int b = blockIdx.x;
  // tile 2, V, is the k tile in the kv mode
  auto tile = [&](int stage, int which) { return tiles + (stage * NT + (which < NT ? which : 1)) * R * LD; };

  if (threadIdx.x == 0) {
    for (int h = 0; h < H; ++h) {
      mbar_init(&full[h], 1);
      mbar_init(&empty[h], MT);
    }
    mbar_fence_init();
  }
  for (int e = threadIdx.x; e < LD; e += blockDim.x) zero[e] = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < R * 4; e += blockDim.x) box_s[e] = boxes[(size_t)b * R * 4 + e];
  for (int e = threadIdx.x; e < kMaxHeads; e += blockDim.x) wb_s[e] = e < H ? __bfloat162float(wg_b[e]) : 0.f;
  for (int e = threadIdx.x; e < R; e += blockDim.x) mask_s[e] = mask[(size_t)b * R + e];
  __syncthreads();

  const size_t head_elems = (size_t)R * DK;
  auto load_head = [&](int h) {  // one warp: head h's q, k, v (q, k) into stage h % kStages, one copy per row
    const int s = h % kStages;
    const size_t base = ((size_t)b * H + h) * head_elems;
    if constexpr (kNarrow<DK>) {  // 26-byte rows: the warp's own element copies, then its arrival
      stage_padded<DK>(tile(s, 0), LD, q + base, R, lane, 32);
      stage_padded<DK>(tile(s, 1), LD, k + base, R, lane, 32);
      if (!KV) stage_padded<DK>(tile(s, 2), LD, v + base, R, lane, 32);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[h]);
    } else {
      if (lane == 0) mbar_arrive_expect_tx(&full[h], (unsigned)NT * R * DK * sizeof(bf16));
      __syncwarp();
      for (int r = lane; r < R; r += 32) {
        tma_load_1d(tile(s, 0) + r * LD, q + base + r * DK, DK * sizeof(bf16), &full[h]);
        tma_load_1d(tile(s, 1) + r * LD, k + base + r * DK, DK * sizeof(bf16), &full[h]);
        if (!KV) tma_load_1d(tile(s, 2) + r * LD, v + base + r * DK, DK * sizeof(bf16), &full[h]);
      }
    }
  };
  if (warp < kStages && warp < H) load_head(warp);

  // geometry log-bias of every (head, pair): the raw geometry pair by pair
  // (four FMAs a head), the trig features in tiles of 16 pairs on the tensor cores
  if (dg == kRawG) {
    raw_log_bias<bf16>(box_s, wg_w, wb_s, H, R, bias_s, bias_out == nullptr ? nullptr : bias_out + (size_t)b * H * P);
  } else {
    uint32_t wfrag[kHeadTiles][4][2];
    load_wg_frags(wg_w, H, wfrag);
    const float fq[2] = {freq[2 * t], freq[2 * t + 1]};
    for (int mt = warp; 16 * mt < P; mt += kMmaWarps) {
      float wgc[kHeadTiles][4];
      geometry_tile_bf16(box_s, R, mt, fq, wfrag, H, wb_s, wgc);
#pragma unroll
      for (int nt = 0; nt < kHeadTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int head = 8 * nt + 2 * t + (e & 1), p = 16 * mt + g + 8 * (e >> 1);
          if (head < H && p < P) {
            const bf16 lb = __float2bfloat16_rn(logf(wgc[nt][e]));
            bias_s[head * P + p] = lb;
            if (bias_out != nullptr) bias_out[((size_t)b * H + head) * P + p] = lb;
          }
        }
      }
    }
  }
  __syncthreads();

  // attention: the (head, query tile) units in order over all warps. Each
  // head has its own pair of barriers (used once: no phase can be mistaken
  // for another); the warp that finishes a head's last tile waits until the
  // head's other tiles are done too and loads head h + kStages into the stage.
  for (int u = warp; u < H * MT; u += kMmaWarps) {
    const int h = u / MT, mt = u - (u / MT) * MT, s = h % kStages;
    mbar_wait(&full[h], 0);
    const size_t row0 = ((size_t)b * H + h) * R;
    attend_tile_bf16<DK, RP>(tile(s, 0), tile(s, 1), tile(s, 2), zero, bias_s + h * P, mask_s,
                             keep == nullptr ? nullptr : keep + row0 * R, keep_prob, out + row0 * DK, R, mt, sqrt_dk);
    fence_proxy_async();  // the output staging wrote into the stage that a later copy overwrites
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[h]);
    if (mt == MT - 1 && h + kStages < H) {
      mbar_wait(&empty[h], 0);
      load_head(h + kStages);
    }
  }
}

// ------------------------------------------------------------ f32: CUDA cores
constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kRowsPerWarp = 4;          // query rows sharing each key load
// f32 key row stride (68 / 36 / 20 floats): 128-bit loads of 8 lanes hit distinct banks
template <int DK> constexpr int kKeyLd = kPad<DK> + 4;

// the f32 bias region, rounded up so that the tiles after it take 16-byte loads
__host__ __device__ inline int bias_floats(int H, int R) { return ((H * R * R + 3) / 4) * 4; }

inline size_t f32_smem_bytes(int dk, int H, int R, bool kv) {
  const size_t floats = bias_floats(H, R) + (size_t)R * (padded_width(dk) + 4) + (kv ? 1 : 2) * (size_t)R * padded_width(dk) +
                        (size_t)kF32Warps * 64 * kRowsPerWarp + (size_t)R * 4 + (size_t)H * 64 + H + kFreqs;
  return floats * sizeof(float) + R;
}

template <int DK, bool KV>
__global__ void __launch_bounds__(kF32Threads)
box_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ boxes, const float* __restrict__ wg_w,
                         const float* __restrict__ wg_b, const float* __restrict__ freq,
                         const unsigned char* __restrict__ mask, const unsigned char* __restrict__ keep,
                         float keep_prob, float* __restrict__ out, float* __restrict__ bias_out, int H, int R,
                         float sqrt_dk, int dg) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  constexpr int KLD = kKeyLd<DK>, DP = kPad<DK>;  // DP: the staged (padded) width
  float* bias_s = smem_f;                  // H * R * R
  float* q_s = bias_s + bias_floats(H, R);  // R * DP
  float* k_s = q_s + R * DP;               // R * KLD
  float* v_s = KV ? k_s : k_s + R * KLD;   // R * DP; the key tile in the kv mode
  constexpr int vld = KV ? KLD : DP;       // its row stride
  float* p_s = k_s + R * KLD + (KV ? 0 : R * DP);  // per warp 64 keys x 4 rows
  float* box_s = p_s + kF32Warps * 64 * kRowsPerWarp;
  float* w_s = box_s + R * 4;              // H * dg (room for H * 64)
  float* wb_s = w_s + H * 64;              // H
  float* freq_s = wb_s + H;                // kFreqs
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(freq_s + kFreqs);
  const int b = blockIdx.x;
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
      if (hh < H) {
        const float lb = logf(wg[hh]);
        bias_s[hh * R * R + p] = lb;
        if (bias_out != nullptr) bias_out[((size_t)b * H + hh) * R * R + p] = lb;
      }
    }
  }

  float* pw = p_s + warp * 64 * kRowsPerWarp;  // [key][row]
  for (int hh = 0; hh < H; ++hh) {
    const size_t base = ((size_t)b * H + hh) * R * DK;
    __syncthreads();  // bias done / the previous head's tiles no longer read
    if constexpr (kNarrow<DK>) {
      stage_padded<DK>(q_s, DP, q + base, R, threadIdx.x, blockDim.x);
      stage_padded<DK>(k_s, KLD, k + base, R, threadIdx.x, blockDim.x);
      if (!KV) stage_padded<DK>(v_s, DP, v + base, R, threadIdx.x, blockDim.x);
    } else {
      for (int e = threadIdx.x; e < R * (DK / 4); e += blockDim.x) {
        const int r = e / (DK / 4), c = 4 * (e % (DK / 4));
        const float4 qv = *reinterpret_cast<const float4*>(q + base + r * DK + c);
        const float4 kv = *reinterpret_cast<const float4*>(k + base + r * DK + c);
        *reinterpret_cast<float4*>(q_s + r * DK + c) = qv;
        *reinterpret_cast<float4*>(k_s + r * KLD + c) = kv;
        if (!KV) *reinterpret_cast<float4*>(v_s + r * DK + c) = *reinterpret_cast<const float4*>(v + base + r * DK + c);
      }
    }
    __syncthreads();
    const float* bias_h = bias_s + hh * R * R;
    for (int i0 = kRowsPerWarp * warp; i0 < R; i0 += kRowsPerWarp * kF32Warps) {
      float acc[kRowsPerWarp][2];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
      const int j0 = lane < R ? lane : 0, j1 = lane + 32 < R ? lane + 32 : 0;
#pragma unroll 4
      for (int d = 0; d < DP; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(k_s + j0 * KLD + d);
        const float4 k1 = *reinterpret_cast<const float4*>(k_s + j1 * KLD + d);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = min(i0 + r, R - 1);
          const float4 qv = *reinterpret_cast<const float4*>(q_s + i * DP + d);  // broadcast
          acc[r][0] = fmaf(qv.x, k0.x, acc[r][0]);
          acc[r][0] = fmaf(qv.y, k0.y, acc[r][0]);
          acc[r][0] = fmaf(qv.z, k0.z, acc[r][0]);
          acc[r][0] = fmaf(qv.w, k0.w, acc[r][0]);
          acc[r][1] = fmaf(qv.x, k1.x, acc[r][1]);
          acc[r][1] = fmaf(qv.y, k1.y, acc[r][1]);
          acc[r][1] = fmaf(qv.z, k1.z, acc[r][1]);
          acc[r][1] = fmaf(qv.w, k1.w, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = min(i0 + r, R - 1);
        float s[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          s[c] = -INFINITY;
          if (j < R) {
            s[c] = div_score(acc[r][c], sqrt_dk);
            if (mask_s[j] == 0) s[c] = kNegInf;
            s[c] += bias_h[i * R + j];
          }
        }
        const float m = warp_max(fmaxf(s[0], s[1]));
        const float e0 = lane < R ? expf(s[0] - m) : 0.f;
        const float e1 = lane + 32 < R ? expf(s[1] - m) : 0.f;
        const float sum = warp_sum(e0 + e1);
        float p0 = e0 / sum, p1 = e1 / sum;
        if (keep != nullptr) {
          const unsigned char* kr = keep + (((size_t)b * H + hh) * R + i) * R;
          p0 = lane < R && kr[lane] ? p0 / keep_prob : 0.f;
          p1 = lane + 32 < R && kr[lane + 32] ? p1 / keep_prob : 0.f;
        }
        pw[lane * kRowsPerWarp + r] = p0;
        pw[(lane + 32) * kRowsPerWarp + r] = p1;
      }
      __syncwarp();
      if (!owns_cols<DK>(lane)) {  // lane owns output columns 2 lane, 2 lane + 1
        __syncwarp();
        continue;
      }
      float2 o[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) o[r] = make_float2(0.f, 0.f);
      for (int j = 0; j < R; ++j) {
        const float4 pj = *reinterpret_cast<const float4*>(pw + j * kRowsPerWarp);  // broadcast: 4 rows' p
        const float2 vv = *reinterpret_cast<const float2*>(v_s + j * vld + 2 * lane);
        const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          o[r].x = fmaf(pr[r], vv.x, o[r].x);
          o[r].y = fmaf(pr[r], vv.y, o[r].y);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (i0 + r < R) store_col_pair<DK>(out + base + (i0 + r) * DK, 2 * lane, o[r]);
      }
      __syncwarp();  // pw is rewritten by the next rows
    }
  }
}

template <int DK, bool KV>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* boxes, const void* wg_w,
             const void* wg_b, const void* freq, const void* mask, const void* keep, float keep_prob, void* out,
             void* bias_out, int B, int H, int R, float sqrt_dk, int dg, void* stream) {
  if (H < 1 || H > kMaxHeads || R < 1 || R > 64 || B < 1 || (dg != kTrigG && dg != kRawG))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes(DK, H, R, KV);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(box_attention_f32_kernel<DK, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    box_attention_f32_kernel<DK, KV><<<B, kF32Threads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(boxes), static_cast<const float*>(wg_w), static_cast<const float*>(wg_b),
        static_cast<const float*>(freq), mk, kp, keep_prob, static_cast<float*>(out), static_cast<float*>(bias_out),
        H, R, sqrt_dk, dg);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(DK, H, R, KV);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int rp = padded_rows(R);
  auto kernel = rp == 16 ? box_attention_mma_kernel<DK, 16, KV>
                : rp == 32 ? box_attention_mma_kernel<DK, 32, KV>
                : rp == 48 ? box_attention_mma_kernel<DK, 48, KV>
                           : box_attention_mma_kernel<DK, 64, KV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kMmaThreads, smem, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                      static_cast<const bf16*>(v), static_cast<const float*>(boxes),
                                      static_cast<const bf16*>(wg_w), static_cast<const bf16*>(wg_b),
                                      static_cast<const float*>(freq), mk, kp, keep_prob, static_cast<bf16*>(out),
                                      static_cast<bf16*>(bias_out), H, R, sqrt_dk, dg);
  return (int)cudaGetLastError();
}

// the instance of head width dk (64, 32 or 13)
template <bool KV>
int dispatch_dk(int dtype, int dk, int dg, const void* q, const void* k, const void* v, const void* boxes,
                const void* wg_w, const void* wg_b, const void* freq, const void* mask, const void* keep,
                float keep_prob, void* out, void* bias_out, int B, int H, int R, float sqrt_dk, void* stream) {
#define SCT_DK(DK)                                                                                                 \
  dispatch<DK, KV>(dtype, q, k, v, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, out, bias_out, B, H, R, sqrt_dk, \
                   dg, stream)
  if (dk == 64) return SCT_DK(64);
  if (dk == 32) return SCT_DK(32);
  if (dk == 13) return SCT_DK(13);
#undef SCT_DK
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16; dk: the head width, 64, 32 or 13; dg: the geometry's width, 64 (trig
// features) or 4 (the raw log-deltas). q/k/v/out (B, H, R, dk); boxes (B, R, 4) f32;
// wg_w (H, dg) and wg_b (H,) in the compute dtype; freq (8,) f32 (read at dg 64); mask (B, R) bool;
// bias_out (B, H, R, R) in the compute dtype, or null: the log-bias added, for the check;
// sqrt_dk: the scores' divisor, sqrt(dk) rounded to the compute dtype.
extern "C" int sct_box_attention(int dtype, int dk, int dg, const void* q, const void* k, const void* v,
                                 const void* boxes, const void* wg_w, const void* wg_b, const void* freq,
                                 const void* mask, void* out, void* bias_out, int B, int H, int R, float sqrt_dk,
                                 void* stream) {
  return sct::dispatch_dk<false>(dtype, dk, dg, q, k, v, boxes, wg_w, wg_b, freq, mask, nullptr, 1.f, out, bias_out,
                                 B, H, R, sqrt_dk, stream);
}

// Train variant: as above, plus keep (B, H, R, R) bool or null (no dropout)
// with keep_prob (the divisor, already rounded to the compute dtype).
extern "C" int sct_box_attention_train(int dtype, int dk, int dg, const void* q, const void* k, const void* v,
                                       const void* boxes, const void* wg_w, const void* wg_b, const void* freq,
                                       const void* mask, const void* keep, float keep_prob, void* out, int B, int H,
                                       int R, float sqrt_dk, void* stream) {
  return sct::dispatch_dk<false>(dtype, dk, dg, q, k, v, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, out, nullptr,
                                 B, H, R, sqrt_dk, stream);
}

// kv modes of both: k (B, H, R, dk) is also V.
extern "C" int sct_box_attention_kv(int dtype, int dk, int dg, const void* q, const void* k, const void* boxes,
                                    const void* wg_w, const void* wg_b, const void* freq, const void* mask, void* out,
                                    void* bias_out, int B, int H, int R, float sqrt_dk, void* stream) {
  return sct::dispatch_dk<true>(dtype, dk, dg, q, k, k, boxes, wg_w, wg_b, freq, mask, nullptr, 1.f, out, bias_out, B,
                                H, R, sqrt_dk, stream);
}

extern "C" int sct_box_attention_train_kv(int dtype, int dk, int dg, const void* q, const void* k, const void* boxes,
                                          const void* wg_w, const void* wg_b, const void* freq, const void* mask,
                                          const void* keep, float keep_prob, void* out, int B, int H, int R,
                                          float sqrt_dk, void* stream) {
  return sct::dispatch_dk<true>(dtype, dk, dg, q, k, k, boxes, wg_w, wg_b, freq, mask, keep, keep_prob, out, nullptr,
                                B, H, R, sqrt_dk, stream);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
