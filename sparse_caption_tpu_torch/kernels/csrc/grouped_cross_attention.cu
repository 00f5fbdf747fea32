// K3: one decode step of cross-attention where the beam rows of an image share
// that image's projected memory K/V (one row per image, never repeated).
//
// Replaces: sparse_caption_tpu/models/layers.py:236-264
// MultiHeadAttention.decode_cross, grouped branch (left to XLA on the TPU).
//
// For image b, head h and each of its `rep` query rows n = b*rep + r:
//   out[n,h] = softmax(fill(q[n,h] . mem_k[b,h,s] / sqrt(dk), mask[b,s], -1e9)) . mem_v[b,h]
// mem_v == mem_k when the layer shares K and V (mem_v=None in the reference).
//
// Bound on the H100 (beam 5, 8 heads, dk 64, 36 regions): bytes. The memory
// K and V are read once per image: 151 MB of bf16 at B = 2048 (0.045 ms at
// 3.35 TB/s), plus 21 MB of q and out.
//
// Design: in bf16 (the serving path), a persistent grid of small blocks walks
// (image, 2 heads) units, several blocks to an SM. A unit's K and V rows
// (18.4 KB at 36 regions) and its q rows land by 16-byte cp.async copies of
// every thread into rows of 144 bytes (the tensor-core fragment loads of 8
// rows hit distinct banks), with the image's region flags (4-byte copies
// where S is a multiple of 4), two units deep: unit i + 1 loads while unit i
// computes (one stage when two do not fit). Not 1-D TMA: one copy per
// 128-byte row (576 an image, a whole image per block of 8 warps) took
// 0.3974 ms at B = 2048 on an H100, 1.9 times the SIMT kernel this one
// replaced and 7.7 times the bytes' bound: the copies, not the bytes, set
// the pace. Each warp takes
// (head, 16 beam rows) tiles: S = Q K^T on the tensor cores
// (mma.sync.m16n8k16), the softmax on the accumulators, and P V with P's
// accumulators as the A operand and V's B fragments by ldmatrix.trans. The
// scores, their scaling, the probabilities and the output are rounded to
// bf16 where the plain version rounds them. Beam rows past `rep` and regions
// past S read zeros.
// In f32 (the SCST sampling decode): one block per (image, head) stages K and V
// in f32 shared memory once and its warps serve all `rep` rows
// (common.cuh warp_attend_row), in f32 throughout.
// kv mode (sct_grouped_cross_attention_kv; ACORT's kv-shared layers, whose
// memory is one array that is both K and V): both kernels stage the K rows
// alone and read them for both products (QK^T's B fragments and, by
// ldmatrix.trans, P V's); a bf16 unit's stage is (S + rep) x 2 + 1 rows
// instead of (2 S + rep) x 2 + 1. Bytes at ACORT serving (B = 2048, 36
// regions, 8 heads): 75.5 MB of memory rows instead of 151.
// Head width 13 (ORT-xsmall): rows of 26 bytes (52 in f32), 2-byte aligned,
// so no 16-byte copy reaches a row alone. A unit's K rows (its heads' S rows
// each) are one contiguous span, its V rows another, and each beam's q rows
// for the unit's heads a third; each span lands whole by 16-byte cp.async
// copies of its 16-byte envelope (vec.cuh envelope_*; at S = 36, H = 8 the
// K and V spans, 1,872 bytes, are aligned and copied exactly), into a raw
// stage (two units deep, as above), and is then repacked in shared memory
// into the 16-wide rows the fragment loads read (columns 13-15 zero,
// common.cuh kPad; one tile: the raw stage of the next unit lands while
// this one computes). One mma k-step over d; only the 13 real columns of
// out written. The f32 kernel copies its (image, head)'s K and V spans the
// same way and repacks them into its key and value tiles.
#include "common.cuh"
#include "mma.cuh"
#include "vec.cuh"

namespace sct {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16: tensor cores
constexpr int kXMaxWarps = 8;
constexpr int kXHeads = 2;          // heads of an image a unit takes
template <int DK> constexpr int kXLd = kPad<DK> + 8;  // staged row pitch in bf16 (144 B at DK = 64, 80 B at 32, 48 B at 13)

// rows of one unit's stage: K and V of its kXHeads heads (kXHeads * S each),
// its q rows (rep beams x kXHeads heads, beam-major), and a row that holds the
// image's S <= 64 region flags; the kv mode stages K alone
__host__ __device__ inline int cross_stage_rows(int S, int rep, bool kv) {
  return ((kv ? 1 : 2) * S + rep) * kXHeads + 1;
}

// head width 13: a raw stage of a unit, its envelopes (vec.cuh envelope_cap): the K span (kXHeads x S
// rows), the V span (not in the kv mode), a q span a beam (kXHeads rows), then the S region flags
__host__ __device__ inline int cross_raw_bytes(int dk, int S, int rep, bool kv) {
  return (kv ? 1 : 2) * envelope_cap(kXHeads * S * dk * 2) + rep * envelope_cap(kXHeads * dk * 2) +
         (S + 15) / 16 * 16;
}

// `stages` stages and a zero row; head width 13: one repacked stage, a zero row and `stages` raw stages
inline size_t cross_smem_bytes(int dk, int S, int rep, int stages, bool kv) {
  const size_t row = (padded_width(dk) + 8) * sizeof(bf16), rows = cross_stage_rows(S, rep, kv);
  if (dk % 8 != 0) return (rows + 1) * row + stages * (size_t)cross_raw_bytes(dk, S, rep, kv);
  return (stages * rows + 1) * row;
}

// the stages that fit (2, else 1; 0: none)
inline int cross_stages(int dk, int S, int rep, bool kv) {
  if (cross_smem_bytes(dk, S, rep, 2, kv) <= (size_t)kBlockSmemLimit) return 2;
  return cross_smem_bytes(dk, S, rep, 1, kv) <= (size_t)kBlockSmemLimit ? 1 : 0;
}

// one (head, 16 query rows) tile of image b: beams mt * 16 + g and + 8, beam
// r's q at qs + r * qstride rows
template <int DK, int KT>
__device__ __forceinline__ void cross_tile_bf16(const bf16* qs, int qstride, const bf16* ks, const bf16* vs,
                                                const bf16* zero, const unsigned char* mask_b,
                                                bf16* __restrict__ out, int b, int h, int H, int S, int rep, int mt,
                                                float sqrt_dk) {
  constexpr int NS = 2 * KT, LD = kXLd<DK>, ND = kPad<DK> / 8;  // ND: output n-tiles over d
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rows[2] = {16 * mt + g, 16 * mt + g + 8};
  const bool half1 = 16 * mt + 8 < rep;  // warp-uniform: rows g + 8 hold a beam
  uint32_t vbits = 0;  // validity of this lane's regions 8 nt + 2 t + c (bit 2 nt + c)
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 8 * nt + 2 * t + c;
      if (j < S && mask_b[j] != 0) vbits |= 1u << (2 * nt + c);
    }
  }
  const bf16* qr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qr[r] = rows[r] < rep ? qs + rows[r] * qstride * LD : zero;
  const int nsv = (S + 7) / 8;
  float sacc[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < kPad<DK> / 16; ++kd) {
    const int col = 16 * kd + 2 * t;
    const uint32_t aq[4] = {lds_u32(qr[0] + col), lds_u32(qr[1] + col), lds_u32(qr[0] + col + 8),
                            lds_u32(qr[1] + col + 8)};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      if (nt < nsv) {
        const int j = 8 * nt + g;
        const bf16* kr = (j < S ? ks + j * LD : zero) + col;
        const uint32_t bk[2] = {lds_u32(kr), lds_u32(kr + 8)};
        mma_bf16(sacc[nt], aq, bk);
      }
    }
  }
  // the plain version: scores rounded, divided by sqrt_dk (rounded), -1e9 (bf16) where padded, softmax rounded
  const float fill = round_to<bf16>(kNegInf);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1, j = 8 * nt + 2 * t + c;
      if ((e >> 1) == 1 && !half1) continue;
      float s = -INFINITY;
      if (j < S) {
        s = ((vbits >> (2 * nt + c)) & 1u) ? round_to<bf16>(div_score(round_to<bf16>(sacc[nt][e]), sqrt_dk)) : fill;
      }
      sacc[nt][e] = s;
      mx[e >> 1] = fmaxf(mx[e >> 1], s);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((e >> 1) == 1 && !half1) continue;
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
  // P V: P (e / sum, the IEEE quotient by div_by, rounded to bf16) as A, V's B fragments by ldmatrix.trans
  float oacc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    float p[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[x][e] = (e >> 1) == 1 && !half1 ? 0.f : div_by(sacc[2 * kk + x][e], sum[e >> 1], inv[e >> 1]);
      }
    }
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]), pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[1][2], p[1][3])};
    const int j = 16 * kk + (lane & 15);
    const bf16* vr = (j < S ? vs + j * LD : zero) + (lane >> 4) * 8;
#pragma unroll
    for (int jn = 0; jn < kPad<DK> / 16; ++jn) {
      uint32_t rr[4];
      ldmatrix_x4_trans(rr, vr + 16 * jn);
      const uint32_t b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
      mma_bf16(oacc[2 * jn], a, b0);
      mma_bf16(oacc[2 * jn + 1], a, b1);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < rep) {
      bf16* dst = out + (((size_t)b * rep + rows[r]) * H + h) * DK;
#pragma unroll
      for (int nt = 0; nt < ND; ++nt) {
        store_col_pair<DK>(dst, 8 * nt + 2 * t, make_float2(oacc[nt][2 * r], oacc[nt][2 * r + 1]));
      }
    }
  }
}

template <int DK, int KT, bool KV>
__global__ void __launch_bounds__(32 * kXMaxWarps)
grouped_cross_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ mem_k,
                                    const bf16* __restrict__ mem_v, const unsigned char* __restrict__ mask,
                                    bf16* __restrict__ out, int B, int H, int S, int rep, float sqrt_dk, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [stage][K: kXHeads x S, V: kXHeads x S (not in the kv mode), q: rep x kXHeads][LD]; head width 13: one
  // such stage, the zero row, then the raw stages (cross_raw_bytes)
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);
  constexpr int NKV = KV ? 1 : 2;  // staged memory arrays
  constexpr int LD = kXLd<DK>, RC = DK / 8, P = kPad<DK>;  // RC: 16-byte chunks of a row
  const int stage_rows = cross_stage_rows(S, rep, KV), groups = (H + kXHeads - 1) / kXHeads, units = B * groups;
  // the region flags go to the stage's last row (the raw stage's end at dk 13) when they are whole 4-byte
  // copies that fit in it (2 LD bytes), else they are read from global memory
  const bool flags_staged = S % 4 == 0 && S <= 2 * LD;
  bf16* zero = tiles + (kNarrow<DK> ? 1 : stages) * stage_rows * LD;
  // head width 13: the raw stages, each its K span, V span, the beams' q spans and the flags
  const int kspan = envelope_cap(kXHeads * S * DK * 2), qspan = envelope_cap(kXHeads * DK * 2);
  const int raw_bytes = cross_raw_bytes(DK, S, rep, KV), flags_at = NKV * kspan + rep * qspan;
  unsigned char* raw = reinterpret_cast<unsigned char*>(zero + LD);
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int e = threadIdx.x; e < LD; e += blockDim.x) zero[e] = __float2bfloat16_rn(0.f);
  // head width 13: span i of unit u (K, V unless kv, then beam i - NKV's q rows) in global memory
  auto narrow_span = [&](int u, int i, int& elems) -> const bf16* {
    const int b = u / groups, h0 = (u - b * groups) * kXHeads, hn = min(kXHeads, H - h0);
    if (i < NKV) {
      elems = hn * S * DK;
      return (i == 0 ? mem_k : mem_v) + ((size_t)b * H + h0) * S * DK;
    }
    elems = hn * DK;
    return q + (((size_t)b * rep + i - NKV) * H + h0) * DK;
  };

  // unit u: image u / groups, heads h0 .. h0 + hn - 1; K, V rows contiguous, q rows hn to a beam
  auto issue = [&](int u, int s) {
    const int b = u / groups, h0 = (u - b * groups) * kXHeads, hn = min(kXHeads, H - h0);
    bf16* st = tiles + s * stage_rows * LD;
    const int kv_rows = hn * S;
    const size_t kv0 = ((size_t)b * H + h0) * S * DK;
    // row r of the unit (K, V, then the q rows): its source and its staged row
    auto row_of = [&](int r, const bf16*& src, int& dst) {
      if (r < NKV * kv_rows) {
        src = (r < kv_rows ? mem_k : mem_v) + kv0 + (size_t)(r < kv_rows ? r : r - kv_rows) * DK;
        dst = r < kv_rows ? r : kXHeads * S + r - kv_rows;
      } else {
        const int qr = r - NKV * kv_rows, beam = qr / hn, hl = qr - beam * hn;
        src = q + (((size_t)b * rep + beam) * H + h0 + hl) * DK;
        dst = NKV * kXHeads * S + qr;
      }
    };
    const int unit_rows = NKV * kv_rows + rep * hn;
    const int chunks = kNarrow<DK> ? 0 : unit_rows * RC;
    unsigned char* flags_dst = reinterpret_cast<unsigned char*>(st + (stage_rows - 1) * LD);
    if constexpr (kNarrow<DK>) {  // the unit's spans, each over its envelope, into raw stage s
      unsigned char* rs = raw + s * raw_bytes;
      const int pk = kspan / 16, pq = qspan / 16;
      for (int e = threadIdx.x; e < NKV * pk + rep * pq; e += blockDim.x) {
        const int i = e < NKV * pk ? e / pk : NKV + (e - NKV * pk) / pq;
        const int c = e < NKV * pk ? e - i * pk : e - NKV * pk - (i - NKV) * pq;
        int elems;
        const bf16* src = narrow_span(u, i, elems);
        unsigned char* dst = rs + (i < NKV ? i * kspan : NKV * kspan + (i - NKV) * qspan);
        if (c < envelope_copies(src, elems * 2)) cp_async<16>(dst + 16 * c, envelope_lo(src) + 16 * c);
      }
      flags_dst = rs + flags_at;
    }
    for (int c = threadIdx.x; c < chunks + (flags_staged ? S / 4 : 0); c += blockDim.x) {
      if (c >= chunks) {  // the region flags, 4 a copy (then read from shared memory)
        cp_async<4>(flags_dst + 4 * (c - chunks), mask + (size_t)b * S + 4 * (c - chunks));
        continue;
      }
      const int r = c / RC, part = (c % RC) * 8;
      const bf16* src;
      int dst;
      row_of(r, src, dst);
      cp_async<16>(st + dst * LD + part, src + part);
    }
  };
  if (stages == 2 && (int)blockIdx.x < units) issue(blockIdx.x, 0);
  cp_async_commit();
  const int mtiles = (rep + 15) / 16;
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
    __syncthreads();  // every thread's copies of unit u have landed
    const int b = u / groups, h0 = (u - b * groups) * kXHeads, hn = min(kXHeads, H - h0);
    const bf16* st = tiles + (kNarrow<DK> ? 0 : s) * stage_rows * LD;
    const unsigned char* mask_b = flags_staged ? reinterpret_cast<const unsigned char*>(st + (stage_rows - 1) * LD)
                                              : mask + (size_t)b * S;
    if constexpr (kNarrow<DK>) {  // raw stage s repacked, a row a thread, into the 16-wide rows, columns 13-15 zero
      const unsigned char* rs = raw + s * raw_bytes;
      const int kv_rows = hn * S, unit_rows = NKV * kv_rows + rep * hn;
      for (int r = threadIdx.x; r < unit_rows; r += blockDim.x) {
        int i, idx, dst, elems;  // span, element of the row's first column in it, staged row
        if (r < NKV * kv_rows) {
          i = r < kv_rows ? 0 : 1;
          idx = (r - i * kv_rows) * DK;
          dst = r < kv_rows ? r : kXHeads * S + r - kv_rows;
        } else {
          const int qr = r - NKV * kv_rows, beam = qr / hn;
          i = NKV + beam;
          idx = (qr - beam * hn) * DK;
          dst = NKV * kXHeads * S + qr;
        }
        const bf16* src = narrow_span(u, i, elems);
        const unsigned char* span = rs + (i < NKV ? i * kspan : NKV * kspan + (i - NKV) * qspan);
        const bf16* row = reinterpret_cast<const bf16*>(span + envelope_offset(src)) + idx;
        const unsigned short* bits = reinterpret_cast<const unsigned short*>(row);
        uint32_t w[P / 2];
#pragma unroll
        for (int c = 0; c < P / 2; ++c) {
          w[c] = (2 * c < DK ? bits[2 * c] : 0u) | (2 * c + 1 < DK ? (uint32_t)bits[2 * c + 1] << 16 : 0u);
        }
        uint4* dst_row = reinterpret_cast<uint4*>(tiles + dst * LD);
#pragma unroll
        for (int c = 0; c < P / 8; ++c) dst_row[c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
      }
      if (flags_staged) mask_b = rs + flags_at;
      __syncthreads();
    }
    for (int item = warp; item < hn * mtiles; item += nwarps) {
      const int hl = item / mtiles, mt = item - hl * mtiles;
      const bf16* ks = st + hl * S * LD;  // the kv mode reads these rows as V too
      cross_tile_bf16<DK, KT>(st + (NKV * kXHeads * S + hl) * LD, hn, ks, KV ? ks : st + (kXHeads * S + hl * S) * LD,
                          zero, mask_b, out, b, h0 + hl, H, S, rep, mt, sqrt_dk);
    }
    __syncthreads();  // the stage may be refilled
  }
  cp_async_wait<0>();
}

template <int DK, int KT, bool KV>
cudaError_t launch_bf16(const void* q, const void* mk, const void* mv, const void* mask, void* out, int B, int H,
                        int S, int rep, float sqrt_dk, cudaStream_t stream) {
  const int stages = cross_stages(DK, S, rep, KV);
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t smem = cross_smem_bytes(DK, S, rep, stages, KV);
  auto kernel = grouped_cross_attention_bf16_kernel<DK, KT, KV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int items = kXHeads * ((rep + 15) / 16), warps = items < kXMaxWarps ? items : kXMaxWarps;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int units = B * ((H + kXHeads - 1) / kXHeads), cap = sm_count() * per_sm;
  kernel<<<units < cap ? units : cap, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(mk), static_cast<const bf16*>(mv),
      static_cast<const unsigned char*>(mask), static_cast<bf16*>(out), B, H, S, rep, sqrt_dk, stages);
  return cudaGetLastError();
}

// ------------------------------------------------------------ f32: CUDA cores
constexpr int kCrossThreads = 128;

template <int DK, bool KV>
__global__ void __launch_bounds__(kCrossThreads)
grouped_cross_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ mem_k,
                                   const float* __restrict__ mem_v, const unsigned char* __restrict__ mask,
                                   float* __restrict__ out, int H, int S, int rep, float sqrt_dk) {
  extern __shared__ __align__(16) float smem[];
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  constexpr int KS = kKeyStride<DK>, VS = kValStride<DK>, DP = kPad<DK>;
  // head width 13: the K and V spans' envelopes first (raw, envelope_cap bytes each)
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
  const int span = envelope_cap(S * DK * 4);
  float* k_s = smem + (kNarrow<DK> ? (KV ? 1 : 2) * span / 4 : 0);  // S * KS
  float* v_s = KV ? k_s : k_s + S * KS;              // S * VS, the K tile in the kv mode
  float* q_s = k_s + S * (KS + (KV ? 0 : VS));       // nwarps * DP
  float* p_s = q_s + nwarps * DP;                    // nwarps * 64 (a row's keys)
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(p_s + nwarps * 64);  // S

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t base = ((size_t)b * H + h) * S * DK;
  if constexpr (kNarrow<DK>) {  // each span whole by 16-byte copies, then repacked at width 16
    for (int a = 0; a < (KV ? 1 : 2); ++a) {
      const float* src = (a == 0 ? mem_k : mem_v) + base;
      for (int c = threadIdx.x; c < envelope_copies(src, S * DK * 4); c += blockDim.x) {
        cp_async<16>(raw + a * span + 16 * c, envelope_lo(src) + 16 * c);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int a = 0; a < (KV ? 1 : 2); ++a) {
      const float* src = (a == 0 ? mem_k : mem_v) + base;
      const float* row = reinterpret_cast<const float*>(raw + a * span + envelope_offset(src));
      stage_padded<DK>(a == 0 ? k_s : v_s, a == 0 ? KS : VS, row, S, threadIdx.x, blockDim.x);
    }
  } else {
    load_tile<DK>(k_s, mem_k + base, S, KS);
    if (!KV) load_tile<DK>(v_s, mem_v + base, S, VS);
  }
  for (int e = threadIdx.x; e < S; e += blockDim.x) mask_s[e] = mask[(size_t)b * S + e];
  __syncthreads();

  float* qw = q_s + warp * DP;
  for (int r = warp; r < rep; r += nwarps) {
    const size_t qo = ((size_t)(b * rep + r) * H + h) * DK;
    if (owns_cols<DK>(lane)) {
      const float2 qv = load_col_pair<DK>(q + qo, 2 * lane);
      qw[2 * lane] = qv.x;
      qw[2 * lane + 1] = qv.y;
    }
    __syncwarp();
    warp_attend_row<DK, float>(qw, k_s, v_s, mask_s, nullptr, S, sqrt_dk, p_s + warp * 64, out + qo, nullptr, 1.f,
                               nullptr, KV ? KS : VS);
  }
}

template <int DK, bool KV>
cudaError_t launch_f32(const void* q, const void* mk, const void* mv, const void* mask, void* out, int B, int H,
                       int S, int rep, float sqrt_dk, cudaStream_t stream) {
  const int nwarps = kCrossThreads / 32;
  const size_t raw = kNarrow<DK> ? (KV ? 1 : 2) * (size_t)envelope_cap(S * DK * 4) : 0;  // head width 13's spans
  const size_t smem =
      ((size_t)S * (kKeyStride<DK> + (KV ? 0 : kValStride<DK>)) + (size_t)nwarps * (kPad<DK> + 64)) * sizeof(float) +
      S + raw;
  grouped_cross_attention_f32_kernel<DK, KV><<<B * H, kCrossThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(mk), static_cast<const float*>(mv),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), H, S, rep, sqrt_dk);
  return cudaGetLastError();
}

template <int DK, bool KV>
int entry_dk(int dtype, const void* q, const void* mem_k, const void* mem_v, const void* mask, void* out, int B,
             int H, int S, int rep, float sqrt_dk, cudaStream_t s) {
  if (dtype == 0) return (int)launch_f32<DK, KV>(q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
  if (dtype == 1) {
    const void* ptrs[] = {q, mem_k, KV ? mem_k : mem_v, out};
    for (const void* p : ptrs) {
      if ((reinterpret_cast<uintptr_t>(p) & 15) != 0) return (int)cudaErrorInvalidValue;
    }
    if (S <= 16) return (int)launch_bf16<DK, 1, KV>(q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
    if (S <= 32) return (int)launch_bf16<DK, 2, KV>(q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
    if (S <= 48) return (int)launch_bf16<DK, 3, KV>(q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
    return (int)launch_bf16<DK, 4, KV>(q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool KV>
int entry(int dtype, int dk, const void* q, const void* mem_k, const void* mem_v, const void* mask, void* out, int B,
          int H, int S, int rep, float sqrt_dk, void* stream) {
  if (H < 1 || S < 1 || S > 64 || rep < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk == 64) return entry_dk<64, KV>(dtype, q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
  if (dk == 32) return entry_dk<32, KV>(dtype, q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
  if (dk == 13) return entry_dk<13, KV>(dtype, q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16; dk: 64, 32 or 13. q/out (B * rep, H, dk); mem_k/mem_v
// (B, H, S, dk), 16-byte aligned in bf16; mask (B, S) bool; sqrt_dk: the
// scores' divisor, sqrt(dk) rounded to the compute dtype.
extern "C" int sct_grouped_cross_attention(int dtype, int dk, const void* q, const void* mem_k, const void* mem_v,
                                           const void* mask, void* out, int B, int H, int S, int rep,
                                           float sqrt_dk, void* stream) {
  return sct::entry<false>(dtype, dk, q, mem_k, mem_v, mask, out, B, H, S, rep, sqrt_dk, stream);
}

// kv mode: mem (B, H, S, dk) is both K and V, staged once.
extern "C" int sct_grouped_cross_attention_kv(int dtype, int dk, const void* q, const void* mem, const void* mask,
                                              void* out, int B, int H, int S, int rep, float sqrt_dk, void* stream) {
  return sct::entry<true>(dtype, dk, q, mem, nullptr, mask, out, B, H, S, rep, sqrt_dk, stream);
}

// the bf16 kernel's shared memory at head width dk for S regions and rep rows
// an image (kv: the kv mode), at its stage count; 0 if none fits
extern "C" long long sct_grouped_cross_attention_smem(int dk, int S, int rep, int kv) {
  const int stages = sct::cross_stages(dk, S, rep, kv != 0);
  return stages == 0 ? 0 : (long long)sct::cross_smem_bytes(dk, S, rep, stages, kv != 0);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
