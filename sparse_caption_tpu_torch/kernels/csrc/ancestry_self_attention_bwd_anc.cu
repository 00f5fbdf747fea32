// K2's backward in the ancestry mode (beam-sample SCST): the gradient of
// one decode step of causal self-attention against the K/V cache through
// the beam-ancestry map (row r of image b reads slot t' of row b K +
// anc[b, r, t']), f32, head widths 64, 32 and 13, unshared K and V or in the
// kv mode (ACORT's kv-shared layers). The identity map, the formulas and
// the cache gradient's contract are ancestry_self_attention_bwd.cu's; the
// argument checks both modes share are in ancestry_self_attention_bwd.cuh.
// A library of its own, so that it compiles in parallel with the identity
// mode.
//
// Replaces: the gradient of sparse_caption_tpu/models/layers.py:320-333
// (the scores and the output through ancestry_onehot), which XLA's autodiff
// derives inside the differentiable beam search of beam-sample SCST
// (engine/training.py:467-468,768-770); left to XLA on the TPU.
//
// Slot t' of row j receives the sum of dk_t' / dv_t' (under kv their sum)
// over the image's rows r with anc[b, r, t'] == j, taken in the order r =
// 0, 1, ..., K - 1 (no atomics; at t' = 0 every beam descends from beam 0,
// so one slot takes K terms). Slots < t are added to; slot t's total goes to
// dk_t / dv_t and the slot is zeroed.
//
// Bound on the H100: bytes. Only the (row, slot) pairs the map names over
// slots 0..t are read and written back, each once: their cache slots in,
// their gradient slots in and out, and q, dout in and dq, dk_t (, dv_t) out
// a row (chip_smoke.py k2_bwd_anc_bytes counts them on the run's map).
//
// Design: one block of 16 warps per (image, head); nothing walks a slot
// serially. In shared memory: the image's K rows' q and dout, p and ds (K x
// (t + 1) each), the inverted map and the staged K cache. Three barriers
// (four phases) when the slots fit at once:
// 1. q and dout; the inverted map, once: a thread per (x, slot s) scans slot
//    s's K map entries (global memory, L1) and records reader x's next
//    reader of the same row (next_s) and row x's first reader (first_s), so
//    every (row j, slot s) lists its readers in increasing r, with no K-long
//    scan per output. The first reader of each touched (row, slot) pair
//    copies the pair's K slot, once, by 16-byte cp.async (dk 64, 32: its dk
//    floats; dk 13: its 16-byte envelope, 4 copies, the slot read at its
//    offset in it) at a pitch of dk + 4 floats (20 at dk 13). Only K is
//    staged (the kv mode's one array is K): V is read once a reader, in
//    place, so that the block fits twice into an SM where K and V together
//    would not (dk 64 at t = 16: 70 KB, not 139). When slots 0..t do not fit
//    the block's shared memory they are walked in chunks of as many as fit
//    (anc_bwd_chunk_slots), staged again for dq; if not even one slot fits,
//    the slots are read from global memory.
// 2. Scores and dout . v: a thread per (r, s), each dot product in its
//    registers (four partial sums over the dims d = 4 g + i at dk 64 and 32,
//    then (x + y) + (z + w); one chain at dk 13).
// 3. The softmax, a warp per row as PyTorch's warp softmax lays it out (lane
//    l holds slots l, l + 32, ...; each lane's terms in slot order, then the
//    butterfly), f32: max, e = exp(s - max), sum, p = e / sum, D = sum p dp,
//    ds = p (dp - D) / sqrt(dk).
// 4. dq: a thread per (row, 16-byte group of dims), its slots in order s =
//    0..t (under chunks, each chunk's partial sum added in order); then,
//    with no barrier between, dK and dV: a thread per (row j, slot s,
//    16-byte group of dims) over the touched pairs and every row's slot t,
//    each summing its readers in the order r = 0..K-1 (the inverted map's
//    list), then read-modify-writing the gradient buffers as 16-byte vectors
//    (dk 13: by element).
// Sum orders the plain version's tolerance rests on: the dot products (2),
// the softmax's (3, the identity mode's), dq's and dK / dV's (4, one FMA a
// reader and element, then the buffer's add: the identity mode's
// update_slot).
#include <initializer_list>

#include "ancestry_self_attention_bwd.cuh"
#include "vec.cuh"

namespace sct {

constexpr int kAncBwdThreads = 512;

// floats a staged slot takes: dk + 4 at dk 64 and 32 (16-byte copies of the
// row; the pad spreads neighbouring slots over the banks), 20 at dk 13 (the
// 16-byte envelope of its 52 bytes, 4 copies, + 4)
__host__ __device__ constexpr int anc_stage_pitch(int dk) { return dk % 4 == 0 ? dk + 4 : 20; }

// slots of K staged at once: all t + 1 where they fit beside the fixed part
// (anc_bwd_smem_bytes, rounded up to 16 bytes), else as many as fit; 0 when
// not one fits (the slots are read from global memory)
__host__ __device__ inline int anc_bwd_chunk_slots(int dk, int K, int t) {
  const size_t fixed = (anc_bwd_smem_bytes(dk, K, t) + 15) / 16 * 16;
  if (fixed >= (size_t)kBlockSmemLimit) return 0;
  const size_t slot = (size_t)K * anc_stage_pitch(dk) * sizeof(float);
  const size_t fit = ((size_t)kBlockSmemLimit - fixed) / slot;
  return fit < (size_t)(t + 1) ? (int)fit : t + 1;
}

// the block's dynamic shared memory: the fixed part, then the stage
__host__ __device__ inline size_t anc_bwd_block_smem(int dk, int K, int t) {
  const int cw = anc_bwd_chunk_slots(dk, K, t);
  if (cw == 0) return anc_bwd_smem_bytes(dk, K, t);
  return (anc_bwd_smem_bytes(dk, K, t) + 15) / 16 * 16 + (size_t)cw * K * anc_stage_pitch(dk) * sizeof(float);
}

// W neighbouring dims: a 16-byte vector (W = 4, dk 64 and 32) or one (dk 13)
template <int W>
struct DimGroup {
  float v[W];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (W == 4) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *p = v[0];
    }
  }
  // += a * (the W dims at p)
  __device__ __forceinline__ void fma(float a, const float* p) {
    DimGroup o;
    o.load(p);
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = fmaf(a, o.v[i], v[i]);
  }
  __device__ __forceinline__ DimGroup plus(const DimGroup& o) const {
    DimGroup r;
#pragma unroll
    for (int i = 0; i < W; ++i) r.v[i] = v[i] + o.v[i];
    return r;
  }
};

// a . b over DK dims (a in shared memory, b in shared or global memory)
template <int DK>
__device__ __forceinline__ float row_dot(const float* a, const float* b) {
  if constexpr (DK % 4 == 0) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < DK / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(a + 4 * g);
      const float4 y = *reinterpret_cast<const float4*>(b + 4 * g);
      acc.x = fmaf(x.x, y.x, acc.x);
      acc.y = fmaf(x.y, y.y, acc.y);
      acc.z = fmaf(x.z, y.z, acc.z);
      acc.w = fmaf(x.w, y.w, acc.w);
    }
    return (acc.x + acc.y) + (acc.z + acc.w);
  } else {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DK; ++d) acc = fmaf(a[d], b[d], acc);
    return acc;
  }
}

// cw: slots staged at once (anc_bwd_chunk_slots; 0 reads the slots from global memory)
template <int DK>
__global__ void __launch_bounds__(kAncBwdThreads, 2) ancestry_self_attention_bwd_anc_kernel(
    const float* __restrict__ q, const float* __restrict__ cache_k, const float* __restrict__ cache_v,
    const float* __restrict__ dout, const int* __restrict__ anc, float* __restrict__ dq,
    float* __restrict__ dcache_k, float* __restrict__ dcache_v, float* __restrict__ dk_t, float* __restrict__ dv_t,
    int H, int K, int t_max, int t, float sqrt_dk, int cw) {
  constexpr int W = DK % 4 == 0 ? 4 : 1;       // dims a group
  constexpr int G = DK / W;                    // groups a row
  constexpr int NV = DK % 4 == 0 ? DK / 4 : 4;  // 16-byte copies a staged slot
  constexpr int PITCH = anc_stage_pitch(DK);
  using D = DimGroup<W>;
  extern __shared__ __align__(16) float anc_smem[];
  const bool kv = cache_v == nullptr;
  const int T1 = t + 1, nt = blockDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  float* q_s = anc_smem;                                      // K x DK
  float* g_s = q_s + K * DK;                                  // K x DK (dout)
  float* p_s = g_s + K * DK;                                  // K x T1: scores, then e, then p
  float* ds_s = p_s + K * T1;                                 // K x T1: dout . v, then ds
  short* first_s = reinterpret_cast<short*>(ds_s + K * T1);  // K x T1: (row j, slot s)'s first reader, -1 none
  short* next_s = first_s + K * T1;                           // K x T1: (reader r, slot s)'s next reader of r's row
  float* stage = anc_smem + (anc_bwd_smem_bytes(DK, K, t) + 15) / 16 * 4;  // cw slots a row of K
  const int* __restrict__ mp = anc + (size_t)b * K * t_max;  // row r's slot s at r t_max + s
  const int span = cw > 0 ? cw : T1;
  const int nchunks = (T1 + span - 1) / span;
  auto row_head = [&](int j) { return ((size_t)b * K + j) * H + h; };
  auto slot_elem = [&](int j, int s) { return (row_head(j) * t_max + s) * DK; };
  // dim 0 of slot s of row j of K: in the stage of the chunk from slot s0, or in global memory when nothing
  // is staged
  auto key_ptr = [&](int j, int s, int s0) -> const float* {
    const float* g = cache_k + slot_elem(j, s);
    if (cw == 0) return g;
    const int off = DK % 4 == 0 ? 0 : (int)((reinterpret_cast<uintptr_t>(g) & 15) >> 2);
    return stage + ((size_t)j * cw + (s - s0)) * PITCH + off;
  };
  // the 16-byte vector v of slot s of row j of K (dk 13: of its envelope) into the stage of the chunk from s0
  auto copy_vector = [&](int j, int s, int s0, int v) {
    const float* src = cache_k + slot_elem(j, s);
    float* dst = stage + ((size_t)j * cw + (s - s0)) * PITCH + 4 * v;
    if constexpr (DK % 4 == 0) {
      cp_async<16>(dst, src + 4 * v);
    } else {
      cp_async<16>(dst, envelope_lo(src) + 16 * v);
    }
  };
  // the touched pairs of slots s0 .. s0 + n - 1 into the stage, spread over the block
  auto stage_chunk = [&](int s0, int n) {
    for (int i = tid; i < K * n * NV; i += nt) {
      const int pair = i / NV, v = i - pair * NV;
      const int j = pair / n, s = s0 + (pair - j * n);
      if (first_s[j * T1 + s] >= 0) copy_vector(j, s, s0, v);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  // 1. q and dout; the inverted map (a thread per (x, s): reader x's next reader of its row, and row x's
  // first reader); each touched pair of the first chunk copied by its first reader
  for (int i = tid; i < K * G; i += nt) {
    const int r = i / G, g = i - r * G;
    D qv, gv;
    qv.load(q + row_head(r) * DK + W * g);
    gv.load(dout + row_head(r) * DK + W * g);
    qv.store(q_s + r * DK + W * g);
    gv.store(g_s + r * DK + W * g);
  }
  for (int i = tid; i < K * T1; i += nt) {
    const int x = i / T1, s = i - x * T1;
    const int j = __ldg(mp + (size_t)x * t_max + s);  // the row reader x reads at slot s
    bool first = true;
    int nx = -1, fx = -1;
    for (int o = 0; o < K; ++o) {
      const int jo = __ldg(mp + (size_t)o * t_max + s);
      if (jo == j) {
        if (o < x) first = false;
        else if (o > x && nx < 0) nx = o;
      }
      if (jo == x && fx < 0) fx = o;
    }
    next_s[i] = (short)nx;
    first_s[i] = (short)fx;
    if (first && cw > 0 && s < span) {
#pragma unroll
      for (int v = 0; v < NV; ++v) copy_vector(j, s, 0, v);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2-3. the scores (K from the stage) and dout . v (V read in place; under kv the stage), a chunk at a time
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * span, n = T1 - s0 < span ? T1 - s0 : span;
    if (c > 0) {
      __syncthreads();  // the last chunk's reads are done
      stage_chunk(s0, n);
    }
    for (int i = tid; i < K * n; i += nt) {
      const int r = i / n, s = s0 + (i - r * n);
      const int j = __ldg(mp + (size_t)r * t_max + s);
      const float* kr = key_ptr(j, s, s0);
      p_s[r * T1 + s] = div_score(row_dot<DK>(q_s + r * DK, kr), sqrt_dk);
      ds_s[r * T1 + s] = row_dot<DK>(g_s + r * DK, kv ? kr : cache_v + slot_elem(j, s));
    }
  }
  __syncthreads();

  // 4. each row's softmax and score gradients, a warp a row
  for (int r = warp; r < K; r += nt / 32) {
    float* pr = p_s + r * T1;
    float* dr = ds_s + r * T1;
    float m = -INFINITY;
    for (int s = lane; s < T1; s += 32) m = fmaxf(m, pr[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < T1; s += 32) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float pdp = 0.f;
    for (int s = lane; s < T1; s += 32) {
      const float p = pr[s] / sum;
      pr[s] = p;
      pdp += p * dr[s];
    }
    const float dsum = warp_sum(pdp);
    for (int s = lane; s < T1; s += 32) dr[s] = div_score(pr[s] * (dr[s] - dsum), sqrt_dk);
  }
  __syncthreads();

  // 5. dq = sum_s ds k, a thread a (row, group of dims); chunks again only if the slots did not fit at once
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * span, n = T1 - s0 < span ? T1 - s0 : span;
    if (nchunks > 1) {
      __syncthreads();
      stage_chunk(s0, n);
    }
    for (int i = tid; i < K * G; i += nt) {
      const int r = i / G, g = i - r * G;
      D acc;
      acc.zero();
      for (int s = s0; s < s0 + n; ++s)
        acc.fma(ds_s[r * T1 + s], key_ptr(__ldg(mp + (size_t)r * t_max + s), s, s0) + W * g);
      float* o = dq + row_head(r) * DK + W * g;
      if (c > 0) {
        D before;
        before.load(o);
        acc = before.plus(acc);
      }
      acc.store(o);
    }
  }

  // 6. dK, dV of every touched (row, slot) and of each row's slot t, its readers summed in row order (no
  // barrier: this reads q, dout, p, ds and the inverted map alone)
  const int items = K * T1 * G;
  for (int i0 = tid; i0 < items; i0 += 2 * nt) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * nt;
      if (i >= items) break;
      const int pair = i / G, g = i - pair * G;
      const int j = pair / T1, s = pair - j * T1;
      const int f = first_s[j * T1 + s];
      const bool last = s == t;
      if (f < 0 && !last) continue;  // no row read this slot: its gradient is unchanged
      const size_t so = slot_elem(j, s) + W * g, to = row_head(j) * DK + W * g;
      D ck, cv, gk, gv;
      ck.load(dcache_k + so);
      if (!kv) cv.load(dcache_v + so);
      gk.zero();
      gv.zero();
      for (int r = f; r >= 0; r = next_s[r * T1 + s]) {
        gk.fma(ds_s[r * T1 + s], q_s + r * DK + W * g);
        gv.fma(p_s[r * T1 + s], g_s + r * DK + W * g);
      }
      D zero;
      zero.zero();
      if (kv) {  // one buffer, both terms
        ck.plus(gk.plus(gv)).store(last ? dk_t + to : dcache_k + so);
        if (last) zero.store(dcache_k + so);
      } else if (!last) {
        ck.plus(gk).store(dcache_k + so);
        cv.plus(gv).store(dcache_v + so);
      } else {  // slot t: the later steps' sum plus this step's, to k_t / v_t; the slot is zeroed
        ck.plus(gk).store(dk_t + to);
        cv.plus(gv).store(dv_t + to);
        zero.store(dcache_k + so);
        zero.store(dcache_v + so);
      }
    }
  }
}

template <int DK>
cudaError_t launch_anc(const void* q, const void* ck, const void* cv, const void* dout, const void* anc, void* dq,
                       void* dck, void* dcv, void* dkt, void* dvt, int N, int H, int K, int t_max, int t,
                       float sqrt_dk, cudaStream_t stream) {
  const size_t smem = anc_bwd_block_smem(DK, K, t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ancestry_self_attention_bwd_anc_kernel<DK>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ancestry_self_attention_bwd_anc_kernel<DK><<<dim3(H, N / K), kAncBwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ck), static_cast<const float*>(cv),
      static_cast<const float*>(dout), static_cast<const int*>(anc), static_cast<float*>(dq),
      static_cast<float*>(dck), static_cast<float*>(dcv), static_cast<float*>(dkt), static_cast<float*>(dvt), H, K,
      t_max, t, sqrt_dk, anc_bwd_chunk_slots(DK, K, t));
  return cudaGetLastError();
}

// cv == nullptr: the kv mode (dcv, dvt null too)
int entry_anc(int dk, const void* q, const void* ck, const void* cv, const void* dout, const void* anc, void* dq,
              void* dck, void* dcv, void* dkt, void* dvt, int N, int H, int K, int t_max, int t, float sqrt_dk,
              void* stream) {
  if (anc == nullptr || !k2_bwd_args_ok(dk, cv, dcv, dvt, anc, N, H, K, t_max, t)) return (int)cudaErrorInvalidValue;
  // dk 64 and 32 move 16-byte vectors
  if (dk % 4 == 0) {
    for (const void* p : std::initializer_list<const void*>{q, ck, cv, dout, dq, dck, dcv, dkt, dvt})
      if (!aligned_to(p, 16)) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCT_K2BA(DK) (int)launch_anc<DK>(q, ck, cv, dout, anc, dq, dck, dcv, dkt, dvt, N, H, K, t_max, t, sqrt_dk, s)
  if (dk == 64) return SCT_K2BA(64);
  if (dk == 32) return SCT_K2BA(32);
  if (dk == 13) return SCT_K2BA(13);
#undef SCT_K2BA
  return (int)cudaErrorInvalidValue;
}

}  // namespace sct

// As sct_ancestry_self_attention_bwd (ancestry_self_attention_bwd.cu), with
// anc (B, K, T_max) int32, N = B K, K >= 1, and the block's fixed shared
// memory (anc_bwd_smem_bytes) within the H100's 227 KB; at dk 64 and 32 the
// tensors 16-byte aligned.
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

// the ancestry mode's fixed shared memory a block (bytes) at head width dk, K beams and step t: the
// arguments' check
extern "C" long long sct_ancestry_self_attention_bwd_anc_smem(int dk, int K, int t) {
  return (long long)sct::anc_bwd_smem_bytes(dk, K, t);
}

// slots of K the ancestry mode stages at once (0: read from global memory) at head width dk, K beams, step t
extern "C" long long sct_ancestry_self_attention_bwd_anc_chunk_slots(int dk, int K, int t) {
  return sct::anc_bwd_chunk_slots(dk, K, t);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
