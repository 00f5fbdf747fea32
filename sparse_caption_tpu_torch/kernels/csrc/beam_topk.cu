// K4: per-row log_softmax + beam constraints + top-K over the vocabulary,
// without materialising the (N, V) log-prob tensor.
//
// Replaces: sparse_caption_tpu/models/layers.py:458-472 Generator (eval
// log_softmax) together with sparse_caption_tpu/decoding/beam.py:165-175
// (constraints) and :55-69,186-200 (the per-beam top-K of the two-level
// top-K). Left to XLA on the TPU.
//
// For each row n of logits (N, V) in the compute dtype T:
//   lp[v] = T((x[v] - max) - log(sum exp(x - max)))          (log_softmax, f32 stats)
//   c[v]  = f32(lp[v]) + -1e18 if v == ban_token[n]           (decoding_constraint, t > 0)
//                      + -1e18 if ban_eos[n] and v == eos_id  (bad ending, t > 0)
//                      + -1000 if v == unk_id                 (suppress_UNK)
//   c[v]  = c[v] - f32(count[v] * lambda)                     (diverse beam search)
//           count[v]: how many of the P tokens that earlier groups chose at
//           this step for the row's image (div_tokens, row n / div_group) are v;
//           the product is formed once, count first (beam.py:176-184), not
//           lambda subtracted once per occurrence
//   out   = top-k of c (ties to the lower index, as lax.top_k), their indices,
//           and the raw f32(lp) at those indices (no penalty).
//
// Bound on the H100 (beam 5, vocab 10000): bytes. The logits are read once:
// at B = 2048 (N = 10240 rows) 205 MB of bf16, 0.06 ms at 3.35 TB/s.
//
// Design: the held path (k <= 32, rows of whole 16-byte vectors, 16-byte
// aligned, V <= 320 threads x 32 values) reads each row once: one block per
// row, sized to the row as K13's held path (320 threads at V = 10,000; four
// blocks an SM in bf16, three in f32), each thread holding its 32 values as
// raw 16-byte vectors, consecutive threads on consecutive vectors, every
// load issued before any math. The row's max and log-sum-exp come from
// `held_row_stats` (row_softmax.cuh): K13's reduction, in K13's order, so
// each log-prob is K13's bit for bit. A threshold then leaves the top-k only
// a few entries to sort: each thread's best constrained value is the
// log-prob of its largest logit (the at most three threads that hold a
// penalised entry take no part), and the k-th largest of the threads' best
// is reached by k entries of the row, so by every entry of its best k. Each
// thread marks which of its 32 logits can round to a log-prob at the
// threshold (a few a row when the logits spread; many when they tie at the
// top); its warp walks the slots marked in any lane, vector by vector, and
// inserts their packed (value, index) keys (a key orders by value, then by
// the lower index) into the warp's list of its best k, held one entry a
// lane, one key at a time by ballots and shuffles. The selection is a chain
// of dependent warp steps, so its maxima are single `redux.sync`
// instructions on order-preserving keys: k rounds in each warp and k over
// the warps for the threshold, k over the warps' lists for the result (warp
// 0). Four barriers a row in all (max, sum, threshold, lists). The raw
// log-prob of a winner is its value unless a penalty touched it (then it is
// recomputed from its logit).
// Diverse rows (P > 0 earlier-group tokens) take the held path too: each
// block stages its image's P tokens in shared memory and marks the penalised
// columns (the P tokens, the ban, EOS under a bad ending, UNK) in a bitmap of
// V bits (1.25 KB at V = 10,000). A penalty only lowers a value, so each
// thread's best constrained value is the log-prob of its largest logit no
// penalty touches, and the threshold is valid for every P: its k threads'
// bests are k entries' exact values (where fewer than k threads hold an
// unpenalised entry the threshold is -inf and every entry is inserted,
// correct but slow; at V = 10,000 320 threads hold 32 entries each, so that
// needs more than the 259 penalised entries a row can carry, and no row
// leaves the held path for its P). A penalised entry whose logit reaches
// x_lo enters the lists with its exact value (count first, then f32(count x
// lambda) subtracted once, `diversify`), its raw log-prob recomputed from
// its logit.
// For k > 32 (any k <= V), one block of 256 threads per row writes the row's
// constrained f32 values into shared memory (40 KB at V = 10000); a
// block-wide radix select (four 8-bit passes of a shared histogram
// over order-preserving uint32 keys) finds the k-th value, the values above it
// and the first of the values equal to it in index order are gathered, and a
// bitonic sort of those k entries (value descending, index ascending, packed
// in one uint64) orders them. Rows off the held path with k <= 32 (V not whole
// vectors, unaligned, or too long) take a scalar kernel: an online max / sum,
// then a second pass that rereads the row into per-thread lists of 8, 16 or
// 32 and k rounds of a block-wide argmax. The diverse-beam penalty (up to
// 256 earlier-group tokens an image, staged in shared memory in the
// prologue) runs on the scalar kernel (k <= 32) and the radix select (k >
// 32) where the held path cannot take the row. The register lists, the radix
// select and the bitonic sort are row_topk.cuh's, shared with K9's top-k
// filter.
#include "row_softmax.cuh"
#include "row_topk.cuh"

namespace sct {

constexpr int kTopkThreads = 256;
constexpr int kRegisterK = 32;  // largest k kept in per-thread register lists
constexpr float kNegBig = -1e18f;  // beam.py NEG_BIG
constexpr int kMaxDiversity = 256;  // earlier-group tokens an image's rows read (diverse beam search)

// The penalties of the module notes, added in f32 to the log-prob lp of index i.
__device__ __forceinline__ float penalize(float c, int i, int ban, bool no_eos, int eos_id, int unk_id) {
  if (i == ban) c += kNegBig;
  if (no_eos && i == eos_id) c += kNegBig;
  if (i == unk_id) c += -1000.f;
  return c;
}

__device__ __forceinline__ bool penalized(int i, int ban, bool no_eos, int eos_id, int unk_id) {
  return i == ban || (no_eos && i == eos_id) || i == unk_id;
}

// The diverse-beam penalty of the module notes: count (the row's image's
// earlier-group tokens equal to i, div_s[0..P)) times lambda, formed once in
// f32 with the count first, then subtracted
__device__ __forceinline__ float diversify(float c, int i, const int* div_s, int P, float lambda) {
  int count = 0;
  for (int j = 0; j < P; ++j) count += div_s[j] == i;
  return count > 0 ? c - (float)count * lambda : c;
}

// The constrained value c[i] of the module notes.
template <typename T>
__device__ __forceinline__ float constrained(const T* __restrict__ x, int i, float mx, float logsum, int ban,
                                             bool no_eos, int eos_id, int unk_id, const int* div_s, int P,
                                             float lambda) {
  return diversify(penalize(round_to<T>((to_f(x[i]) - mx) - logsum), i, ban, no_eos, eos_id, unk_id), i, div_s, P,
                   lambda);
}

constexpr int kHeldPenWords = kTopkHeldMaxThreads * kRowHeld / 32;  // the held path's bitmap of penalised columns

// the row's image's P earlier-group tokens (diverse beam search) into div_s
__device__ __forceinline__ void stage_diversity(const int* __restrict__ div_tokens, int P, int group, int row,
                                                int* div_s) {
  for (int j = threadIdx.x; j < P; j += blockDim.x) div_s[j] = div_tokens[(size_t)(row / group) * P + j];
  __syncthreads();
}

// (value, index) as one key: a larger value ranks above, and of equal values
// the lower index; 0 is below every key of a real entry
__device__ __forceinline__ unsigned long long topk_key(float v, int i) {
  return ((unsigned long long)order_key(v) << 32) | (0xFFFFFFFFu - (unsigned int)i);
}
__device__ __forceinline__ int key_index(unsigned long long key) { return (int)(0xFFFFFFFFu - (unsigned int)key); }
__device__ __forceinline__ float key_value(unsigned long long key) { return order_value((unsigned int)(key >> 32)); }

// the warp's largest key: the largest value half, then the largest index half among it
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long key) {
  const unsigned int hi = __reduce_max_sync(0xffffffffu, (unsigned int)(key >> 32));
  const unsigned int lo = __reduce_max_sync(0xffffffffu, (unsigned int)(key >> 32) == hi ? (unsigned int)key : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// The held path: one block per row of `units` 16-byte vectors; thread t
// holds vectors t, t + nt, ... (PER of them). DIV: the diverse-beam penalty
// (div_p > 0), the penalised columns marked in a bitmap.
template <typename T, bool DIV>
__global__ void __launch_bounds__(kTopkHeldMaxThreads, sizeof(T) == 2 ? 4 : 3)
beam_topk_held_kernel(const T* __restrict__ logits, int V, int k, const int* __restrict__ ban_token,
                      const unsigned char* __restrict__ ban_eos, int eos_id, int unk_id,
                      const int* __restrict__ div_tokens, int div_p, int div_group, float div_lambda,
                      float* __restrict__ out_val, int* __restrict__ out_idx, float* __restrict__ out_raw) {
  constexpr int UE = 16 / sizeof(T);
  constexpr int PER = kRowHeld / UE;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float red[2][32];
  __shared__ unsigned long long cand[32 * kRegisterK];  // each warp's best k, best first
  __shared__ unsigned int wbest[32 * kRegisterK];  // each warp's k best of its threads' best values
  __shared__ unsigned int pen_s[DIV ? kHeldPenWords : 1];  // DIV: bit i of the row's penalised columns
  __shared__ int div_s[DIV ? kMaxDiversity : 1];  // DIV: the image's earlier-group tokens
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int units = V / UE;
  const int row = blockIdx.x;
  const T* x = logits + (size_t)row * V;
  uint4 raw[PER];  // kept packed: the whole row's loads in flight at once
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int u = j * nt + tid;
    raw[j] = u < units ? ld16(x + (size_t)u * UE) : make_uint4(0u, 0u, 0u, 0u);
  }
  const int ban = ban_token != nullptr ? ban_token[row] : -1;
  const bool no_eos = ban_eos != nullptr && ban_eos[row] != 0;
  if constexpr (DIV) {  // the bitmap, while the loads are in flight
    for (int w = tid; w < (V + 31) / 32; w += nt) pen_s[w] = 0u;
    for (int j = tid; j < div_p; j += nt) div_s[j] = div_tokens[(size_t)(row / div_group) * div_p + j];
    __syncthreads();
    auto mark = [&](int i) {
      if (i >= 0 && i < V) atomicOr(&pen_s[i >> 5], 1u << (i & 31));
    };
    for (int j = tid; j < div_p; j += nt) mark(div_s[j]);
    if (tid == 0) {
      mark(ban);
      if (no_eos) mark(eos_id);
      mark(unk_id);
    }
  }  // held_row_stats' barriers publish div_s and the marks
  float m, logsum, xmax;
  held_row_stats<T, PER>(raw, units, red[0], red[1], m, logsum, xmax);

  // this thread's best constrained value (penalties only lower a value): the
  // log-prob of its largest logit; a thread that holds a penalised entry (at
  // most three a row) offers none. DIV: the log-prob of its largest logit no
  // penalty touches (pen: bit j UE + e, value e of vector j is penalised)
  float cbest;
  unsigned pen = 0u;
  if constexpr (DIV) {
    float xfree = -INFINITY;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int u = j * nt + tid;
      if (u < units) {
        const unsigned bits = (pen_s[(u * UE) >> 5] >> ((u * UE) & 31)) & ((1u << UE) - 1u);
        pen |= bits << (j * UE);
        float v[UE];
        unpack16<T>(raw[j], v);
#pragma unroll
        for (int e = 0; e < UE; ++e)
          if (!((bits >> e) & 1u)) xfree = fmaxf(xfree, v[e]);
      }
    }
    cbest = xfree == -INFINITY ? -INFINITY : round_to<T>((xfree - m) - logsum);
  } else {
    auto owns = [&](int i) { return i >= 0 && i < units * UE && (i / UE) % nt == tid; };
    cbest = xmax == -INFINITY ? -INFINITY : round_to<T>((xmax - m) - logsum);
    if (owns(ban) || (no_eos && owns(eos_id)) || owns(unk_id)) cbest = -INFINITY;
  }
  // the constrained value of entry i (value e of this thread's vector j) from its log-prob
  auto constrain = [&](float lp, int i, int j, int e) {
    if constexpr (DIV)
      return (pen >> (j * UE + e)) & 1u ? diversify(penalize(lp, i, ban, no_eos, eos_id, unk_id), i, div_s, div_p,
                                                    div_lambda)
                                        : lp;
    else
      return penalize(lp, i, ban, no_eos, eos_id, unk_id);
  };
  // the row's threshold: the k-th largest of the threads' best values (k
  // entries of the row reach it, so every entry of the row's best k does):
  // k rounds of a warp argmax on order keys in each warp, then k over the warps'
  const int nwarps = nt / 32;
  const unsigned int ckey = order_key(cbest);  // above 0 even for -inf
  {
    bool out = false;
    unsigned int round_best = 0u;
    for (int r = 0; r < k; ++r) {
      const unsigned int best = __reduce_max_sync(kAll, out ? 0u : ckey);
      if (lane == r) round_best = best;
      const unsigned at = __ballot_sync(kAll, !out && ckey == best);
      if (lane == __ffs(at) - 1) out = true;
    }
    if (lane < k) wbest[warp * kRegisterK + lane] = round_best;
  }
  __syncthreads();
  unsigned int thr_key = 0u;
  {
    int head = 0;
    for (int r = 0; r < k; ++r) {
      const bool live = lane < nwarps && head < k;
      const unsigned int v = live ? wbest[lane * kRegisterK + head] : 0u;
      thr_key = __reduce_max_sync(kAll, v);
      const unsigned at = __ballot_sync(kAll, live && v == thr_key);
      if (lane == __ffs(at) - 1) ++head;
    }
  }
  const float thr = thr_key == 0u ? -INFINITY : order_value(thr_key);
  // a logit below x_lo cannot round to a log-prob that reaches thr (a margin
  // of one ulp of the log-prob's dtype at thr, and of f32's over the two
  // subtractions)
  const float x_lo = thr == -INFINITY ? -INFINITY
                                      : (thr + m + logsum) - fabsf(thr) * (sizeof(T) == 2 ? 0x1p-7f : 0x1p-22f) -
                                            (fabsf(thr) + fabsf(m) + fabsf(logsum)) * 0x1p-20f;

  // the warp's best k, lane q holding entry q (descending keys; 0: empty):
  // the entries whose logit reaches x_lo (a few a row) are inserted one at a
  // time, each once it beats the list's k-th entry
  unsigned long long entry = 0ull, last = 0ull;  // last: entry k - 1
  unsigned reach = 0u;  // bit j UE + e: this thread's value e of vector j reaches x_lo
  if (xmax >= x_lo) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      float v[UE];
      unpack16<T>(raw[j], v);
#pragma unroll
      for (int e = 0; e < UE; ++e)
        if (j * nt + tid < units && v[e] >= x_lo) reach |= 1u << (j * UE + e);
    }
  }
  // the slots marked in any lane, vector by vector
  const unsigned any_reach = __reduce_or_sync(kAll, reach);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    unsigned slots = (any_reach >> (j * UE)) & ((1u << UE) - 1u);
    if (slots == 0u) continue;
    float v[UE];
    unpack16<T>(raw[j], v);
    for (; slots != 0u; slots &= slots - 1u) {
      const int e = __ffs(slots) - 1;
      float xv = v[0];
#pragma unroll
      for (int q = 1; q < UE; ++q)
        if (q == e) xv = v[q];
      const int i = (j * nt + tid) * UE + e;
      const float lp = round_to<T>((xv - m) - logsum);
      const unsigned long long mine = (reach >> (j * UE + e)) & 1u ? topk_key(constrain(lp, i, j, e), i) : 0ull;
      // the lanes whose key beats the list's k-th entry, lowest lane first;
      // each insertion raises the k-th entry, and lanes it passes drop out
      // (many equal logits cost one ballot, not one insertion each)
      unsigned pending = __ballot_sync(kAll, mine > last);
      while (pending != 0u) {
        const int src = __ffs(pending) - 1;
        const unsigned long long key = __shfl_sync(kAll, mine, src);
        const int pos = __popc(__ballot_sync(kAll, lane < k && entry > key));
        const unsigned long long above = __shfl_up_sync(kAll, entry, 1);
        if (lane == pos) entry = key;
        else if (lane > pos && lane < k) entry = above;
        last = __shfl_sync(kAll, entry, k - 1);
        pending &= __ballot_sync(kAll, mine > last) & ~(1u << src);
      }
    }
  }
  if (lane < k) cand[warp * kRegisterK + lane] = entry;
  __syncthreads();
  if (warp != 0) return;
  // the row's best k: k rounds over the warps' lists, lane w reading warp w's
  int head = 0;
  unsigned long long result = 0ull;
  for (int r = 0; r < k; ++r) {
    const unsigned long long key = lane < nwarps && head < k ? cand[lane * kRegisterK + head] : 0ull;
    const unsigned long long best = warp_max_key(key);
    if (key == best) ++head;
    if (lane == r) result = best;
  }
  if (lane < k) {
    const int i = key_index(result);
    const float val = key_value(result);
    const size_t o = (size_t)row * k + lane;
    out_val[o] = val;
    out_idx[o] = i;
    const bool touched = DIV ? (pen_s[i >> 5] >> (i & 31)) & 1u : penalized(i, ban, no_eos, eos_id, unk_id);
    out_raw[o] = touched ? round_to<T>((to_f(x[i]) - m) - logsum) : val;
  }
}

// Rows off the held path with k <= kRegisterK (diverse rows too): a scalar
// kernel of 256 threads a row, the shared register path (row_topk.cuh).
template <typename T, int KMAX>
__global__ void __launch_bounds__(kTopkThreads)
beam_topk_kernel(const T* __restrict__ logits, int V, int k, const int* __restrict__ ban_token,
                 const unsigned char* __restrict__ ban_eos, int eos_id, int unk_id,
                 const int* __restrict__ div_tokens, int div_p, int div_group, float div_lambda,
                 float* __restrict__ out_val, int* __restrict__ out_idx, float* __restrict__ out_raw) {
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  __shared__ int red_i[32];
  __shared__ int winner;
  __shared__ int div_s[kMaxDiversity];
  const int row = blockIdx.x;
  const T* x = logits + (size_t)row * V;
  stage_diversity(div_tokens, div_p, div_group, row, div_s);
  float mx, logsum;
  row_logsumexp(x, V, red_a, red_b, mx, logsum);

  // pass 2: constrained log-probs, sorted per-thread top-k
  const int ban = ban_token != nullptr ? ban_token[row] : -1;
  const bool no_eos = ban_eos != nullptr && ban_eos[row] != 0;
  float tv[KMAX], thr;
  int ti[KMAX];
  topk_init(tv, ti, thr);
  for (int i = threadIdx.x; i < V; i += blockDim.x)
    topk_insert(constrained(x, i, mx, logsum, ban, no_eos, eos_id, unk_id, div_s, div_p, div_lambda), i, k, tv, ti,
                thr);

  // merge: k rounds of a block-wide argmax over each thread's best remaining entry
  topk_merge(tv, ti, k, red_a, red_i, &winner, [&](int r, float cv, int ci) {
    const size_t o = (size_t)row * k + r;
    out_val[o] = cv;
    out_idx[o] = ci;
    out_raw[o] = round_to<T>((to_f(x[ci]) - mx) - logsum);
  });
}

// k > kRegisterK: radix select over the row's constrained values in shared
// memory, then a bitonic sort of the k selected entries. Dynamic shared
// memory: V floats, then `cap` (a power of two >= k) uint64 entries.
template <typename T>
__global__ void __launch_bounds__(kTopkThreads)
beam_topk_select_kernel(const T* __restrict__ logits, int V, int k, int cap, const int* __restrict__ ban_token,
                        const unsigned char* __restrict__ ban_eos, int eos_id, int unk_id,
                        const int* __restrict__ div_tokens, int div_p, int div_group, float div_lambda,
                        float* __restrict__ out_val, int* __restrict__ out_idx, float* __restrict__ out_raw) {
  extern __shared__ __align__(16) unsigned char topk_smem[];
  unsigned long long* cand = reinterpret_cast<unsigned long long*>(topk_smem);  // cap
  float* c_s = reinterpret_cast<float*>(cand + cap);                            // V
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  __shared__ int hist[256];
  __shared__ int warp_count[32];
  __shared__ unsigned int prefix_s;
  __shared__ int remaining_s, n_cand;
  __shared__ int div_s[kMaxDiversity];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const T* x = logits + (size_t)row * V;
  stage_diversity(div_tokens, div_p, div_group, row, div_s);
  float mx, logsum;
  row_logsumexp(x, V, red_a, red_b, mx, logsum);
  const int ban = ban_token != nullptr ? ban_token[row] : -1;
  const bool no_eos = ban_eos != nullptr && ban_eos[row] != 0;
  for (int i = threadIdx.x; i < V; i += blockDim.x)
    c_s[i] = constrained(x, i, mx, logsum, ban, no_eos, eos_id, unk_id, div_s, div_p, div_lambda);
  if (threadIdx.x == 0) n_cand = 0;
  __syncthreads();
  // radix select of the k-th largest key (row_topk.cuh)
  unsigned int kth;
  int need_eq;  // values equal to the k-th taken, lowest indices first
  radix_select_kth(c_s, V, k, hist, &prefix_s, &remaining_s, kth, need_eq);
  // gather: every value above the k-th, then the first need_eq equal ones in index order
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const unsigned int key = order_key(c_s[i]);
    if (key > kth) cand[atomicAdd(&n_cand, 1)] = ((unsigned long long)key << 32) | (0xFFFFFFFFu - (unsigned int)i);
  }
  int taken = 0;  // equal values taken so far, in index order
  for (int base = 0; base < V && taken < need_eq; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool eq = i < V && order_key(c_s[i]) == kth;
    const unsigned int ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = taken;
    for (int w = 0; w < warp; ++w) before += warp_count[w];
    before += __popc(ballot & ((1u << lane) - 1u));
    if (eq && before < need_eq) {
      cand[k - need_eq + (before)] = ((unsigned long long)kth << 32) | (0xFFFFFFFFu - (unsigned int)i);
    }
    int chunk = 0;
    for (int w = 0; w < nwarps; ++w) chunk += warp_count[w];
    taken += chunk;
    __syncthreads();  // warp_count is rewritten by the next chunk
  }
  for (int e = k + threadIdx.x; e < cap; e += blockDim.x) cand[e] = 0ull;  // below every real entry
  __syncthreads();
  bitonic_sort_desc(cand, cap);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int i = (int)(0xFFFFFFFFu - (unsigned int)(cand[r] & 0xFFFFFFFFull));
    const size_t o = (size_t)row * k + r;
    out_val[o] = c_s[i];
    out_idx[o] = i;
    out_raw[o] = round_to<T>((to_f(x[i]) - mx) - logsum);
  }
}

inline int select_capacity(int k) {
  int cap = 1;
  while (cap < k) cap <<= 1;
  return cap;
}

inline size_t select_smem_bytes(int V, int k) {
  return (size_t)select_capacity(k) * sizeof(unsigned long long) + (size_t)V * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* logits, int N, int V, int k, const void* ban_token, const void* ban_eos, int eos_id,
                   int unk_id, const void* div_tokens, int div_p, int div_group, float div_lambda, void* out_val,
                   void* out_idx, void* out_raw, cudaStream_t stream) {
  const T* lg = static_cast<const T*>(logits);
  const int* bt = static_cast<const int*>(ban_token);
  const unsigned char* be = static_cast<const unsigned char*>(ban_eos);
  const int* dt = static_cast<const int*>(div_tokens);
  float* ov = static_cast<float*>(out_val);
  int* oi = static_cast<int*>(out_idx);
  float* orw = static_cast<float*>(out_raw);
  const int held = aligned_to(logits, 16) ? held_row_threads<T>(V, kTopkHeldMaxThreads) : 0;
#define SCT_DIV dt, div_p, div_group, div_lambda
  if (held > 0 && k <= kRegisterK) {
    if (div_p > 0)
      beam_topk_held_kernel<T, true><<<N, held, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, SCT_DIV, ov, oi, orw);
    else
      beam_topk_held_kernel<T, false><<<N, held, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, SCT_DIV, ov, oi, orw);
  } else if (k <= 8) {
    beam_topk_kernel<T, 8><<<N, kTopkThreads, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, SCT_DIV, ov, oi, orw);
  } else if (k <= 16) {
    beam_topk_kernel<T, 16><<<N, kTopkThreads, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, SCT_DIV, ov, oi, orw);
  } else if (k <= kRegisterK) {
    beam_topk_kernel<T, 32><<<N, kTopkThreads, 0, stream>>>(lg, V, k, bt, be, eos_id, unk_id, SCT_DIV, ov, oi, orw);
  } else {
    const size_t smem = select_smem_bytes(V, k);
    if (smem > 232448 - 4096) return cudaErrorInvalidValue;  // the static shared arrays need the rest
    cudaError_t err = cudaFuncSetAttribute(beam_topk_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    beam_topk_select_kernel<T><<<N, kTopkThreads, smem, stream>>>(lg, V, k, select_capacity(k), bt, be, eos_id,
                                                                 unk_id, SCT_DIV, ov, oi, orw);
  }
#undef SCT_DIV
  return cudaGetLastError();
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. logits (N, V); ban_token (N,) int32 or null;
// ban_eos (N,) bool or null; unk_id < 0 disables the UNK penalty; 1 <= k <= V
// (k > 32: 8 * pow2ceil(k) + 4 * V bytes of shared memory, at most 223 KB).
// div_tokens (N / div_group, div_p) int32 or null (div_p 0): the earlier
// groups' tokens of each image at this step (row n reads row n / div_group),
// 0 <= div_p <= 256; div_lambda: the diverse-beam penalty's weight.
// Outputs: values (N, k) f32, indices (N, k) int32, raw log-probs (N, k) f32.
extern "C" int sct_beam_topk(int dtype, const void* logits, int N, int V, int k, const void* ban_token,
                             const void* ban_eos, int eos_id, int unk_id, const void* div_tokens, int div_p,
                             int div_group, float div_lambda, void* out_val, void* out_idx, void* out_raw,
                             void* stream) {
  if (k < 1 || V < k || div_p < 0 || div_p > sct::kMaxDiversity || (div_p > 0 && (div_tokens == nullptr ||
                                                                                   div_group < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)sct::launch<float>(logits, N, V, k, ban_token, ban_eos, eos_id, unk_id, div_tokens, div_p, div_group,
                                   div_lambda, out_val, out_idx, out_raw, s);
  if (dtype == 1)
    return (int)sct::launch<__nv_bfloat16>(logits, N, V, k, ban_token, ban_eos, eos_id, unk_id, div_tokens, div_p,
                                           div_group, div_lambda, out_val, out_idx, out_raw, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
