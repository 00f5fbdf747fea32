// K9: one step of the sampling decode: log_softmax, temperature, a sampling
// filter (top-k or nucleus) or the Gumbel method, the Gumbel-max draw (or the
// greedy argmax), the chosen log-prob and the `unfinished` latch, without
// materialising the (N, V) log-probs.
//
// Replaces: sparse_caption_tpu/decoding/sample.py:134-159 (the body of the
// sampling loop: decoding_constraint, jax.random.categorical, the chosen
// log-prob, the latch and the seq writes), :29-66 modified_sample_logits (the
// top-k and nucleus filters) and :69-90 sample_next_word (the Gumbel method),
// together with the train-mode generator's f32 log_softmax
// (sparse_caption_tpu/models/layers.py:465-472). Left to XLA on the TPU.
// The ss mode (sct_scheduled_sample) replaces the scheduled sampling of the
// Up-Down XE forward, sparse_caption_tpu/models/up_down.py:170-183 (a coin a
// row against ss_prob, then jax.random.categorical on step t-1's
// log-probs); left to XLA on the TPU too.
//
// For each row n of logits (N, V) in the compute dtype T:
//   lp[v] = T((x[v] - max) - log(sum exp(x - max)))        (log_softmax, f32 stats)
//   c[v]  = f32(lp[v]) + (-1e30 if ban_prev and v == prev[n])  (decoding_constraint, t > 0)
//   g[v]  = -log(-log(u)),  u = ((bits >> 9) * 2 + 1) * 2^-24 in (0, 1)
//           bits: Philox4x32-10 under (key, site), counter (site, t, n, v / 4), word v % 4
//   mode random:  z[v] = c[v] / temperature + g[v];   chosen = c[w]
//   mode gumbel:  z[v] = c[v] + g'[v], g' = -log(-log(u + 1e-20) + 1e-20) (the
//                 same u; no temperature, sample.py:81-85);   chosen = c[w]
//   mode top-k:   s[v] = c[v] / temperature; kth = the k-th largest s (with
//                 repeats, as lax.top_k); m[v] = s[v] if s[v] >= kth (ties
//                 kept) else -1e30;  z[v] = m[v] + g[v];   chosen = m[w]
//   mode nucleus: s as top-k; p = softmax(s) (f32: exp(s - max) / sum);
//                 sorted descending, equal p by the lower index (a stable
//                 sort); csum the prefix sums of the sorted p; the first
//                 n_keep = 1 + #{j <= V - 2 : csum[j] < top_p} sorted entries
//                 kept; m[v] = log(p[v] / denom) if kept else -1e30, denom =
//                 the sum of the kept p;  z[v] = m[v] + g[v];   chosen = m[w]
//   greedy:       z = c;   chosen = c[w]
//   w     = argmax z (ties to the lower index)
//   tok   = unfinished[n] ? w : pad;  seq[n, t] = tok;  seq_lp[n, t] = chosen;
//   next[n] = tok;  unfinished[n] &= (w != eos)
// The chosen log-prob is the un-tempered c for random and gumbel
// (sample.py:85,150) and the filtered m for top-k and nucleus (:89).
// The nucleus's prefix sums are exact: each p as a 62-bit fixed-point
// integer (exact for p >= 2^-39), summed with integer adds, compared with
// top_p rounded up to the same grid; the denominator is the exact sum of the
// kept p rounded once to f32. torch.cumsum (the plain version) and XLA's
// cumsum round in their own orders, so a row whose cutoff sum lies within a
// few ulps of top_p may keep one entry more or less.
//
// The ss mode, for row n of step t-1's log-probs lp (N, V) in the compute
// dtype T and the teacher token teacher[n] of step t:
//   coin  = u_c < ss_prob,  u_c = (bits >> 8) 2^-24, bits: Philox (key, coin
//           site), counter (coin site, t, n, 0), word 0 (f32, as JAX's coin)
//   u[v]  = T: f32 ((bits >> 9) 2 + 1) 2^-24, bf16 ((bits >> 25) 2 + 1) 2^-8
//           (exact in bf16, in (0, 1)); bits: counter (noise site, t, n,
//           v / 4), word v % 4
//   g[v]  = -T(log(-T(log(u[v]))))          (jax.random.gumbel in T: each
//                                             log rounded to T)
//   z[v]  = T(lp[v] + g[v]);  w = argmax z (ties to the lower index)
//   out[n] = coin ? w : teacher[n]
// A row whose coin fails reads nothing of lp.
//
// Bound on the H100 (random and Gumbel): the larger of the bytes (the
// logits read once: 38.4 MB at N = 960, V = 10000, f32, 11.5 us at 3.35
// TB/s; 205 MB of bf16 at N = 10240, 61 us) and the operations: a
// Philox4x32-10 call per 4 entries (40 32-bit multiplies, at 64 an SM a
// clock; 61 us at N = 10240 and 1,980 MHz) and two logf and one expf an
// entry (on the held path one expf an entry, one __expf a group and two
// logf an entry that may win, counted at the SFU's 16 an SM a clock);
// `chip_smoke.py k9_ops_ms` counts them.
//
// Design: random, greedy and Gumbel on the held path: where V is
// whole 16-byte vectors, the logits 16-byte aligned and V <= 320 x 32, one
// block per row sized to it (K4's and K13's held layout: thread t holds
// vectors t, t + nt, ... as raw 16-byte vectors, every load issued before
// any math). `held_row_stats` (row_softmax.cuh) gives the max and log-sum in
// K13's order, so each lp is K13's bit for bit; z is formed from the
// registers, no second read. The Philox calls align with the vectors (a
// bf16 vector takes two, an f32 one one; the counter and the u grid are the
// streaming path's). Logs only where a token can win: z_ref is the z of
// some entry (each warp draws the noise of its largest logit not banned,
// z_ref the largest of those), a lower bound on the winner's. Since -log u
// >= 1 - u, an entry whose 1 - u exceeds exp(amax - z_ref + delta) (amax
// the largest a of its group of 4; a = c / T for random, c for Gumbel)
// has g < z_ref - a - delta, and delta lies above the logs' error and the
// add's rounding, so fl(a + g) < z_ref: it cannot win, not even a tie to a
// lower index. The bound is formed once a group (one __expf, its error
// under a factor 1 + 2^-14) and compared with the bits exactly; such an
// entry takes no log. On flat rows a few entries in ten thousand take the
// two logf (`k9_skip_model`), so the step costs the read, the stats' expf
// and the Philox calls. Greedy is z = c in the same instance. Rows off the
// held path (V not whole vectors, unaligned, or longer) take the streaming
// kernel below: the row read twice, an entry at a time, every group drawing
// its noise.
//
// Design of the filter modes (and of the streaming kernel): one block of
// 256 threads per row, as K4's scalar path.
// - Pass 1 keeps an online max/sum per thread and merges them across the
//   block (random, Gumbel and greedy off the held path, and the radix
//   top-k: row_topk.cuh row_logsumexp, an entry at a time). The register
//   top-k (k <= 4 and k <= 32, one instance each) and the nucleus read the row (the k <= 4 top-k and
//   the nucleus as 16-byte vectors where V is whole vectors and the logits
//   aligned; else an entry at a time), and keep each thread's k largest logits
//   other than the banned one in registers (the nucleus: the largest); a
//   butterfly of bitonic merges joins them across the warp, the warps' lists
//   meet once in shared memory. c and s = c / T are non-decreasing in x, so
//   the k-th largest s is s of the k-th largest logit; the banned entry is
//   merged in on its own (its c is f32(lp) - 1e30). No row is held: the last
//   pass reads the logits again (from L2, as vectors) and forms s. Above k =
//   32 the tempered row goes to shared memory and row_topk.cuh's radix
//   select finds the k-th.
// - The nucleus takes max s from the largest logit not banned, then reads the
//   row again for e = exp(s - max s) into shared memory (40 KB at V = 10000),
//   their sum and the masses of e above four levels (a prefilter: entries far
//   below the cut take no part), gathers the taken entries' p bits, and
//   finds the cut by a search over those bits with exact fixed-point masses
//   (nucleus_cut, no sort, no atomics on the sums). Its last pass reads the
//   p from shared memory.
// - The last pass takes 4 consecutive columns per Philox call and keeps each
//   thread's best (z, index); a block-wide argmax merges them. The filter
//   modes draw the Philox words and logs only for a group of 4 with a kept
//   entry: a filtered entry's z = -1e30 + g rounds to -1e30 for every g the
//   noise gives (|g| < 17, half an ulp of 1e30 is 3.8e22).
// The mode is a template parameter, one instance each (top-k three; random
// and Gumbel a held and a streaming one), still one launch a step: the
// random instances (greedy too) hold no filter code, no candidate registers
// and no filter scratch in shared memory.
// The ss mode is a kernel of its own (one block of 256 threads a row, the
// last pass of the random mode on the given log-probs), one instance a dtype.
#include <climits>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"
#include "row_softmax.cuh"
#include "row_topk.cuh"

namespace sct {

constexpr int kSampleThreads = 256;
constexpr int kSampleWarps = kSampleThreads / 32;
constexpr int kTopkFew = 4;        // largest k of the 4-candidate top-k instance
constexpr int kTopkRegister = 32;  // largest k of the register paths; the radix select above
// the dynamic shared memory a block may take: the card's opt-in limit less room for the static arrays
constexpr int kSampleMaxDynamicSmem = 232448 - 8192;
constexpr float kBanPrev = -1e30f;  // sample.py: nan_to_num(one_hot * -inf, neginf=-1e30)
constexpr float kFiltered = -1e30f;  // sample.py NEG_INF: a filtered-out entry
constexpr unsigned int kNoKey = 0xFFFFFFFFu;  // above the bits of every p (p <= 1)
enum SampleMode { kRandom = 0, kGumbel = 1, kTopK = 2, kNucleus = 3 };

__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return static_cast<float>((bits >> 9) * 2u + 1u) * 0x1p-24f;
}

__device__ __forceinline__ float gumbel(uint32_t bits) { return -logf(-logf(uniform_of(bits))); }

// the Gumbel method's noise, with the eps of sample.py:81-84
__device__ __forceinline__ float gumbel_eps(uint32_t bits) {
  return -logf(-logf(uniform_of(bits) + 1e-20f) + 1e-20f);
}

// ---------------------------------------------------------------- top-k
// A thread's KC largest logits, sorted descending, repeats kept (-inf where
// empty): v (> thr, the k-th) takes its place among the first k and the k-th
// drops out; the entries from k on stay -inf.
template <int KC>
__device__ __forceinline__ void cand_insert(float v, int k, float (&tv)[KC], float& thr) {
#pragma unroll
  for (int j = KC - 1; j > 0; --j)
    if (j < k) tv[j] = v > tv[j - 1] ? tv[j - 1] : fmaxf(tv[j], v);
  tv[0] = fmaxf(tv[0], v);
#pragma unroll
  for (int j = 0; j < KC; ++j)
    if (j == k - 1) thr = tv[j];
}

// The KC largest of the lists of WIDTH lanes, in each of them: a butterfly;
// each round keeps the top KC of two sorted lists (the larger of a[j] and
// b[KC - 1 - j], a bitonic sequence) and sorts them again (KC a power of two).
template <int KC, int WIDTH>
__device__ __forceinline__ void cand_merge(float (&tv)[KC]) {
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1) {
    float b[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) b[j] = __shfl_xor_sync(0xffffffffu, tv[j], o);
#pragma unroll
    for (int j = 0; j < KC; ++j) tv[j] = fmaxf(tv[j], b[KC - 1 - j]);
#pragma unroll
    for (int h = KC / 2; h > 0; h >>= 1)
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if ((j & h) == 0) {
          const float hi = fmaxf(tv[j], tv[j + h]), lo = fminf(tv[j], tv[j + h]);
          tv[j] = hi;
          tv[j + h] = lo;
        }
  }
}

// The filter modes read the row as 16-byte vectors of kUnit<T> entries
// where V is whole vectors and the logits are 16-byte aligned (`vec`, the
// same for every row), else an entry at a time; thread t takes vectors t,
// t + nt, ..., so each thread meets its entries in index order.
template <typename T> constexpr int kUnit = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ bool row_vectors(const T* logits, int V) {
  return V % kUnit<T> == 0 && (reinterpret_cast<uintptr_t>(logits) & 15u) == 0;
}

// Pass 1 of the register top-k and the nucleus: the row's max and
// log(sum exp(x - max)) (an online max / sum per thread, rescaled once a
// vector; merged across the block in a fixed order) and the row's KC largest
// logits other than the banned one (the first k exact, sorted descending,
// repeats kept), in lane 0 of every warp. One __syncthreads for both merges.
// cand: KC x the block's warps of shared memory; red_a, red_b, cand free on
// return.
template <typename T, int KC>
__device__ __forceinline__ void row_stats_candidates(const T* __restrict__ x, int V, bool vec, int ban, int k,
                                                     float* red_a, float* red_b, float* cand, float& mx,
                                                     float& logsum, float (&tv)[KC]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  float m = -INFINITY, s = 0.f, thr = -INFINITY;
#pragma unroll
  for (int j = 0; j < KC; ++j) tv[j] = -INFINITY;
  if (vec) {
    constexpr int UE = kUnit<T>;
#pragma unroll 2
    for (int u = threadIdx.x; u < V / UE; u += blockDim.x) {
      float v[UE];
      unpack16<T>(ld16(x + (size_t)u * UE), v);
      float vm = v[0];
#pragma unroll
      for (int q = 1; q < UE; ++q) vm = fmaxf(vm, v[q]);
      if (vm > m) {
        s *= expf(m - vm);
        m = vm;
      }
#pragma unroll
      for (int q = 0; q < UE; ++q) {
        s += expf(v[q] - m);
        if (v[q] > thr && u * UE + q != ban) cand_insert(v[q], k, tv, thr);
      }
    }
  } else {
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const float xi = to_f(x[i]);
      if (xi > m) {
        s = s * expf(m - xi) + 1.f;
        m = xi;
      } else {
        s += expf(xi - m);
      }
      if (xi > thr && i != ban) cand_insert(xi, k, tv, thr);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o), os = __shfl_xor_sync(0xffffffffu, s, o);
    merge_max_sum(m, s, om, os);
  }
  cand_merge<KC, 32>(tv);
  if (lane == 0) {
    red_a[warp] = m;
    red_b[warp] = s;
#pragma unroll
    for (int j = 0; j < KC; ++j) cand[warp * KC + j] = tv[j];
  }
  __syncthreads();
  m = -INFINITY;
  s = 0.f;
  for (int w = 0; w < nwarps; ++w) merge_max_sum(m, s, red_a[w], red_b[w]);
  mx = m;
  logsum = logf(s);
#pragma unroll
  for (int j = 0; j < KC; ++j) tv[j] = lane < nwarps ? cand[lane * KC + j] : -INFINITY;
  cand_merge<KC, kSampleWarps>(tv);
  __syncthreads();  // red_a / red_b / cand are reused by the caller
}

// entry j (a run-time index) of a register array, -inf outside it
template <int KC>
__device__ __forceinline__ float entry(const float (&tv)[KC], int j) {
  float v = -INFINITY;
#pragma unroll
  for (int q = 0; q < KC; ++q)
    if (q == j) v = tv[q];
  return v;
}

// -------------------------------------------------------------- nucleus
// 62-bit fixed point of a p in [0, 1] (its bits `key`): exact for p >= 2^-39,
// truncated below by less than 2^-62. Sums of them are exact and their order
// does not matter.
__device__ __forceinline__ unsigned long long p_fixed(unsigned int key) {
  return __float2ull_rz(__uint_as_float(key) * 0x1p62f);
}

constexpr int kMassLevels = 4;  // the prefilter's levels of exp(s - max): 2^-6, 2^-12, 2^-18, 2^-24
constexpr float kMassMargin = 0x1p-12f;  // above the f32 mass estimate's error (< 100 x 2^-24 relative)
constexpr int kCompact = 1024;  // the taken keys gathered into a list up to this many (4 KB)
constexpr int kHeldKeys = kCompact / kSampleThreads;  // a thread's share of the list, in registers
static_assert(kCompact % kSampleThreads == 0, "the gathered list splits evenly over the block");

struct NucleusCut {
  unsigned int klo, keq;  // kept: key >= klo, and key != keq or the index <= icut
  int icut;
  float denom;            // the kept p's exact sum, rounded once
};

__device__ __forceinline__ bool nucleus_kept(const NucleusCut& c, unsigned int key, int i) {
  return key >= c.klo && (key != c.keq || i <= c.icut);
}

// The nucleus cut of a row (module notes) without a sort. s_of(i, x): entry
// i's tempered value from its logit x; max_s: the row's largest.
// - Pass 2 reads the row (from L2) and writes e = exp(s - max) to shared
//   memory, with their sum and the masses of e at or above each prefilter
//   level. The highest level whose mass is above top_p by kMassMargin bounds
//   the cut: the entries at or above it hold top_p of the exact mass, so the
//   crossing entry has p >= fl(level / sum), and an entry whose e lies below
//   level (1 - 2^-21) has a smaller p (the gap is wider than two ulps); those
//   take no part (key 0), and no p is formed for them.
// - The others' p = e / sum replace them as their bits (the order key of p
//   >= 0), and up to kCompact of them are gathered into a list (else the
//   whole row is the list).
// - With M(K) the exact mass of the keys >= K (62-bit fixed point, integer
//   adds; a warp's by REDUX on 16-bit parts, the block's through shared
//   memory, one barrier each), the crossing entry's key is K* = max{K : M(K)
//   >= top_p}: a bisection between the taken keys' bounds, the gathered keys
//   held in registers (4 a thread). The entries with keys above K* hold
//   base = M(K* + 1); the g = (M(K*) - base) / p entries of p =
//   K*'s value come in index order (the stable sort's), the j-th ending the
//   prefix base + (j + 1) p, so the crossing one is the j* = ceil((top_p -
//   base) / p) - 1-th by index. The kept entries are those up to and
//   including the crossing one: n_keep = 1 + #{j <= V - 2 : csum[j] < top_p}
//   (the rule of sample.py, the first entry always kept; a row whose total
//   stays below top_p keeps all).
template <typename T, typename SFn>
__device__ NucleusCut nucleus_cut(const T* __restrict__ x, int V, bool vec, SFn s_of, float max_s, float top_p,
                                  unsigned int* keys) {
  __shared__ unsigned int compact[kCompact];
  __shared__ unsigned long long wsum[2][kSampleWarps];
  __shared__ float wred[kMassLevels + 1][kSampleWarps];
  __shared__ unsigned int wcnt[kSampleWarps];
  __shared__ unsigned int taken_s;
  __shared__ int icut_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32, nt = blockDim.x;
  float* ev = reinterpret_cast<float*>(keys);
  float acc[kMassLevels + 1] = {};  // the sum, then the masses of e >= 2^-6, 2^-12, 2^-18, 2^-24
  auto take = [&](float e) {
    acc[0] += e;
#pragma unroll
    for (int j = 0; j < kMassLevels; ++j)
      if (e >= __uint_as_float((127u - 6u * (j + 1)) << 23)) acc[j + 1] += e;
  };
  if (vec) {
    constexpr int UE = kUnit<T>;
#pragma unroll 2
    for (int u = tid; u < V / UE; u += nt) {
      float v[UE];
      unpack16<T>(ld16(x + (size_t)u * UE), v);
#pragma unroll
      for (int q = 0; q < UE; ++q) {
        v[q] = expf(s_of(u * UE + q, v[q]) - max_s);
        take(v[q]);
      }
#pragma unroll
      for (int h = 0; h < UE / 4; ++h)
        reinterpret_cast<float4*>(ev + (size_t)u * UE)[h] = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  } else {
    for (int i = tid; i < V; i += nt) {
      const float e = expf(s_of(i, to_f(x[i])) - max_s);
      ev[i] = e;
      take(e);
    }
  }
#pragma unroll
  for (int j = 0; j <= kMassLevels; ++j) {
    const float w = warp_sum(acc[j]);
    if (lane == 0) wred[j][warp] = w;
  }
  if (tid == 0) taken_s = 0u;
  __syncthreads();
#pragma unroll
  for (int j = 0; j <= kMassLevels; ++j) {
    acc[j] = 0.f;
    for (int w = 0; w < nt / 32; ++w) acc[j] += wred[j][w];
  }
  const float sum = acc[0];
  float e_lo = 0.f;  // the prefilter: entries with e below it take no part
  for (int j = 0; j < kMassLevels; ++j)
    if (acc[j + 1] >= (top_p + kMassMargin) * sum) {
      e_lo = __uint_as_float((127u - 6u * (j + 1)) << 23) * (1.f - 0x1p-21f);
      break;
    }
  // the keys: p's bits where the prefilter takes the entry, else 0; the taken ones gathered
  for (int b0 = warp * 32; b0 < V; b0 += nt) {  // entry b0 + lane: each thread's own entries
    const int i = b0 + lane;
    const float e = i < V ? ev[i] : -1.f;
    const bool taken = e >= e_lo;
    const unsigned int key = taken ? __float_as_uint(e / sum) : 0u;
    if (i < V) keys[i] = key;
    const unsigned int bal = __ballot_sync(0xffffffffu, taken);
    if (bal == 0u) continue;
    unsigned int at = 0u;
    if (lane == 0) at = atomicAdd(&taken_s, (unsigned int)__popc(bal));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(bal & ((1u << lane) - 1u));
    if (taken && at < (unsigned int)kCompact) compact[at] = key;
  }
  __syncthreads();
  const bool gathered = taken_s <= (unsigned int)kCompact;
  unsigned int hk[kHeldKeys];  // a gathered list: each thread holds its entries and their fixed-point p
  unsigned long long hf[kHeldKeys];
#pragma unroll
  for (int r = 0; r < kHeldKeys; ++r) {
    const int j = tid + r * nt;
    hk[r] = gathered && j < (int)taken_s ? compact[j] : 0u;
    hf[r] = p_fixed(hk[r]);
  }
  int buf = 0;
  // M(k) in every thread: each thread's share, the warps' by REDUX on 16-bit parts (exact), the block's through
  // shared memory (two buffers: one barrier a call)
  auto mass = [&](unsigned int k) {
    unsigned long long part = 0ull;
    if (gathered) {
#pragma unroll
      for (int r = 0; r < kHeldKeys; ++r)
        if (hk[r] >= k) part += hf[r];
    } else {
      for (int i = tid; i < V; i += nt) {
        const unsigned int key = keys[i];
        if (key >= k) part += p_fixed(key);
      }
    }
    unsigned long long w = 0ull;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w += (unsigned long long)__reduce_add_sync(0xffffffffu, (unsigned int)(part >> (16 * q)) & 0xFFFFu) << (16 * q);
    if (lane == 0) wsum[buf][warp] = w;
    __syncthreads();
    unsigned long long m = 0ull;
    for (int v = 0; v < nt / 32; ++v) m += wsum[buf][v];
    buf ^= 1;
    return m;
  };
  const unsigned long long top = __float2ull_ru(top_p * 0x1p62f);
  const unsigned long long total = mass(0u);
  if (total < top) return NucleusCut{0u, kNoKey, INT_MAX, __ull2float_rn(total) * 0x1p-62f};  // all kept
  // K* = max{K : M(K) >= top}: a bisection with M(lo) >= top > M(hi); every taken key lies in [p of e_lo,
  // p of e = 1] (the largest entry's e is exp(0))
  unsigned int lo = __float_as_uint(e_lo / sum), hi = __float_as_uint(1.f / sum) + 1u;
  unsigned long long m_lo = total, m_hi = 0ull;
  while (hi - lo > 1u) {
    const unsigned int mid = lo + (hi - lo) / 2u;
    const unsigned long long m = mass(mid);
    if (m >= top) {
      lo = mid;
      m_lo = m;
    } else {
      hi = mid;
      m_hi = m;
    }
  }
  // K* = lo: base = M(K* + 1), g entries of p = K*'s value; the crossing one is the j*-th of them by index
  const unsigned long long pf = p_fixed(lo), base = m_hi;  // pf > 0: M(K*) > M(K* + 1)
  const unsigned long long cnt = (m_lo - base) / pf;
  const unsigned long long jstar = (top - base + pf - 1ull) / pf - 1ull;
  const float denom = __ull2float_rn(base + (jstar + 1ull) * pf) * 0x1p-62f;
  if (jstar + 1ull >= cnt) return NucleusCut{lo, kNoKey, INT_MAX, denom};
  const unsigned int prefix = lo;
  // the j*-th equal entry by index: warp w counts the equal keys of its span of the row, then the warp whose
  // span holds it finds it
  const int span = (V + nt - 1) / nt * 32, first = warp * span, last = min(first + span, V);
  int count = 0;
  for (int b0 = first; b0 < last; b0 += 32) {
    const int i = b0 + lane;
    count += __popc(__ballot_sync(0xffffffffu, i < last && keys[i] == prefix));
  }
  if (lane == 0) wcnt[warp] = (unsigned int)count;
  __syncthreads();
  int need = (int)jstar;
  for (int w = 0; w < warp; ++w) need -= (int)wcnt[w];
  if (need >= 0 && need < count) {
    for (int b0 = first; b0 < last; b0 += 32) {
      const int i = b0 + lane;
      const bool eq = i < last && keys[i] == prefix;
      const unsigned int bal = __ballot_sync(0xffffffffu, eq);
      if (need < __popc(bal)) {
        if (eq && __popc(bal & ((1u << lane) - 1u)) == need) icut_s = i;
        break;
      }
      need -= __popc(bal);
    }
  }
  __syncthreads();
  return NucleusCut{prefix, prefix, icut_s, denom};
}

// dynamic shared memory of a mode: the tempered row (top-k's radix select)
// or the row's p (nucleus), 4 bytes an entry
__host__ __device__ inline size_t sample_smem_bytes(int V, int mode, int top_k) {
  const bool row = mode == kNucleus || (mode == kTopK && top_k > kTopkRegister);
  return row ? (size_t)V * sizeof(float) : 0;
}

// kMode: a SampleMode. KC: top-k's candidates a thread (kTopkFew or
// kTopkRegister; 0 the radix select), the nucleus's 1 (the largest logit
// not banned); 0 for the others. The random instance (greedy too) carries
// none of the filter code, its registers or its shared memory.
template <typename T, int kMode, int KC>
__global__ void __launch_bounds__(kSampleThreads)
sample_step_kernel(const T* __restrict__ logits, int V, const int* __restrict__ prev,
                   unsigned char* __restrict__ unfinished, int* __restrict__ seq, float* __restrict__ seq_lp,
                   int* __restrict__ next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site, int greedy,
                   float temperature, int ban_prev, int eos_id, int pad_id, int top_k, float top_p) {
  constexpr bool filtered = kMode == kTopK || kMode == kNucleus;
  constexpr bool radix_topk = kMode == kTopK && KC == 0;
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  __shared__ int red_i[32];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const T* x = logits + (size_t)row * V;
  const int ban = ban_prev ? prev[row] : -1;
  float mx, logsum;
  auto logprob = [&](int i) {  // c[i] of the module notes
    float c = round_to<T>((to_f(x[i]) - mx) - logsum);
    if (i == ban) c += kBanPrev;
    return c;
  };
  auto tempered_logit = [&](float xv) { return round_to<T>((xv - mx) - logsum) / temperature; };  // s, not banned
  auto tempered = [&](int i, float xv) {  // s[i] of the module notes from its logit xv
    float c = round_to<T>((xv - mx) - logsum);
    if (i == ban) c += kBanPrev;
    return c / temperature;
  };
  // vector loads for the 4-candidate top-k and the nucleus; the 32-candidate top-k reads an entry at a time
  // (unrolled over a vector of 8 bf16 entries, its 32-entry insertion spills to local memory)
  const bool vec = filtered && KC > 0 && KC <= kTopkFew && row_vectors(logits, V);

  extern __shared__ __align__(16) unsigned char sample_smem[];
  float* sv = reinterpret_cast<float*>(sample_smem);  // top-k's radix select: the tempered row
  unsigned int* keys = reinterpret_cast<unsigned int*>(sample_smem);  // nucleus: the row's p as bits
  float kth = 0.f;  // top-k: the k-th largest s (with repeats)
  NucleusCut cut{0u, kNoKey, INT_MAX, 1.f};

  // pass 1: log-sum-exp (and the register top-k's candidates, the nucleus's largest logit not banned)
  if constexpr (kMode == kTopK && KC > 0) {
    __shared__ float cand[kSampleWarps * (KC > 0 ? KC : 1)];
    float tv[KC > 0 ? KC : 1];
    row_stats_candidates<T>(x, V, vec, ban, top_k, red_a, red_b, cand, mx, logsum, tv);
    // the k-th largest s is s of the k-th largest logit (s is non-decreasing in x), the banned entry merged in
    const float xk = __shfl_sync(0xffffffffu, entry(tv, top_k - 1), 0);
    const float xk1 = __shfl_sync(0xffffffffu, entry(tv, top_k - 2), 0);
    kth = tempered_logit(xk);
    if (ban >= 0) {
      const float sb = logprob(ban) / temperature;
      if (sb > kth) kth = top_k == 1 ? sb : fminf(sb, tempered_logit(xk1));
    }
  } else if constexpr (kMode == kNucleus) {
    __shared__ float cand[kSampleWarps];
    float tv[1];
    row_stats_candidates<T>(x, V, vec, ban, 1, red_a, red_b, cand, mx, logsum, tv);
    float max_s = tempered_logit(__shfl_sync(0xffffffffu, tv[0], 0));
    if (ban >= 0) max_s = fmaxf(max_s, logprob(ban) / temperature);
    cut = nucleus_cut(x, V, vec, tempered, max_s, top_p, keys);
  } else {
    row_logsumexp(x, V, red_a, red_b, mx, logsum);
    if constexpr (radix_topk) {  // the row's s in shared memory, the radix select of the k-th
      __shared__ int hist[256];
      __shared__ unsigned int prefix_s;
      __shared__ int remaining_s;
      for (int i = threadIdx.x; i < V; i += blockDim.x) sv[i] = logprob(i) / temperature;
      __syncthreads();
      unsigned int key;
      int need_eq;
      radix_select_kth(sv, V, top_k, hist, &prefix_s, &remaining_s, key, need_eq);
      kth = order_value(key);
    }
  }

  // last pass: noise, per-thread argmax over 4 columns a call; the filter modes draw noise only for a group
  // with a kept entry (a filtered entry's z = -1e30 + g rounds to -1e30 for every g the noise gives)
  float best = -INFINITY;
  int best_i = INT_MAX;
  const int groups = (V + 3) / 4;
  if constexpr (filtered) {
    // group c4's filtered values m (kFiltered where not kept): the noise only if one is kept
    auto draw_group = [&](int c4, const float (&m)[4]) {
      const bool any = m[0] != kFiltered || m[1] != kFiltered || m[2] != kFiltered || m[3] != kFiltered;
      Philox4 r{0u, 0u, 0u, 0u};
      if (any) r = philox4x32_10(Philox4{site, (uint32_t)t, (uint32_t)row, (uint32_t)c4}, k0, k1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * c4 + q;
        if (i >= V) break;
        const float z = m[q] == kFiltered ? kFiltered : m[q] + gumbel(philox_word(r, q));
        if (z > best) {  // i grows within a thread, so a tie keeps the lower index
          best = z;
          best_i = i;
        }
      }
    };
    auto topk_value = [&](float s) { return s >= kth ? s : kFiltered; };
    if (kMode == kTopK && KC > 0 && vec) {  // the logits again (from L2), a vector at a time
      constexpr int UE = kUnit<T>;
      for (int u = threadIdx.x; u < V / UE; u += blockDim.x) {
        float v[UE];
        unpack16<T>(ld16(x + (size_t)u * UE), v);
#pragma unroll
        for (int h = 0; h < UE / 4; ++h) {
          float m[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) m[q] = topk_value(tempered(u * UE + 4 * h + q, v[4 * h + q]));
          draw_group(u * (UE / 4) + h, m);
        }
      }
    } else {
      for (int c4 = threadIdx.x; c4 < groups; c4 += blockDim.x) {
        float m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * c4 + q;
          m[q] = kFiltered;
          if (i >= V) continue;
          if constexpr (kMode == kNucleus) {
            const unsigned int key = keys[i];
            if (nucleus_kept(cut, key, i)) m[q] = logf(__uint_as_float(key) / cut.denom);
          } else {
            m[q] = topk_value(radix_topk ? sv[i] : logprob(i) / temperature);
          }
        }
        draw_group(c4, m);
      }
    }
  } else {
    for (int c4 = threadIdx.x; c4 < groups; c4 += blockDim.x) {
      Philox4 r{0u, 0u, 0u, 0u};
      if (!greedy) r = philox4x32_10(Philox4{site, (uint32_t)t, (uint32_t)row, (uint32_t)c4}, k0, k1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * c4 + q;
        if (i >= V) break;
        float z;
        if (greedy) {
          z = logprob(i);
        } else if (kMode == kGumbel) {
          z = logprob(i) + gumbel_eps(philox_word(r, q));
        } else {
          z = logprob(i) / temperature + gumbel(philox_word(r, q));
        }
        if (z > best) {  // i grows within a thread, so a tie keeps the lower index
          best = z;
          best_i = i;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ranks_above(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red_a[warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w)
      if (ranks_above(red_a[w], red_i[w], best, best_i)) {
        best = red_a[w];
        best_i = red_i[w];
      }
    if (best_i >= V) best_i = 0;  // every z was -inf: argmax's first index
    float chosen;
    if constexpr (kMode == kNucleus) {
      const unsigned int key = keys[best_i];
      chosen = nucleus_kept(cut, key, best_i) ? logf(__uint_as_float(key) / cut.denom) : kFiltered;
    } else if constexpr (kMode == kTopK) {
      const float s = radix_topk ? sv[best_i] : logprob(best_i) / temperature;
      chosen = s >= kth ? s : kFiltered;
    } else {
      chosen = logprob(best_i);
    }
    const bool live = unfinished[row] != 0;
    const int tok = live ? best_i : pad_id;
    seq[(size_t)row * t_max + t] = tok;
    seq_lp[(size_t)row * t_max + t] = chosen;
    next[row] = tok;
    unfinished[row] = (live && best_i != eos_id) ? 1 : 0;
  }
}


// the noise of a word, out of line: on the held path few entries take the two logf, so one copy serves all
template <int kMode>
__device__ __noinline__ float held_noise(uint32_t bits) {
  return kMode == kGumbel ? gumbel_eps(bits) : gumbel(bits);
}

// The held path of the random (greedy too) and Gumbel modes (module notes):
// one block per row of `units` 16-byte vectors, thread t holding vectors t,
// t + nt, ... (PER of them); z from the registers, Philox only for a group
// and logf only for an entry that can win.
template <typename T, int kMode>
__global__ void __launch_bounds__(kTopkHeldMaxThreads, sizeof(T) == 2 ? 4 : 3)
sample_held_kernel(const T* __restrict__ logits, int V, const int* __restrict__ prev,
                   unsigned char* __restrict__ unfinished, int* __restrict__ seq, float* __restrict__ seq_lp,
                   int* __restrict__ next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site, int greedy,
                   float temperature, int ban_prev, int eos_id, int pad_id) {
  constexpr int UE = kUnit<T>;
  constexpr int PER = kRowHeld / UE;
  constexpr int GV = UE / 4;  // groups of 4 columns (a Philox call each) in a vector
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float red[2][32];
  __shared__ float red_z[32];
  __shared__ int red_i[32];
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid / 32, nwarps = nt / 32;
  const int units = V / UE, row = blockIdx.x;
  const T* x = logits + (size_t)row * V;
  uint4 raw[PER];  // kept packed: the whole row's loads in flight at once
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int u = j * nt + tid;
    raw[j] = u < units ? ld16(x + (size_t)u * UE) : make_uint4(0u, 0u, 0u, 0u);
  }
  const int ban = ban_prev ? prev[row] : -1;
  float m, logsum, xmax;
  held_row_stats<T, PER>(raw, units, red[0], red[1], m, logsum, xmax);
  auto logprob = [&](int i, float xv) {  // c[i] of the module notes from its logit xv
    float c = round_to<T>((xv - m) - logsum);
    if (i == ban) c += kBanPrev;
    return c;
  };
  // a, what the noise is added to: c / T for random (c itself at T = 1), c for greedy and the Gumbel method
  // (not tempered, sample.py:81-85)
  const bool tempered = kMode == kRandom && !greedy && temperature != 1.f;
  auto value = [&](float c) { return tempered ? c / temperature : c; };

  // z_ref: each warp draws the noise of its largest logit not banned (one Philox call a warp), z_ref the
  // largest of those z, a lower bound on the winner's
  float z_ref = -INFINITY;
  if (!greedy) {
    float xb = -INFINITY;
    int ib = -1;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int u = j * nt + tid;
      if (u < units) {
        float v[UE];
        unpack16<T>(raw[j], v);
#pragma unroll
        for (int e = 0; e < UE; ++e)
          if (v[e] > xb && u * UE + e != ban) {
            xb = v[e];
            ib = u * UE + e;
          }
      }
    }
    const float wx = warp_max(xb);
    const unsigned at = __ballot_sync(kAll, ib >= 0 && xb == wx);
    float zw = -INFINITY;
    if (at != 0u) {
      const int iw = __shfl_sync(kAll, ib, __ffs(at) - 1);
      const Philox4 r = philox4x32_10(Philox4{site, (uint32_t)t, (uint32_t)row, (uint32_t)(iw / 4)}, k0, k1);
      zw = value(logprob(iw, wx)) + held_noise<kMode>(philox_word(r, iw % 4));
    }
    if (lane == 0) red_z[warp] = zw;
    __syncthreads();
    for (int w = 0; w < nwarps; ++w) z_ref = fmaxf(z_ref, red_z[w]);
  }

  // z from the registers, 4 columns a Philox call; each thread's best (z, index)
  float best = -INFINITY;
  int best_i = INT_MAX;
  auto offer = [&](float z, int i) {
    if (z > best) {  // i grows within a thread, so a tie keeps the lower index
      best = z;
      best_i = i;
    }
  };
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int u = j * nt + tid;
    if (u >= units) continue;
    float v[UE];
    unpack16<T>(raw[j], v);
#pragma unroll
    for (int h = 0; h < GV; ++h) {
      const int i0 = u * UE + 4 * h;
      if (greedy) {
#pragma unroll
        for (int q = 0; q < 4; ++q) offer(logprob(i0 + q, v[4 * h + q]), i0 + q);
        continue;
      }
      // a of the group's largest logit, which no entry of the group exceeds (c and a grow with the logit;
      // the ban only lowers one)
      const float amax =
          value(round_to<T>((fmaxf(fmaxf(v[4 * h], v[4 * h + 1]), fmaxf(v[4 * h + 2], v[4 * h + 3])) - m) - logsum));
      // an entry whose u cannot lift it to z_ref takes no log: 1 - u > lim = exp(amax - z_ref + delta) gives
      // -log u > exp(a - z_ref + delta), so g < z_ref - a - delta and fl(a + g) < z_ref (delta above the
      // logs' and the adds' rounding, the factor above __expf's error)
      const float lim =
          __expf(amax - z_ref + (0x1p-17f + 0x1p-21f * (fabsf(z_ref) + fabsf(amax)))) * (1.f + 0x1p-14f);
      // on the bits, exactly: 1 - u = ((~bits >> 9) 2 + 1) 2^-24 > lim where bits >> 9 <= kmax (kf is exact)
      const float kf = lim * 0x1p23f - 0.5f;
      const int kmax = kf < 0.f ? 8388607 : !(kf < 8388607.f) ? -1 : 8388606 - (int)kf;
      const Philox4 r = philox4x32_10(Philox4{site, (uint32_t)t, (uint32_t)row, (uint32_t)(u * GV + h)}, k0, k1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bits = philox_word(r, q);
        if ((int)(bits >> 9) <= kmax) continue;  // 1 - u > lim
        offer(value(logprob(i0 + q, v[4 * h + q])) + held_noise<kMode>(bits), i0 + q);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kAll, best, o);
    const int oi = __shfl_xor_sync(kAll, best_i, o);
    if (ranks_above(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red[0][warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w)
      if (ranks_above(red[0][w], red_i[w], best, best_i)) {
        best = red[0][w];
        best_i = red_i[w];
      }
    if (best_i >= V) best_i = 0;  // every z was -inf: argmax's first index
    const float chosen = logprob(best_i, to_f(x[best_i]));
    const bool live = unfinished[row] != 0;
    const int tok = live ? best_i : pad_id;
    seq[(size_t)row * t_max + t] = tok;
    seq_lp[(size_t)row * t_max + t] = chosen;
    next[row] = tok;
    unfinished[row] = (live && best_i != eos_id) ? 1 : 0;
  }
}

// the ss mode's noise: a uniform with T's precision (exact in T), then
// -log(-log(u)) with each log rounded to T, as jax.random.gumbel in T
template <typename T>
__device__ __forceinline__ float ss_gumbel(uint32_t bits);
template <>
__device__ __forceinline__ float ss_gumbel<float>(uint32_t bits) {
  return -logf(-logf(uniform_of(bits)));
}
template <>
__device__ __forceinline__ float ss_gumbel<__nv_bfloat16>(uint32_t bits) {
  const float u = static_cast<float>((bits >> 25) * 2u + 1u) * 0x1p-8f;
  return -round_to<__nv_bfloat16>(logf(-round_to<__nv_bfloat16>(logf(u))));
}

template <typename T>
__global__ void __launch_bounds__(kSampleThreads)
scheduled_sample_kernel(const T* __restrict__ lp, int V, const int* __restrict__ teacher, int* __restrict__ out,
                        int t, uint32_t k0, uint32_t k1, uint32_t coin_site, uint32_t noise_site, float ss_prob) {
  __shared__ float red_a[32];
  __shared__ int red_i[32];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const uint32_t coin_bits = philox4x32_10(Philox4{coin_site, (uint32_t)t, (uint32_t)row, 0u}, k0, k1).x;
  if (!(static_cast<float>(coin_bits >> 8) * 0x1p-24f < ss_prob)) {  // the teacher's token
    if (threadIdx.x == 0) out[row] = teacher[row];
    return;
  }
  const T* x = lp + (size_t)row * V;
  float best = -INFINITY;
  int best_i = INT_MAX;
  const int groups = (V + 3) / 4;
  for (int c4 = threadIdx.x; c4 < groups; c4 += blockDim.x) {
    const Philox4 r = philox4x32_10(Philox4{noise_site, (uint32_t)t, (uint32_t)row, (uint32_t)c4}, k0, k1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * c4 + q;
      if (i >= V) break;
      const float z = round_to<T>(to_f(x[i]) + ss_gumbel<T>(philox_word(r, q)));
      if (z > best) {  // i grows within a thread, so a tie keeps the lower index
        best = z;
        best_i = i;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ranks_above(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red_a[warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w)
      if (ranks_above(red_a[w], red_i[w], best, best_i)) {
        best = red_a[w];
        best_i = red_i[w];
      }
    out[row] = best_i >= V ? 0 : best_i;  // every z NaN or -inf: argmax's first index
  }
}

template <typename T, int kMode, int KC>
cudaError_t launch_mode(const void* logits, int N, int V, const void* prev, void* unfinished, void* seq,
                        void* seq_lp, void* next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site,
                        int greedy, float temperature, int ban_prev, int eos_id, int pad_id, int top_k, float top_p,
                        cudaStream_t stream) {
  const size_t smem = sample_smem_bytes(V, kMode, top_k);
  if (smem > (size_t)kSampleMaxDynamicSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(sample_step_kernel<T, kMode, KC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sample_step_kernel<T, kMode, KC><<<N, kSampleThreads, smem, stream>>>(
      static_cast<const T*>(logits), V, static_cast<const int*>(prev), static_cast<unsigned char*>(unfinished),
      static_cast<int*>(seq), static_cast<float*>(seq_lp), static_cast<int*>(next), t, t_max, k0, k1, site, greedy,
      temperature, ban_prev, eos_id, pad_id, top_k, top_p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* logits, int N, int V, const void* prev, void* unfinished, void* seq, void* seq_lp,
                   void* next, int t, int t_max, uint32_t k0, uint32_t k1, uint32_t site, int greedy,
                   float temperature, int ban_prev, int eos_id, int pad_id, int mode, int top_k, float top_p,
                   cudaStream_t stream) {
#define SCT_MODE(M, KC)                                                                                          \
  launch_mode<T, M, KC>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site, greedy,     \
                        temperature, ban_prev, eos_id, pad_id, top_k, top_p, stream)
  if (greedy || mode == kRandom || mode == kGumbel) {
    const int held = aligned_to(logits, 16) ? held_row_threads<T>(V, kTopkHeldMaxThreads) : 0;
    const bool gumbel_mode = !greedy && mode == kGumbel;
    if (held > 0) {
#define SCT_HELD(M)                                                                                               \
  sample_held_kernel<T, M><<<N, held, 0, stream>>>(                                                              \
      static_cast<const T*>(logits), V, static_cast<const int*>(prev), static_cast<unsigned char*>(unfinished),    \
      static_cast<int*>(seq), static_cast<float*>(seq_lp), static_cast<int*>(next), t, t_max, k0, k1, site, greedy, \
      temperature, ban_prev, eos_id, pad_id)
      if (gumbel_mode) SCT_HELD(kGumbel);
      else SCT_HELD(kRandom);
#undef SCT_HELD
      return cudaGetLastError();
    }
    return gumbel_mode ? SCT_MODE(kGumbel, 0) : SCT_MODE(kRandom, 0);
  }
  if (mode == kTopK) {
    if (top_k <= kTopkFew) return SCT_MODE(kTopK, kTopkFew);
    if (top_k <= kTopkRegister) return SCT_MODE(kTopK, kTopkRegister);
    return SCT_MODE(kTopK, 0);
  }
  return SCT_MODE(kNucleus, 1);
#undef SCT_MODE
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16. logits (N, V); prev (N,) int32; unfinished
// (N,) bool, updated in place; seq (N, t_max) int32 and seq_lp (N, t_max) f32,
// column t written; next (N,) int32. mode: 0 random, 1 gumbel, 2 top-k (top_k
// in 1..V), 3 nucleus (top_p in (0, 1)); greedy overrides it. The nucleus and
// top-k above 32 hold 4 bytes an entry in shared memory: sct_sample_smem(V,
// mode, top_k) at most kSampleMaxDynamicSmem, so V <= 56064.
extern "C" int sct_sample_step(int dtype, const void* logits, int N, int V, const void* prev, void* unfinished,
                               void* seq, void* seq_lp, void* next, int t, int t_max, uint32_t k0, uint32_t k1,
                               uint32_t site, int greedy, float temperature, int ban_prev, int eos_id, int pad_id,
                               int mode, int top_k, float top_p, void* stream) {
  if (N <= 0 || V <= 0 || t < 0 || t >= t_max || !(temperature > 0.f) || mode < sct::kRandom ||
      mode > sct::kNucleus || (mode == sct::kTopK && (top_k < 1 || top_k > V)) ||
      (mode == sct::kNucleus && !(top_p > 0.f && top_p < 1.f)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)sct::launch<float>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site, greedy,
                                   temperature, ban_prev, eos_id, pad_id, mode, top_k, top_p, s);
  if (dtype == 1)
    return (int)sct::launch<__nv_bfloat16>(logits, N, V, prev, unfinished, seq, seq_lp, next, t, t_max, k0, k1, site,
                                           greedy, temperature, ban_prev, eos_id, pad_id, mode, top_k, top_p, s);
  return (int)cudaErrorInvalidValue;
}

// The ss mode. dtype: 0 = float32, 1 = bfloat16. lp (N, V), step t-1's
// log-probs; teacher (N,) int32, step t's teacher tokens; out (N,) int32,
// step t's input tokens; (k0, k1) the 64-bit key; 0 <= ss_prob <= 1.
extern "C" int sct_scheduled_sample(int dtype, const void* lp, int N, int V, const void* teacher, void* out, int t,
                                    uint32_t k0, uint32_t k1, uint32_t coin_site, uint32_t noise_site, float ss_prob,
                                    void* stream) {
  if (N <= 0 || V <= 0 || t < 0 || !(ss_prob >= 0.f && ss_prob <= 1.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sct::scheduled_sample_kernel<float><<<N, sct::kSampleThreads, 0, s>>>(
        static_cast<const float*>(lp), V, static_cast<const int*>(teacher), static_cast<int*>(out), t, k0, k1,
        coin_site, noise_site, ss_prob);
  else if (dtype == 1)
    sct::scheduled_sample_kernel<__nv_bfloat16><<<N, sct::kSampleThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lp), V, static_cast<const int*>(teacher), static_cast<int*>(out), t, k0,
        k1, coin_site, noise_site, ss_prob);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// the dynamic shared memory of a launch (greedy aside), bytes
extern "C" long long sct_sample_smem(int V, int mode, int top_k) {
  return (long long)sct::sample_smem_bytes(V, mode, top_k);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
