// K5: supermask weight sample with its straight-through backward, over a set
// of masked tensors in one launch each way.
//
// Replaces: sparse_caption_tpu/ops/masked.py:70-82 _Prunable._masked and
// ops/ste.py:51-64 bernoulli_sample_sigmoid / rounding_sigmoid (left to XLA's
// fusions on the TPU; the fused supermask matmul Pallas kernel was deleted).
//
// Computes, element by element over every masked weight tensor of a set,
//   forward   s     = [u < sigmoid(m)]   (mode 0, train: a Bernoulli draw)
//                   = [0.5 < sigmoid(m)] (mode 1, eval: round(sigmoid(m)))
//                   = m                  (mode 2, a 0/1 mask of another type)
//             w_eff = w * s, written in w's dtype (exact: s is 0 or 1)
//   backward  dw    = g * s                                  (w's dtype)
//             dm    = (g * w) * sigmoid(m) (1 - sigmoid(m))   (f32; mode 0/1)
//                   = g * w                (bypass_sigmoid_grad, or mode 2)
// In mode 0 the forward writes s as one bit per weight, packed 32 to a word
// (byte u of the set's bit array holds the 8 weights of unit u); the
// backward reads those bits, never u, so the uniforms die with the forward.
// Modes 1 and 2 recompute s from m. sigmoid is 1 / (1 + expf(-m)), the
// expression PyTorch's CUDA sigmoid evaluates, so the sample equals the
// plain version's bit for bit.
//
// Bound on the H100: bytes. The ORT's set carries 55.3M masked weights: in
// bf16 the forward reads w, m, u and writes w_eff and the bits (12.125 B per
// weight), the backward reads g, w, m and the bits and writes dw, dm
// (14.125 B): 1.45 GB, 0.43 ms at 3.35 TB/s. Up-Down's unrolled step draws
// 48.5M weights afresh, 17 times an XE step. A few flops per byte.
//
// Design: one launch per set and direction. The wrapper hands a table of
// entries (pointers, size, the tensor's first unit in the launch's index
// space and in the bit array), passed by value as the kernel's parameter
// (8 KB: CUDA 12.1 and later take up to 32,764 bytes), so a launch needs no
// copy to the device first; the set's index space is the concatenation of
// the tensors' units of 8 weights. A persistent grid sized by the occupancy
// calculator walks it; each thread keeps a cursor into the table (its units
// only grow). A unit takes 16-byte accesses (vec.cuh): 8 bf16 weights in one
// (f32 in two), m and u in two each; a tensor whose size is not a multiple
// of 8 or whose storage is not 16-byte aligned takes a scalar tail (its last
// unit, or all of it). The GEMMs that consume w_eff stay in cuBLAS
// (F.linear), as the JAX package leaves them to XLA.
#include <string.h>

#include "common.cuh"
#include "vec.cuh"

namespace sct {

constexpr int kMaskThreads = 256;
constexpr int kUnit = 8;  // weights a thread takes at a time

// One tensor of a set. Forward p = {w, m, u, w_eff, -}; backward p = {g, w,
// m, dw, dm}. n weights; unit0: its first unit in the launch's index space;
// bit0: its first unit in the set's bit array (the forward's index space).
struct MaskEntry {
  const void* p[5];
  long long n, unit0, bit0;
};
constexpr int kMaxEntries = 128;  // tensors of a set
struct MaskSet {
  MaskEntry e[kMaxEntries];
};

__device__ __forceinline__ float sigmoid_of(float m) { return 1.f / (1.f + expf(-m)); }

// s of one weight: mode 0 from u, 1 from m's sigmoid, 2 m itself
__device__ __forceinline__ float mask_sample(int mode, float m, float u) {
  if (mode == 2) return m;
  const float p = sigmoid_of(m);
  return (mode == 0 ? u < p : 0.5f < p) ? 1.f : 0.f;
}

// every pointer of the entry (the first `count`; null ones aside) 16-byte aligned
__device__ __forceinline__ bool vectors_fit(const MaskEntry& e, int count) {
  bool ok = true;
  for (int i = 0; i < count; ++i) ok &= aligned_to(e.p[i], 16);
  return ok;
}

// the first unit of entry i + 1 (past the last entry: `units`)
__device__ __forceinline__ long long next_unit0(const MaskSet& set, int i, int count, long long units) {
  return i + 1 < count ? set.e[i + 1].unit0 : units;
}

template <typename T>
__global__ void __launch_bounds__(kMaskThreads)
supermask_fwd_kernel(const __grid_constant__ MaskSet set, int count, long long units,
                     unsigned char* __restrict__ bits, int mode) {
  int ti = -1;
  long long next0 = 0;
  MaskEntry ent{};
  bool vec = false;
  for (long long unit = (long long)blockIdx.x * blockDim.x + threadIdx.x; unit < units;
       unit += (long long)gridDim.x * blockDim.x) {
    if (unit >= next0) {
      do {
        next0 = next_unit0(set, ++ti, count, units);
      } while (unit >= next0);
      ent = set.e[ti];
      vec = vectors_fit(ent, 4);
    }
    const T* w = static_cast<const T*>(ent.p[0]);
    const float* m = static_cast<const float*>(ent.p[1]);
    const float* u = static_cast<const float*>(ent.p[2]);
    T* out = static_cast<T*>(const_cast<void*>(ent.p[3]));
    const long long e0 = (unit - ent.unit0) * kUnit;
    unsigned int byte = 0;
    if (vec && e0 + kUnit <= ent.n) {
      float wv[kUnit], mv[kUnit], uv[kUnit];
      load_n<kUnit>(w + e0, wv);
      load_n<kUnit>(m + e0, mv);
      if (mode == 0) load_n<kUnit>(u + e0, uv);
#pragma unroll
      for (int i = 0; i < kUnit; ++i) {
        const float s = mask_sample(mode, mv[i], mode == 0 ? uv[i] : 0.f);
        wv[i] *= s;
        byte |= (s != 0.f ? 1u : 0u) << i;
      }
      store_n<kUnit>(out + e0, wv);
    } else {  // scalar tail
      const int cnt = (int)(ent.n - e0 < kUnit ? ent.n - e0 : kUnit);
      for (int i = 0; i < cnt; ++i) {
        const float s = mask_sample(mode, m[e0 + i], mode == 0 ? u[e0 + i] : 0.f);
        out[e0 + i] = from_f<T>(to_f(w[e0 + i]) * s);
        byte |= (s != 0.f ? 1u : 0u) << i;
      }
    }
    if (mode == 0) bits[ent.bit0 + (unit - ent.unit0)] = (unsigned char)byte;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaskThreads)
supermask_bwd_kernel(const __grid_constant__ MaskSet set, int count, long long units,
                     const uint32_t* __restrict__ bits, int mode, int bypass) {
  const bool need_m = !(mode == 0 && bypass);  // the sample comes from the bits; sigmoid' is bypassed
  const bool plain_gw = bypass || mode == 2;
  int ti = -1;
  long long next0 = 0;
  MaskEntry ent{};
  bool vec = false;
  for (long long unit = (long long)blockIdx.x * blockDim.x + threadIdx.x; unit < units;
       unit += (long long)gridDim.x * blockDim.x) {
    if (unit >= next0) {
      do {
        next0 = next_unit0(set, ++ti, count, units);
      } while (unit >= next0);
      ent = set.e[ti];
      vec = vectors_fit(ent, 5);
    }
    const T* g = static_cast<const T*>(ent.p[0]);
    const T* w = static_cast<const T*>(ent.p[1]);
    const float* m = static_cast<const float*>(ent.p[2]);
    T* dw = static_cast<T*>(const_cast<void*>(ent.p[3]));
    float* dm = static_cast<float*>(const_cast<void*>(ent.p[4]));
    const long long e0 = (unit - ent.unit0) * kUnit;
    unsigned int byte = 0;
    if (mode == 0) {
      const long long bu = ent.bit0 + (unit - ent.unit0);
      byte = (bits[bu >> 2] >> (8 * (bu & 3))) & 0xffu;
    }
    if (vec && e0 + kUnit <= ent.n) {
      float gv[kUnit], wv[kUnit], mv[kUnit], dmv[kUnit];
      load_n<kUnit>(g + e0, gv);
      load_n<kUnit>(w + e0, wv);
      if (need_m) load_n<kUnit>(m + e0, mv);
#pragma unroll
      for (int i = 0; i < kUnit; ++i) {
        const float s = mode == 0 ? (float)((byte >> i) & 1u) : mask_sample(mode, mv[i], 0.f);
        const float gw = gv[i] * wv[i];
        const float p = need_m ? sigmoid_of(mv[i]) : 0.f;
        dmv[i] = plain_gw ? gw : gw * (p * (1.f - p));
        gv[i] *= s;
      }
      store_n<kUnit>(dw + e0, gv);
      store_n<kUnit>(dm + e0, dmv);
    } else {  // scalar tail
      const int cnt = (int)(ent.n - e0 < kUnit ? ent.n - e0 : kUnit);
      for (int i = 0; i < cnt; ++i) {
        const float mi = need_m ? m[e0 + i] : 0.f;
        const float s = mode == 0 ? (float)((byte >> i) & 1u) : mask_sample(mode, mi, 0.f);
        const float gi = to_f(g[e0 + i]), gw = gi * to_f(w[e0 + i]);
        const float p = need_m ? sigmoid_of(mi) : 0.f;
        dw[e0 + i] = from_f<T>(gi * s);
        dm[e0 + i] = plain_gw ? gw : gw * (p * (1.f - p));
      }
    }
  }
}

// a persistent grid: the blocks the card holds at once, no more than the units need
template <typename K>
cudaError_t mask_grid(K kernel, long long units, int& blocks) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMaskThreads, 0);
  if (err != cudaSuccess) return err;
  const long long want = (units + kMaskThreads - 1) / kMaskThreads;
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  return cudaSuccess;
}

// the host table's `count` entries into a kernel parameter
inline MaskSet set_of(const void* table, int count) {
  MaskSet set;
  memcpy(set.e, table, (size_t)count * sizeof(MaskEntry));
  return set;
}

template <typename T>
cudaError_t launch_fwd(const void* table, int count, long long units, void* bits, int mode, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = mask_grid(supermask_fwd_kernel<T>, units, blocks);
  if (err != cudaSuccess) return err;
  supermask_fwd_kernel<T><<<blocks, kMaskThreads, 0, stream>>>(set_of(table, count), count, units,
                                                               static_cast<unsigned char*>(bits), mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* table, int count, long long units, const void* bits, int mode, int bypass,
                       cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = mask_grid(supermask_bwd_kernel<T>, units, blocks);
  if (err != cudaSuccess) return err;
  supermask_bwd_kernel<T><<<blocks, kMaskThreads, 0, stream>>>(set_of(table, count), count, units,
                                                               static_cast<const uint32_t*>(bits), mode, bypass);
  return cudaGetLastError();
}

inline bool bad_args(int dtype, const void* table, int count, long long units, const void* bits, int mode) {
  return dtype < 0 || dtype > 1 || table == nullptr || count < 1 || count > kMaxEntries || units < 1 || mode < 0 ||
         mode > 2 || (mode == 0 && (bits == nullptr || !aligned_to(bits, 4)));
}

}  // namespace sct

// dtype: 0 = float32, 1 = bfloat16 (w, w_eff, g, dw); m, u, dm f32. table:
// `count` <= 128 entries (MaskEntry, 64 bytes each, in host memory) whose units (8
// weights, the last of a tensor maybe fewer) number `units` in all; bits:
// the set's sample bits (mode 0: one byte a unit, 4-byte aligned; else
// null).
extern "C" int sct_supermask(int dtype, const void* table, int count, long long units, void* bits, int mode,
                             void* stream) {
  if (sct::bad_args(dtype, table, count, units, bits, mode)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)sct::launch_fwd<float>(table, count, units, bits, mode, s);
  return (int)sct::launch_fwd<__nv_bfloat16>(table, count, units, bits, mode, s);
}

extern "C" int sct_supermask_bwd(int dtype, const void* table, int count, long long units, const void* bits,
                                 int mode, int bypass, void* stream) {
  if (sct::bad_args(dtype, table, count, units, bits, mode)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)sct::launch_bwd<float>(table, count, units, bits, mode, bypass, s);
  return (int)sct::launch_bwd<__nv_bfloat16>(table, count, units, bits, mode, bypass, s);
}

extern "C" const char* sct_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
