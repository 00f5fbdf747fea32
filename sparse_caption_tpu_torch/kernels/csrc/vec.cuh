// 16-byte global accesses and per-thread cp.async copies for the byte-bound
// row kernels (K6 residual + RefLayerNorm, K13 vocabulary log-softmax, K4
// beam top-K, K12 additive attention).
//
// `ld16` / `st16` move 16 bytes as raw bits, `unpack16<T>` widens them to
// f32 and `pack16<T>` rounds f32 back to T (round to nearest even, as
// `from_f`). `load_n<N>(p, out)` / `store_n<N>` do the same for N
// neighbouring elements (N x size in {8, 16, 32} bytes, the address aligned
// to min(that, 16)). `ld_flags<N>` reads N one-byte flags (a keep-mask) in
// one access.
// `cp_async<B>` copies B bytes (4, 8 or 16, both addresses aligned to B) from
// global to shared memory without passing through registers; the copies a
// thread issued since its last `cp_async_commit` form one group, and
// `cp_async_wait<n>` returns once at most n of its groups are still in
// flight. A thread that reads back only what it copied itself needs no
// barrier beyond that wait. `prefetch_l2` brings a line into L2 ahead of
// its use.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sct {

// the two bf16 halves of a 32-bit word, the lower address in the low half, as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes as raw bits: kept packed in registers until needed (half the
// registers of the widened bf16 values)
__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void st16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// the 16 / sizeof(T) elements of a raw 16-byte vector, widened to f32
template <typename T>
__device__ __forceinline__ void unpack16(uint4 v, float* o) {
  if constexpr (sizeof(T) == 4) {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_lo(w[i]);
      o[2 * i + 1] = bf16_hi(w[i]);
    }
  }
}

// 16 / sizeof(T) floats rounded to T (round to nearest even) as a raw 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* in) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                      __float_as_uint(in[3]));
  } else {
    return make_uint4(pack_bf16x2(in[0], in[1]), pack_bf16x2(in[2], in[3]), pack_bf16x2(in[4], in[5]),
                      pack_bf16x2(in[6], in[7]));
  }
}

// N elements (N = 4 or 8) as one or two 16-byte accesses, or one 8-byte
// access for 4 bf16
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* o) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N == 4 || N == 8, "vectors of 4 or 8 elements");
  if constexpr (N >= kPer) {
#pragma unroll
    for (int h = 0; h < N / kPer; ++h) unpack16<T>(ld16(p + h * kPer), o + h * kPer);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    o[0] = bf16_lo(v.x);
    o[1] = bf16_hi(v.x);
    o[2] = bf16_lo(v.y);
    o[3] = bf16_hi(v.y);
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_n(T* p, const float* in) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N == 4 || N == 8, "vectors of 4 or 8 elements");
  if constexpr (N >= kPer) {
#pragma unroll
    for (int h = 0; h < N / kPer; ++h) st16(p + h * kPer, pack16<T>(in + h * kPer));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(in[0], in[1]), pack_bf16x2(in[2], in[3]));
  }
}

// N one-byte flags (a keep-mask; N = 4 or 8) in one access, as raw bits;
// `flag(w, i)`: flag i set (nonzero)
template <int N>
__device__ __forceinline__ uint2 ld_flags(const unsigned char* p) {
  static_assert(N == 4 || N == 8, "4 or 8 flags");
  if constexpr (N == 8) return *reinterpret_cast<const uint2*>(p);
  return make_uint2(*reinterpret_cast<const uint32_t*>(p), 0u);
}
__device__ __forceinline__ bool flag(uint2 w, int i) { return (((i < 4 ? w.x : w.y) >> (8 * (i % 4))) & 0xffu) != 0; }

// ask for the 128-byte line at p to be brought into L2 (no registers, no wait)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int B>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  static_assert(B == 4 || B == 8 || B == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(smem)), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(shared_addr(smem)), "l"(gmem), "n"(B)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A span of `bytes` bytes at p that starts anywhere (a 13-wide row is 26
// bytes, 2-byte aligned) is copied whole by 16-byte cp.async copies of its
// envelope, the aligned 16-byte blocks that hold it: `envelope_copies` of
// them from `envelope_lo`, the span then `envelope_offset` bytes into the
// copy. `envelope_cap`: the most bytes an envelope of such a span takes
// (it starts at most 15 bytes into its first block).
__host__ __device__ inline int envelope_cap(int bytes) { return (bytes + 15) / 16 * 16 + 16; }
__device__ __forceinline__ int envelope_offset(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}
__device__ __forceinline__ const unsigned char* envelope_lo(const void* p) {
  return reinterpret_cast<const unsigned char*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
}
__device__ __forceinline__ int envelope_copies(const void* p, int bytes) {
  return (envelope_offset(p) + bytes + 15) / 16;
}

// a null pointer counts as aligned (an absent operand)
__host__ __device__ inline bool aligned_to(const void* p, uintptr_t bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace sct
