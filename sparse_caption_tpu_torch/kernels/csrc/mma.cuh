// Hopper building blocks of the tensor-core kernels (K1 and K7 in bf16):
// warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulators), ldmatrix, and
// 1-D TMA bulk copies into shared memory completed on an mbarrier.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4), each 32-bit
// register two bf16 of neighbouring k, the lower k in the low half:
//   A (16 x 16, row major): a0 = (row g, k 2t..2t+1), a1 = (row g + 8, k 2t..),
//                           a2 = (row g, k 2t + 8..), a3 = (row g + 8, k 2t + 8..)
//   B (16 x 8, k by n):     b0 = (k 2t..2t+1, col g), b1 = (k 2t + 8.., col g)
//   C (16 x 8, f32):        c0, c1 = (row g, cols 2t, 2t + 1), c2, c3 = (row g + 8, same cols)
// so the C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of one k-step: a product's result feeds the next product in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sct {

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (round to nearest even) in one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds_u32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8. Used for a B operand stored k-major (rows = k): lanes 0-15
// at rows k0 + (l & 15), column n0 + 8 (l >> 4) give the B fragments of the
// n-tiles at n0 (r[0], r[1]) and n0 + 8 (r[2], r[3]).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ------------------------------------------------------------ mbarrier + TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// generic-proxy writes to shared memory ordered before later TMA writes to it
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// 1-D TMA: `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, counted on `bar`'s transaction count
__device__ __forceinline__ void tma_load_1d(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace sct
