// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the constants and round of Random123's philox4x32). The plain
// PyTorch version is `philox4x32_10` in kernels/keyed_dropout.py, which
// reproduces these bits in int64 arithmetic masked to 32 bits.
#pragma once

#include <stdint.h>

namespace sct {

struct Philox4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Philox4 philox4x32_10(Philox4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = Philox4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// the j-th word of a Philox output
__device__ __forceinline__ uint32_t philox_word(const Philox4& r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// a keep decision: the top 24 bits as a uniform in [0, 1), below keep_prob
__device__ __forceinline__ bool keep_bit(uint32_t bits, float keep_prob) {
  return static_cast<float>(bits >> 8) * 0x1p-24f < keep_prob;
}

}  // namespace sct
