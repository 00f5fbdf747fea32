// K2's backward (ancestry_self_attention_bwd.cu: the identity map;
// ancestry_self_attention_bwd_anc.cu: the ancestry mode): what both modes
// share, the argument checks and the ancestry mode's fixed shared memory;
// each mode a library of its own so that the two compile in parallel. What
// the kernels compute, their bound and their design are in the two
// sources' notes.
#pragma once

#include "common.cuh"

namespace sct {

// the ancestry mode's fixed shared memory: the image's K rows' q and dout
// (dk f32 each), their p and ds over slots 0..t (f32), and the inverted map
// (a 16-bit first reader per (row, slot) and next reader per (reader,
// slot)); its staged cache comes after (anc_bwd_block_smem)
__host__ __device__ inline size_t anc_bwd_smem_bytes(int dk, int K, int t) {
  return (size_t)K * 2 * dk * sizeof(float) + (size_t)K * (t + 1) * 3 * sizeof(float);
}

// the arguments both modes take: anc == nullptr is the identity map (K = 1);
// cv == nullptr the kv mode, with dcv and dvt null too
inline bool k2_bwd_args_ok(int dk, const void* cv, const void* dcv, const void* dvt, const void* anc, int N, int H,
                           int K, int t_max, int t) {
  return K >= 1 && N >= K && N % K == 0 && H >= 1 && H <= 32 && t >= 0 && t < t_max && t_max <= 1024 &&
         (cv == nullptr) == (dcv == nullptr) && (cv == nullptr) == (dvt == nullptr) &&
         (anc == nullptr || anc_bwd_smem_bytes(dk, K, t) <= (size_t)kBlockSmemLimit);
}

}  // namespace sct
