#!/bin/bash
# Planted source faults in kernels K1 (box attention) and K7 (its backward), to
# show what the kernel checks of chip_smoke.py catch. Each mutant is a copy of
# the port under build/mutants/<name>/ with sed edits to one CUDA source; its
# kernel checks (check_kernels: K1 serving with its log-bias check, and
# check_train_kernels: K1's train variant and K7) then run at paper shapes and
# at small R. A mutant whose checks pass is one they cannot see; each verdict
# line ends "caught" (a kernel that raises is caught too) or "checks pass".
#
# In the bf16 tensor-core design the trig features and K1's log-bias reach
# the products and the scores only as bf16 values (MMA fragments, a bf16
# array), so leaving them unrounded cannot be written; the mutants drop the
# rounding points that remain in f32 arithmetic.
#
#     bash chip_mutants.sh      # on a machine with one H100, from the repo root
cd "$(dirname "$0")" || exit 1
run_mutant() {  # name file sed-expression dtypes
  local name=$1 file=$2 expr=$3 dtypes=$4 dir=build/mutants/$1
  rm -rf "$dir" && mkdir -p "$dir"
  cp -r sparse_caption_tpu_torch chip_smoke.py "$dir/"
  sed -i "$expr" "$dir/sparse_caption_tpu_torch/kernels/csrc/$file"
  if cmp -s "sparse_caption_tpu_torch/kernels/csrc/$file" "$dir/sparse_caption_tpu_torch/kernels/csrc/$file"; then
    echo "[mutant] $name: sed changed nothing"; return
  fi
  echo "[mutant] $name: $(diff "sparse_caption_tpu_torch/kernels/csrc/$file" "$dir/sparse_caption_tpu_torch/kernels/csrc/$file" | grep '^>' | head -2 | tr '\n' ' ')"
  (cd "$dir" && python3 -c "
import torch, chip_smoke as c
from sparse_caption_tpu_torch.kernels import build_all
torch.backends.cuda.matmul.allow_tf32 = False
build_all()
for dt in ($dtypes):
    g, results = torch.Generator(device='cuda').manual_seed(0), {}
    try:
        verdict = 'checks pass' if c.check_kernels(g, dt, results) & c.check_train_kernels(g, dt, results) else 'caught'
    except RuntimeError as e:  # a kernel that fails to launch or faults fails chip_smoke.py too
        verdict = 'caught (raised: ' + str(e).splitlines()[0][:120] + ')'
    print('[mutant] $name', str(dt).split('.')[-1], verdict, flush=True)
" 2>&1 | grep -E "^\[mutant\]|FAIL|MISSED|Error|error" )
}
run_mutant bias_dropped box_attention.cu 's/if (row < R) s = round_to<bf16>(s + __bfloat162float(bias_h\[row \* R + j\]));/;/; s/s\[c\] += bias_h\[i \* R + j\];/;/' "torch.float32, torch.bfloat16"
run_mutant logbias_unrounded box_attention_bwd.cu 's/round_to<bf16>(logf(__bfloat162float(wz\[row \* R + j\])))/logf(__bfloat162float(wz[row * R + j]))/' "torch.bfloat16,"
run_mutant wg_sum_unrounded box_geometry.cuh 's/round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(acc\[e\]) + wb)/round_to<__nv_bfloat16>(acc[e] + wb)/' "torch.bfloat16,"
run_mutant wg_bias_dropped box_geometry.cuh 's/round_to<__nv_bfloat16>(acc\[e\]) + wb)/round_to<__nv_bfloat16>(acc[e]))/' "torch.bfloat16,"
run_mutant geo_argument_reordered box_geometry.cuh 's/sincos_call(100.f \* delta_c \* freq_f);/sincos_call(100.f * (delta_c * freq_f));/' "torch.bfloat16,"
run_mutant p_unrounded box_attention_bwd.cu 's/round_to<bf16>(div_by(sacc\[nt\]\[e\], sum\[e >> 1\], inv\[e >> 1\]))/div_by(sacc[nt][e], sum[e >> 1], inv[e >> 1])/' "torch.bfloat16,"
run_mutant keep_dropped_in_dP box_attention_bwd.cu 's/const float dpk = !kept ? 0.f/const float dpk = !real ? 0.f/' "torch.bfloat16,"
run_mutant fold_smem_short box_attention_bwd.cu 's/return bars + (parts > fold ? parts : fold);/return bars + parts;/' "torch.bfloat16,"
