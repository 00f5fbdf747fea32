#!/bin/bash
# Planted source faults in kernel K1 (box attention), to show what the kernel
# checks of chip_smoke.py catch. Each mutant is a copy of the port under
# build/mutants/<name>/ with one sed edit to a CUDA source; its kernel checks
# then run at paper shapes. A mutant that "passes" is one the checks cannot see.
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
build_all()
g = torch.Generator(device='cuda').manual_seed(0)
for dt in ($dtypes):
    print('[mutant] $name', dt, 'kernel checks pass:', c.check_kernels(g, dt, {}), flush=True)
" 2>&1 | grep -E "mutant|box_attention|FAIL|Error|error" )
}
run_mutant bias_dropped common.cuh 's/if (bias != nullptr) v += bias\[j\];/if (false) v += bias[j];/' "torch.float32, torch.bfloat16"
run_mutant logbias_unrounded box_attention.cu 's/= round_to<T>(logf(wg\[hh\]));/= logf(wg[hh]);/' "torch.bfloat16,"
run_mutant geo_unrounded box_geometry.cuh 's/sn = round_to<T>(sn);/;/; s/cs = round_to<T>(cs);/;/' "torch.bfloat16,"
run_mutant wg_bias_dropped box_geometry.cuh 's/round_to<T>(acc\[hh\]) + wb_s\[hh\]/round_to<T>(acc[hh])/' "torch.bfloat16,"
