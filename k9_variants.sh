#!/bin/bash
# Timed variants of K9's top-k and nucleus modes, to show where their time
# goes (NVIDIA H100; no ncu on that machine). Each variant is a copy of the
# port under build/variants/<name>/ with sed edits to csrc/sample_step.cu
# that leave out or replace one part (its outputs are then wrong: only its
# time counts); all are built in parallel, then timed by kernel_ab_times.py
# (K9 at 10,240 x 10,000 bf16 and 960 x 10,000 f32), the unedited tree
# first and last.
#
#     bash k9_variants.sh [regex]   # from the repo root; regex: the K9 modes to time (default top3|top0.9)
cd "$(dirname "$0")" || exit 1
MODES=${1:-top3|top0.9}
SRC=sparse_caption_tpu_torch/kernels/csrc/sample_step.cu
declare -A EDITS=(
  # the nucleus's cut left out: nothing kept (pass 1, pass 2, the keys and a last pass without noise)
  [nucleus_no_cut]='s/  const unsigned long long top = __float2ull_ru(top_p \* 0x1p62f);/  return NucleusCut{kNoKey, kNoKey, INT_MAX, 1.f};\n  const unsigned long long top = __float2ull_ru(top_p * 0x1p62f);/'
  # no list of the taken keys: the bisection reads the whole row's keys
  [nucleus_no_gather]='s/  const bool gathered = taken_s <= (unsigned int)kCompact;/  const bool gathered = false;/'
  # no prefilter: every entry taken (and the row's keys read, the list overflowing)
  [nucleus_no_prefilter]='s/      e_lo = __uint_as_float(/      e_lo = 0.f * __uint_as_float(/'
  # the row read an entry at a time (top-k and nucleus)
  [scalar_row]='s/  const bool vec = filtered \&\& KC > 0 \&\& KC <= kTopkFew \&\& row_vectors(logits, V);/  const bool vec = false;/'
)
mkdir -p build/variants
for name in "${!EDITS[@]}"; do
  dir=build/variants/$name
  rm -rf "$dir" && mkdir -p "$dir"
  cp -r sparse_caption_tpu_torch chip_smoke.py "$dir/"
  sed -i "${EDITS[$name]}" "$dir/$SRC"
  if cmp -s "$SRC" "$dir/$SRC"; then echo "[variant] $name: sed changed nothing"; exit 1; fi
  (cd "$dir" && python3 ../../../kernel_ab_times.py build "$name" k9 > build.log 2>&1 || echo "[variant] $name: build failed") &
done
python3 kernel_ab_times.py build change k9 > /dev/null 2>&1
wait
python3 kernel_ab_times.py time change k9 "$MODES" | tail -1
for name in "${!EDITS[@]}"; do
  (cd "build/variants/$name" && python3 ../../../kernel_ab_times.py time "$name" k9 "$MODES" | tail -1)
done
python3 kernel_ab_times.py time change k9 "$MODES" | tail -1
