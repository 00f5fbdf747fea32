#!/bin/bash
# Timed variants of K9's random, greedy and Gumbel modes, to show where their
# time goes (NVIDIA H100; no ncu on that machine). Each variant is a copy of
# the port under build/variants/<name>/ with sed edits to
# csrc/sample_step.cu that leave out or replace one part (its outputs are
# then wrong: only its time counts); all are built in parallel, then timed
# by kernel_ab_times.py (K9 at 10,240 x 10,000 bf16 and 960 x 10,000 f32,
# logits at scale 3), the unedited tree first and last. The stream_*
# variants turn the held path off: stream_scalar is the design before the
# held path (two passes an entry at a time), stream_scalar_pass1 its first
# pass alone, stream_scalar_no_noise both passes without Philox and logs;
# held_no_logs is the held path with the Philox calls and its entry rule
# but no logf (an entry that passes adds no g), held_no_entry_rule without
# the rule that spares an entry its logs.
#
#     bash k9_variants.sh [regex]   # from the repo root; regex: the K9 modes to time (default random|greedy|gumbel)
cd "$(dirname "$0")" || exit 1
MODES=${1:-random|greedy|gumbel}
SRC=sparse_caption_tpu_torch/kernels/csrc/sample_step.cu
HELD_OFF='s/    const int held = aligned_to(logits, 16) ? held_row_threads<T>(V, kTopkHeldMaxThreads) : 0;/    const int held = 0;/'
declare -A EDITS=(
  [stream_scalar]="$HELD_OFF"
  [stream_scalar_pass1]="$HELD_OFF; s/^    for (int c4 = threadIdx.x; c4 < groups; c4 += blockDim.x) {$/    for (int c4 = groups; c4 < groups; c4 += blockDim.x) {/"
  [stream_scalar_no_noise]="$HELD_OFF; s/          z = logprob(i) + gumbel_eps(philox_word(r, q));/          z = logprob(i);/; s/          z = logprob(i) \/ temperature + gumbel(philox_word(r, q));/          z = logprob(i) \/ temperature;/"
  [held_no_logs]='s/        offer(value(logprob(i0 + q, v\[4 \* h + q\])) + held_noise<kMode>(bits), i0 + q);/        offer(value(logprob(i0 + q, v[4 * h + q])), i0 + q);/'
  [held_no_entry_rule]='s/        if ((int)(bits >> 9) <= kmax) continue;  \/\/ 1 - u > lim/        ;/'
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
