#!/bin/bash
# Planted source faults in the kernels whose checks hold them bit by bit, to
# show what the kernel checks of chip_smoke.py catch: K1 (box attention) and
# K7 (its backward), K6 (residual + RefLayerNorm), K13 (vocabulary
# log-softmax), K14 / K15 (the decoder attention, forward and backward), K3
# (grouped cross-attention), K4 (beam log-softmax + top-K), K12 (additive
# attention), K5 (the supermask sets), K2 (ancestry self-attention), K11 (the
# LSTM cell), K16 (the magnitude threshold), the kv modes of K1, K7, K2, K3,
# K14 and K15 (ACORT's kv-shared layers), the head width 32 instances
# (ACORT-small), the head width 13 instances (ORT-xsmall), K10's radix
# mode, supermask SCST's kernels: K2's and K3's backward and K5's keyed
# mode, and the decode variants: K9's top-k, nucleus and Gumbel modes, K4's
# diverse-beam penalty and K1's raw 4-wide geometry, and K9's scheduled-sampling
# mode and K2's backward through the beam-ancestry map, K2's and K3's backward
# at head widths 32 and 13 and in the kv mode, the keyed draw of each slot
# of a shared layer, and K9's top-k candidates and nucleus cut (ties at the
# k-th, the ban among the candidates, the cut's comparison, the equal-p group
# taken by index, the noise of a kept group), and K9's held-path entry rule
# (its margin gone or unscaled, one u more skipped) and K4's held diverse
# rows (a penalised entry in a thread's best, the last token unmarked), and
# K2's forward (its walk of short rows: the softmax unrounded, the ancestor
# row ignored, the kv mode's values read through the row's own; its staged
# path: the ancestor row ignored, a beam reading its
# neighbour's row, a slot's last 16-byte part not copied, one of the four
# partial sums of a score dropped, a short row's last lane part of a score
# dropped, the last slot left out of p v, a long
# cache's earlier chunks dropped from p v, the softmax's sum over the first
# 32 slots alone, the kv mode's values read from its unfilled V stage or its
# stage read before the copies land, the dk 13 envelope's offset one element
# off) and K3's dk 13 repack shifted by one column (bf16 and f32), and the
# bf16 log-softmax's log-sum left unrounded (K13, K4, K9 share it) and K4's
# held threshold without its bf16 margin, and K2's ancestry-mode backward
# (the map ignored, a pair's readers each overwriting the last, slot t's own
# term dropped, the next readers dropped, a touched pair's last 16-byte copy
# missing, a long cache's dq chunks overwriting each other, the kv mode's V
# term dropped, dk 13 read from its envelope's start) and K3's backward (the
# kv mode's values read past K, a slice of dq's regions dropped, the dk 13
# repack shifted by one element). Each
# mutant is a copy of the
# port under build/mutants/<name>/ with sed edits to one CUDA source (or,
# with run_mutant_cmd, any shell edit run in its csrc/, the wrappers beside
# it included), reusing the unmutated
# libraries already built (a library's file name carries a hash of its
# source and of the headers it includes; an edited header rebuilds the
# libraries that include it); its kernel
# checks then run at paper shapes and at the small or off-width shapes: for
# K1/K7 check_kernels (K1 serving with its log-bias check) and
# check_train_kernels (K1's train variant and K7), for K6/K13
# check_norm_softmax_kernels without its timings, for K14/K15
# check_decoder_attention_kernels (with the check that K14's P~ equals K15's
# bit for bit) and for K3 and K4 check_kernels, for K12
# check_updown_kernels, for K5 check_supermask_kernels, for K2
# check_kernels, for K11 check_updown_kernels, for K16
# check_magnitude_kernels, for the kv modes check_acort_kernels (each kv mode
# against its plain version and bit-equal to the unshared kernel given the
# one tensor twice), for the dk 32 instances check_acort_small_kernels, for
# the dk 13 instances check_xsmall_kernels, for K10's radix mode check_radix_reward (bit-equal to the word mode on the
# plain regroup's words), for K2's and K3's backward
# check_decode_backward_kernels (K2's with a cache gradient the later steps
# left, and 17 steps with the cache threaded under autograd), for K9's modes
# check_sample_modes, for K4's diverse-beam penalty check_diverse_topk,
# for the raw geometry check_raw_geometry_kernels, for K9's ss mode
# check_ss_kernels (its bf16 rows built so that the draw hinges on the
# noise's rounding) and for K2's ancestry-mode backward
# check_k2_bwd_anc_kernels (three maps, one of every beam from beam 0), for
# K2's and K3's backward at head widths 32 and 13 and in their kv modes
# check_k2_bwd_width_kernels and check_k3_bwd_width_kernels, and for the keyed
# draws of a shared layer's slots (ops/rng.py mask_draws) check_slot_draws,
# all without their timings. A mutant whose checks
# pass is one they cannot see; each verdict line ends "caught" (a kernel that
# raises is caught too) or "checks pass", and the last line counts the
# mutants caught (every verdict line of the mutant "caught") of all run.
#
# In the bf16 tensor-core designs the trig features, K1's log-bias and K14's
# P~ reach the products only as bf16 values (MMA fragments, a bf16 array),
# so leaving them unrounded cannot be written; the mutants drop the rounding
# points that remain in f32 arithmetic. K14 and K15 share their scores and
# softmax (decoder_attention.cuh), so a mutant there moves both: the
# dropout quotient left unrounded shows only in K15's dP (K14 packs P~ to
# bf16 either way), and the score's rounding before its division by
# sqrt(dk) (exact at dk 64: by 8) is no rounding point there, so that mutant
# leaves the score and its quotient unrounded.
#
#     bash chip_mutants.sh          # on a machine with one H100, from the repo root
#     bash chip_mutants.sh 'k2_|k16_'   # only the mutants whose names match the regex
cd "$(dirname "$0")" || exit 1
python3 -c "from sparse_caption_tpu_torch.kernels import build_all; build_all()" || exit 1
mkdir -p build/mutants && VERDICTS=build/mutants/verdicts.txt && : > "$VERDICTS"
K17="c.check_kernels(g, dt, results) & c.check_train_kernels(g, dt, results)"
K613="c.check_norm_softmax_kernels(g, results, (dt,), timing=False)"
K15="c.check_decoder_attention_kernels(g, results, timing=False)"
K14="$K15"
K5="c.check_supermask_kernels(g, dt, results, timing=False)"
K3="c.check_kernels(g, dt, results, timing=False)"
K4="$K3"
K12="c.check_updown_kernels(g, dt, results, timing=False)"
K2="$K3"
K11="$K12"
K16="c.check_magnitude_kernels(g, results, timing=False)"
KV="c.check_acort_kernels(g, dt, results, timing=False)"
K32="c.check_acort_small_kernels(g, dt, results, timing=False)"
K10R="c.check_radix_reward(results, timing=False)"
K13W="c.check_xsmall_kernels(g, dt, results, timing=False)"
KBWD="c.check_decode_backward_kernels(g, results, timing=False)"
K9M="c.check_sample_modes(g, results, timing=False)"
K4D="c.check_diverse_topk(g, results, timing=False)"
KRAW="c.check_raw_geometry_kernels(g, dt, results, timing=False)"
K9SS="c.check_ss_kernels(g, results, timing=False)"
K2A="c.check_k2_bwd_anc_kernels(g, results, timing=False)"
KSW="c.check_k2_bwd_width_kernels(g, results, timing=False) & c.check_k3_bwd_width_kernels(g, results, timing=False)"
KSLOT="c.check_slot_draws(g, results, timing=False)"
ONLY=${1:-}
picked() { [[ -z "$ONLY" || $1 =~ $ONLY ]]; }
run_mutant() {  # name file sed-expression dtypes checks
  local name=$1 file=$2 expr=$3 dir=build/mutants/$1
  picked "$name" || return 0
  prepare "$name"
  sed -i "$expr" "$dir/sparse_caption_tpu_torch/kernels/csrc/$file"
  if cmp -s "sparse_caption_tpu_torch/kernels/csrc/$file" "$dir/sparse_caption_tpu_torch/kernels/csrc/$file"; then
    echo "[mutant] $name: sed changed nothing" | tee -a "$VERDICTS"; return
  fi
  echo "[mutant] $name: $(diff "sparse_caption_tpu_torch/kernels/csrc/$file" "$dir/sparse_caption_tpu_torch/kernels/csrc/$file" | grep '^>' | head -2 | tr '\n' ' ')" | tee -a "$VERDICTS"
  check_mutant "$name" "$4" "$5"
}
run_mutant_cmd() {  # name shell-command (run in the mutant's csrc/) dtypes checks
  local name=$1 dir=build/mutants/$1
  picked "$name" || return 0
  prepare "$name"
  (cd "$dir/sparse_caption_tpu_torch/kernels/csrc" && eval "$2") || { echo "[mutant] $name: the edit failed" | tee -a "$VERDICTS"; return; }
  if diff -rq -x __pycache__ sparse_caption_tpu_torch "$dir/sparse_caption_tpu_torch" > /dev/null; then
    echo "[mutant] $name: the edit changed nothing" | tee -a "$VERDICTS"; return
  fi
  echo "[mutant] $name: $(diff -r -x __pycache__ sparse_caption_tpu_torch "$dir/sparse_caption_tpu_torch" | grep '^>' | head -2 | tr '\n' ' ')" | tee -a "$VERDICTS"
  check_mutant "$name" "$3" "$4"
}
prepare() {  # a copy of the port and of the built libraries under build/mutants/<name>/
  local dir=build/mutants/$1
  rm -rf "$dir" && mkdir -p "$dir/build"
  cp -r sparse_caption_tpu_torch chip_smoke.py "$dir/"
  cp -r build/torch_kernels "$dir/build/"
}
check_mutant() {  # name dtypes checks
  local name=$1 dtypes=$2 checks=$3 dir=build/mutants/$1
  (cd "$dir" && python3 -c "
import torch, chip_smoke as c
from sparse_caption_tpu_torch.kernels import build_all
torch.backends.cuda.matmul.allow_tf32 = False
build_all()
for dt in ($dtypes):
    g, results = torch.Generator(device='cuda').manual_seed(0), {}
    try:
        verdict = 'checks pass' if $checks else 'caught'
    except RuntimeError as e:  # a kernel that fails to launch or faults fails chip_smoke.py too
        verdict = 'caught (raised: ' + str(e).splitlines()[0][:120] + ')'
    print('[mutant] $name', str(dt).split('.')[-1], verdict, flush=True)
" 2>&1 | grep -E "^\[mutant\]|FAIL|MISSED|Error|error" | awk '/^\[mutant\]/ || n++ < 40') | tee -a "$VERDICTS"
}
run_mutant bias_dropped box_attention.cu 's/if (row < R) s = round_to<bf16>(s + __bfloat162float(bias_h\[row \* R + j\]));/;/; s/s\[c\] += bias_h\[i \* R + j\];/;/' "torch.float32, torch.bfloat16" "$K17"
run_mutant logbias_unrounded box_attention_bwd.cu 's/round_to<bf16>(logf(__bfloat162float(wz\[row \* R + j\])))/logf(__bfloat162float(wz[row * R + j]))/' "torch.bfloat16," "$K17"
run_mutant wg_sum_unrounded box_geometry.cuh 's/round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(acc\[e\]) + wb)/round_to<__nv_bfloat16>(acc[e] + wb)/' "torch.bfloat16," "$K17"
run_mutant wg_bias_dropped box_geometry.cuh 's/round_to<__nv_bfloat16>(acc\[e\]) + wb)/round_to<__nv_bfloat16>(acc[e]))/' "torch.bfloat16," "$K17"
run_mutant geo_argument_reordered box_geometry.cuh 's/sincos_call(100.f \* delta_c \* freq_f);/sincos_call(100.f * (delta_c * freq_f));/' "torch.bfloat16," "$K17"
run_mutant p_unrounded box_attention_bwd.cu 's/round_to<bf16>(div_by(sacc\[nt\]\[e\], sum\[e >> 1\], inv\[e >> 1\]))/div_by(sacc[nt][e], sum[e >> 1], inv[e >> 1])/' "torch.bfloat16," "$K17"
run_mutant keep_dropped_in_dP box_attention_bwd.cu 's/const float dpk = !kept ? 0.f/const float dpk = !real ? 0.f/' "torch.bfloat16," "$K17"
run_mutant fold_smem_short box_attention_bwd.cu 's/return bars + (parts > fold ? parts : fold);/return bars + parts;/' "torch.bfloat16," "$K17"
run_mutant bessel_dropped add_ref_layernorm.cu 's/ \/ (d > 1 ? d - 1 : 1));/ \/ d);/' "torch.float32, torch.bfloat16" "$K613"
run_mutant keep_divisor_unrounded add_ref_layernorm.cu 's/round_to<T>(t \/ keep_prob)/(t \/ keep_prob)/; s/round_to<T>(yy \/ keep_prob)/(yy \/ keep_prob)/' "torch.bfloat16," "$K613"
run_mutant gs_dropped_from_dx add_ref_layernorm.cu 's/ds\[i\] = round_to<T>(ds\[i\] + g2\[i\]);/ds[i] = round_to<T>(ds[i]);/; s/ds = round_to<T>(ds + to_f(gs\[base + c\]));/ds = round_to<T>(ds);/' "torch.float32, torch.bfloat16" "$K613"
run_mutant db_last_block_dropped add_ref_layernorm.cu 's/p < nblocks; p += kNormWarps/p < nblocks - 1; p += kNormWarps/' "torch.float32, torch.bfloat16" "$K613"
run_mutant max_shift_dropped row_softmax.cuh 's/  m = block_max(mloc, red_max);/  m = 0.f * block_max(mloc, red_max);/' "torch.float32, torch.bfloat16" "$K613"
run_mutant dy_sum_last_chunk_dropped vocab_log_softmax.cu 's/for (int k = 0; k < PER; ++k) {  \/\/ sum(dy)/for (int k = 0; k < PER - 1; ++k) {  \/\/ sum(dy)/' "torch.float32, torch.bfloat16" "$K613"
run_mutant tail_last_element_skipped vocab_log_softmax.cu 's/i < V; i += kLsmThreads) {  \/\/ pass 1/i < V - 1; i += kLsmThreads) {  \/\/ pass 1/' "torch.bfloat16," "$K613"
run_mutant D_from_unrounded_products decoder_attention_bwd.cu 's/const float gp = round_to<bf16>(dpk \* p);/const float gp = dpk * p;/' "torch.bfloat16," "$K15"
run_mutant member_sum_unrounded decoder_attention_bwd.cu 's/tot\[nt\]\[e\] += round_to<bf16>(acc\[nt\]\[e\]);/tot[nt][e] += acc[nt][e];/' "torch.bfloat16," "$K15"
run_mutant keep_dropped_from_dV decoder_attention_bwd.cu 's/pk2\[c\] = dec_dropped(p, kept, keep != nullptr, keep_prob, inv_kp);/pk2[c] = p;/; s/pk\[c\] = kept ? (keep != nullptr ? p\[c\] \/ keep_prob : p\[c\]) : 0.f;/pk[c] = p[c];/' "torch.bfloat16," "$K15"
run_mutant causal_dropped_from_softmax decoder_attention.cuh 's/return ((vbits >> c) \& 1u) != 0 \&\& (!causal || j <= i);/return ((vbits >> c) \& 1u) != 0;/' "torch.bfloat16," "$K15"
run_mutant last_member_skipped decoder_attention_bwd.cu 's/for (int m = 0; m < group; ++m) {/for (int m = 0; m < group - 1; ++m) {/' "torch.bfloat16," "$K15"
run_mutant k3_last_row_skipped grouped_cross_attention.cu 's/    if (rows\[r\] < rep) {/    if (rows[r] < rep - 1) {/' "torch.bfloat16," "$K3"
run_mutant k3_mask_ignored grouped_cross_attention.cu 's/if (j < S \&\& mask_b\[j\] != 0) vbits/if (j < S) vbits/' "torch.bfloat16," "$K3"
run_mutant k4_unk_penalty_dropped beam_topk.cu 's/  if (i == unk_id) c += -1000.f;/  ;/' "torch.float32, torch.bfloat16" "$K4"
run_mutant k4_ban_eos_ignored beam_topk.cu 's/  if (no_eos \&\& i == eos_id) c += kNegBig;/  ;/' "torch.float32, torch.bfloat16" "$K4"
run_mutant k4_ties_to_higher_index beam_topk.cu 's/  return ((unsigned long long)order_key(v) << 32) | (0xFFFFFFFFu - (unsigned int)i);/  return ((unsigned long long)order_key(v) << 32) | (unsigned int)i;/; s/{ return (int)(0xFFFFFFFFu - (unsigned int)key); }/{ return (int)(unsigned int)key; }/' "torch.bfloat16," "$K4"
run_mutant k4_last_vector_skipped beam_topk.cu 's/  const int units = V \/ UE;/  const int units = V \/ UE - 1;/' "torch.float32, torch.bfloat16" "$K4"
run_mutant k4_logprob_reassociated beam_topk.cu 's/const float lp = lsm_logprob<T>(xv, m, lse);/const float lp = round_to<T>(xv - (m + lse));/' "torch.float32, torch.bfloat16" "$K4"
run_mutant lsm_lse_unrounded common.cuh 's/return round_to<R>(logf(round_to<R>(s)));/return logf(s);/' "torch.bfloat16," "$K613"
run_mutant k4_threshold_margin_dropped beam_topk.cu 's/(sizeof(T) == 2 ? (2.f \* fabsf(thr) + fabsf(lse)) \* 0x1p-7f/(sizeof(T) == 2 ? 0.f/' "torch.bfloat16," "$K4"
run_mutant k12_tanh_input_unrounded additive_attention.cu 's/const uint32_t tr = tanh_bits(xr \& 0xFFFFu, tab) | (tanh_bits(xr >> 16, tab) << 16);/const uint32_t tr = pack_bf16x2(tanhf(bf16_lo(pw[i]) + bf16_lo(hw[i])), tanhf(bf16_hi(pw[i]) + bf16_hi(hw[i])));/' "torch.bfloat16," "$K12"
run_mutant k12_mask_ignored_in_renorm additive_attention.cu 's/const float q0 = in0 \&\& mask_b\[lane\] ? p0 : 0.f;/const float q0 = in0 ? p0 : 0.f;/; s/const float q1 = in1 \&\& mask_b\[lane + 32\] ? p1 : 0.f;/const float q1 = in1 ? p1 : 0.f;/' "torch.float32, torch.bfloat16" "$K12"
run_mutant k12_last_region_skipped additive_attention.cu 's/for (int r = 0; r < R; ++r) {  \/\/ the weighted sum over regions/for (int r = 0; r < R - 1; ++r) {  \/\/ the weighted sum over regions/' "torch.float32, torch.bfloat16" "$K12"
run_mutant k12_tanh_table_left_out_of_smem_check additive_attention.cu 's/ + sizeof(unsigned short) \* kTanhEntries;/;/' "torch.bfloat16," "$K12"
run_mutant k14_score_unrounded decoder_attention.cuh 's/? round_to<bf16>(div_score(round_to<bf16>(sacc\[nt\]\[e\]), sqrt_dk))/? div_score(sacc[nt][e], sqrt_dk)/' "torch.bfloat16," "$K14"
run_mutant k14_padding_keys_filled decoder_attention.cuh 's/      float s = -INFINITY;/      float s = fill;/' "torch.bfloat16," "$K14"
run_mutant k14_dropout_quotient_unrounded decoder_attention.cuh 's/!dropout ? x : round_to<bf16>(div_by(x, keep_prob, inv_kp));/!dropout ? x : div_by(x, keep_prob, inv_kp);/' "torch.bfloat16," "$K14"
run_mutant k14_last_member_skipped decoder_attention.cu 's/    live\[r\] = sr < rows;/    live[r] = sr < rows - Tq;/' "torch.bfloat16," "$K14"
run_mutant_cmd k14_private_quad_sum 'cp decoder_attention.cuh decoder_attention_k14.cuh && sed -i "s/\"decoder_attention.cuh\"/\"decoder_attention_k14.cuh\"/" decoder_attention.cu && sed -i "s/sum\[r\], 1);/sum[r], 9);/; s/sum\[r\], 2);/sum[r], 1);/; s/sum\[r\], 9);/sum[r], 2);/" decoder_attention_k14.cuh' "torch.bfloat16," "$K14"
run_mutant k5_scalar_tail_skipped supermask.cu 's/const int cnt = (int)(ent.n - e0 < kUnit ? ent.n - e0 : kUnit);/const int cnt = 0;/' "torch.float32, torch.bfloat16" "$K5"
run_mutant k5_next_word_bit supermask.cu 's/byte = (bits\[bu >> 2\] >> (8 \* (bu \& 3))) \& 0xffu;/byte = (bits[(bu >> 2) + 1] >> (8 * (bu \& 3))) \& 0xffu;/' "torch.float32, torch.bfloat16" "$K5"
run_mutant k2_softmax_unrounded ancestry_self_attention.cu 's/sc\[s\] = round_to<T>(sc\[s\] \/ sum);/sc[s] = sc[s] \/ sum;/' "torch.bfloat16," "$K2"
run_mutant k2_walk_softmax_unrounded ancestry_self_attention.cu 's/  const float p = round_to<T>(e \/ warp_sum(e));/  const float p = e \/ warp_sum(e);/' "torch.bfloat16," "$K2"
run_mutant k2_walk_ancestor_row_ignored ancestry_self_attention.cu 's/  const int my_row = anc != nullptr \&\& lane <= t ? b \* K + anc\[(size_t)n \* t_max + lane\] : n;/  const int my_row = n;/' "torch.bfloat16," "$K2"
run_mutant k2_kv_values_through_own_row ancestry_self_attention.cu 's/    vv.load(vals + (size_t)r \* H/    vv.load(vals + (size_t)(cache_v != nullptr ? r : n) * H/' "torch.float32, torch.bfloat16" "$KV"
run_mutant k2_ancestor_row_ignored ancestry_self_attention.cu 's/rows\[s\] = anc != nullptr ? b \* K + anc\[(size_t)n \* t_max + s\] : n;/rows[s] = n;/' "torch.bfloat16," "$K2"
run_mutant k2_beam_reads_neighbour_row ancestry_self_attention.cu 's/b \* K + anc\[(size_t)n \* t_max + s\] : n;/b * K + (anc[(size_t)n * t_max + s] + 1) % K : n;/' "torch.bfloat16," "$K2"
run_mutant k2_last_slot_part_not_copied ancestry_self_attention.cu 's/    for (int e = lane; e < (c1 - c0) \* NC; e += 32) {/    for (int e = lane; e < (c1 - c0) * NC - 1; e += 32) {/' "torch.bfloat16," "$K2"
run_mutant k2_score_sums_one_dropped ancestry_self_attention.cu 's/    float dot = (acc\[0\] + acc\[1\]) + (acc\[2\] + acc\[3\]);/    float dot = (acc[0] + acc[1]) + acc[2];/' "torch.bfloat16," "$K2"
run_mutant k2_short_row_lane_part_dropped ancestry_self_attention.cu 's/    for (int o = 1; o < LS; o <<= 1) dot += /    for (int o = 1; o < LS \/ 2; o <<= 1) dot += /' "torch.bfloat16," "$K13W"
run_mutant k2_pv_last_slot_dropped ancestry_self_attention.cu 's/    for (int s = c0; s < c1; ++s) {/    for (int s = c0; s < c1 - 1; ++s) {/' "torch.bfloat16," "$K2"
run_mutant k2_long_chunks_sum_restarted ancestry_self_attention.cu 's/    if (!one) {/    if (!one) { a0 = a1 = 0.f;/' "torch.float32," "$K2"
run_mutant k2_softmax_first_32_slots_only ancestry_self_attention.cu 's/  for (int s = lane; s < T1; s += 32) {/  for (int s = lane; s < (T1 < 32 ? T1 : 32); s += 32) {/' "torch.float32," "$K2"
run_mutant k2_kv_values_from_an_unfilled_stage ancestry_self_attention.cu 's/  const unsigned char\* vsrc = one \&\& cache_v == nullptr ? kst : vst;/  const unsigned char* vsrc = vst;/' "torch.bfloat16," "$KV"
run_mutant k2_kv_stage_read_before_copy ancestry_self_attention.cu 's/^    cp_async_wait<0>();$/    \/\/ no wait/' "torch.bfloat16," "$KV"
run_mutant k2_dk32_lane_pairs ancestry_self_attention.cu 's/  constexpr int PL = kLaneDims<DK>; /  constexpr int PL = 2; /' "torch.float32, torch.bfloat16" "$K32"
run_mutant k2_dk13_envelope_offset_off_by_one ancestry_self_attention.cu 's/(kEnv ? envelope_offset(slot(cache_k, rows\[s\], s)) : 0);/(kEnv ? envelope_offset(slot(cache_k, rows[s], s)) + ES : 0);/' "torch.bfloat16," "$K13W"
run_mutant k11_sigmoid_bwd_unrounded lstm_cell.cu 's/return round_to<T>(round_to<T>(g \* round_to<T>(1.f - s)) \* s);/return round_to<T>(g * (1.f - s) * s);/' "torch.bfloat16," "$K11"
run_mutant_cmd k16_index_in_f64 'sed -i "0,/f32 = np.float32/s//f32 = np.float64/" ../magnitude_threshold.py' "torch.float32," "$K16"
run_mutant k16_fma_interpolation magnitude_threshold.cu 's/th\[p\] = __fadd_rn(__fmul_rn(v_lo, lwhw\[2 \* p\]), __fmul_rn(v_hi, lwhw\[2 \* p + 1\]));/th[p] = fmaf(v_hi, lwhw[2 * p + 1], v_lo * lwhw[2 * p]);/' "torch.float32," "$K16"
run_mutant k16_ge_in_place_of_gt magnitude_threshold.cu 's/mask\[i\] = criterion(w\[i\], stats, set.tensor0 + c.ti) > t ? 1.f : 0.f;/mask[i] = criterion(w[i], stats, set.tensor0 + c.ti) >= t ? 1.f : 0.f;/' "torch.float32," "$K16"
run_mutant k16_last_radix_pass_dropped magnitude_threshold.cu 's/for (int pass = 0; pass < sct::kPasses; ++pass) {/for (int pass = 0; pass < sct::kPasses - 1; ++pass) {/' "torch.float32," "$K16"
run_mutant k3_kv_half_rows_staged grouped_cross_attention.cu 's/    const int kv_rows = hn \* S;/    const int kv_rows = KV ? hn * S \/ 2 : hn * S;/' "torch.bfloat16," "$KV"
run_mutant k7_kv_dkv_summed_in_f32 box_attention_bwd.cu 's/kacc\[nt\]\[e\] = round_to<bf16>(round_to<bf16>(kacc\[nt\]\[e\]) + round_to<bf16>(vacc\[nt\]\[e\]));/kacc[nt][e] = kacc[nt][e] + vacc[nt][e];/' "torch.bfloat16," "$KV"
run_mutant k1_kv_v_from_q_tile box_attention.cu 's/(which < NT ? which : 1)/(which < NT ? which : 0)/' "torch.bfloat16," "$KV"
run_mutant k10_radix_tail_filled_with_0 cider_reward.cu 's/      if (k > 0) {  \/\/ the short tail/      if (false) {  \/\/ the short tail/' "torch.float32," "$K10R"
run_mutant k10_radix_bos_kept cider_reward.cu 's/if (d == 0 || d == bos_r) continue;/if (d == 0) continue;/' "torch.float32," "$K10R"
run_mutant k1_dk32_q_rows_strided_by_64 box_attention.cu 's/(q_s + i \* DP + d);  \/\/ broadcast/(q_s + i * 64 + d);  \/\/ broadcast/' "torch.float32," "$K32"
run_mutant dk13_pad_columns_unzeroed common.cuh 's/  return c < DK ? src\[c\] : from_f<T>(0.f);/  return src[c];/' "torch.float32, torch.bfloat16" "$K13W"
run_mutant k15_kv_dkv_summed_before_rounding decoder_attention_bwd.cu 's/tot\[nt\]\[e\] = round_to<bf16>(round_to<bf16>(tot\[nt\]\[e\]) + round_to<bf16>(tv\[nt\]\[e\]));/tot[nt][e] = tot[nt][e] + tv[nt][e];/' "torch.bfloat16," "$KV"
run_mutant k14_kv_v_through_second_pointer decoder_attention.cu 's/decoder_attention_entry(dtype, dk, q, kv, nullptr, key_valid,/decoder_attention_entry(dtype, dk, q, kv, q, key_valid,/' "torch.float32, torch.bfloat16" "$KV"
run_mutant k2_bwd_own_slot_dropped ancestry_self_attention_bwd.cu 's/    tk.store(dk_t + to, lane);/    ck.store(dk_t + to, lane);/; s/    tv.store(dv_t + to, lane);/    cv.store(dv_t + to, lane);/' "torch.float32," "$KBWD"
run_mutant k2_bwd_cache_grad_order ancestry_self_attention_bwd.cu 's/    tk.store(dk_t + to, lane);/    dkv.store(dk_t + to, lane);/; s/    tv.store(dv_t + to, lane);/    dvv.store(dv_t + to, lane);/' "torch.float32," "$KBWD"
run_mutant k3_bwd_first_row_only grouped_cross_attention_bwd.cu 's/    for (int r = 0; r < rep; ++r) {/    for (int r = 0; r < 1; ++r) {/' "torch.float32," "$KBWD"
run_mutant k5_keyed_ignores_t supermask.cu 's/Philox4{d.site, d.t, (uint32_t)e4, 0u}/Philox4{d.site, 0u, (uint32_t)e4, 0u}/' "torch.float32," "$K5"
run_mutant k9_topk_ties_dropped sample_step.cu 's/s >= kth/s > kth/g' "torch.float32," "$K9M"
run_mutant k9_nucleus_cutoff_le sample_step.cu 's/    if (m >= top) {/    if (m > top) {/; s/  if (total < top) return/  if (total <= top) return/; s/(top - base + pf - 1ull) \/ pf - 1ull;/(top - base) \/ pf;/' "torch.float32," "$K9M"
run_mutant k9_nucleus_equal_p_reverse_index sample_step.cu 's/  int need = (int)jstar;/  int need = (int)(cnt - 1u - jstar);/; s/(key != c.keq || i <= c.icut)/(key != c.keq || i >= c.icut)/' "torch.float32," "$K9M"
run_mutant k9_kept_group_skips_noise sample_step.cu 's/      if (any) r = philox4x32_10(/      if (false) r = philox4x32_10(/' "torch.float32," "$K9M"
run_mutant k9_topk_ban_among_candidates sample_step.cu 's/    if (xi > thr \&\& i != ban) cand_insert(xi, k, tv, thr);/    if (xi > thr) cand_insert(xi, k, tv, thr);/; s/if (v\[q\] > thr \&\& u \* UE + q != ban) cand_insert/if (v[q] > thr) cand_insert/' "torch.float32," "$K9M"
run_mutant k9_gumbel_tempered sample_step.cu 's/  const bool tempered = kMode == kRandom \&\& !greedy \&\& temperature != 1.f;/  const bool tempered = !greedy \&\& temperature != 1.f;/; s/          z = logprob(i) + gumbel_eps(philox_word(r, q));/          z = logprob(i) \/ temperature + gumbel_eps(philox_word(r, q));/' "torch.float32," "$K9M"
run_mutant k9_entry_bound_no_delta sample_step.cu 's/          __expf(amax - z_ref + (0x1p-17f + 0x1p-21f \* (fabsf(z_ref) + fabsf(amax)))) \* (1.f + 0x1p-14f);/          __expf(amax - z_ref) * (1.f + 0x1p-14f);/' "torch.float32," "$K9M"
run_mutant k9_entry_bound_no_scale sample_step.cu 's/          __expf(amax - z_ref + (0x1p-17f + 0x1p-21f \* (fabsf(z_ref) + fabsf(amax)))) \* (1.f + 0x1p-14f);/          __expf(amax - z_ref + 0x1p-17f) * (1.f + 0x1p-14f);/' "torch.float32," "$K9M"
run_mutant k9_entry_kmax_off_by_one sample_step.cu 's/ : 8388606 - (int)kf;/ : 8388607 - (int)kf;/' "torch.float32," "$K9M"
run_mutant k4_diversity_once_per_occurrence beam_topk.cu 's/  return count > 0 ? c - (float)count \* lambda : c;/  for (int j = 0; j < P; ++j) c = div_s[j] == i ? c - lambda : c; return c;/' "torch.float32," "$K4D"
run_mutant k4_diverse_penalised_in_threshold beam_topk.cu 's/          if (!((bits >> e) \& 1u)) xfree = fmaxf(xfree, v\[e\]);/          xfree = fmaxf(xfree, v[e]);/' "torch.float32," "$K4D"
run_mutant k4_diverse_bitmap_misses_last beam_topk.cu 's/    for (int j = tid; j < div_p; j += nt) mark(div_s\[j\]);/    for (int j = tid; j < div_p - 1; j += nt) mark(div_s[j]);/' "torch.float32," "$K4D"
run_mutant k1_raw_geometry_unrounded box_geometry.cuh 's/  for (int c = 0; c < kRawG; ++c) pos\[c\] = round_to<T>(pair_delta(bi, bj, c));/  for (int c = 0; c < kRawG; ++c) pos[c] = pair_delta(bi, bj, c);/' "torch.bfloat16," "$KRAW"
run_mutant k9_ss_coin_inverted sample_step.cu 's/  if (!(static_cast<float>(coin_bits >> 8) \* 0x1p-24f < ss_prob)) {/  if (static_cast<float>(coin_bits >> 8) * 0x1p-24f < ss_prob) {/' "torch.float32," "$K9SS"
run_mutant k9_ss_noise_in_f32_under_bf16 sample_step.cu 's/  return -round_to<__nv_bfloat16>(logf(-round_to<__nv_bfloat16>(logf(u))));/  return -logf(-logf(u));/' "torch.float32," "$K9SS"
run_mutant k2_bwd_anc_identity_map ancestry_self_attention_bwd_anc.cu 's/__ldg(mp + (size_t)r \* t_max + s)/r/g; s/__ldg(mp + (size_t)o \* t_max + s)/o/g; s/__ldg(mp + (size_t)x \* t_max + s)/x/g' "torch.float32," "$K2A"
run_mutant k2_bwd_anc_last_writer_wins ancestry_self_attention_bwd_anc.cu 's/        gk.fma(ds_s\[r \* T1 + s\], q_s + r \* DK + W \* g);/        gk.zero(); gk.fma(ds_s[r * T1 + s], q_s + r * DK + W * g);/; s/        gv.fma(p_s\[r \* T1 + s\], g_s + r \* DK + W \* g);/        gv.zero(); gv.fma(p_s[r * T1 + s], g_s + r * DK + W * g);/' "torch.float32," "$K2A"
run_mutant k2_bwd_anc_own_slot_dropped ancestry_self_attention_bwd_anc.cu 's/        ck.plus(gk).store(dk_t + to);/        ck.store(dk_t + to);/; s/        cv.plus(gv).store(dv_t + to);/        cv.store(dv_t + to);/' "torch.float32," "$K2A"
run_mutant k2_bwd_anc_next_reader_dropped ancestry_self_attention_bwd_anc.cu 's/    next_s\[i\] = (short)nx;/    next_s[i] = (short)-1;/' "torch.float32," "$K2A"
run_mutant k2_bwd_anc_stage_misses_last_copy ancestry_self_attention_bwd_anc.cu 's/      for (int v = 0; v < NV; ++v) copy_vector(j, s, 0, v);/      for (int v = 0; v < NV - 1; ++v) copy_vector(j, s, 0, v);/' "torch.float32," "$K2A"
run_mutant k2_bwd_anc_dq_chunk_overwrites ancestry_self_attention_bwd_anc.cu 's/        acc = before.plus(acc);/        before.zero(); acc = before.plus(acc);/' "torch.float32," "$K2A"
run_mutant k2_bwd_anc_kv_v_term_dropped ancestry_self_attention_bwd_anc.cu 's/        ck.plus(gk.plus(gv)).store(/        ck.plus(gk).store(/' "torch.float32," "$KSW"
run_mutant k2_bwd_anc_dk13_envelope_offset_ignored ancestry_self_attention_bwd_anc.cu 's/    const int off = DK % 4 == 0 ? 0 : (int)((reinterpret_cast<uintptr_t>(g) \& 15) >> 2);/    const int off = 0;/' "torch.float32," "$KSW"
run_mutant k2_bwd_kv_v_term_dropped ancestry_self_attention_bwd.cu 's/    const L tot = ck.plus(dkv.plus(dvv));/    const L tot = ck.plus(dkv);/' "torch.float32," "$KSW"
run_mutant k2_bwd_kv_score_term_dropped ancestry_self_attention_bwd.cu 's/    const L tot = ck.plus(dkv.plus(dvv));/    const L tot = ck.plus(dvv);/' "torch.float32," "$KSW"
run_mutant k2_bwd_dk13_reads_pad_lanes common.cuh 's/  __device__ __forceinline__ void load(const T\* p, int lane) { v = lane < DK ? to_f(\*p) : 0.f; }/  __device__ __forceinline__ void load(const T* p, int lane) { v = lane < kPad<DK> ? to_f(*p) : 0.f; }/' "torch.float32," "$KSW"
run_mutant k3_bwd_kv_values_read_past_k grouped_cross_attention_bwd.cu 's/  float\* v_s = kv ? k_s : k_s + S \* PK; /  float* v_s = k_s + S * PK; /' "torch.float32," "$KSW"
run_mutant k3_bwd_dq_slice_dropped grouped_cross_attention_bwd.cu 's/    for (int o = G; o < 32; o <<= 1) {/    for (int o = G; o < 16; o <<= 1) {/' "torch.float32," "$KSW"
run_mutant k3_bwd_dk13_repack_shifted grouped_cross_attention_bwd.cu 's/      k_s\[j \* PK + d\] = d < DK ? raw\[ok + j \* DK + d\] : 0.f;/      k_s[j * PK + d] = d < DK ? raw[ok + j * DK + d + 1] : 0.f;/' "torch.float32," "$KSW"
run_mutant_cmd k5_keyed_shared_slot_reuses_slot0 'sed -i "s/        draws.append(slot_rng(rng, k).mask_draw(m, m.weight.shape, m.weight.device))/        draws.append(slot_rng(rng, 0).mask_draw(m, m.weight.shape, m.weight.device))/" ../../ops/rng.py' "torch.float32," "$KSLOT"
run_mutant k3_dk13_repack_shifted grouped_cross_attention.cu 's/        const unsigned short\* bits = reinterpret_cast<const unsigned short\*>(row);/        const unsigned short* bits = reinterpret_cast<const unsigned short*>(row + 1);/' "torch.bfloat16," "$K13W"
run_mutant k3_dk13_f32_repack_shifted grouped_cross_attention.cu 's/      stage_padded<DK>(a == 0 ? k_s : v_s, a == 0 ? KS : VS, row, S, threadIdx.x, blockDim.x);/      stage_padded<DK>(a == 0 ? k_s : v_s, a == 0 ? KS : VS, row + 1, S, threadIdx.x, blockDim.x);/' "torch.float32," "$K13W"
# a mutant is caught when it printed a verdict line and every one says so
awk '/^\[mutant\] [^ ]+: / { name = $2; sub(":", "", name); seen[name] = 1 }
     /^\[mutant\] [^ :]+ [a-z0-9]+ / { seen[$2] = 1; n[$2]++; if ($0 ~ / caught/) c[$2]++ }
     /^\[mutant\] [^ ]+: (sed changed nothing|the edit)/ { name = $2; sub(":", "", name); n[name]++ }
     END { t = 0; k = 0; for (m in seen) { t++; if (n[m] > 0 && c[m] == n[m]) k++ }
           print "[mutants] " k " of " t " caught" }' "$VERDICTS"
