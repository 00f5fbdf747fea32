#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparse_caption_tpu_torch``) on one GPU.

Phases:
1. set-up: card name and power limit, versions, build of the sixteen kernel
   libraries (``kernels/csrc/*.cu``, nvcc for sm_90a, one process per source);
2. kernel checks: each kernel against its plain PyTorch version at the
   shapes of its path (beam-5 serving: B = 2048 images, 36 regions, 8 heads
   of 64, vocab 10000, 17 steps; XE step: the 105 masked tensors as one K5
   set, 256 x 5 captions; Up-Down's K5 sets (the encode's 3 tensors, an
   unrolled step's 8) and K11-K13: 1024 x 5 beams, 1000 units, 512 attention
   units, 36 regions, and 256 x 5 x 17 rows of 10000 logits; the decoder's
   full-sequence attention K14/K15: 256 x 5 captions and the SCST replay's
   64 x 15 samples, causal self-attention over 17 tokens and cross-attention
   over 36 regions read once per image), in f32 and bf16, forward and
   backward, each with a planted fault, and the times of kernel, plain
   version and one PyTorch library call, every one of them the median of 5
   windows of device time taken in turns (``turns_ms``: the host's enqueue
   held off the window); K1 and K7 also with an image that has no valid
   region, bf16 K1/K7 outputs and K1's log-bias held bit by bit against the
   plain versions (``rounding_share``); K14's bf16 output and K15's dq, dk,
   dv (self and cross calls, with and without the keep-mask) and K3's bf16
   output too, K15 and K3 also at off shapes (K15: Tk 9 and 64, a group of
   3 x 20 rows; K3: 15 and 40 rows an image, 33 regions), and their
   shared-memory sizes against the wrappers' limits; the P~ K14 used
   against the P~ K15 recomputes, bit for bit (K14's output with V = the
   identity against K15's dV with dO = the identity), on every bf16 case;
   K5 on a set of off shapes (unaligned storage, a tail) in every mode,
   w_eff and dw exactly; K4 also at beams 10,
   15 and 40, bit by bit in bf16, with rows tied at the top and rows whose
   log-sum lies next to a bf16 midpoint (``k4_midpoint_counts``), and at V =
   9,999; K12 bit by bit in bf16 at the serving, SCST and off shapes (one
   at the edge of its held forward's shared memory); K6 and K13 also bit by bit in bf16 (K6's s exactly, its n,
   dx, dy and K13's y by ``rounding_share``), K6's da / db repeated bit for
   bit, both at off widths (K6 d = 37 and 500, K13 V = 37 and 9,999) and
   K13 also bf16 -> f32, on inputs of their own generator; K6 timed forward + backward at the XE
   shape and forward alone at the serving decode step (10,240 x 512), K13
   in f32, bf16 and bf16 -> f32, beside byte bounds (``k6_bytes``,
   ``k13_bytes``; K3's, K14's and K15's from ``k3_bytes``, ``k14_bytes``,
   ``k15_bytes`` and ``decoder_attention_flops``, K5's from ``k5_bytes``);
   K2's bf16 output and K11's bf16 h', c' and backward (d gates, d c) bit
   by bit (``rounding_share``); K16 (the magnitude threshold) on the ORT's
   105 masked tensors as 105 pools and as one pool of 55,331,840 weights
   (|w| and dist) at the gradual schedule's sparsities and on off shapes:
   thresholds and masks bit for bit, each pool's pruned count against an f32
   index reference written in torch (``f32_quantile_index``), and K16, its
   plain version, ``torch.kthvalue`` and the compare alone timed in turns;
   the kv modes of K1 (eval and train variant), K7, K2 and K3 at ACORT-base's
   shapes (``check_acort_kernels``: one tensor is K and V; element-wise and
   in bf16 by ``rounding_share`` against the plain versions on that tensor,
   bit-equal to the unshared kernels given it twice, K2 also past its
   staged slots, K3's shared memory against the wrapper's), K4 and K13 at
   the radix vocabulary's V = 771, K14 / K15 at ACORT's 26 positions with
   the one tensor as k and v; each kv mode timed beside the unshared kernel
   on the tensor passed twice, the plain version and one library call;
3. serving path: a paper-width ``relation_transformer_prune`` (random
   weights and supermask logits from a seed, masks folded), ``encode`` +
   beam-5 ``generate`` in bf16 at batch 50 and 2048 with the kernels' launch
   counts asserted, a profile of one encode + decode, and the same weights in
   f32 at batch 8 on the card against the CPU's plain versions (identical
   tokens but for near-ties, ``tie_aware_match``; log-probs within 1e-4);
4. train path: the supermask XE step (masks kept as parameters, init 5.0,
   dropout on) at 15 x 5 captions in f32 and bf16 and at 256 x 5 in bf16,
   1 warm-up + 10 steps each with the launch counts asserted, a profile of
   one step at 256 x 5, and one f32 step at 2 x 5 without dropout on the
   card against the CPU's plain versions (loss, gradients, params, masks);
   then the prune path (``run_prune_phase``): gradual magnitude pruning
   (mag_grad_uniform to 0.8, bf16 at 15 x 5, the schedule shortened so that
   4 updates fire in 9 steps) through ``engine/prune_training.py
   gradual_prune`` and K16, the launch counts asserted, each update held
   against the plain version (per tensor, and one blind and one dist pool of
   every weight), every pruned weight's gradient 0 in the next step; a host
   one-shot mag_blind prune and a SNIP saliency over 2 batches timed on the
   host clock; the lottery rewind to a ``torch.save``'d init snapshot;
5. SCST path: the kernel checks of K8 (keyed dropout, at the replay shape
   75 x 17 x 2048), K9 (sampling step, 960 x 10000) and K10 (CIDEr-D + BLEU
   reward, 960 captions against 5 refs), each with a planted fault; the
   paper's sparse SCST step (mask_freeze ORT, frozen 0/1 masks at 0.9875
   sparsity, dropout 0.1, f32, step LR 5e-5, 15 random samples per image,
   leave-one-out baseline, CIDEr-D + BLEU-4 reward) at 5 x 15 and 64 x 15,
   1 warm-up + 5 steps each with the launch counts asserted, a profile of
   one step at 64 x 15; the replay's log-probs against the sampling
   decode's at 5 x 15; and one step at 2 x 3 with dropout on, on the card
   and on the CPU from the same seed, the card's tokens feeding both
   replays (rewards, loss, gradients, differing sampled tokens);
6. Up-Down path: a paper-width ``up_down_lstm_prune`` (rnn 1000, att_hid
   512, 2048-wide fc and region features): beam-5 serving in bf16 at batch
   50 and 1024 (masks folded) with the launch counts asserted and a profile
   at 1024, K4 timed on the logits that run hands it (``path_topk_times``),
   the f32 batch-8 card-vs-CPU check; the supermask XE step (the
   paper's Up-Down family: cosine LR 0.01, Adam eps 0.01, dropout 0.1,
   target 0.991, weight 120; fresh mask samples on every call, 3 + 8 per
   step) at 15 x 5 in f32 and bf16 and 256 x 5 in bf16 with the launch
   counts asserted and a profile at 256 x 5, and the card-vs-CPU f32 step at
   2 x 5 without dropout; greedy decode card vs CPU (f32, batch 8); the
   paper's sparse SCST step for Up-Down (mask_freeze at 0.991, dropout 0.1,
   f32, 60 random samples per image, leave-one-out baseline, CIDEr-D +
   BLEU-4) at 5 x 60 and 16 x 60 with the launch counts asserted and a
   profile at 16 x 60, its replay check at 5 x 60, and its card-vs-CPU step
   at 2 x 3 with dropout on;
7. ACORT path (``run_acort_phase``): ACORT-base built by ``from_config``
   from the recipe's flags (``resources/commands_acort.sh``: kv sharing and
   6 slots over 2 layers on both sides) and a radix tokenizer over a
   synthetic 10,000-word vocabulary (vocab 771, 26 tokens), random weights:
   beam-5 serving in bf16 at batch 50 and 2048 with the launch counts
   asserted (the kv modes of K1, K2 and K3, K4 at V = 771), a profile at
   2048, two captions decoded to words, the f32 batch-8 card-vs-CPU check;
   the dense XE step (noam, dropout on) in bf16 at 15 x 5 and 256 x 5 with
   the launch counts asserted (the kv modes of K1's train variant and K7,
   K13 at V = 771, the kv modes of K14 / K15) and a profile
   at 256 x 5, the card-vs-CPU f32 step at 2 x 5; then a 2-layer qk-shared
   ORT's card-vs-CPU decode and step (the unshared kernels, q's projection
   as k);
8. ACORT-small (``run_acort_small_phase``, heads of 32): serving, XE and the
   recipe's SCST stage (K10's radix mode), with their card-vs-CPU checks;
9. ORT-xsmall (``run_ort_xsmall_phase``; ``commands_acort.sh:57-70``: d104 /
   ff416, 8 heads of 13, word tokens, dense): beam-5 serving in bf16 at
   batch 50 and 2048 and the dense XE step (noam, dropout 0.1 / 0.5, clip
   0.1) in bf16 at 15 x 5 and 256 x 5, the launch counts asserted (the dk
   13 instances of K1, K1 train, K7, K2, K3, K14 and K15), a profile at
   2048, the f32 batch-8 card-vs-CPU decode and the card-vs-CPU f32 step
   at 2 x 5; then the same two card-vs-CPU checks, untimed, for ORT-small
   (d256, dk 32 unshared) and ACORT-base-AL (kv, one layer in all six
   slots a side). Its kernel checks (``check_xsmall_kernels``: the dk 13
   instances, unshared at ORT-xsmall's shapes and kv at ACORT's) run with
   the others, and the K14 / K15 kv modes (``check_decoder_kv``: bit-equal
   to the unshared kernels given the tensor twice) at dk 64, 32 and 13;
10. supermask SCST (``run_supermask_scst_phase``): the ORT and Up-Down with
   a training supermask, each decode step drawing fresh keyed masks, and
   their card-vs-CPU steps (the CPU taking the card's samples, every keyed
   set's flips counted);
11. decode variants (``run_decode_variants_phase``; their kernel checks,
   ``check_decode_variant_kernels``, run with the others: K9's top-k,
   nucleus and Gumbel modes, K4's diverse-beam penalty, K1 / K7 on the raw
   4-wide geometry at every instance): sampling serve (5 samples an image by
   top3, top0.9 at T 0.7 and gumbel) and diverse beam (6 in 3 groups) on
   the paper ORT in bf16 at batch 50 and 2048 with the launch counts
   asserted, profiles at 2048, their card-vs-CPU checks at f32 batch 8; the
   raw-geometry ORT (``no_box_trigonometric_embedding``): beam-5 serving,
   the XE step (15 x 5 f32 and bf16, 256 x 5 bf16) and its card-vs-CPU
   decode and step.
12. scheduled sampling and beam-sample SCST (``run_ss_beam_phase``; their
   kernel checks, ``check_ss_beam_kernels``, run with the others: K9's ss
   mode bit for bit, K2's backward through three ancestry maps): the Up-Down
   XE cell at ss_prob 0.25 and 2 logit layers (15 x 5 f32 and bf16, 256 x 5
   bf16) and its card-vs-CPU step (the CPU taking the card's scheduled
   samples); beam-sample SCST of the mask_freeze ORT (beam 15; 64 x 15) and
   Up-Down (beam 60; 16 x 60), the launch counts asserted,
   the gradient pass's forced search against the sampling search, and the
   card-vs-CPU steps on the card's search decisions.
13. supermask and beam-sample SCST at ACORT's and ORT-xsmall's widths
   (``run_shared_width_scst_phase``; its kernel checks,
   ``check_shared_width_kernels``, run with the others: K2's backward in
   the kv mode and at head widths 32 and 13 in both its modes, K3's
   backward likewise, each against its plain version, and the keyed draws
   of a shared layer's slots bit for bit): ACORT-small's SCST stage with
   beam search of width 15 and under a training supermask (5 x 15, 64 x 15),
   ORT-xsmall's supermask and beam-sample SCST (64 x 15), the launch counts
   asserted, profiles, the replays and the card-vs-CPU steps; ACORT-base's
   supermask XE step (bf16, 15 x 5 and 256 x 5; its card-vs-CPU f32 step)
   and its supermask SCST step card against CPU, the card's launches
   counted.

The ORT XE and SCST steps run the decoder's full-sequence attention through
K14/K15 (12 + 12 launches per step, asserted), and the plain
``scaled_dot_attention`` must not run in any train or SCST step. Masked
products with gradients run as K5 sets: one forward and one backward launch
per ORT step (the XE forward, the SCST replay), 1 + 17 per Up-Down step.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that one JSON line with every
kernel's numbers. Exits non-zero, without the ok line, when CUDA is absent or
any phase fails.

    python3 chip_smoke.py
    python3 chip_smoke.py --whole-step-seeds 3   # only the card-vs-CPU XE step, data seeds 0..2
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

PAPER = dict(vocab_size=10000, d_model=512, dim_feedforward=2048, num_layers=6, num_heads=8, att_feat_size=2048,
             max_seq_length=17)
REGIONS, BEAM, MAX_LEN, HEADS, DK = 36, 5, 17, 8, 64
BIG_BATCH, EVAL_BATCH, CHECK_BATCH = 2048, 50, 8
SEED = 0  # weights, inputs and supermask logits all come from it
# kernel vs plain version, element by element. f32: |a - b| <= 1e-5 + 1e-5 |b|
# (the two differ by summation order only). bf16: |a - b| <= u (2 |b| + 8 s),
# u = 2^-8 the unit roundoff of bf16 and s the scale of the values attended
# over (rms of V; 0 for beam top-K): 2 u |b| is one bf16 ulp of |b| for the
# two outputs' own final roundings; 8 u s covers the plain version rounding
# scores (|score| up to ~6) and probabilities to bf16 where the kernel keeps
# f32, which moves each probability by a few u and the output by that times
# a value row. Each check prints its worst err/allowed, and a planted fault
# (one part of the function left out) must fail the same bound.
F32_TOL = 1e-5
BF16_U = 2.0 ** -8
BF16_SCALE_UNITS = 8
WHOLE_PATH_LP_TOL = 1e-4
# K1/K7 in bf16 against their plain versions, bit by bit (rounding_share):
# the share of elements allowed to differ by one ulp, and by more
BIAS_SHARE_LIMIT = 0.01
K1_SHARE_LIMIT, K1_FAR_LIMIT = 0.02, 0.001
K7_SHARE_LIMIT, K7_FAR_LIMIT = 0.05, 0.005
# K14's output and K15's dq, dk, dv in bf16 against the plain version, bit by
# bit as K1 / K7
K14_SHARE_LIMIT, K14_FAR_LIMIT = 0.02, 0.001
K15_SHARE_LIMIT, K15_FAR_LIMIT = 0.05, 0.005
# K3's and K2's bf16 outputs against the plain version, bit by bit as K1's
K3_SHARE_LIMIT, K3_FAR_LIMIT = 0.02, 0.001
K2_SHARE_LIMIT, K2_FAR_LIMIT = 0.02, 0.001
# K2 beyond 32 cache slots: the character tokenizer's 60 (two slots a lane), then 8 a lane (past a block's
# stage at dk 64: slots walked in chunks), and at head widths 32 and 13 also MAX_SLOTS (chunks at dk 13)
K2_LONG_CACHES, K2_LONG_IMAGES = (60, 250), 64
# K2's forward is held on two maps: a uniform random one, and one collapsed as a real beam search leaves it
K2_MAPS = ("uniform", "collapsed")
K2_ODD_SPANS = (17, 26, 60)  # dk 13 caches whose (row, head) spans start at odd offsets: T_max x 26 bytes apart
K2_WALK_STEP = 3  # a step where K2 walks the slots at every width (its staged path starts at 5 slots or more)
# K11's bf16 h', c' and its backward's d gates, d c against the plain
# version's autograd, bit by bit: the same rounding points and the same
# transcendental functions, so only a rare 1-ulp difference of expf / tanhf
K11_SHARE_LIMIT, K11_FAR_LIMIT = 0.01, 1e-4
# K6 (n, dx, dy) and K13 (y) in bf16 against their plain versions, bit by
# bit: the stats and the backward's row sums are taken in another order, so
# an element may move by one ulp now and then; more than one ulp only where
# the value is tiny next to its row (|ds| ~ 1e-5 of the row's scale, where
# an f32 rounding of the sum is several bf16 ulps of the element)
K6_SHARE_LIMIT, K6_FAR_LIMIT = 0.01, 1e-4
K13_SHARE_LIMIT, K13_FAR_LIMIT = 0.01, 1e-4
K6_OFF_WIDTHS, K13_OFF_WIDTHS, OFF_ROWS = (37, 104, 500), (37, 9999), 333  # scalar paths, vector tails, ORT-xsmall
# K4's raw log-probs in bf16 against the plain rule (``rounded_log_softmax``,
# the JAX package's rounding points) at the kernel's indices, and its values where no penalty touched either side's entry, bit
# by bit with K13's limits (the log-prob is K13's computation). Ties go to the
# lower index: a row whose k values equal the plain version's bit for bit
# holds the plain indices, but for a near-tie of an element one ulp off (at
# most this share of rows)
K4_INDEX_SHARE_LIMIT = 1e-3
K4_OFF_WIDTH = 9999  # rows that are not whole 16-byte vectors: the general path
K4_MIDPOINT_TOP = 1024.0  # the top logit of K4's rows whose log-sum lies next to a bf16 midpoint
# K12's bf16 output as K1's; its backward's d p_att, d att_h, d att as K7's
K12_SHARE_LIMIT, K12_FAR_LIMIT = 0.02, 0.001
K12_BWD_SHARE_LIMIT, K12_BWD_FAR_LIMIT = 0.05, 0.005
# (regions, A, D, rows an image): a short region list; a D off the 16-byte
# vector; the held forward's largest bf16 A at R = 64 and 16 rows (its
# staging, scores and tanh table fill 232,400 of a block's 232,448 bytes of
# shared memory) and the next A, which takes the general forward
K12_OFF_SHAPES = ((20, 512, 1000, BEAM), (36, 512, 1001, BEAM), (64, 1384, 1000, 16), (64, 1392, 1000, 16))
SERVE_ROWS = BIG_BATCH * BEAM  # the serving decode step's rows
HOLD_CYCLES = 100_000_000  # ~55 ms of the card's clock: the longest hold of a timed window
CYCLES_PER_S = HOLD_CYCLES / 0.055
HOLD_MIN_CYCLES = HOLD_CYCLES // 10  # the shortest hold, ~5.5 ms
WINDOW_S = 0.1  # a timed window's calls of a function slower than 5 ms a call (a plain version) take about this
BEAM_WIDTHS = (BEAM, 10, 15, 40)  # K4: the serving beam, then wider ones (any width up to the vocabulary)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor core / f32 CUDA cores
ESIZE = {torch.float32: 4, torch.bfloat16: 2}
REPLACES = {
    "box_attention": "sparse_caption_tpu/models/layers.py:406",
    "ancestry_self_attention": "sparse_caption_tpu/models/layers.py:280",
    "grouped_cross_attention": "sparse_caption_tpu/models/layers.py:236",
    "beam_topk": "sparse_caption_tpu/models/layers.py:458",
    "supermask": "sparse_caption_tpu/ops/masked.py:70",
    "add_ref_layernorm": "sparse_caption_tpu/models/layers.py:71",
    "box_attention_bwd": "sparse_caption_tpu/models/layers.py:406",
    "keyed_dropout": "sparse_caption_tpu/models/layers.py:31",
    "sample_step": "sparse_caption_tpu/decoding/sample.py:134",
    "cider_reward": "sparse_caption_tpu/scst/device_reward.py:282",
    "lstm_cell": "sparse_caption_tpu/models/up_down.py:47",
    "additive_attention": "sparse_caption_tpu/models/up_down.py:67",
    "vocab_log_softmax": "sparse_caption_tpu/models/up_down.py:124",
    "decoder_attention": "sparse_caption_tpu/models/layers.py:158",
    "decoder_attention_bwd": "sparse_caption_tpu/models/layers.py:158",
    "magnitude_threshold": "sparse_caption_tpu/pruning/engine.py:210",
    "ancestry_self_attention_bwd": "sparse_caption_tpu/models/layers.py:317",
    "grouped_cross_attention_bwd": "sparse_caption_tpu/models/layers.py:249",
    "ancestry_self_attention_bwd_anc": "sparse_caption_tpu/models/layers.py:320",
}
# the ACORT rows of the kernels line: (name, library, entry points, JAX site)
ACORT_MODES = (
    ("box_attention kv", "box_attention", ("box_attention_kv", "box_attention_train_kv"),
     "sparse_caption_tpu/models/layers.py:383"),
    ("box_attention_bwd kv", "box_attention_bwd", ("box_attention_bwd_kv",), "sparse_caption_tpu/models/layers.py:383"),
    ("ancestry_self_attention kv", "ancestry_self_attention", ("ancestry_self_attention_kv",),
     "sparse_caption_tpu/models/layers.py:296"),
    ("grouped_cross_attention kv", "grouped_cross_attention", ("grouped_cross_attention_kv",),
     "sparse_caption_tpu/models/layers.py:244"),
    ("beam_topk V=771", "beam_topk", ("beam_topk",), "sparse_caption_tpu/models/layers.py:458"),
    ("vocab_log_softmax V=771", "vocab_log_softmax", ("vocab_log_softmax", "vocab_log_softmax_bwd"),
     "sparse_caption_tpu/models/layers.py:465"),
    ("decoder_attention kv", "decoder_attention", ("decoder_attention_kv",), "sparse_caption_tpu/models/layers.py:205"),
    ("decoder_attention_bwd kv", "decoder_attention_bwd", ("decoder_attention_bwd_kv",),
     "sparse_caption_tpu/models/layers.py:205"),
)
# the supermask XE train step (bench.py:230-292): 15 images x 5 captions of 18
# tokens, and the throughput point at 256 images; supermask logits start at 5.0
TRAIN_BATCH, TRAIN_BIG_BATCH, SEQ_PER_IMG, TRAIN_T = 15, 256, 5, MAX_LEN + 1
WHOLE_STEP_BATCH, TRAIN_STEPS, MASK_INIT = 2, 10, 5.0
TRAIN_CONFIG = dict(lr_scheduler="noam", optim="adam", d_model=PAPER["d_model"], noamopt_warmup=10000,
                    grad_clip=0.1, learning_rate=5e-4, max_train_step=100000, prune_sparsity_target=0.8,
                    caption_model="relation_transformer_prune", seed=SEED)
# whole-step check (card vs CPU, f32). Element-wise, a gradient is held to
# 1e-4 of its tensor's largest entry plus 1e-6 of the largest gradient
# anywhere (the key projections' biases have a gradient of 0 in exact
# arithmetic: rounding noise on both sides). That bound is reported; what must
# hold is each tensor's norm-wise error, ||card - cpu|| <= 1e-2 ||cpu|| (+ the
# same floor): a ReLU pre-activation within rounding of 0 may take the other
# side of the kink on one device, which changes that unit's gradient row and,
# by ~1e-3, every gradient upstream of it (norm-wise 1.9e-3 at worst for data
# seed 2 of --whole-step-seeds 3 on an H100); a wrong wire or cast moves
# gradients by O(1).
STEP_GRAD_TOL, STEP_GRAD_FLOOR, STEP_GRAD_NORM_TOL, STEP_LOSS_RTOL = 1e-4, 1e-6, 1e-2, 1e-5
# the paper's sparse SCST stage (resources/commands_pruning.sh:98-114): frozen
# 0/1 masks at 0.9875 sparsity, 15 random samples per image, leave-one-out
# baseline, CIDEr-D + BLEU-4, step LR 5e-5; 5 images (the paper's) and 64
# (bench.py:1038-1045); refs and df as bench.py:354-362 makes them
SCST_SPARSITY, SCST_SAMPLES, SCST_BATCHES, SCST_STEPS, SCST_BLEU = 0.9875, 15, (5, 64), 5, (0.0, 0.0, 0.0, 1.0)
SCST_CONFIG = dict(lr_scheduler="step", learning_rate=5e-5, optim="adam", grad_clip=0.1, scst_sample="random",
                   scst_baseline="sample", scst_reward="device", max_seq_length=MAX_LEN + 1, seed=SEED)
SCST_CHECK_BATCH, SCST_CHECK_SAMPLES = 2, 3
# supermask SCST: the ORT and Up-Down at paper width with
# MaskConfig("supermask", 5.0), the mask logits drawn N(0, 1) from the seed
# (samples vary from step to step), trained by the mask Adam (lr 100, eps
# 1e-2); steps timed after a warm-up at each batch of SCST_BATCHES /
# UPDOWN_SCST_BATCHES
SUPERMASK_LOGIT_STD, SUPERMASK_SCST_STEPS = 1.0, 3
# K2's backward at the SCST gradient pass (960 rows, 17 slots): the first,
# a middle and the last step
K2_BWD_STEPS = (0, 8, MAX_LEN - 1)
# replay vs sampling decode (f32, plain full-sequence attention vs K2/K3 over
# the cache: rounding only); K10 vs its plain version (summation order); the
# card-vs-CPU step: rewards relative (plus the kernel's absolute floor), loss
# absolute, gradients norm-wise as the XE step's
REPLAY_LP_TOL, REWARD_RTOL, REWARD_ATOL, SCST_LOSS_TOL = 1e-4, 1e-5, 1e-6, 1e-5
# Up-Down at paper width (sparse_caption_tpu/models/up_down.py:22, bench.py:620-710):
# rnn 1000, input encoding 1000, att_hid 512, fc and att features 2048, 36
# regions, vocab 10000, 17 steps; beam-5 serving at batch 50 and 1024
UPDOWN = dict(vocab_size=10000, rnn_size=1000, input_encoding_size=1000, att_hid_size=512, fc_feat_size=2048,
              att_feat_size=2048, max_seq_length=MAX_LEN)
UPDOWN_BATCHES = (50, 1024)
# the paper's Up-Down supermask family (resources/commands_pruning.sh:19,23-25,52-58,98-113):
# cosine LR 0.01, Adam eps 0.01, drop_prob_lm 0.1, target 0.991, weight 120
UPDOWN_CONFIG = dict(lr_scheduler="cosine", learning_rate=0.01, optim_epsilon=0.01, optim="adam", grad_clip=0.1,
                     max_train_step=100000, prune_sparsity_target=0.991, prune_supermask_sparsity_weight=120,
                     caption_model="up_down_lstm_prune", seed=SEED)
UPDOWN_DROP = 0.1
# the paper's Up-Down sparse SCST (resources/commands_pruning.sh:113): mask_freeze
# at 0.991, 60 random samples per image, leave-one-out baseline, dropout 0.1,
# the ORT SCST's step LR 5e-5 / Adam / clip 0.1 and reward; 5 images (the
# paper's batch) and 16 (960 rows, the ORT's 64 x 15)
UPDOWN_SCST_SPARSITY, UPDOWN_SCST_SAMPLES, UPDOWN_SCST_BATCHES = 0.991, 60, (5, 16)
# the paper's gradual magnitude pruning (resources/commands_pruning.sh:60-75:
# mag_grad_uniform to 0.8) on the paper-width ORT, bf16 XE at 15 x 5, its Zhu
# & Gupta schedule shortened to 2 steps an epoch, an update every 2 steps to
# half of 16 steps: updates after steps 2, 4, 6 and 8 to sparsities 0,
# 0.563, 0.770 and 0.8, then one more step on the pruned weights
PRUNE_TYPE, PRUNE_TARGET = "mag_grad_uniform", 0.8
PRUNE_EPOCH_STEPS, PRUNE_FREQ, PRUNE_MAX_STEP, PRUNE_STEPS = 2, 2, 16, 9
# K16's dist stats against torch.mean / torch.std: the mean within 1e-6 of
# the tensor's std, the std within 1e-6 relative (f32 sums of up to 5.1M
# weights in two fixed orders)
K16_STATS_TOL = 1e-6
# ACORT-base (resources/commands_acort.sh:13-21,30-40): the ORT at d512 /
# ff2048, 8 heads, kv-shared attention on both sides, 6 layer slots over 2
# unique layers a side, radix tokens of base 768 over a synthetic word
# vocabulary of ACORT_WORDS words (2 digits a word; vocab 771: pad 0, digits
# 1..768, bos 769, eos 770; unk id 1, a digit, as the JAX package's
# from_config gives it), 26 tokens; dense, noam, dropout 0.1 / 0.5 (the
# recipe's defaults), 36 regions x 2048 features
ACORT_FLAGS = dict(caption_model="relation_transformer", tokenizer="radix", radix_base=768, max_seq_length=26,
                   share_att_encoder="kv", share_att_decoder="kv", share_layer_encoder="(0, 0, 0, 1, 1, 1)",
                   share_layer_decoder="(0, 0, 0, 1, 1, 1)", d_model=512, dim_feedforward=2048, num_layers=6,
                   num_heads=8, att_feat_size=2048)
ACORT_BASE = dict(vocab_size=771, pad_id=0, bos_id=769, eos_id=770, unk_id=1)  # what the radix tokenizer writes
ACORT_LEN, ACORT_SLOTS, ACORT_WORDS = ACORT_FLAGS["max_seq_length"], ACORT_FLAGS["num_layers"], 10000
ACORT_CONFIG = dict(lr_scheduler="noam", optim="adam", d_model=ACORT_FLAGS["d_model"], noamopt_warmup=10000,
                    grad_clip=0.1, max_train_step=100000, caption_model="relation_transformer", seed=SEED)
# a small ORT with qk-shared attention on both sides (the JAX package's other
# sharing layout): 2 layers at paper width, dense, served and stepped once
# against the CPU
QK_ORT = dict(PAPER, num_layers=2, share_att_encoder="qk", share_att_decoder="qk")
QK_CONFIG = dict(ACORT_CONFIG, d_model=PAPER["d_model"])
# ACORT-small (resources/commands_acort.sh:41-52; its SCST stage :72-98): ACORT
# at d256 / ff1024, 8 heads of 32, the same sharing, radix tokens and 26
# positions; XE as ACORT-base's (noam at d256, dropout 0.1 / 0.5); SCST with
# --drop_prob_src 0.1 (dropout 0.1, the model's default), step LR 5e-5 without
# decay, Adam, clip 0.1, 15 random samples, the sample baseline, BLEU-4 weight
# 1 with CIDEr-D, f32; at 5 x 15 (the recipe's batch) and 64 x 15 (the ORT SCST
# cell's 960 rows). Nothing cut.
ACORT_SMALL_FLAGS = dict(ACORT_FLAGS, d_model=256, dim_feedforward=1024)
DK_SMALL = ACORT_SMALL_FLAGS["d_model"] // ACORT_SMALL_FLAGS["num_heads"]
ACORT_SMALL_CONFIG = dict(ACORT_CONFIG, d_model=ACORT_SMALL_FLAGS["d_model"])
ACORT_SMALL_SCST_DROP_SRC = 0.1
ACORT_SMALL_SCST_CONFIG = dict(SCST_CONFIG, max_seq_length=ACORT_LEN)
# the dk 32 rows of the kernels line (ACORT-small's instances): (name, library, entry points, JAX site)
ACORT_SMALL_MODES = (
    ("box_attention kv dk32", "box_attention", ("box_attention_kv", "box_attention_train_kv"),
     "sparse_caption_tpu/models/layers.py:383"),
    ("box_attention_bwd kv dk32", "box_attention_bwd", ("box_attention_bwd_kv",),
     "sparse_caption_tpu/models/layers.py:383"),
    ("ancestry_self_attention kv dk32", "ancestry_self_attention", ("ancestry_self_attention_kv",),
     "sparse_caption_tpu/models/layers.py:296"),
    ("grouped_cross_attention kv dk32", "grouped_cross_attention", ("grouped_cross_attention_kv",),
     "sparse_caption_tpu/models/layers.py:244"),
    ("decoder_attention kv dk32", "decoder_attention", ("decoder_attention_kv",),
     "sparse_caption_tpu/models/layers.py:205"),
    ("decoder_attention_bwd kv dk32", "decoder_attention_bwd", ("decoder_attention_bwd_kv",),
     "sparse_caption_tpu/models/layers.py:205"),
    ("cider_reward radix", "cider_reward", ("cider_reward",), "sparse_caption_tpu/scst/device_reward.py:235"),
)
ACORT_SMALL_PATHS = ("acort_small_serve", "acort_small_train_step", "acort_small_scst_step")
# ORT-xsmall (resources/commands_acort.sh:57-70, its speed test :129-141): the
# recipe's smallest ORT baseline, a dense relation_transformer at d104 /
# ff416, 8 heads of 13 (the kernels' padded dk 13 instances), 6 + 6 layers,
# word tokens (vocab 10,000, 17 positions), 36 regions x 2048 features;
# beam-5 serving and the dense XE step as the ORT's TRAIN_CONFIG (noam at
# d104, dropout 0.1 / 0.5, clip 0.1). Nothing cut. Beside it, checked on the
# card against the CPU and not timed: ORT-small (the same at d256 / ff1024,
# dk 32 unshared) and ACORT-base-AL (:100-104: ACORT-base with one layer in
# all six slots a side).
ORT_XSMALL_FLAGS = dict(caption_model="relation_transformer", vocab_size=PAPER["vocab_size"], d_model=104,
                        dim_feedforward=416, num_layers=PAPER["num_layers"], num_heads=HEADS,
                        att_feat_size=PAPER["att_feat_size"], max_seq_length=MAX_LEN, pad_token_id=0, bos_token_id=2,
                        eos_token_id=3)
DK_XSMALL = ORT_XSMALL_FLAGS["d_model"] // ORT_XSMALL_FLAGS["num_heads"]
ORT_XSMALL_CONFIG = dict(TRAIN_CONFIG, d_model=ORT_XSMALL_FLAGS["d_model"], caption_model="relation_transformer")
ORT_SMALL_FLAGS = dict(ORT_XSMALL_FLAGS, d_model=256, dim_feedforward=1024)
ORT_SMALL_CONFIG = dict(ORT_XSMALL_CONFIG, d_model=ORT_SMALL_FLAGS["d_model"])
ACORT_BASE_AL_FLAGS = dict(ACORT_FLAGS, share_layer_encoder="(0, 0, 0, 0, 0, 0)",
                           share_layer_decoder="(0, 0, 0, 0, 0, 0)")
# the dk 13 rows of the kernels line (ORT-xsmall's instances, unshared): (name, library, entry points, JAX site)
XSMALL_MODES = (
    ("box_attention dk13", "box_attention", ("box_attention", "box_attention_train"),
     "sparse_caption_tpu/models/layers.py:406"),
    ("box_attention_bwd dk13", "box_attention_bwd", ("box_attention_bwd",), "sparse_caption_tpu/models/layers.py:406"),
    ("ancestry_self_attention dk13", "ancestry_self_attention", ("ancestry_self_attention",),
     "sparse_caption_tpu/models/layers.py:280"),
    ("grouped_cross_attention dk13", "grouped_cross_attention", ("grouped_cross_attention",),
     "sparse_caption_tpu/models/layers.py:236"),
    ("decoder_attention dk13", "decoder_attention", ("decoder_attention",), "sparse_caption_tpu/models/layers.py:158"),
    ("decoder_attention_bwd dk13", "decoder_attention_bwd", ("decoder_attention_bwd",),
     "sparse_caption_tpu/models/layers.py:158"),
)
XSMALL_PATHS = ("ort_xsmall_serve", "ort_xsmall_train_step")
# supermask SCST: K5's keyed mode, its own row on the kernels line
SUPERMASK_MODES = (
    ("supermask keyed", "supermask", ("supermask_keyed",), "sparse_caption_tpu/decoding/api.py:83"),
)
SUPERMASK_PATHS = ("supermask_scst_step", "updown_supermask_scst_step")
# the decode variants (decoding/sample.py:29-90, decoding/beam.py:176-184) and
# the raw 4-wide geometry (--no_box_trigonometric_embedding) on the paper ORT:
# sampling serve with 5 samples an image (method, temperature), diverse beam
# serve (beam 6 in 3 groups), and the raw-geometry ORT built by from_config
# (dense, the ORT's TRAIN_CONFIG for its XE step). Nothing cut.
SAMPLE_METHODS, SAMPLE_ROWS = (("top3", 1.0), ("top0.9", 0.7), ("gumbel", 1.0)), 5
DIVERSE = dict(beam_size=6, group_size=3, diversity_lambda=0.5)
RAW_FLAGS = dict(ORT_XSMALL_FLAGS, d_model=PAPER["d_model"], dim_feedforward=PAPER["dim_feedforward"],
                 no_box_trigonometric_embedding=True)
RAW_CONFIG = dict(ORT_XSMALL_CONFIG, d_model=PAPER["d_model"])
# K9's modes against their plain versions: tokens equal but for near-ties of
# the Gumbel-max (as K9's random mode) and, in the nucleus mode, rows whose
# cutoff prefix sum lies within NUCLEUS_NEAR_ULPS ulps of p (the kernel's exact
# sums and torch.cumsum's rounding may keep one entry apart; counted and
# reported apart); chosen log-probs within K9_LP_TOL (1 + |lp|), on such a row
# of the plain version's with its kept set, or one entry fewer or more
K9_LP_TOL, NUCLEUS_NEAR_ULPS = 1e-6, 4
# The whole sampling path on the card against the CPU: a nucleus sample whose
# tokens differ passes as a near-tie when a cutoff sum of the CPU's step lies
# within NUCLEUS_PATH_TIE of p. The two sides' log-probs there come from two
# models' arithmetic (up to WHOLE_PATH_LP_TOL apart, not from one kernel's
# scan), which moves a cutoff sum by far more than a few ulps (1e-5 is about
# 170 f32 ulps at 0.9).
NUCLEUS_PATH_TIE = 1e-5
K9_MODE_CASES = (("top3", 1.0, False), ("top3", 0.7, True), ("top1", 1.0, True), ("top20", 0.7, True),
                 ("top40", 1.0, False), ("top0.9", 0.7, False), ("top0.9", 0.7, True), ("top0.5", 1.0, True),
                 ("gumbel", 1.0, False), ("gumbel", 0.7, True), ("random", 1.0, False), ("random", 0.7, True),
                 ("greedy", 1.0, True))
# K9 at NUCLEUS_MAX_VOCAB (the streaming path for random, Gumbel and greedy)
K9_LONG_CASES = (("top0.9", 0.7, True), ("top0.5", 1.0, False), ("top3", 1.0, True), ("top40", 0.7, True),
                 ("random", 0.7, True), ("gumbel", 1.0, False), ("greedy", 1.0, True))
# K9's held path on peaked rows too (logits at scale K9_PEAKED_SCALE)
K9_HELD_CASES = (("random", 1.0, False), ("random", 0.7, True), ("gumbel", 1.0, False), ("greedy", 1.0, True))
K9_PEAKED_SCALE = 10.0
HELD_MAX_THREADS = 320  # csrc/row_softmax.cuh kTopkHeldMaxThreads: K4's and K9's held rows, V <= 320 x 32
# K9's entry-rule rows (``entry_bound_rows``): a random step at this temperature makes |a| ~ 4,600, where the
# add's rounding (2.4e-4) passes the rule's fixed margins; the case at T 1 (and Gumbel) tells its bits apart
K9_BOUND_TEMPERATURE = 0.002
# K9's operations (csrc/sample_step.cu notes): 40 32-bit multiplies a Philox4x32-10 call (10 rounds of two lo
# and two hi), at 64 an SM a clock; logf and expf counted at the SFU's 16 an SM a clock (compute capability 9.0)
PHILOX_MULS, IMUL_PER_SM_CLOCK, SFU_PER_SM_CLOCK = 40, 64, 16
DIVERSE_LAMBDA_CHECK = 0.3  # K4's kernel check: a lambda whose multiples round apart from repeated subtraction
# the decode variants' rows of the kernels line: (name, library, entry points, JAX site)
VARIANT_MODES = (
    ("sample_step gumbel", "sample_step", ("sample_step_gumbel",), "sparse_caption_tpu/decoding/sample.py:69"),
    ("sample_step top-k", "sample_step", ("sample_step_topk",), "sparse_caption_tpu/decoding/sample.py:29"),
    ("sample_step nucleus", "sample_step", ("sample_step_nucleus",), "sparse_caption_tpu/decoding/sample.py:29"),
    ("beam_topk diverse", "beam_topk", ("beam_topk_diverse",), "sparse_caption_tpu/decoding/beam.py:176"),
    ("box_attention raw geometry", "box_attention",
     ("box_attention_raw", "box_attention_train_raw", "box_attention_kv_raw", "box_attention_train_kv_raw"),
     "sparse_caption_tpu/models/layers.py:338"),
    ("box_attention_bwd raw geometry", "box_attention_bwd", ("box_attention_bwd_raw", "box_attention_bwd_kv_raw"),
     "sparse_caption_tpu/models/layers.py:338"),
)
VARIANT_PATHS = tuple(f"sample_serve_{m}" for m, _ in SAMPLE_METHODS) + ("diverse_serve", "raw_serve",
                                                                         "raw_train_step")
# Up-Down with scheduled sampling and two logit layers (sparse_caption_tpu/opts.py:107 --ss_prob,
# models/up_down.py --logit_layers): the paper Up-Down supermask XE cell's model and steps at ss_prob 0.25 and
# logit_layers 2; beam-sample SCST (--scst_sample beam_search, engine/training.py:467-468, beam width =
# scst_num_samples): the paper ORT's and Up-Down's sparse SCST cells (mask_freeze 0.9875 / 0.991, f32, dropout
# on) with the search in place of the random samples. Nothing cut.
SS_PROB, SS_LOGIT_LAYERS = 0.25, 2
SS_CHECK_ROWS = TRAIN_BIG_BATCH * SEQ_PER_IMG  # K9's ss mode at the 256 x 5 XE step's rows
SS_HINGE_ROWS = 256  # bf16 rows whose draw hinges on the noise's rounding (``ss_rounding_rows``)
BEAM_SCST_CONFIG = dict(SCST_CONFIG, scst_sample="beam_search")
BEAM_SCST_STEPS = 2  # timed steps after the warm-up, at each batch
K2_ANC_MAPS = ("identity", "from_beam_0", "random")  # K2's backward, ancestry mode: the maps it is held on
SS_BEAM_MODES = (
    ("scheduled_sample", "sample_step", ("scheduled_sample",), "sparse_caption_tpu/models/up_down.py:170"),
    ("ancestry_self_attention_bwd ancestry", "ancestry_self_attention_bwd_anc", ("ancestry_self_attention_bwd_anc",),
     "sparse_caption_tpu/models/layers.py:320"),
)
SS_BEAM_PATHS = ("updown_ss_train_step", "ort_beam_scst_step", "updown_beam_scst_step")
# Supermask and beam-sample SCST at ACORT's and ORT-xsmall's widths (resources/commands_acort.sh:41-98, opts.py:68
# --scst_sample beam_search; sparse_caption_tpu/models/relation_transformer.py:61-62 registers
# relation_transformer_prune with every ACORT flag): ACORT-small's SCST stage (drop_prob_src 0.1, 15 samples, the
# sample baseline, the radix reward, f32) with beam search of width 15 (dense, as the recipe trains it) and under a
# training supermask (logits N(0, 1)); ORT-xsmall's (d104, dk 13) supermask and beam-sample SCST at the paper SCST
# cell's settings; ACORT-base's supermask XE (logits at 5.0, noam, dropout on) and its supermask SCST step card
# against CPU (the kv dk 64 instances). Nothing cut.
ACORT_SMALL_BEAM_CONFIG = dict(ACORT_SMALL_SCST_CONFIG, scst_sample="beam_search")
ACORT_BASE_SCST_CONFIG = dict(SCST_CONFIG, max_seq_length=ACORT_LEN)
# K2's and K3's backward instances of this slice, held on the card at the paths' shapes (960 rows, 8 heads, the
# decode's T_max): (row tag, head width, kv, T_max); the first three are on the paths (ACORT-small, ORT-xsmall,
# ACORT-base) and timed, the last two are the other instances of the same templates (timed with
# ``check_k2_bwd_width_kernels(..., timed=len(BWD_WIDTH_CASES))`` and its K3 twin)
BWD_WIDTH_CASES = (("kv dk32", DK_SMALL, True, ACORT_LEN - 1), ("dk13", DK_XSMALL, False, MAX_LEN),
                   ("kv", DK, True, ACORT_LEN - 1), ("dk32", DK_SMALL, False, MAX_LEN),
                   ("kv dk13", DK_XSMALL, True, MAX_LEN))
BWD_TIMED_CASES = 3
BWD_ANC_MAPS = ("identity", "from_beam_0", "random")  # the ancestry mode's maps at the new widths
# K2's ancestry-mode backward on long caches (2 images, a random map, the last and a middle step): (head width, kv,
# beams, T_max); K's slots staged in chunks (9 at dk 64, 38 at dk 13) or, at 18 beams and dk 64, not at all
K2_BWD_LONG_CASES = ((DK, False, SCST_SAMPLES, 1024), (DK_XSMALL, True, SCST_SAMPLES, 1024),
                     (DK_SMALL, True, 18, 1024), (DK, False, 18, 1024))
# K3's backward at off shapes (4 images, 8 heads, an image with no valid region): (regions, rows an image)
K3_BWD_SHAPES = ((1, 1), (33, 5), (64, 16), (64, 60))
SHARED_WIDTH_PATHS = ("acort_small_beam_scst_step", "acort_small_supermask_scst_step", "ort_xsmall_supermask_scst_step",
                      "ort_xsmall_beam_scst_step", "acort_base_supermask_train_step", "acort_base_supermask_scst_step")
# the kernels line's rows of this slice: (name, library, entry points, JAX site, the paths of its instance)
SHARED_WIDTH_MODES = (
    ("ancestry_self_attention_bwd kv dk32", "ancestry_self_attention_bwd", ("ancestry_self_attention_bwd_kv",),
     "sparse_caption_tpu/models/layers.py:305", ("acort_small_supermask_scst_step",)),
    ("ancestry_self_attention_bwd ancestry kv dk32", "ancestry_self_attention_bwd_anc",
     ("ancestry_self_attention_bwd_anc_kv",), "sparse_caption_tpu/models/layers.py:320",
     ("acort_small_beam_scst_step",)),
    ("ancestry_self_attention_bwd dk13", "ancestry_self_attention_bwd", ("ancestry_self_attention_bwd",),
     "sparse_caption_tpu/models/layers.py:317", ("ort_xsmall_supermask_scst_step",)),
    ("ancestry_self_attention_bwd ancestry dk13", "ancestry_self_attention_bwd_anc",
     ("ancestry_self_attention_bwd_anc",), "sparse_caption_tpu/models/layers.py:320", ("ort_xsmall_beam_scst_step",)),
    ("ancestry_self_attention_bwd kv", "ancestry_self_attention_bwd", ("ancestry_self_attention_bwd_kv",),
     "sparse_caption_tpu/models/layers.py:305", ("acort_base_supermask_scst_step",)),
    ("grouped_cross_attention_bwd kv dk32", "grouped_cross_attention_bwd", ("grouped_cross_attention_bwd_kv",),
     "sparse_caption_tpu/models/layers.py:244", ("acort_small_beam_scst_step", "acort_small_supermask_scst_step")),
    ("grouped_cross_attention_bwd dk13", "grouped_cross_attention_bwd", ("grouped_cross_attention_bwd",),
     "sparse_caption_tpu/models/layers.py:249", ("ort_xsmall_supermask_scst_step", "ort_xsmall_beam_scst_step")),
    ("grouped_cross_attention_bwd kv", "grouped_cross_attention_bwd", ("grouped_cross_attention_bwd_kv",),
     "sparse_caption_tpu/models/layers.py:244", ("acort_base_supermask_scst_step",)),
    ("supermask keyed slots", "supermask", ("supermask_keyed",), "sparse_caption_tpu/models/transformer.py:300",
     ("acort_small_supermask_scst_step", "acort_base_supermask_scst_step")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, hold: bool = False, hold_cycles: int = HOLD_CYCLES) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls.
    With `hold` the card first spins for `hold_cycles` while the host enqueues
    the whole window, so that the host's time per call (autograd, the
    launches) does not show: the time of the work on the device alone."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def turns_ms(*fns) -> list:
    """For each of `fns`, the median of 5 held `time_ms` windows (device
    time alone), the functions taking turns window by window (kernel, plain,
    library, kernel, ...) so that a slow stretch of the card falls on all.
    Two warm-up calls size each function's window: 20 calls, fewer for one
    slower than WINDOW_S / 20 a call (the plain versions: about WINDOW_S of
    calls, at least one), and a hold of twice the host's time to enqueue the
    window (between HOLD_MIN_CYCLES and HOLD_CYCLES)."""
    plans = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        iters = max(1, min(20, int(WINDOW_S / (time.perf_counter() - t0))))
        plans.append((iters, int(min(HOLD_CYCLES, max(HOLD_MIN_CYCLES, 2 * iters * enqueue * CYCLES_PER_S)))))
    times = [[] for _ in fns]
    for w in range(5):
        for fn, t, (iters, cycles) in zip(fns, times, plans):
            t.append(time_ms(fn, iters=iters, warmup=1 if w == 0 else 0, hold=True, hold_cycles=cycles))
    return [sorted(t)[len(t) // 2] for t in times]


def k6_bytes(rows: int, d: int, dtype, keep: bool = True, backward: bool = True) -> int:
    """Bytes K6 must move (with y), each launch's inputs read once and outputs
    written once. Forward: x, y (and keep) in, s, n out, a and b in, the stats
    (8 bytes a row) out. Backward: gn, gs, s (and keep) in, dx, dy out, the
    stats and a in, da and db out."""
    es, flags = ESIZE[dtype], 1 if keep else 0
    fwd = rows * d * (4 * es + flags) + rows * 8 + 2 * d * es
    bwd = rows * d * (5 * es + flags) + rows * 8 + 3 * d * es
    return fwd + (bwd if backward else 0)


def k5_bytes(n_weights: int, dtype, bits: bool = True, mode: str = "sample", bypass: bool = False) -> int:
    """Bytes K5 must move for a set of n weights, forward and backward.
    Forward: w and m in (and u in mode sample), w_eff out, and in mode sample
    with `bits` the sample out, one bit a weight. Backward: g and w in, dw
    and dm out; the sample from its bits (mode sample with `bits`), else
    from u and m again; m for sigmoid' unless `bypass` (and for the sample
    of the other modes). Mode keyed: as sample, without u (made in the kernel)."""
    es, sample = ESIZE[dtype], mode in ("sample", "keyed")
    bit_bytes = -(-n_weights // 8) if sample and bits else 0
    fwd = n_weights * (2 * es + 4 + (4 if mode == "sample" else 0)) + bit_bytes
    need_m = not (sample and bits and bypass)
    bwd = n_weights * (3 * es + 4 + (4 if need_m else 0) + (4 if sample and not bits else 0)) + bit_bytes
    return fwd + bwd


def k13_bytes(rows: int, vocab: int, in_dtype, out_dtype) -> int:
    """Bytes K13 must move, forward and backward: x in, y and the stats out;
    then dy, x and the stats in, dx out."""
    ei, eo = ESIZE[in_dtype], ESIZE[out_dtype]
    return rows * vocab * ((ei + eo) + (eo + 2 * ei)) + rows * 16


def k14_bytes(n: int, nk: int, tk: int, dtype, keep: bool = True, valid: bool = True, tq: int = MAX_LEN,
              dk: int = DK, kv: bool = False) -> int:
    """Bytes K14 must move for one call: q read and out written (n query rows),
    k and v read (nk K/V rows, one per image in cross-attention; with `kv`
    one tensor, read once), the keep-mask (n, h, tq, tk) and the
    key-validity flags (nk, tk)."""
    return ((2 * n * tq + (1 if kv else 2) * nk * tk) * HEADS * dk * ESIZE[dtype]
            + (n * HEADS * tq * tk if keep else 0) + (nk * tk if valid else 0))


def k15_bytes(n: int, nk: int, tk: int, dtype, keep: bool = True, valid: bool = True, tq: int = MAX_LEN,
              dk: int = DK, kv: bool = False) -> int:
    """Bytes K15 must move for one call: q and dO read and dq written (n
    query rows), k and v read and dk and dv written (nk K/V rows; with `kv`
    one tensor read and its one gradient written), the keep-mask and the
    key-validity flags read."""
    return ((3 * n * tq + (2 if kv else 4) * nk * tk) * HEADS * dk * ESIZE[dtype]
            + (n * HEADS * tq * tk if keep else 0) + (nk * tk if valid else 0))


def decoder_attention_flops(n: int, tk: int, backward: bool = False, tq: int = MAX_LEN, dk: int = DK) -> int:
    """Operations of K14 (S = QK^T, P V) or K15 (S recomputed, dPd = dO V^T,
    dQ = dS K, dK = dS^T Q, dV = P~^T dO) for n query rows: 2 n h tq tk dk
    a product."""
    return (10 if backward else 4) * n * HEADS * tq * tk * dk


def k2_steps(t_max: int) -> tuple:
    """The steps K2's forward is timed at on a cache of T_max slots: the
    first, floor((T_max - 1) / 2) and the last."""
    return (0, (t_max - 1) // 2, t_max - 1)


def k2_check_steps(t_max: int) -> tuple:
    """The steps K2's forward is checked at: ``k2_steps`` and K2_WALK_STEP,
    where every width walks its slots (a map past slot 0 to read)."""
    return tuple(sorted(set(k2_steps(t_max)) | {K2_WALK_STEP}))


def k2_map(anc, kind: str, t: int, root=None):
    """K2's (B, K, T_max) int32 map at step t, from a uniform random map
    `anc`: slot t the identity (each row wrote it itself); `collapsed` as a
    real beam search leaves it: every beam descends from beam root[b] over
    the first floor(t / 2) slots."""
    out = anc.clone()
    if kind == "collapsed":
        out[:, :, : t // 2] = root.to(anc.dtype)[:, None, None]
    out[:, :, t] = torch.arange(anc.shape[1], device=anc.device, dtype=anc.dtype)
    return out


def k2_bytes(n: int, t: int, dtype, anc=None, h: int = HEADS, dk: int = DK, kv: bool = False) -> int:
    """Bytes K2's forward must move at step t: each distinct (row, slot) pair
    the map `anc` (B, K, T_max) names over slots 0..t once, K and V (the kv
    mode: the one cache; no map: each of the n rows' own slots 0..t), q read
    and out written a row, the map's columns 0..t (int32)."""
    if anc is None:
        pairs, map_bytes = n * (t + 1), 0
    else:
        b, k, _ = anc.shape
        rows = anc[:, :, : t + 1].long() + torch.arange(b, device=anc.device)[:, None, None] * k
        pairs = int(torch.unique(rows * (t + 1) + torch.arange(t + 1, device=anc.device)).numel())
        map_bytes = 4 * n * (t + 1)
    return ((1 if kv else 2) * pairs + 2 * n) * h * dk * ESIZE[dtype] + map_bytes


def steps_loss(launches_per_step: int, steps: int, timed: dict) -> float:
    """A decode kernel's loss on a path of `steps` steps (ms): the sum over
    t = 0 .. steps - 1 of launches_per_step x (time(t) - bound(t)), both
    linear in t between the timed steps (`timed`: {t: (ms, bound_ms)}, the
    first and the last step among them)."""
    ts = sorted(timed)
    if ts[0] != 0 or ts[-1] != steps - 1:
        raise ValueError(f"the timed steps {ts} must include 0 and {steps - 1}")
    gap = {t: ms - bnd for t, (ms, bnd) in timed.items()}
    total = 0.0
    for t in range(steps):
        hi = next(x for x in ts if x >= t)
        lo = max(x for x in ts if x <= t)
        total += gap[t] if lo == hi else gap[lo] + (gap[hi] - gap[lo]) * (t - lo) / (hi - lo)
    return launches_per_step * total


def k2_gen():
    """K2's own generator for the inputs its checks added since its redesign
    (the collapsed maps' roots, the identity-map case), so that the checks'
    shared generators draw what they drew before."""
    return torch.Generator(device="cuda").manual_seed(SEED + 42)


def k2_roots(images: int, beams: int = BEAM):
    """Each image's beam of K2's collapsed map."""
    return torch.randint(0, beams, (images,), generator=k2_gen(), device="cuda", dtype=torch.int32)


def check_k2_forward(tag: str, q, ck, cv, anc, root, compare, bits, same=None, steps=None) -> float:
    """K2's forward (cv None: the kv mode) against its plain version at
    `steps` (by default ``k2_check_steps``: both of its paths) on both K2_MAPS made from the uniform
    random map `anc` (``k2_map``; `root`: each image's beam of the collapsed
    map), or on the identity map where `anc` is None: `compare(name, out,
    ref, scale, fault=)` element by element, with a planted fault (the plain
    version with the ancestor row ignored, past step 0, whose slot 0 each row
    wrote itself; on the identity map, every row reading its neighbour's
    cache), `bits(name, out, ref, share, far)` bit by bit in bf16, and under
    kv `same(name, a, b)`: bit-equal to the unshared kernel given the cache
    twice. Returns the last compare's max abs error."""
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2

    plain = k2.ancestry_self_attention_plain
    err, scale = 0.0, rms(ck if cv is None else cv)
    for step in steps or k2_check_steps(ck.shape[2]):
        for kind in K2_MAPS if anc is not None else ("identity",):
            anc_t = None if anc is None else k2_map(anc, kind, step, root)
            name = f"{tag} t={step} {kind}"
            out, ref = k2.ancestry_self_attention(q, ck, cv, anc_t, step), plain(q, ck, cv, anc_t, step)
            if anc is None:
                fault = plain(q, ck.roll(1, 0), None if cv is None else cv.roll(1, 0), None, step)
            else:
                fault = plain(q, ck, cv, None, step) if step > 0 else None
            err = compare(name, out, ref, scale, fault=fault)
            bits(f"{name} out", out, ref, K2_SHARE_LIMIT, K2_FAR_LIMIT)
            if same is not None and cv is None:
                same(name, out, k2.ancestry_self_attention(q, ck, ck, anc_t, step))
            del out, ref, fault
    return err


def k3_bytes(images: int, beams: int, dtype, regions: int = REGIONS, kv: bool = False, dk: int = DK) -> int:
    """Bytes K3 must move for one decode step: the image's memory K and V
    read once per image (not per beam; with `kv` one array, K and V), q read
    and out written per beam row, the region mask."""
    return ((1 if kv else 2) * images * regions + 2 * images * beams) * HEADS * dk * ESIZE[dtype] + images * regions


def k4_bytes(n: int, vocab: int, k: int, dtype, div_p: int = 0) -> int:
    """Bytes K4 must move: the (n, vocab) logits read once, each row's banned
    token (int32) and bad-ending flag (one byte), the k values, indices and
    raw log-probs written (4 bytes each); with the diverse-beam penalty, each
    image's (n / k rows) div_p earlier-group tokens (int32) read once."""
    return n * vocab * ESIZE[dtype] + n * 5 + 3 * n * k * 4 + n // k * div_p * 4


def k9_bytes(n: int, vocab: int, dtype) -> int:
    """Bytes K9 must move for one step, in every mode (the filters work in
    shared memory): the (n, vocab) logits read once; per row the fed token
    (int32) and the unfinished flag (one byte) read, the token written to seq
    and to next (int32 each), the chosen log-prob (f32) and the flag written."""
    return n * vocab * ESIZE[dtype] + n * (4 + 1 + 4 + 4 + 4 + 1)


def k1_bytes(b: int, h: int, r: int, dk: int, dtype, dim_g: int = 64) -> int:
    """Bytes K1 must move: q, k, v read and out written, (B, h, R, dk) each;
    the f32 boxes (16 bytes a region) and the region mask (one byte a region);
    wg (h, dim_g) and its bias in the compute dtype."""
    return 4 * b * h * r * dk * ESIZE[dtype] + b * r * 16 + b * r + h * (dim_g + 1) * ESIZE[dtype]


def k7_bytes(b: int, h: int, r: int, dk: int, dtype, dim_g: int = 64) -> int:
    """Bytes K7 must move: q, k, v and dO read, dq, dk and dv written (B, h,
    R, dk each); the keep-mask (one byte a (head, pair)), the boxes and the
    region mask; wg and its bias read, their gradients written."""
    return 7 * b * h * r * dk * ESIZE[dtype] + b * h * r * r + b * r * 16 + b * r + 2 * h * (dim_g + 1) * ESIZE[dtype]


def k12_bytes(images: int, rows: int, regions: int, a: int, d: int, dtype, backward: bool = False) -> int:
    """Bytes K12 must move for `rows` query rows an image. Forward: p_att (R x
    A) and att (R x D) read once per image, att_h (A) read and out (D) written
    per row, w and the bias, the region mask (one byte a region). With the
    backward: the forward also writes prob and weight (f32, R a row); the
    backward reads p_att, att, att_h, w, the mask, prob, weight and dout, and
    writes d p_att, d att, d att_h, d w and d bias."""
    es, n = ESIZE[dtype], images * rows
    fwd = (images * regions * (a + d) + n * (a + d) + a + 1) * es + images * regions
    if not backward:
        return fwd
    saved = 2 * n * regions * 4
    bwd_in = (images * regions * (a + d) + n * (a + d) + a) * es + images * regions + saved
    bwd_out = (images * regions * (a + d) + n * a + a + 1) * es
    return fwd + saved + bwd_in + bwd_out


def k11_bytes(n: int, h: int, dtype, backward: bool = False) -> int:
    """Bytes K11 must move for n rows of h units. Forward: gx, gh (4h each)
    and c in, h', c' out. With the backward too: gx, gh, c, dh', dc' in,
    the gates' gradient (4h, one tensor for gx and gh) and dc out."""
    fwd = (4 * h + 4 * h + h + 2 * h) * n
    bwd = (4 * h + 4 * h + h + 2 * h + 4 * h + h) * n
    return (fwd + (bwd if backward else 0)) * ESIZE[dtype]


def fwd_bwd(fn, ins, cots):
    """Forward + backward of fn on the leaves `ins`: (detached outputs, gradients)."""
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o.detach() for o in out), torch.autograd.grad(out, ins, cots)


def bf16_ulps(a, b):
    """|a - b| in units of the last place of bf16 at |b| (the spacing of bf16
    values next to b; 0 where equal)."""
    b = b.float()
    mag = b.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (a.float() - b).abs() / ulp


def rounding_share(name, out, ref, share_limit: float, far_limit: float = 0.0) -> bool:
    """The bits of a bf16 result against the plain version's, which rounds at
    the same points: the kernel may differ from it by one ulp on at most
    `share_limit` of the elements (summation order, and a rounding tie in an
    intermediate), and by more than one ulp on at most `far_limit`. A dropped or
    moved rounding point moves a large share of the elements. An empty
    selection (every rank touched by a penalty) has nothing to hold."""
    ulps = bf16_ulps(out, ref)
    if ulps.numel() == 0:
        log(f"[rounding] {name}: no elements")
        return True
    differ = (ulps > 0).float().mean().item()
    far = (ulps > 1).float().mean().item()
    good = differ <= share_limit and far <= far_limit
    log(f"[rounding] {name}: {differ:.5f} of elements differ from the plain version (limit {share_limit}), "
        f"{far:.6f} by more than 1 ulp (limit {far_limit}), worst {ulps.max().item():.1f} ulp "
        f"{'ok' if good else 'FAIL'}")
    return good


def allowed(b, dtype, scale: float = 0.0, sum_scale: float = 0.0):
    """Per-element error allowed against the plain version's output `b`
    (`scale`: rms of the values attended over, see BF16_SCALE_UNITS;
    `sum_scale`: for a sum over many terms, the size of the sum's rounding,
    i.e. sqrt(terms) times their rms, held to the same units)."""
    b = b.float()
    if dtype == torch.float32:
        return F32_TOL + F32_TOL * (b.abs() + sum_scale)
    return BF16_U * (2 * b.abs() + BF16_SCALE_UNITS * max(scale, sum_scale))


def close(a, b, dtype, scale: float = 0.0, sum_scale: float = 0.0):
    """(max |a - b|, every element within its allowed error, worst |a - b| / allowed)."""
    err = (a.float() - b.float()).abs()
    ratio = torch.where(err == 0, 0.0, err / allowed(b, dtype, scale, sum_scale))
    return (a.float() - b.float()).abs().max().item(), bool((ratio <= 1).all()), ratio.max().item()


def rms(x) -> float:
    return x.float().pow(2).mean().sqrt().item()


def fault_caught(name, fault, ref, dtype, scale, sum_scale: float = 0.0) -> bool:
    """A planted fault (`fault`: the plain version with one part of the
    function left out) must fail the tolerance the kernel is held to."""
    ratio = (fault.float() - ref.float()).abs() / allowed(ref, dtype, scale, sum_scale)
    frac = ((ratio > 1) | ~torch.isfinite(ratio)).float().mean().item()
    log(f"[fault] {name} {str(dtype).split('.')[-1]}: {frac:.3f} of elements outside the tolerance "
        f"(worst err/allowed {ratio.max().item():.1f}) {'caught' if frac > 0 else 'MISSED'}")
    return frac > 0


def sm_clock_hz() -> float:
    """The card's largest SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k9_ops_ms(n: int, vocab: int, logged: int, clock_hz: float, sms: int) -> float:
    """K9's least time for its operations (random and Gumbel modes, the held
    path): a Philox call a group of 4 columns, PHILOX_MULS 32-bit multiplies
    each at IMUL_PER_SM_CLOCK, or its SFU work at SFU_PER_SM_CLOCK (an expf
    an entry for the log-sum, an __expf a group for its entries' bound, two
    logf an entry that `logged`), whichever takes longer."""
    groups = n * -(-vocab // 4)
    t_mul = PHILOX_MULS * groups / (IMUL_PER_SM_CLOCK * sms * clock_hz)
    t_sfu = (n * vocab + groups + 2 * logged) / (SFU_PER_SM_CLOCK * sms * clock_hz)
    return max(t_mul, t_sfu) * 1e3


def k9_bound(n: int, vocab: int, dtype, logged: int) -> tuple:
    """(bound ms, by) of K9's random or Gumbel mode on the card: the larger of
    its bytes (``k9_bytes``) over the memory rate and ``k9_ops_ms``."""
    t_bytes = k9_bytes(n, vocab, dtype) / HBM_BYTES_PER_S * 1e3
    t_ops = k9_ops_ms(n, vocab, logged, sm_clock_hz(),
                      torch.cuda.get_device_properties(0).multi_processor_count)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held_block(units: int, ue: int) -> int:
    """The threads of a held row of `units` 16-byte vectors of `ue` entries
    each: 32 entries a thread, rounded up to whole warps."""
    return -(-(-(-units // (32 // ue))) // 32) * 32


def held_threads(vocab: int, esize: int, max_threads: int = HELD_MAX_THREADS) -> int:
    """row_softmax.cuh held_row_threads: the block of a held row of `vocab`
    entries of `esize` bytes (``held_block``), 0 if not held (K4's and K9's
    held paths)."""
    ue = 16 // esize
    if vocab % ue:
        return 0
    threads = held_block(vocab // ue, ue)
    return threads if threads <= max_threads else 0


def k9_skip_model(logits, c, u, method: str, temperature: float, prev=None, fault: str = ""):
    """K9's held-path entry rule (csrc/sample_step.cu sample_held_kernel) in
    PyTorch, for a random or Gumbel step: each warp of the held block (thread
    t holding 16-byte vectors t, t + nt, ...) draws the z of its largest
    logit other than the banned one `prev` (the lowest lane's, that lane's
    first), z_ref is the largest of those z; an entry takes the logs only
    where 1 - u is not above its group's bound lim = exp(amax - z_ref +
    delta) (1 + 2^-14), amax the group's largest a (a = c / T for random, c
    for gumbel), delta = 2^-17 + 2^-21 (|z_ref| + |amax|) (torch.exp for the
    card's __expf). c: the (banned) f32 log-probs; u: the uniforms (g =
    -log(-log(u)) for random, as ``gumbel_noise``). `fault` plants one of the
    mutants of ``chip_mutants.sh``: "no_delta" (delta 0), "no_scale" (delta
    2^-17) or "kmax" (one more grid point of u skipped: 1 - u + 2^-23 >
    lim). Returns (the token the rule picks, ties to the lower index; the
    entries that take the logs, (N, V) bool)."""
    from sparse_caption_tpu_torch.decoding.sample import divide_by_temperature

    n, vocab = c.shape
    esize = logits.element_size()
    ue, nt = 16 // esize, held_threads(vocab, esize)
    if nt == 0:
        raise ValueError(f"V={vocab} in {logits.dtype} is not a held row")
    a = c if method == "gumbel" else divide_by_temperature(c, temperature)
    z = sample_z(c, method, temperature, u if method == "gumbel" else -torch.log(-torch.log(u)))
    col = torch.arange(vocab, device=c.device)
    tid = (col // ue) % nt
    lane, warp = tid % 32, tid // 32
    x = logits.float().clone()
    if prev is not None:
        x[torch.arange(n, device=c.device), prev.long()] = -float("inf")
    idx = warp.expand(n, vocab)
    wx = torch.full((n, nt // 32), -float("inf"), device=c.device).scatter_reduce(1, idx, x, "amax")
    top = (x == wx.gather(1, idx)) & (x > -float("inf"))
    order = torch.where(top, lane * vocab + col, vocab * 32)
    first = torch.full((n, nt // 32), vocab * 32, device=c.device, dtype=order.dtype).scatter_reduce(
        1, idx, order, "amin")
    has = first < vocab * 32
    zw = torch.where(has, z.gather(1, (first % vocab).clamp(max=vocab - 1)), -float("inf"))
    z_ref = zw.max(1, keepdim=True).values
    amax = a.view(n, vocab // 4, 4).amax(-1)
    delta = {"no_delta": 0.0, "no_scale": 2.0 ** -17}.get(fault, 2.0 ** -17 + 2.0 ** -21 * (z_ref.abs() + amax.abs()))
    lim = torch.exp(amax - z_ref + delta) * (1 + 2.0 ** -14)
    one_less = 1 - u.double() + (2.0 ** -23 if fault == "kmax" else 0.0)
    logged = ~(one_less > lim.repeat_interleave(4, 1))
    token = torch.argmax(torch.where(logged, z, -float("inf")), dim=-1)
    return token, logged


def flops(*pairs) -> dict:
    """{dtype: operations} summed over (dtype, operations) pairs."""
    out: dict = {}
    for dtype, n in pairs:
        out[dtype] = out.get(dtype, 0) + n
    return out


def bound_ms(nbytes: float, flops_by_dtype: dict) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in flops_by_dtype.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_boxes(gen, b, r, device):
    xy = torch.rand(b, r, 2, generator=gen, device=device) * 400
    wh = torch.rand(b, r, 2, generator=gen, device=device) * 190 + 10
    return torch.cat([xy, xy + wh], dim=-1)


def random_region_mask(gen, b, r, device):
    """(B, R) bool: each image keeps its first 10..R regions."""
    n_valid = torch.randint(10, r + 1, (b, 1), generator=gen, device=device)
    return torch.arange(r, device=device)[None, :] < n_valid


# ------------------------------------------------------------ kernel checks
def no_turns(*fns) -> list:
    """`turns_ms` left out (a check run without timings): each function once."""
    for fn in fns:
        fn()
    return [float("nan")] * len(fns)


def smem_agrees(name: str, symbol: str, python_fn, shapes) -> bool:
    """A kernel library's shared-memory size (its C function `symbol`)
    against the Python wrapper's copy of the formula that bounds the inputs."""
    from sparse_caption_tpu_torch.kernels import _build

    fn = getattr(_build.library(name), symbol)
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * len(shapes[0])
    got = [(shape, fn(*shape), python_fn(*shape)) for shape in shapes]
    good = all(c == p for _, c, p in got)
    log(f"[kernel] {name} shared memory, C vs wrapper: {got} {'ok' if good else 'FAIL'}")
    return good


def k4_constraints(gen, n: int, vocab: int, eos_id: int = 3, unk_id: int = 1) -> dict:
    """Every K4 constraint on: a banned token a row, bad endings on ~30% of
    rows, the UNK penalty."""
    dev = torch.device("cuda")
    return dict(ban_token=torch.randint(0, vocab, (n,), generator=gen, device=dev, dtype=torch.int32),
                ban_eos=torch.rand(n, generator=gen, device=dev) < 0.3, eos_id=eos_id, unk_id=unk_id)


def bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def k4_midpoint_counts(vocab: int, top: float = K4_MIDPOINT_TOP) -> list:
    """Counts n of a row's equal top logits `top` (the rest 200 below, whose
    exp is 0 in f32, so that the row's sum is n) for which K4's bf16 log-prob
    of a top entry, (x - m) - L = -L with L = log n, and the same value
    formed as x - (m + L) round apart: L lies within 2^-14 (half an f32 ulp
    of m + L at m = 1024) of a bf16 rounding midpoint M, so m + L rounds to
    m + M and x - (m + L) is -M, a tie that rounds to the even neighbour,
    while -L rounds to the odd one. Every L within 3 f32 ulps of log n does
    the same (logf's error on the card is at most one), so such rows hold
    the bf16 log-prob to K13's order of operations."""
    m = np.float32(top)
    counts = []
    for n in range(1, vocab + 1):
        near = np.float32(np.log(np.float64(n)))
        ls = np.array([np.float32(near + k * np.spacing(near)) for k in range(-3, 4)], dtype=np.float32)
        kept = bf16_round(np.float32(0.0) - ls)  # (x - m) - L with x = m
        moved = bf16_round(m - (m + ls).astype(np.float32))  # x - (m + L)
        if (kept == kept[3]).all() and (moved != kept).all():
            counts.append(n)
    return counts


def k4_margin_rows(n: int, vocab: int, device) -> torch.Tensor:
    """bf16 rows (n, vocab) whose BEAM-th log-prob is a tie that the held
    path's threshold finds only through its bf16 margin: logits 8, 7.5, 7
    and 6.1875 over a floor of -20 give lse = bf16(log bf16(2.14)) =
    0.76171875, and three logits -0.0100, 0 and 0.0078 (increasing indices,
    each in a thread of its own) all round to sh = -8 and lp = bf16(-8.76) =
    -8.75, above the unrounded -8.76: so each lies below the bare threshold
    thr + m + lse = 0.0117, and the lowest index among them is the 5th
    winner (csrc/beam_topk.cu x_lo; mutant k4_threshold_margin_dropped)."""
    x = torch.full((n, vocab), -20.0, device=device)
    for row in range(n):
        base = 8 * (row % 16)
        x[row, [base, base + 88, base + 184, base + 296]] = torch.tensor([8.0, 7.5, 7.0, 6.1875], device=device)
        x[row, [base + 8 * (50 + 13 * j) for j in range(3)]] = torch.tensor([-0.010009765625, 0.0, 0.0078125],
                                                                            device=device)
    return x.to(torch.bfloat16)


def check_beam_topk(logits, kw: dict, dtype, tag: str = "", widths=BEAM_WIDTHS) -> tuple:
    """K4 against its plain version at every width of `widths`: values and
    raw log-probs element-wise; indices equal but for near-ties (tie-aware),
    and equal outright in rows whose values agree bit for bit (ties to the
    lower index); the raw log-probs equal K13's output at the kernel's
    indices bit for bit up to width 32 (K4's held path and its scalar path
    share K13's reduction order, with or without the diverse-beam penalty;
    the radix-select variant beyond 32 keeps an online one); in
    bf16 the raw log-probs and the untouched values by `rounding_share`.
    Returns (every check passed, the first width's worst element error)."""
    from sparse_caption_tpu_torch.kernels import beam_topk as k4
    from sparse_caption_tpu_torch.kernels import vocab_log_softmax as k13

    dname = str(dtype).split(".")[-1]
    ok, err_k = True, 0.0
    lp, c = k4.constrained_logprobs(logits, **kw)
    y13 = k13.vocab_log_softmax(logits).float()
    ban, ban_eos, eos_id, unk_id = kw["ban_token"].long()[:, None], kw["ban_eos"][:, None], kw["eos_id"], kw["unk_id"]

    div = kw.get("div_tokens")
    counts = None if div is None else k4.diversity_counts(div, logits.shape[1]).repeat_interleave(
        logits.shape[0] // div.shape[0], 0)

    def touched(idx):  # entries a penalty moved
        out = (idx == ban) | (ban_eos & (idx == eos_id)) | (idx == unk_id)
        return out if counts is None else out | (counts.gather(1, idx) > 0)

    for width in widths:
        vals, idx, raw = k4.beam_topk(logits, width, **kw)
        pvals, pidx, _ = k4.beam_topk_plain(logits, width, **kw)
        ik = idx.long()
        name = f"beam_topk{tag} k={width}"
        err_v, good_v, worst_v = close(vals, pvals, dtype)
        err_r, good_r, worst_r = close(raw, lp.gather(1, ik), dtype)
        log(f"[kernel] {name} {dname}: values max_abs_err={err_v:.3e} worst err/allowed={worst_v:.3f}, raw log-probs "
            f"max_abs_err={err_r:.3e} worst err/allowed={worst_r:.3f} {'ok' if good_v and good_r else 'FAIL'}")
        ok &= good_v and good_r
        # an index may differ from the plain one only at a near-tie: then the plain
        # constrained value at the kernel's index must match the rank's value
        differ = idx != pidx
        tie_ok = bool(((c.gather(1, ik) - pvals).abs() <= allowed(pvals, dtype))[differ].all())
        same_vals = (vals == pvals).all(dim=1)
        swapped = (same_vals & differ.any(dim=1)).float().mean().item()
        k13_same = bool(torch.equal(raw, y13.gather(1, ik)))
        log(f"[kernel] {name}: indices differing {int(differ.sum())}/{differ.numel()} (near-ties ok={tie_ok}); "
            f"rows with bit-equal values but other indices {swapped:.5f} (limit {K4_INDEX_SHARE_LIMIT}) "
            f"{'ok' if swapped <= K4_INDEX_SHARE_LIMIT else 'FAIL'}; raw log-probs equal K13's bit for bit={k13_same}")
        ok &= tie_ok and swapped <= K4_INDEX_SHARE_LIMIT and (k13_same or width > k4.REGISTER_K)
        if dtype == torch.bfloat16:
            ok &= rounding_share(f"{name} raw log-probs", raw, lp.gather(1, ik), K13_SHARE_LIMIT, K13_FAR_LIMIT)
            plain_rank = ~(touched(ik) | touched(pidx.long()))
            ok &= rounding_share(f"{name} untouched values", vals[plain_rank], pvals[plain_rank], K13_SHARE_LIMIT,
                                 K13_FAR_LIMIT)
        if width == widths[0]:
            err_k = max(err_v, err_r)
    return ok, err_k


def check_kernels(gen, dtype, results: dict, timing: bool = True) -> bool:
    """Each kernel vs its plain version at the main path's shapes; timings
    (with `timing`)."""
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import beam_topk as k4
    from sparse_caption_tpu_torch.kernels import box_attention as k1
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
    from sparse_caption_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    es = ESIZE[dtype]
    dname = str(dtype).split(".")[-1]
    b, n, r, h, dk, t_max, vocab = BIG_BATCH, BIG_BATCH * BEAM, REGIONS, HEADS, DK, MAX_LEN, PAPER["vocab_size"]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    turns = turns_ms if timing else no_turns
    ok = True

    def compare(name, out, ref, scale=0.0, fault=None):
        """Kernel output vs plain version; with `fault`, also show that the
        tolerance fails a plain version with one part left out."""
        nonlocal ok
        err, good, worst = close(out, ref, dtype, scale)
        log(f"[kernel] {name} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"median|ref|={ref.float().abs().median().item():.3e} value scale={scale:.3f} {'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, dtype, scale)
        return err, good

    def record(name, err, ms, plain_ms, lib_ms, nbytes, ops):
        if not timing:
            return
        bnd, by = bound_ms(nbytes, ops)
        log(f"[kernel] {name} {dname}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bnd:.4f} ({by}; held windows in turns)")
        if dtype == torch.bfloat16:  # the main path's dtype goes into the JSON line
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                                 bound_by=by)

    # K1 box attention: (B, h, R, dk) q/k/v, boxes, wg (h, 64). wg has 4
    # entries of +-0.225 per head, so |wg . geo| <= 0.9 and w_g = relu(. + 1)
    # lies in [0.1, 1.9]: the log-bias spans [-2.3, 0.64] (std ~0.4, like the
    # scores') and stays away from relu's kink, where log(max(w_g, 1e-6))
    # turns a last-bit difference of the 64-term dot into an O(1) bias
    # difference that no tolerance can hold (the main path's random weights
    # reach the kink; the whole-path f32 check covers them). Image 0 has no
    # valid region: the plain version averages all of its keys.
    q, k, v = rnd(b, h, r, dk), rnd(b, h, r, dk), rnd(b, h, r, dk)
    boxes = random_boxes(gen, b, r, dev)
    picks = torch.rand(h, 64, generator=gen, device=dev).argsort(dim=1)[:, :4]
    signs = torch.randint(0, 2, (h, 4), generator=gen, device=dev).float() * 2 - 1
    wg_w = torch.zeros(h, 64, device=dev).scatter_(1, picks, signs * 0.225).to(dtype)
    wg_b = torch.ones(h, device=dev).to(dtype)
    mask = random_region_mask(gen, b, r, dev)
    mask[0] = False
    args = (q, k, v, boxes, wg_w, wg_b, mask)
    from sparse_caption_tpu_torch.ops.attention import box_relational_embedding, scaled_dot_attention

    bias = k1.box_log_bias_plain(boxes, wg_w, wg_b, dtype)
    log(f"[kernel] box_attention {dname}: geometry log-bias in [{bias.min().item():.3f}, {bias.max().item():.3f}], "
        f"std {bias.float().std().item():.3f}")
    out = k1.box_attention(*args)
    ref = k1.box_attention_plain(*args)
    err, _ = compare("box_attention", out, ref, rms(v), fault=scaled_dot_attention(q, k, v, mask))  # bias dropped
    err0 = (out[0].float() - ref[0].float()).abs().max().item()
    uniform = (out[0].float() - v[0].float().mean(dim=1, keepdim=True)).abs().max().item()
    log(f"[kernel] box_attention {dname}: image 0 (no valid region) max_abs_err={err0:.3e}, "
        f"off the mean of its values by {uniform:.3e}")
    ok &= err0 <= (1e-5 if dtype == torch.float32 else 2 * BF16_U * rms(v) * 8)
    # the log-bias the kernel added, against the plain version's, bit for bit
    # but for summation order (bf16: the 64-term dot in another order moves w_g
    # by one ulp now and then, and the log by one ulp; f32: within 1e-5)
    bias_k = torch.empty(b, h, r, r, device=dev, dtype=dtype)
    out_b = k1.box_attention(*args, bias_out=bias_k)
    ok &= bool(torch.equal(out_b, out))
    if dtype == torch.bfloat16:
        ok &= rounding_share("box_attention log-bias", bias_k, bias, BIAS_SHARE_LIMIT)
        ok &= rounding_share("box_attention out", out, ref, K1_SHARE_LIMIT, K1_FAR_LIMIT)
    else:
        ok &= compare("box_attention log-bias", bias_k, bias)[1]
    float_mask = bias.masked_fill(~mask[:, None, None, :], NEG_INF).to(dtype).contiguous()

    def build_bias():  # the torch ops that make SDPA's float bias: what the library yardstick leaves out
        g_ = box_relational_embedding(boxes)
        w_ = torch.relu(F.linear(g_.to(dtype), wg_w) + wg_b)
        return torch.log(torch.clamp(w_, min=1e-6)).permute(0, 3, 1, 2).masked_fill(~mask[:, None, None, :], NEG_INF)

    ms, plain_ms, lib_ms, bias_ms = turns(lambda: k1.box_attention(*args), lambda: k1.box_attention_plain(*args),
                                             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask),
                                             build_bias)
    record("box_attention", err, ms, plain_ms, lib_ms,
           k1_bytes(b, h, r, dk, dtype),
           flops((dtype, 4 * b * h * r * r * dk), (torch.float32, 2 * b * r * r * 64 * h)))
    log(f"[kernel] box_attention {dname}: bias build (geometry + linear + relu + clamp + log + fill) "
        f"ms={bias_ms:.4f} (in the same turns)")
    if dtype == torch.bfloat16 and timing:
        results["box_attention"]["bias_build_ms"] = bias_ms

    # K2 ancestry self-attention at the first, middle and last step (full cache), on a uniform and a collapsed
    # map; bf16 bit by bit: the score, its scaling and P rounded as the plain version
    q = rnd(n, h, dk)
    ck, cv = rnd(n, h, t_max, dk), rnd(n, h, t_max, dk)
    anc = torch.randint(0, BEAM, (b, BEAM, t_max), generator=gen, device=dev, dtype=torch.int32)

    def bits2(name, out, ref, share, far):
        nonlocal ok
        if dtype == torch.bfloat16:
            ok &= rounding_share(name, out, ref, share, far)

    compare2 = lambda *a, **kw: compare(*a, **kw)[0]  # noqa: E731
    err = check_k2_forward("ancestry_self_attention", q, ck, cv, anc, k2_roots(b), compare2, bits2)
    for t_long in K2_LONG_CACHES:  # more slots than lanes; at 250 more than a block stages at once
        nl = K2_LONG_IMAGES * BEAM
        ql, ckl, cvl = rnd(nl, h, dk), rnd(nl, h, t_long, dk), rnd(nl, h, t_long, dk)
        ancl = torch.randint(0, BEAM, (K2_LONG_IMAGES, BEAM, t_long), generator=gen, device=dev, dtype=torch.int32)
        check_k2_forward(f"ancestry_self_attention T_max={t_long}", ql, ckl, cvl, ancl, k2_roots(K2_LONG_IMAGES),
                         compare2, bits2, steps=(40, t_long - 1))
    # the SCST sampling decode's instance: the identity map (each row its own cache), f32 there, 64 x 15 rows
    ni = SCST_BATCHES[-1] * SCST_SAMPLES
    gi = k2_gen()
    qi, cki, cvi = (torch.randn(*shape, generator=gi, device=dev).to(dtype)
                    for shape in ((ni, h, dk), (ni, h, t_max, dk), (ni, h, t_max, dk)))
    check_k2_forward(f"ancestry_self_attention identity {ni}", qi, cki, cvi, None, None, compare2, bits2)
    del qi, cki, cvi
    # the block's shared memory (dk, bytes an element, t): the paths' caches, past a stage, the longest; and
    # the step from which the kernel stages (dk, bytes an element, kv, t), by the wrapper's rule
    ok &= smem_agrees("ancestry_self_attention", "sct_ancestry_self_attention_smem", k2.smem_bytes,
                      [(dk_, es_, t_) for dk_ in (64, 32, 13) for es_ in (2, 4) for t_ in (0, 16, 25, 59, 1023)])
    ok &= smem_agrees("ancestry_self_attention", "sct_ancestry_self_attention_staged",
                      lambda dk_, es_, kv_, t_: int(k2.staged(dk_, es_, bool(kv_), t_)),
                      [(dk_, es_, kv_, t_) for dk_ in (64, 32, 13) for es_ in (2, 4) for kv_ in (0, 1)
                       for t_ in range(0, 40, 3)])
    step = t_max - 1
    anc_t = k2_map(anc, "uniform", step)
    rows = (anc_t.long() + torch.arange(b, device=dev)[:, None, None] * BEAM).reshape(n, t_max)
    slots = torch.arange(t_max, device=dev)
    kg = ck.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous()  # physically reordered cache
    vg = cv.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous()
    q4 = q[:, :, None]
    # beams of one image share ancestors: the cache slots this data needs are
    # the distinct (ancestor row, slot) pairs, not N * T_max
    record("ancestry_self_attention", err,
           *turns(lambda: k2.ancestry_self_attention(q, ck, cv, anc_t, step),
                  lambda: k2.ancestry_self_attention_plain(q, ck, cv, anc_t, step),
                  lambda: F.scaled_dot_product_attention(q4, kg, vg)),
           k2_bytes(n, step, dtype, anc_t), flops((dtype, 4 * n * h * t_max * dk)))

    # K3 grouped cross-attention: beam rows share their image's memory K/V
    q = rnd(n, h, dk)
    mk, mv = rnd(b, h, r, dk), rnd(b, h, r, dk)
    mask = random_region_mask(gen, b, r, dev)
    no_mask = torch.ones_like(mask)
    out3, ref3 = k3.grouped_cross_attention(q, mk, mv, mask), k3.grouped_cross_attention_plain(q, mk, mv, mask)
    err, _ = compare("grouped_cross_attention", out3, ref3, rms(mv),
                     fault=k3.grouped_cross_attention_plain(q, mk, mv, no_mask))  # padding attended
    compare("grouped_cross_attention mem_v=None", k3.grouped_cross_attention(q, mk, None, mask),
            k3.grouped_cross_attention_plain(q, mk, None, mask), rms(mk))
    if dtype == torch.bfloat16:  # bit by bit: scores, their scaling, P and the output rounded as the plain version
        ok &= rounding_share("grouped_cross_attention out", out3, ref3, K3_SHARE_LIMIT, K3_FAR_LIMIT)
        ok &= smem_agrees("grouped_cross_attention", "sct_grouped_cross_attention_smem",
                          lambda dk_, s_, rep_, kv_: k3.bf16_smem(s_, rep_, bool(kv_), dk_),
                          [(64, REGIONS, BEAM, kv_) for kv_ in (0, 1)] + [
                              (64, REGIONS, BEAM_WIDTHS[-1], 0), (64, 64, 300, 0), (64, 64, 300, 1),
                              (64, REGIONS, 800, 0), (64, REGIONS, 800, 1)])
    del out3, ref3
    # the SCST sampling group (15 samples an image), a wide beam (40: three
    # 16-row tiles) and 33 regions (region flags read from device memory, not
    # staged), 64 images, image 0 with every region padded (uniform weights);
    # inputs of their own generator
    g3 = torch.Generator(device=dev).manual_seed(SEED + 3)
    for rep_, rx in ((SCST_SAMPLES, r), (BEAM_WIDTHS[-1], r), (BEAM, 33)):
        bx = SCST_BATCHES[-1]
        qx = torch.randn(bx * rep_, h, dk, generator=g3, device=dev).to(dtype)
        kx, vx = (torch.randn(bx, h, rx, dk, generator=g3, device=dev).to(dtype) for _ in range(2))
        mx = random_region_mask(g3, bx, rx, dev)
        mx[0] = False
        ox, px = k3.grouped_cross_attention(qx, kx, vx, mx), k3.grouped_cross_attention_plain(qx, kx, vx, mx)
        tag = f"{bx}x{rep_}" + ("" if rx == r else f" S={rx}")
        compare(f"grouped_cross_attention {tag}", ox, px, rms(vx))
        if dtype == torch.bfloat16:
            ok &= rounding_share(f"grouped_cross_attention {tag} out", ox, px, K3_SHARE_LIMIT, K3_FAR_LIMIT)
        uniform = (ox[:rep_].float() - vx[0].float().mean(1)[None]).abs().max().item()
        log(f"[kernel] grouped_cross_attention {tag} {dname}: all-padded image, output - mean(v) max {uniform:.3e}")
        if rep_ == SCST_SAMPLES and timing:
            t_k, t_p = turns_ms(lambda: k3.grouped_cross_attention(qx, kx, vx, mx),
                                lambda: k3.grouped_cross_attention_plain(qx, kx, vx, mx))
            log(f"[kernel] grouped_cross_attention {dname} at the SCST sampling shape {bx}x{rep_}: ms={t_k:.4f} "
                f"plain_ms={t_p:.4f} bound_ms={bound_ms(k3_bytes(bx, rep_, dtype), {})[0]:.4f} (held windows in turns)")
            if dtype == torch.float32:  # the SCST sampling decode's dtype: into the JSON line with the bf16 row
                results["grouped_cross_attention_scst_f32"] = dict(scst_f32_ms=t_k, scst_f32_plain_ms=t_p)
        del qx, kx, vx, ox, px
    qg = q.reshape(b, BEAM, h, dk).transpose(1, 2)  # (B, h, K, dk): the beams as query rows
    cross_mask = torch.zeros(b, 1, 1, r, device=dev, dtype=dtype).masked_fill(~mask[:, None, None, :], NEG_INF)
    record("grouped_cross_attention", err,
           *turns(lambda: k3.grouped_cross_attention(q, mk, mv, mask),
                  lambda: k3.grouped_cross_attention_plain(q, mk, mv, mask),
                  lambda: F.scaled_dot_product_attention(qg, mk, mv, attn_mask=cross_mask)),
           k3_bytes(b, BEAM, dtype),
           flops((dtype, 4 * n * h * r * dk)))
    if timing and dtype == torch.bfloat16 and "grouped_cross_attention_scst_f32" in results:
        results["grouped_cross_attention"].update(results.pop("grouped_cross_attention_scst_f32"))

    # K4 beam top-k with every constraint on: the serving beam and wider
    # beams (register lists of 16 and 32, and the radix-select variant)
    logits = rnd(n, vocab)
    kw = k4_constraints(gen, n, vocab)
    logits[1] = 0  # every entry ties: the lowest indices win
    logits[2, : 3 * BEAM_WIDTHS[-1]] = 8  # more ties at the top than the widest beam takes
    # rows 3, 4, ...: n equal top logits spread over the row, with a log-sum
    # next to a bf16 midpoint (k4_midpoint_counts), so that a log-prob formed
    # in another order than K13's moves by one bf16 ulp
    for row, count in enumerate(k4_midpoint_counts(vocab), start=3):
        logits[row] = K4_MIDPOINT_TOP - 200
        logits[row, torch.arange(count, device=dev) * (vocab // count)] = K4_MIDPOINT_TOP
    good, err_k = check_beam_topk(logits, kw, dtype)
    ok &= good
    if dtype == torch.bfloat16:  # the held path's bf16 threshold margin: a tie below the bare threshold
        margin = k4_margin_rows(64, vocab, dev)
        got, want = k4.beam_topk(margin, BEAM), k4.beam_topk_plain(margin, BEAM)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"[kernel] beam_topk bf16, ties below the bare threshold (k4_margin_rows, 64 rows): values, indices and "
            f"raw log-probs equal the plain version's {'ok' if same else 'FAIL'}")
        ok &= same
        del margin
    # the general paths: rows that are not 16-byte vectors (V = 9,999)
    g4 = torch.Generator(device=dev).manual_seed(SEED + 4)
    off = torch.randn(OFF_ROWS, K4_OFF_WIDTH, generator=g4, device=dev).to(dtype)
    ok &= check_beam_topk(off, k4_constraints(g4, OFF_ROWS, K4_OFF_WIDTH), dtype, f" V={K4_OFF_WIDTH}")[0]
    del off
    record("beam_topk", err_k,
           *turns(lambda: k4.beam_topk(logits, BEAM, **kw), lambda: k4.beam_topk_plain(logits, BEAM, **kw),
                  lambda: torch.topk(torch.log_softmax(logits, dim=-1), BEAM)),
           k4_bytes(n, vocab, BEAM, dtype),
           flops((torch.float32, 4 * n * vocab)))
    # Up-Down's serving step: 1024 images x beam 5 rows
    n_ud = UPDOWN_BATCHES[-1] * BEAM
    ud_logits, ud_kw = logits[:n_ud], {key: val[:n_ud] if torch.is_tensor(val) else val for key, val in kw.items()}
    if timing:
        t_k, t_p, t_l = turns_ms(lambda: k4.beam_topk(ud_logits, BEAM, **ud_kw),
                                 lambda: k4.beam_topk_plain(ud_logits, BEAM, **ud_kw),
                                 lambda: torch.topk(torch.log_softmax(ud_logits, dim=-1), BEAM))
        log(f"[kernel] beam_topk {dname} at Up-Down's N={n_ud}: ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
            f"bound_ms={bound_ms(k4_bytes(n_ud, vocab, BEAM, dtype), {})[0]:.4f} (held windows in turns)")
        if dtype == torch.bfloat16:
            results["beam_topk"].update(updown_ms=t_k, updown_plain_ms=t_p, updown_library_ms=t_l)
    return ok


def masked_shapes(layers: int = PAPER["num_layers"]) -> list:
    """(out, in) shapes of the masked tensors of the paper-width ORT, in call
    order: 105 at the paper's 6 layers, 139 at 8."""
    d, ff, v, h = PAPER["d_model"], PAPER["dim_feedforward"], PAPER["vocab_size"], HEADS
    enc = [(d, d)] * 3 + [(h, 64), (d, d), (ff, d), (d, ff)]
    dec = [(d, d)] * 8 + [(ff, d), (d, ff)]
    return [(d, PAPER["att_feat_size"])] + enc * layers + [(v, d)] + dec * layers + [(v, d)]


def updown_masked_shapes() -> tuple:
    """(out, in) shapes of the paper-width Up-Down's masked tensors, in call
    order: (the encode's 3, one unrolled step's 8)."""
    r, e, a, v = UPDOWN["rnn_size"], UPDOWN["input_encoding_size"], UPDOWN["att_hid_size"], UPDOWN["vocab_size"]
    enc = [(r, UPDOWN["fc_feat_size"]), (r, UPDOWN["att_feat_size"]), (a, r)]
    step = [(v, e), (4 * r, 2 * r + e), (4 * r, r), (a, r), (1, a), (4 * r, 2 * r), (4 * r, r), (v, r)]
    return enc, step


def ort_step_shapes(layers: int = PAPER["num_layers"]) -> list:
    """(out, in) shapes of the masked tensors one decode step of the
    paper-width ORT draws (the embedding, each layer's q, k, v, out and the
    cross q, out, its FFN, the generator): 50 tensors, 32,260,096 weights."""
    d, ff, v = PAPER["d_model"], PAPER["dim_feedforward"], PAPER["vocab_size"]
    return [(v, d)] + ([(d, d)] * 6 + [(ff, d), (d, ff)]) * layers + [(v, d)]


def leaves(*ts):
    return [t.detach().clone().requires_grad_() for t in ts]


def check_supermask_kernels(gen, dtype, results: dict, timing: bool = True) -> bool:
    """K5 against its plain version (autograd), each set in one launch each
    way: the ORT's 105 masked tensors (inputs from `gen`), Up-Down's encode
    set (3 tensors) and unrolled step's set (8), and a set of off shapes
    (the shapes of wg and alpha_net at storage off the 16-byte boundary, 91
    weights: a tail of 3; in every mode, bypass on and off, one output that
    no loss reaches) on inputs of their own generator; w_eff and dw exact,
    dm element-wise, a planted fault (the round mode in place of the
    sample). With `timing`: the set, the same tensors one set each, and the
    plain version in held turns, and the Up-Down XE step's K5 time (17 step
    sets and 1 encode set) against its bound. The keyed mode (supermask
    SCST) on the ORT's decode-step set (50 tensors) and Up-Down's
    step set (8) of their own generator: w_eff, dw and dm bit for bit against
    the plain version (the same Philox in int64 torch arithmetic, then the
    sample mode's plain arithmetic), the same (key, site, t) twice the same
    samples, two steps different samples, and a planted fault (the step
    ignored: t = 0 for t = 3) caught; timed against the sample mode given
    the same uniforms as tensors."""
    from sparse_caption_tpu_torch.kernels import supermask as k5

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    turns = turns_ms if timing else no_turns
    ok = True

    def draw(g, shapes, unaligned=()):
        """w, m, u, g for each shape; the tensors at the indices in `unaligned`
        start one element past an allocation's 16-byte boundary."""
        def make(sh, i, fn, dt):
            if i not in unaligned:
                return fn(*sh, generator=g, device=dev).to(dt)
            n = math.prod(sh)
            return fn(n + 1, generator=g, device=dev).to(dt)[1:].view(sh)
        return ([make(sh, i, torch.randn, dtype) for i, sh in enumerate(shapes)],
                [make(sh, i, torch.randn, torch.float32) * 2.0 for i, sh in enumerate(shapes)],
                [make(sh, i, torch.rand, torch.float32) for i, sh in enumerate(shapes)],
                [make(sh, i, torch.randn, dtype) for i, sh in enumerate(shapes)])

    def plain_set(ws, ms, us, mode, bypass):
        return [k5.supermask_weight_plain(w, m, None if us is None else us[i], mode, bypass)
                for i, (w, m) in enumerate(zip(ws, ms))]

    def run(fn, ws, ms, us, gs, mode="sample", bypass=False, unused_last=False):
        """(w_effs, dws, dms) of one set; with `unused_last` no loss reaches
        the last output, whose w and m then get no gradient (None)."""
        wl = [w.detach().requires_grad_() for w in ws]  # views keep their storage offset
        ml = [m.detach().requires_grad_() for m in ms]
        outs = fn(wl, ml, us if mode in ("sample", "keyed") else None, mode, bypass)
        used = len(outs) - 1 if unused_last else len(outs)
        grads = torch.autograd.grad(outs[:used], wl + ml, gs[:used], allow_unused=True)
        return [o.detach() for o in outs], grads[:len(ws)], grads[len(ws):]

    def flat(ts):
        return torch.cat([t.flatten() for t in ts if t is not None])

    def held(tag, ws, ms, us, gs, fault=True, **kw):
        nonlocal ok
        ko, kdw, kdm = run(k5.supermask_weights, ws, ms, us, gs, **kw)
        po, pdw, pdm = run(plain_set, ws, ms, us, gs, **kw)
        if kw.get("unused_last"):
            none = kdw[-1] is None and kdm[-1] is None
            log(f"[kernel] supermask {tag} {dname}: the output no loss reaches gives no gradient={none}")
            ok &= none
        for nm, kt, pt in (("w_eff", ko, po), ("dw", kdw, pdw)):
            kt, pt = flat(kt), flat(pt)
            same = bool(torch.equal(kt, pt))
            log(f"[kernel] supermask {tag} {nm} {dname}: {'exact' if same else 'DIFFERS'} "
                f"({int((kt != pt).sum())} of {pt.numel()} elements differ)")
            ok &= same
        kdm, pdm = flat(kdm), flat(pdm)
        err, good, worst = close(kdm, pdm, torch.float32)
        log(f"[kernel] supermask {tag} dm (f32) {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        if fault:  # the round mode in place of the sample
            fo = flat(run(plain_set, ws, ms, None, gs, mode="round")[0])
            n_diff = int((fo != flat(po)).sum())
            log(f"[fault] supermask {tag} w_eff {dname}: {n_diff} of {fo.numel()} elements differ "
                f"{'caught' if n_diff else 'MISSED'}")
            ok &= n_diff > 0
        return 0.0 if good else err, flat(ko).ne(0).float().mean().item()

    def times(ws, ms, us, gs):
        """(set, one set a tensor, plain) ms, forward + backward in mode sample."""
        mode = k5.MODES["sample"]
        bit_units = k5.unit_offsets([w.numel() for w in ws])[:-1]

        def set_kernels():
            _, bits = k5.launch_forward(ws, ms, us, mode)
            k5.launch_backward(gs, ws, ms, bits, bit_units, mode, False)

        def tensor_kernels():
            for w, m, u, g in zip(ws, ms, us, gs):
                _, bits = k5.launch_forward([w], [m], [u], mode)
                k5.launch_backward([g], [w], [m], bits, [0], mode, False)

        plain_leaves = [leaves(w, m) for w, m in zip(ws, ms)]

        def plain():
            for (w, m), u, g in zip(plain_leaves, us, gs):
                torch.autograd.grad(k5.supermask_weight_plain(w, m, u), (w, m), g)

        return turns(set_kernels, tensor_kernels, plain)

    # the ORT's set: every masked tensor of one XE step
    shapes = masked_shapes()
    assert len(shapes) == 105, len(shapes)
    n_el = sum(a * b for a, b in shapes)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    ws = [rnd(*sh) for sh in shapes]
    ms = [torch.randn(*sh, generator=gen, device=dev) * 2.0 for sh in shapes]
    us = [torch.rand(*sh, generator=gen, device=dev) for sh in shapes]
    gs = [rnd(*sh) for sh in shapes]
    err, kept = held("ORT set", ws, ms, us, gs)
    log(f"[kernel] supermask: {len(shapes)} tensors, {n_el} weights, kept share {kept:.3f}")
    t_set, t_tensor, t_plain = times(ws, ms, us, gs)
    bnd, by = bound_ms(k5_bytes(n_el, dtype), {})
    log(f"[kernel] supermask {dname} ORT set: ms={t_set:.4f} (one set a tensor: {t_tensor:.4f}) plain_ms={t_plain:.4f} "
        f"library_ms=null bound_ms={bnd:.4f} ({by}; held windows in turns)")
    if dtype == torch.bfloat16:
        results["supermask"] = dict(max_abs_err=err, ms=t_set, plain_ms=t_plain, library_ms=None, bound_ms=bnd,
                                    bound_by=by, per_tensor_ms=t_tensor)
    del ws, ms, us, gs

    # Up-Down's sets (fresh samples on every call: the encode's 3 tensors,
    # then 8 per unrolled step) and the off shapes, on inputs of their own generator
    g5 = torch.Generator(device=dev).manual_seed(SEED + 5)
    enc_shapes, step_shapes = updown_masked_shapes()
    ud = {}
    for tag, set_shapes in (("encode", enc_shapes), ("step", step_shapes)):
        sw, sm, su, sg = draw(g5, set_shapes)
        held(f"Up-Down {tag} set", sw, sm, su, sg)
        n_set = sum(a * b for a, b in set_shapes)
        t_set, t_tensor, t_plain = times(sw, sm, su, sg)
        bnd = bound_ms(k5_bytes(n_set, dtype), {})[0]
        log(f"[kernel] supermask {dname} Up-Down {tag} set ({len(set_shapes)} tensors, {n_set} weights): "
            f"ms={t_set:.4f} (one set a tensor: {t_tensor:.4f}) plain_ms={t_plain:.4f} bound_ms={bnd:.4f} "
            f"(bytes; held windows in turns)")
        ud[tag] = (t_set, t_tensor, t_plain, bnd)
        del sw, sm, su, sg
    if timing:
        total = {key: MAX_LEN * ud["step"][i] + ud["encode"][i] for i, key in enumerate(("ms", "per_tensor_ms",
                                                                                        "plain_ms", "bound_ms"))}
        log(f"[kernel] supermask {dname} Up-Down XE step ({MAX_LEN} step sets + 1 encode set): {total['ms']:.4f} ms "
            f"(one set a tensor: {total['per_tensor_ms']:.4f}) against a bound of {total['bound_ms']:.4f} "
            f"(loss {total['ms'] - total['bound_ms']:.4f} ms)")
        if dtype == torch.bfloat16:
            results["supermask"].update({f"updown_{tag}_{key}": val for tag, vals in ud.items()
                                         for key, val in zip(("ms", "per_tensor_ms", "plain_ms", "bound_ms"), vals)})
            results["supermask"].update({f"updown_xe_step_{key}": val for key, val in total.items()})
    # wg's and alpha_net's shapes unaligned; the raw geometry's (h, 4) wg
    off = [(HEADS, 64), (1, UPDOWN["att_hid_size"]), (7, 13), (HEADS, 4), (64, 64)]
    sw, sm, su, sg = draw(g5, off, unaligned=(0, 1))
    for mode in ("sample", "round", "multiply"):
        for bypass in (False, True):
            mm = [(m > 0).float() for m in sm] if mode == "multiply" else sm
            held(f"off shapes {mode}{' bypass' if bypass else ''}", sw, mm, su, sg, fault=mode == "sample",
                 mode=mode, bypass=bypass, unused_last=True)
    ok &= check_keyed_supermask(dtype, results, timing, run, plain_set, flat, draw)
    return ok


def check_keyed_supermask(dtype, results: dict, timing: bool, run, plain_set, flat, draw) -> bool:
    """K5's keyed mode (see check_supermask_kernels), with its helpers."""
    from sparse_caption_tpu_torch.kernels import supermask as k5
    from sparse_caption_tpu_torch.ops.rng import site_id

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    ok = True
    gk = torch.Generator(device=dev).manual_seed(SEED + 15)
    key = 0xC0FFEE0123456789
    for tag, set_shapes in (("ORT decode-step", ort_step_shapes()), ("Up-Down step", updown_masked_shapes()[1])):
        sw, sm, _, sg = draw(gk, set_shapes)
        sites = [site_id(f"{tag}.{i}") for i in range(len(set_shapes))]

        def draws(t):
            return [k5.KeyedDraw(key, site, t) for site in sites]

        ko, kdw, kdm = run(k5.supermask_weights, sw, sm, draws(3), sg, mode="keyed")
        po, pdw, pdm = run(plain_set, sw, sm, draws(3), sg, mode="keyed")
        for nm, kt, pt in (("w_eff", ko, po), ("dw", kdw, pdw), ("dm", kdm, pdm)):
            kt, pt = flat(kt), flat(pt)
            same = bool(torch.equal(kt, pt))
            log(f"[kernel] supermask keyed {tag} set {nm} {dname}: {'exact' if same else 'DIFFERS'} "
                f"({int((kt != pt).sum())} of {pt.numel()} elements differ)")
            ok &= same
        again = flat(run(k5.supermask_weights, sw, sm, draws(3), sg, mode="keyed")[0])
        nxt = flat(run(k5.supermask_weights, sw, sm, draws(4), sg, mode="keyed")[0])
        fault = flat(run(plain_set, sw, sm, draws(0), sg, mode="keyed")[0])  # the step ignored
        ko = flat(ko)
        same_t, moved, caught = bool(torch.equal(again, ko)), float((nxt != ko).float().mean()), bool(
            (fault != ko).any())
        log(f"[kernel] supermask keyed {tag} set {dname}: {len(set_shapes)} tensors, kept share "
            f"{float(ko.ne(0).float().mean()):.3f}; the same (key, site, t) again "
            f"{'the same samples' if same_t else 'OTHER SAMPLES'}; step 4 against step 3: {moved:.3f} of the "
            f"weights differ {'ok' if moved > 0.1 else 'FAIL'}")
        log(f"[fault] supermask keyed {tag} {dname}, the step ignored: {'caught' if caught else 'MISSED'}")
        ok &= same_t and moved > 0.1 and caught
        if timing and tag.startswith("ORT"):
            n_set = sum(a * b for a, b in set_shapes)
            us = [d.uniform(sh, dev) for d, sh in zip(draws(3), set_shapes)]
            bit_units = k5.unit_offsets([w.numel() for w in sw])[:-1]

            def keyed():
                _, bits = k5.launch_forward(sw, sm, draws(3), k5.MODES["keyed"])
                k5.launch_backward(sg, sw, sm, bits, bit_units, k5.MODES["keyed"], False)

            def sampled():  # the sample mode, given the same uniforms as tensors
                _, bits = k5.launch_forward(sw, sm, us, k5.MODES["sample"])
                k5.launch_backward(sg, sw, sm, bits, bit_units, k5.MODES["sample"], False)

            plain_leaves = [leaves(w, m) for w, m in zip(sw, sm)]

            def plain():
                for (w, m), d, g, sh in zip(plain_leaves, draws(3), sg, set_shapes):
                    torch.autograd.grad(k5.supermask_weight_plain(w, m, d, "keyed"), (w, m), g)

            t_keyed, t_sample, t_plain = turns_ms(keyed, sampled, plain)
            bnd, by = bound_ms(k5_bytes(n_set, dtype, mode="keyed"), {})
            log(f"[kernel] supermask keyed {dname} {tag} set ({n_set} weights, fwd + bwd): ms={t_keyed:.4f} "
                f"(sample mode on the uniforms as tensors: {t_sample:.4f}, bound {bound_ms(k5_bytes(n_set, dtype), {})[0]:.4f}) "
                f"plain_ms={t_plain:.4f} library_ms=null bound_ms={bnd:.4f} ({by}; held windows in turns)")
            if dtype == torch.float32:  # supermask SCST runs in f32
                results["supermask keyed"] = dict(max_abs_err=0.0, ms=t_keyed, plain_ms=t_plain, library_ms=None,
                                                  bound_ms=bnd, bound_by=by, sample_mode_ms=t_sample)
            del us, plain_leaves
        del sw, sm, sg
    return ok


def check_train_kernels(gen, dtype, results: dict) -> bool:
    """K5 (``check_supermask_kernels``), K6, K1's train variant and K7 vs
    their plain versions (autograd) at the XE step's shapes; timings of
    forward + backward."""
    from sparse_caption_tpu_torch.kernels import add_ref_layernorm as k6
    from sparse_caption_tpu_torch.kernels import box_attention as k1
    from sparse_caption_tpu_torch.kernels import box_attention_bwd as k7
    from sparse_caption_tpu_torch.ops.attention import NEG_INF, box_relational_embedding

    dev = torch.device("cuda")
    es = ESIZE[dtype]
    dname = str(dtype).split(".")[-1]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    ok = True

    def compare(name, out, ref, scale=0.0, sum_scale=0.0, fault=None):
        nonlocal ok
        err, good, worst = close(out, ref, dtype, scale, sum_scale)
        log(f"[kernel] {name} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"median|ref|={ref.float().abs().median().item():.3e} scale={max(scale, sum_scale):.3f} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, dtype, scale, sum_scale)
        return err

    def record(name, err, ms, plain_ms, lib_ms, nbytes, ops):
        bnd, by = bound_ms(nbytes, ops)
        log(f"[kernel] {name} {dname}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms={bnd:.4f} ({by}; held windows in turns)")
        if dtype == torch.bfloat16:
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                                 bound_by=by)

    ok &= check_supermask_kernels(gen, dtype, results)

    # K6 residual + RefLayerNorm: the decoder's rows at the throughput batch
    rows, d = TRAIN_BIG_BATCH * SEQ_PER_IMG * MAX_LEN, PAPER["d_model"]
    x, y = rnd(rows, d), rnd(rows, d)
    a = (torch.rand(d, generator=gen, device=dev) + 0.5).to(dtype)
    bias = rnd(d)
    keep = torch.rand(rows, d, generator=gen, device=dev) < 0.9
    gs_, gn_ = rnd(rows, d), rnd(rows, d)

    def k6_run(fn):
        ins = leaves(x, y, a, bias)
        s_, n_ = fn(*ins, keep, 0.9)
        return (s_.detach(), n_.detach()), torch.autograd.grad((s_, n_), ins, (gs_, gn_))

    (ks, kn), kg = k6_run(k6.add_ref_layernorm)
    (ps, pn), pg = k6_run(k6.add_ref_layernorm_plain)
    err = compare("add_ref_layernorm s", ks, ps, rms(ps))
    fault_n = (F.layer_norm(ps.float(), (d,), a.float(), bias.float(), 1e-6).to(dtype) if dtype == torch.float32
               else k6.ref_layer_norm_plain(y, a, bias))  # biased variance (f32) / residual left out (bf16)
    err = max(err, compare("add_ref_layernorm n", kn, pn, rms(pn), fault=fault_n))
    sum_scale = (rows ** 0.5) * rms(gn_)
    for nm, kt, pt in zip(("dx", "dy"), kg[:2], pg[:2]):
        err = max(err, compare(f"add_ref_layernorm {nm}", kt, pt, rms(pt)))
    for nm, kt, pt in zip(("da", "db"), kg[2:], pg[2:]):
        err = max(err, compare(f"add_ref_layernorm {nm}", kt, pt, sum_scale=sum_scale))
    n_only = k6.add_ref_layernorm_plain(x, None, a, bias)
    compare("add_ref_layernorm norm only", k6.add_ref_layernorm(x, None, a, bias), n_only, rms(n_only))
    del x, y, keep, gs_, gn_, ks, kn, kg, ps, pn, pg  # K6's times: check_norm_softmax_kernels

    # K1 train variant + K7 at the throughput batch, attention dropout 0.1
    b, h, r, dk = TRAIN_BIG_BATCH, HEADS, REGIONS, DK
    q, k, v, dout = rnd(b, h, r, dk), rnd(b, h, r, dk), rnd(b, h, r, dk), rnd(b, h, r, dk)
    boxes = random_boxes(gen, b, r, dev)
    picks = torch.rand(h, 64, generator=gen, device=dev).argsort(dim=1)[:, :4]
    signs = torch.randint(0, 2, (h, 4), generator=gen, device=dev).float() * 2 - 1
    wg_w = torch.zeros(h, 64, device=dev).scatter_(1, picks, signs * 0.225).to(dtype)  # w_g in [0.1, 1.9]
    wg_b = torch.ones(h, device=dev).to(dtype)
    mask = random_region_mask(gen, b, r, dev)
    mask[0] = False  # an image with no valid region: every key averaged, dq and dk from the uniform rows
    keep = torch.rand(b, h, r, r, generator=gen, device=dev) < 0.9

    def k7_run(fn, keep_):
        ins = leaves(q, k, v, wg_w, wg_b)
        out = fn(ins[0], ins[1], ins[2], boxes, ins[3], ins[4], mask, keep_, 0.9)
        return out.detach(), torch.autograd.grad(out, ins, dout)

    kout, kg = k7_run(k7.box_attention_train, keep)
    pout, pg = k7_run(k1.box_attention_plain, keep)
    fout, fg = k7_run(k1.box_attention_plain, None)  # fault: keep-mask ignored
    compare("box_attention train fwd", kout, pout, rms(v), fault=fout)
    err = 0.0
    # the plain version rounds dP = dO.V^T and dS to bf16 before the 36-term
    # products that make dq, dk, dv, so its error follows the largest gradient
    # rows: s = max |ref| for these three
    for i, nm in enumerate(("dq", "dk", "dv")):
        err = max(err, compare(f"box_attention_bwd {nm}", kg[i], pg[i], pg[i].float().abs().max().item(),
                               fault=fg[i] if nm == "dq" else None))
    for i, nm in ((3, "d wg_w"), (4, "d wg_b")):
        ref = pg[i]
        err = max(err, compare(f"box_attention_bwd {nm}", kg[i], ref, sum_scale=ref.float().abs().max().item(),
                               fault=torch.zeros_like(ref) if nm == "d wg_w" else None))  # fault: wg gradient dropped
    for i, nm in enumerate(("dq", "dk", "dv")):
        err0 = (kg[i][0].float() - pg[i][0].float()).abs().max().item()
        log(f"[kernel] box_attention_bwd {nm} {dname}: image 0 (no valid region) max_abs_err={err0:.3e}")
    if dtype == torch.bfloat16:
        bits_ok = rounding_share("box_attention train fwd", kout, pout, K1_SHARE_LIMIT, K1_FAR_LIMIT)
        for i, nm in enumerate(("dq", "dk", "dv")):
            bits_ok &= rounding_share(f"box_attention_bwd {nm}", kg[i], pg[i], K7_SHARE_LIMIT, K7_FAR_LIMIT)
        ok &= bits_ok
    ins_k = leaves(q, k, v, wg_w, wg_b)
    out_k = k7.box_attention_train(ins_k[0], ins_k[1], ins_k[2], boxes, ins_k[3], ins_k[4], mask, keep, 0.9)
    ins_p = leaves(q, k, v, wg_w, wg_b)
    out_p = k1.box_attention_plain(ins_p[0], ins_p[1], ins_p[2], boxes, ins_p[3], ins_p[4], mask, keep, 0.9)
    geo = box_relational_embedding(boxes)
    log_bias = torch.log(torch.clamp(torch.relu(F.linear(geo.to(dtype), wg_w, wg_b)), min=1e-6)).permute(0, 3, 1, 2)
    float_mask = log_bias.masked_fill(~mask[:, None, None, :], NEG_INF).to(dtype).contiguous()
    ins_l = leaves(q, k, v)
    out_l = F.scaled_dot_product_attention(*ins_l, attn_mask=float_mask)
    with torch.no_grad():
        fwd_ms, fwd_plain_ms, fwd_lib_ms = turns_ms(
            lambda: k7.box_attention_train(q, k, v, boxes, wg_w, wg_b, mask, keep, 0.9),
            lambda: k1.box_attention_plain(q, k, v, boxes, wg_w, wg_b, mask, keep, 0.9),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask))
    log(f"[kernel] box_attention train fwd {dname}: ms={fwd_ms:.4f} plain_ms={fwd_plain_ms:.4f} "
        f"library_ms={fwd_lib_ms:.4f} (SDPA, float bias given; held windows in turns)")
    record("box_attention_bwd", err,
           *turns_ms(lambda: torch.autograd.grad(out_k, ins_k, dout, retain_graph=True),
                     lambda: torch.autograd.grad(out_p, ins_p, dout, retain_graph=True),
                     lambda: torch.autograd.grad(out_l, ins_l, dout, retain_graph=True)),
           k7_bytes(b, h, r, dk, dtype),
           flops((dtype, 5 * 2 * b * h * r * r * dk), (torch.float32, 2 * 2 * b * r * r * 64 * h)))
    if dtype == torch.bfloat16:
        results["box_attention"]["train_fwd_ms"] = fwd_ms

    # K1's train variant and K7 at small R, where K7's fold of the d wg partials
    # needs more shared memory than its tiles, and at 16 heads; w_g in [0.1, 1.9]
    # as above (near relu's kink d wg follows 1 / w_g, and the order of the
    # geometry's 64-term dot alone moves it past the f32 tolerance)
    for hs, rs in ((HEADS, 8), (16, 12)):
        bs = 64
        q, k, v, dout = rnd(bs, hs, rs, dk), rnd(bs, hs, rs, dk), rnd(bs, hs, rs, dk), rnd(bs, hs, rs, dk)
        boxes = random_boxes(gen, bs, rs, dev)
        picks = torch.rand(hs, 64, generator=gen, device=dev).argsort(dim=1)[:, :4]
        signs = torch.randint(0, 2, (hs, 4), generator=gen, device=dev).float() * 2 - 1
        wg_w = torch.zeros(hs, 64, device=dev).scatter_(1, picks, signs * 0.225).to(dtype)
        wg_b = torch.ones(hs, device=dev).to(dtype)
        mask = torch.arange(rs, device=dev)[None] < torch.randint(1, rs + 1, (bs, 1), generator=gen, device=dev)
        mask[0] = False
        keep = torch.rand(bs, hs, rs, rs, generator=gen, device=dev) < 0.9
        kout, kg = k7_run(k7.box_attention_train, keep)
        pout, pg = k7_run(k1.box_attention_plain, keep)
        tag = f"h={hs} R={rs}"
        compare(f"box_attention train fwd {tag}", kout, pout, rms(v))
        for i, nm in enumerate(("dq", "dk", "dv")):
            compare(f"box_attention_bwd {nm} {tag}", kg[i], pg[i], pg[i].float().abs().max().item())
        for i, nm in ((3, "d wg_w"), (4, "d wg_b")):
            compare(f"box_attention_bwd {nm} {tag}", kg[i], pg[i], sum_scale=pg[i].float().abs().max().item())
    return ok


def bounded_wg(gen, h: int, dtype):
    """A wg projection (h, 64) with 4 entries of +-0.225 a head and a bias of
    1: w_g = relu(wg . geo + 1) lies in [0.1, 1.9], away from relu's kink
    (see check_kernels)."""
    dev = torch.device("cuda")
    picks = torch.rand(h, 64, generator=gen, device=dev).argsort(dim=1)[:, :4]
    signs = torch.randint(0, 2, (h, 4), generator=gen, device=dev).float() * 2 - 1
    return (torch.zeros(h, 64, device=dev).scatter_(1, picks, signs * 0.225).to(dtype),
            torch.ones(h, device=dev).to(dtype))


def check_acort_kernels(gen, dtype, results: dict, timing: bool = True) -> bool:
    """The kv modes of K1 (eval and train variant), K7, K2 and K3 (ACORT's
    kv-shared layers: one tensor is K and V) against their plain versions
    called with that tensor as K and V, at ACORT-base's shapes (serving: B =
    2048 images x beam 5, 36 regions, 8 heads of 64, a 26-slot cache; XE:
    256 x 5 captions), element-wise, and in bf16 bit by bit
    (`rounding_share`); each kv mode also bit-equal to the unshared kernel
    given the one tensor twice (the same arithmetic, the rows read once), K2
    also at the long caches (past the staged slots of its shared memory), K3
    at the SCST group, a wide beam and 33 regions, and its shared memory
    against the wrapper's; each with a planted fault. K4 at V = 771 (the
    radix vocabulary: not whole 16-byte vectors, eos 770, unk 1, a digit) and
    K13 at V = 771 over the XE rows, as in check_kernels and
    check_norm_softmax_kernels; K14 / K15's kv modes at ACORT's XE shape (26
    positions: two 16-row tiles, the second part padding) by
    `check_decoder_kv`. With `timing`, the bf16 times: each kv mode, the
    unshared kernel on the tensor passed twice, the plain version and one
    library call, in held turns, beside the bound with the shared rows
    counted once."""
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import beam_topk as k4
    from sparse_caption_tpu_torch.kernels import box_attention as k1
    from sparse_caption_tpu_torch.kernels import box_attention_bwd as k7
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
    from sparse_caption_tpu_torch.kernels import vocab_log_softmax as k13
    from sparse_caption_tpu_torch.ops.attention import NEG_INF, box_relational_embedding

    dev = torch.device("cuda")
    es = ESIZE[dtype]
    dname = str(dtype).split(".")[-1]
    b, n, r, h, dk = BIG_BATCH, BIG_BATCH * BEAM, REGIONS, HEADS, DK
    t_max, vocab = ACORT_LEN, ACORT_BASE["vocab_size"]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    turns = turns_ms if timing else no_turns
    ok = True

    def compare(name, out, ref, scale=0.0, sum_scale=0.0, fault=None):
        """Element-wise, with the bound of the output's dtype."""
        nonlocal ok
        err, good, worst = close(out, ref, out.dtype, scale, sum_scale)
        log(f"[kernel] {name} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"median|ref|={ref.float().abs().median().item():.3e} scale={max(scale, sum_scale):.3f} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, out.dtype, scale, sum_scale)
        return err

    def same(name, a, b_):
        nonlocal ok
        equal = bool(torch.equal(a, b_))
        log(f"[kernel] {name} {dname}: bit-equal to the unshared kernel given the tensor twice={equal} "
            f"{'ok' if equal else 'FAIL'}")
        ok &= equal

    def bits(name, out, ref, share, far):
        nonlocal ok
        if dtype == torch.bfloat16:
            ok &= rounding_share(name, out, ref, share, far)

    def record(key, err, times, nbytes, ops, lib_note):
        if not timing:
            return
        ms, unshared_ms, plain_ms, lib_ms = times
        bnd, by = bound_ms(nbytes, ops)
        log(f"[kernel] {key} {dname}: ms={ms:.4f} unshared_ms={unshared_ms:.4f} (the tensor passed twice) "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} ({lib_note}) bound_ms={bnd:.4f} ({by}, shared rows "
            f"counted once; held windows in turns)")
        if dtype == torch.bfloat16:
            results[key] = dict(max_abs_err=err, ms=ms, unshared_ms=unshared_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bnd, bound_by=by)

    # K1 kv mode at ACORT serving: one tensor kv is K and V
    q, kv = rnd(b, h, r, dk), rnd(b, h, r, dk)
    boxes = random_boxes(gen, b, r, dev)
    wg_w, wg_b = bounded_wg(gen, h, dtype)
    mask = random_region_mask(gen, b, r, dev)
    mask[0] = False
    out = k1.box_attention(q, kv, None, boxes, wg_w, wg_b, mask)
    ref = k1.box_attention_plain(q, kv, None, boxes, wg_w, wg_b, mask)
    err = compare("box_attention kv", out, ref, rms(kv),
                  fault=k1.box_attention_plain(q, kv, q, boxes, wg_w, wg_b, mask))  # V read from another tensor
    same("box_attention kv", out, k1.box_attention(q, kv, kv, boxes, wg_w, wg_b, mask))
    bits("box_attention kv out", out, ref, K1_SHARE_LIMIT, K1_FAR_LIMIT)
    bias = k1.box_log_bias_plain(boxes, wg_w, wg_b, dtype)
    float_mask = bias.masked_fill(~mask[:, None, None, :], NEG_INF).to(dtype).contiguous()
    record("box_attention kv", err,
           turns(lambda: k1.box_attention(q, kv, None, boxes, wg_w, wg_b, mask),
                 lambda: k1.box_attention(q, kv, kv, boxes, wg_w, wg_b, mask),
                 lambda: k1.box_attention_plain(q, kv, None, boxes, wg_w, wg_b, mask),
                 lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=float_mask)),
           3 * b * h * r * dk * es + b * r * 4 * 4 + b * r + h * 65 * es,
           flops((dtype, 4 * b * h * r * r * dk), (torch.float32, 2 * b * r * r * 64 * h)), "SDPA, float bias given")
    del q, kv, out, ref, bias, float_mask

    # K1's train variant and K7 in their kv modes at the XE throughput batch, attention dropout 0.1
    bt = TRAIN_BIG_BATCH
    q, kv, dout = rnd(bt, h, r, dk), rnd(bt, h, r, dk), rnd(bt, h, r, dk)
    boxes = random_boxes(gen, bt, r, dev)
    wg_w, wg_b = bounded_wg(gen, h, dtype)
    mask = random_region_mask(gen, bt, r, dev)
    mask[0] = False
    keep = torch.rand(bt, h, r, r, generator=gen, device=dev) < 0.9

    def k7_run(fn, v_of=lambda kv_: None):
        ins = leaves(q, kv, wg_w, wg_b)
        o = fn(ins[0], ins[1], v_of(ins[1]), boxes, ins[2], ins[3], mask, keep, 0.9)
        return o.detach(), torch.autograd.grad(o, ins, dout)

    kout, kg = k7_run(k7.box_attention_train)
    uout, ug = k7_run(k7.box_attention_train, lambda kv_: kv_)  # the unshared kernels, autograd adds dk + dv
    pout, pg = k7_run(k1.box_attention_plain)
    _, fg = k7_run(k1.box_attention_plain, lambda kv_: kv_.detach())  # fault: dV left out of dKV
    err = compare("box_attention train kv fwd", kout, pout, rms(kv))
    err = max(err, compare("box_attention_bwd kv dq", kg[0], pg[0], pg[0].float().abs().max().item()),
              compare("box_attention_bwd kv dkv", kg[1], pg[1], pg[1].float().abs().max().item(), fault=fg[1]))
    for i, nm in ((2, "d wg_w"), (3, "d wg_b")):
        err = max(err, compare(f"box_attention_bwd kv {nm}", kg[i], pg[i], sum_scale=pg[i].float().abs().max().item()))
    same("box_attention train kv fwd", kout, uout)
    for i, nm in enumerate(("dq", "dkv", "d wg_w", "d wg_b")):
        same(f"box_attention_bwd kv {nm}", kg[i], ug[i])
    bits("box_attention train kv fwd", kout, pout, K1_SHARE_LIMIT, K1_FAR_LIMIT)
    bits("box_attention_bwd kv dq", kg[0], pg[0], K7_SHARE_LIMIT, K7_FAR_LIMIT)
    bits("box_attention_bwd kv dkv", kg[1], pg[1], K7_SHARE_LIMIT, K7_FAR_LIMIT)
    geo = box_relational_embedding(boxes)
    log_bias = torch.log(torch.clamp(torch.relu(F.linear(geo.to(dtype), wg_w, wg_b)), min=1e-6)).permute(0, 3, 1, 2)
    float_mask = log_bias.masked_fill(~mask[:, None, None, :], NEG_INF).to(dtype).contiguous()
    graphs = []
    for fn, v_of in ((k7.box_attention_train, lambda kv_: None), (k7.box_attention_train, lambda kv_: kv_),
                     (k1.box_attention_plain, lambda kv_: None)):
        ins = leaves(q, kv, wg_w, wg_b)
        graphs.append((fn(ins[0], ins[1], v_of(ins[1]), boxes, ins[2], ins[3], mask, keep, 0.9), ins))
    ins_l = leaves(q, kv)
    graphs.append((F.scaled_dot_product_attention(ins_l[0], ins_l[1], ins_l[1], attn_mask=float_mask), ins_l))
    if timing:
        with torch.no_grad():
            fwd = turns_ms(lambda: k7.box_attention_train(q, kv, None, boxes, wg_w, wg_b, mask, keep, 0.9),
                           lambda: k7.box_attention_train(q, kv, kv, boxes, wg_w, wg_b, mask, keep, 0.9))
        log(f"[kernel] box_attention train kv fwd {dname}: ms={fwd[0]:.4f} unshared_ms={fwd[1]:.4f} "
            f"(held windows in turns)")
    record("box_attention_bwd kv", err,
           turns(*(lambda o=o, i=i: torch.autograd.grad(o, i, dout, retain_graph=True) for o, i in graphs)),
           5 * bt * h * r * dk * es + bt * h * r * r + bt * r * 16 + bt * r + 2 * h * 65 * es,
           flops((dtype, 5 * 2 * bt * h * r * r * dk), (torch.float32, 2 * 2 * bt * r * r * 64 * h)),
           "SDPA backward, float bias given")
    if timing and dtype == torch.bfloat16:
        results["box_attention_bwd kv"].update(train_fwd_ms=fwd[0], train_fwd_unshared_ms=fwd[1])
    del q, kv, dout, kg, ug, pg, fg, graphs, ins_l, keep

    # K2 kv mode: one cache array, at the first, middle and last step of ACORT's 26 on both maps, then the long
    # caches (at 250 bf16 slots more than a block stages at once)
    q = rnd(n, h, dk)
    cache = rnd(n, h, t_max, dk)
    anc = torch.randint(0, BEAM, (b, BEAM, t_max), generator=gen, device=dev, dtype=torch.int32)
    err = check_k2_forward("ancestry_self_attention kv", q, cache, None, anc, k2_roots(b), compare, bits, same)
    for t_long in K2_LONG_CACHES:
        nl = K2_LONG_IMAGES * BEAM
        ql, cl = rnd(nl, h, dk), rnd(nl, h, t_long, dk)
        ancl = torch.randint(0, BEAM, (K2_LONG_IMAGES, BEAM, t_long), generator=gen, device=dev, dtype=torch.int32)
        check_k2_forward(f"ancestry_self_attention kv T_max={t_long}", ql, cl, None, ancl, k2_roots(K2_LONG_IMAGES),
                         compare, bits, same, steps=(40, t_long - 1))
    step = t_max - 1
    anc_t = k2_map(anc, "uniform", step)
    rows = (anc_t.long() + torch.arange(b, device=dev)[:, None, None] * BEAM).reshape(n, t_max)
    slots = torch.arange(t_max, device=dev)
    kg_ = cache.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous()  # the physically reordered cache
    q4 = q[:, :, None]
    record("ancestry_self_attention kv", err,
           turns(lambda: k2.ancestry_self_attention(q, cache, None, anc_t, step),
                 lambda: k2.ancestry_self_attention(q, cache, cache, anc_t, step),
                 lambda: k2.ancestry_self_attention_plain(q, cache, None, anc_t, step),
                 lambda: F.scaled_dot_product_attention(q4, kg_, kg_)),
           k2_bytes(n, step, dtype, anc_t, kv=True), flops((dtype, 4 * n * h * t_max * dk)),
           "SDPA on the gathered cache as K and V")
    del q, cache, kg_, q4

    # K3 kv mode: one memory array an image, read once for both products
    q = rnd(n, h, dk)
    mem = rnd(b, h, r, dk)
    mask = random_region_mask(gen, b, r, dev)
    out3 = k3.grouped_cross_attention(q, mem, None, mask)
    ref3 = k3.grouped_cross_attention_plain(q, mem, None, mask)
    err = compare("grouped_cross_attention kv", out3, ref3, rms(mem),
                  fault=k3.grouped_cross_attention_plain(q, mem, None, torch.ones_like(mask)))  # padding attended
    same("grouped_cross_attention kv", out3, k3.grouped_cross_attention(q, mem, mem, mask))
    bits("grouped_cross_attention kv out", out3, ref3, K3_SHARE_LIMIT, K3_FAR_LIMIT)
    for rep_, rx in ((SCST_SAMPLES, r), (BEAM_WIDTHS[-1], r), (BEAM, 33)):
        bx = SCST_BATCHES[-1]
        qx, mx_ = rnd(bx * rep_, h, dk), rnd(bx, h, rx, dk)
        valid = random_region_mask(gen, bx, rx, dev)
        valid[0] = False
        ox = k3.grouped_cross_attention(qx, mx_, None, valid)
        px = k3.grouped_cross_attention_plain(qx, mx_, None, valid)
        tag = f"{bx}x{rep_}" + ("" if rx == r else f" S={rx}")
        compare(f"grouped_cross_attention kv {tag}", ox, px, rms(mx_))
        same(f"grouped_cross_attention kv {tag}", ox, k3.grouped_cross_attention(qx, mx_, mx_, valid))
        bits(f"grouped_cross_attention kv {tag} out", ox, px, K3_SHARE_LIMIT, K3_FAR_LIMIT)
    qg = q.reshape(b, BEAM, h, dk).transpose(1, 2)
    cross_mask = torch.zeros(b, 1, 1, r, device=dev, dtype=dtype).masked_fill(~mask[:, None, None, :], NEG_INF)
    record("grouped_cross_attention kv", err,
           turns(lambda: k3.grouped_cross_attention(q, mem, None, mask),
                 lambda: k3.grouped_cross_attention(q, mem, mem, mask),
                 lambda: k3.grouped_cross_attention_plain(q, mem, None, mask),
                 lambda: F.scaled_dot_product_attention(qg, mem, mem, attn_mask=cross_mask)),
           k3_bytes(b, BEAM, dtype, kv=True),
           flops((dtype, 4 * n * h * r * dk)), "SDPA, the memory as K and V")
    del q, mem, out3, ref3, qg

    # K14 / K15's kv modes at ACORT's XE shape
    ok &= check_decoder_kv(gen, dtype, results, dk, timing)

    # K4 at V = 771 (the radix vocabulary), every constraint on, eos 770 and unk 1 (a digit)
    logits = rnd(n, vocab)
    kw = k4_constraints(gen, n, vocab, eos_id=ACORT_BASE["eos_id"], unk_id=ACORT_BASE["unk_id"])
    logits[1] = 0
    logits[2, : 3 * BEAM_WIDTHS[-1]] = 8
    for row, count in enumerate(k4_midpoint_counts(vocab), start=3):
        logits[row] = K4_MIDPOINT_TOP - 200
        logits[row, torch.arange(count, device=dev) * (vocab // count)] = K4_MIDPOINT_TOP
    good, err_k = check_beam_topk(logits, kw, dtype, f" V={vocab}")
    ok &= good
    if timing:
        t_k, t_p, t_l = turns_ms(lambda: k4.beam_topk(logits, BEAM, **kw), lambda: k4.beam_topk_plain(logits, BEAM, **kw),
                                 lambda: torch.topk(torch.log_softmax(logits, dim=-1), BEAM))
        bnd, by = bound_ms(k4_bytes(n, vocab, BEAM, dtype), flops((torch.float32, 4 * n * vocab)))
        log(f"[kernel] beam_topk V={vocab} {dname}: ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
            f"bound_ms={bnd:.4f} ({by}; held windows in turns)")
        if dtype == torch.bfloat16:
            results[f"beam_topk V={vocab}"] = dict(max_abs_err=err_k, ms=t_k, plain_ms=t_p, library_ms=t_l,
                                                   bound_ms=bnd, bound_by=by)
    del logits

    # K13 at V = 771 over ACORT's XE rows (256 x 5 captions x 26 positions): the compute dtype, and bf16 -> f32
    # (the ORT generator's train site); logits offset by 100 as in check_norm_softmax_kernels
    rows13 = TRAIN_BIG_BATCH * SEQ_PER_IMG * ACORT_LEN
    for tout in ((dtype,) if dtype == torch.float32 else (torch.bfloat16, torch.float32)):
        x = (torch.randn(rows13, vocab, generator=gen, device=dev) * 3 + 100).to(dtype)
        dy = torch.randn(rows13, vocab, generator=gen, device=dev).to(tout)
        xl = leaves(x)

        def run13(fn):
            return fwd_bwd(lambda v_: fn(v_, tout), xl, dy)

        (yk,), (gk,) = run13(k13.vocab_log_softmax)
        (yp,), (gp,) = run13(k13.vocab_log_softmax_plain)
        tag = f"V={vocab} {dname}->{str(tout).split('.')[-1]} {rows13}x{vocab}"
        err13 = compare(f"vocab_log_softmax y {tag}", yk, yp)
        sum_scale = yp.float().max().exp().item() * vocab ** 0.5 * rms(dy)
        err13 = max(err13, compare(f"vocab_log_softmax_bwd dx {tag}", gk, gp, sum_scale=sum_scale))
        if tout == torch.bfloat16:
            bits(f"vocab_log_softmax y {tag}", yk, yp, K13_SHARE_LIMIT, K13_FAR_LIMIT)
        if timing and dtype == torch.bfloat16 and tout == torch.float32:
            t_k, t_p, t_l = turns_ms(lambda: run13(k13.vocab_log_softmax), lambda: run13(k13.vocab_log_softmax_plain),
                                     lambda: fwd_bwd(lambda v_: torch.log_softmax(v_, dim=-1, dtype=tout), xl, dy))
            bnd, by = bound_ms(k13_bytes(rows13, vocab, dtype, tout), {})
            log(f"[kernel] vocab_log_softmax fwd+bwd {tag}: ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
                f"bound_ms={bnd:.4f} ({by}; held windows in turns)")
            results[f"vocab_log_softmax V={vocab}"] = dict(max_abs_err=err13, ms=t_k, plain_ms=t_p, library_ms=t_l,
                                                           bound_ms=bnd, bound_by=by)
        del x, dy, xl, yk, gk, yp, gp
    torch.cuda.empty_cache()
    return ok


def check_width_kernels(gen, dtype, results: dict, dk: int, positions: dict, timed_kv: bool,
                        timing: bool = True) -> bool:
    """The attention kernels' head-width-`dk` instances: K1 (eval and train
    variant), K7, K2, K3, K14 and K15, unshared and in their kv modes,
    against their plain versions at the shapes of the models of that width
    (serving: B = 2048 images x beam 5, 36 regions, a cache of
    `positions[kv]` slots; XE: 256 x 5 captions of `positions[kv]`
    positions; the SCST group: 64 images x 15 samples), element-wise, and in
    bf16 bit by bit (`rounding_share`), each with a planted fault; K14 /
    K15's kv modes at ACORT's XE shape by `check_decoder_kv`; K3's, K14's and
    K15's shared memory at `dk` against their wrappers'. With `timing`, the
    bf16 times of the instances the width's main path runs (`timed_kv`: the
    kv modes, else the unshared kernels): kernel, plain version and one
    library call (SDPA at `dk`), in held turns, beside the bound; the rows
    are named "<kernel>[ kv] dk<dk>"."""
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import box_attention as k1
    from sparse_caption_tpu_torch.kernels import box_attention_bwd as k7
    from sparse_caption_tpu_torch.kernels import decoder_attention as k14
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
    from sparse_caption_tpu_torch.ops.attention import NEG_INF, box_relational_embedding

    dev = torch.device("cuda")
    es = ESIZE[dtype]
    dname = str(dtype).split(".")[-1]
    b, n, r, h = BIG_BATCH, BIG_BATCH * BEAM, REGIONS, HEADS
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    turns = turns_ms if timing else no_turns
    ok = True

    def compare(name, out, ref, scale=0.0, sum_scale=0.0, fault=None):
        """Element-wise, with the bound of the output's dtype."""
        nonlocal ok
        err, good, worst = close(out, ref, out.dtype, scale, sum_scale)
        log(f"[kernel] {name} dk{dk} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"median|ref|={ref.float().abs().median().item():.3e} scale={max(scale, sum_scale):.3f} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(f"{name} dk{dk}", fault, ref, out.dtype, scale, sum_scale)
        return err

    def bits(name, out, ref, share, far):
        nonlocal ok
        if dtype == torch.bfloat16:
            ok &= rounding_share(f"{name} dk{dk}", out, ref, share, far)

    def timed(kv, name):  # the kernels-line row of this instance, if it is one
        return timing and kv == timed_kv and f"{name}{' kv' if kv else ''} dk{dk}"

    def record(key, err, times, nbytes, ops, lib_note):
        if not key:
            return
        ms, plain_ms, lib_ms = times
        bnd, by = bound_ms(nbytes, ops)
        log(f"[kernel] {key} {dname}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} ({lib_note}) "
            f"bound_ms={bnd:.4f} ({by}; held windows in turns)")
        if dtype == torch.bfloat16:
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                                bound_by=by)

    # K1 at serving, unshared and kv
    boxes = random_boxes(gen, b, r, dev)
    wg_w, wg_b = bounded_wg(gen, h, dtype)
    mask = random_region_mask(gen, b, r, dev)
    mask[0] = False
    for kv in (False, True):
        q, k, v = rnd(b, h, r, dk), rnd(b, h, r, dk), rnd(b, h, r, dk)
        v_in, tag = (None, "box_attention kv") if kv else (v, "box_attention")
        out = k1.box_attention(q, k, v_in, boxes, wg_w, wg_b, mask)
        ref = k1.box_attention_plain(q, k, v_in, boxes, wg_w, wg_b, mask)
        err = compare(tag, out, ref, rms(k if kv else v),
                      fault=k1.box_attention_plain(q, k, q, boxes, wg_w, wg_b, mask))  # V read from another tensor
        bits(f"{tag} out", out, ref, K1_SHARE_LIMIT, K1_FAR_LIMIT)
        key = timed(kv, "box_attention")
        if key:
            bias = k1.box_log_bias_plain(boxes, wg_w, wg_b, dtype)
            float_mask = bias.masked_fill(~mask[:, None, None, :], NEG_INF).to(dtype).contiguous()
            vt = k if kv else v
            record(key, err,
                   turns(lambda: k1.box_attention(q, k, v_in, boxes, wg_w, wg_b, mask),
                         lambda: k1.box_attention_plain(q, k, v_in, boxes, wg_w, wg_b, mask),
                         lambda: F.scaled_dot_product_attention(q, k, vt, attn_mask=float_mask)),
                   (3 if kv else 4) * b * h * r * dk * es + b * r * 4 * 4 + b * r + h * 65 * es,
                   flops((dtype, 4 * b * h * r * r * dk), (torch.float32, 2 * b * r * r * 64 * h)),
                   "SDPA, float bias given")
            del bias, float_mask
        del q, k, v, out, ref

    # K1's train variant and K7 at the XE throughput batch, attention dropout 0.1
    bt = TRAIN_BIG_BATCH
    boxes = random_boxes(gen, bt, r, dev)
    wg_w, wg_b = bounded_wg(gen, h, dtype)
    mask = random_region_mask(gen, bt, r, dev)
    mask[0] = False
    keep = torch.rand(bt, h, r, r, generator=gen, device=dev) < 0.9
    for kv in (False, True):
        q, k, v, dout = rnd(bt, h, r, dk), rnd(bt, h, r, dk), rnd(bt, h, r, dk), rnd(bt, h, r, dk)
        tag = "box_attention_bwd kv" if kv else "box_attention_bwd"

        def k7_run(fn, keep_=keep):
            ins = leaves(q, k, wg_w, wg_b) if kv else leaves(q, k, wg_w, wg_b, v)
            o = fn(ins[0], ins[1], None if kv else ins[4], boxes, ins[2], ins[3], mask, keep_, 0.9)
            return o.detach(), torch.autograd.grad(o, ins, dout)

        kout, kg = k7_run(k7.box_attention_train)
        pout, pg = k7_run(k1.box_attention_plain)
        _, fg = k7_run(k1.box_attention_plain, None)  # fault: the dropout left out
        err = compare(f"{tag} train fwd", kout, pout, rms(k if kv else v))
        names = ("dq", "dkv" if kv else "dk", "d wg_w", "d wg_b") + (() if kv else ("dv",))
        for i, nm in enumerate(names):
            peak = pg[i].float().abs().max().item()
            scale, sum_scale = (0.0, peak) if nm.startswith("d wg") else (peak, 0.0)
            err = max(err, compare(f"{tag} {nm}", kg[i], pg[i], scale, sum_scale, fault=fg[i] if i == 0 else None))
            if not nm.startswith("d wg"):
                bits(f"{tag} {nm}", kg[i], pg[i], K7_SHARE_LIMIT, K7_FAR_LIMIT)
        bits(f"{tag} train fwd", kout, pout, K1_SHARE_LIMIT, K1_FAR_LIMIT)
        key = timed(kv, "box_attention_bwd")
        if key:
            geo = box_relational_embedding(boxes)
            log_bias = torch.log(torch.clamp(torch.relu(F.linear(geo.to(dtype), wg_w, wg_b)), min=1e-6))
            float_mask = log_bias.permute(0, 3, 1, 2).masked_fill(~mask[:, None, None, :], NEG_INF).to(dtype)
            graphs = []
            for fn in (k7.box_attention_train, k1.box_attention_plain):
                ins = leaves(q, k, wg_w, wg_b) if kv else leaves(q, k, wg_w, wg_b, v)
                graphs.append((fn(ins[0], ins[1], None if kv else ins[4], boxes, ins[2], ins[3], mask, keep, 0.9),
                               ins))
            ins_l = leaves(q, k) if kv else leaves(q, k, v)
            graphs.append((F.scaled_dot_product_attention(ins_l[0], ins_l[1], ins_l[1] if kv else ins_l[2],
                                                          attn_mask=float_mask.contiguous()), ins_l))
            record(key, err,
                   turns(*(lambda o=o, i=i: torch.autograd.grad(o, i, dout, retain_graph=True) for o, i in graphs)),
                   (5 if kv else 7) * bt * h * r * dk * es + bt * h * r * r + bt * r * 16 + bt * r + 2 * h * 65 * es,
                   flops((dtype, 5 * 2 * bt * h * r * r * dk), (torch.float32, 2 * 2 * bt * r * r * 64 * h)),
                   "SDPA backward, float bias given")
            if dtype == torch.bfloat16:
                with torch.no_grad():
                    fwd = turns_ms(lambda: k7.box_attention_train(q, k, None if kv else v, boxes, wg_w, wg_b, mask,
                                                                  keep, 0.9))
                results[key].update(train_fwd_ms=fwd[0])
                log(f"[kernel] box_attention train{' kv' if kv else ''} dk{dk} fwd {dname}: ms={fwd[0]:.4f} "
                    f"(held windows)")
            del graphs, ins_l, float_mask, log_bias, geo
        del q, k, v, dout, kg, pg, fg
    del keep

    # K2 at serving's cache: the first, middle and last step on both maps, unshared and kv
    for kv in (False, True):
        t_max = positions[kv]
        anc = torch.randint(0, BEAM, (b, BEAM, t_max), generator=gen, device=dev, dtype=torch.int32)
        q, ck, cv = rnd(n, h, dk), rnd(n, h, t_max, dk), rnd(n, h, t_max, dk)
        cv_in, tag = (None, "ancestry_self_attention kv") if kv else (cv, "ancestry_self_attention")
        err = check_k2_forward(tag, q, ck, cv_in, anc, k2_roots(b), compare, bits)
        key = timed(kv, "ancestry_self_attention")
        if key:
            anc_t = k2_map(anc, "uniform", t_max - 1)
            rows = (anc_t.long() + torch.arange(b, device=dev)[:, None, None] * BEAM).reshape(n, t_max)
            slots = torch.arange(t_max, device=dev)
            kg_ = ck.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous()  # the physically reordered cache
            vg_ = kg_ if kv else cv.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous()
            q4 = q[:, :, None]
            record(key, err,
                   turns(lambda: k2.ancestry_self_attention(q, ck, cv_in, anc_t, t_max - 1),
                         lambda: k2.ancestry_self_attention_plain(q, ck, cv_in, anc_t, t_max - 1),
                         lambda: F.scaled_dot_product_attention(q4, kg_, vg_)),
                   k2_bytes(n, t_max - 1, dtype, anc_t, dk=dk, kv=kv), flops((dtype, 4 * n * h * t_max * dk)),
                   f"SDPA on the gathered cache{' as K and V' if kv else ''}")
            del kg_, vg_, q4
        del q, ck, cv
    # spans at odd offsets (dk 13: a (row, head) span starts T_max x 26 bytes after the last) and the long
    # caches (past a block's stage: slots walked in chunks), on K2's own generator
    g2, nl = k2_gen(), K2_LONG_IMAGES * BEAM
    for t_x in (K2_ODD_SPANS if dk == DK_XSMALL else ()) + K2_LONG_CACHES[1:] + (k2.MAX_SLOTS,):
        for kv in (False, True):
            ql, ckl, cvl = (torch.randn(*shape, generator=g2, device=dev).to(dtype)
                            for shape in ((nl, h, dk), (nl, h, t_x, dk), (nl, h, t_x, dk)))
            ancl = torch.randint(0, BEAM, (K2_LONG_IMAGES, BEAM, t_x), generator=g2, device=dev, dtype=torch.int32)
            check_k2_forward(f"ancestry_self_attention{' kv' if kv else ''} T_max={t_x}", ql, ckl,
                             None if kv else cvl, ancl, k2_roots(K2_LONG_IMAGES), compare, bits)
            del ql, ckl, cvl

    # K3 at serving and at the SCST sampling group (64 x 15), unshared and kv
    for kv in (False, True):
        tag = "grouped_cross_attention kv" if kv else "grouped_cross_attention"
        for bx, rep_ in ((b, BEAM), (SCST_BATCHES[-1], SCST_SAMPLES)):
            q, mk, mv = rnd(bx * rep_, h, dk), rnd(bx, h, r, dk), rnd(bx, h, r, dk)
            mv_in = None if kv else mv
            valid = random_region_mask(gen, bx, r, dev)
            out3 = k3.grouped_cross_attention(q, mk, mv_in, valid)
            ref3 = k3.grouped_cross_attention_plain(q, mk, mv_in, valid)
            err = compare(f"{tag} {bx}x{rep_}", out3, ref3, rms(mk if kv else mv),
                          fault=k3.grouped_cross_attention_plain(q, mk, mv_in, torch.ones_like(valid)))
            bits(f"{tag} {bx}x{rep_} out", out3, ref3, K3_SHARE_LIMIT, K3_FAR_LIMIT)
            key = timed(kv, "grouped_cross_attention")
            if key and bx == b:
                qg = q.reshape(b, BEAM, h, dk).transpose(1, 2)
                cross_mask = torch.zeros(b, 1, 1, r, device=dev, dtype=dtype).masked_fill(~valid[:, None, None, :],
                                                                                         NEG_INF)
                vt = mk if kv else mv
                record(key, err,
                       turns(lambda: k3.grouped_cross_attention(q, mk, mv_in, valid),
                             lambda: k3.grouped_cross_attention_plain(q, mk, mv_in, valid),
                             lambda: F.scaled_dot_product_attention(qg, mk, vt, attn_mask=cross_mask)),
                       k3_bytes(b, BEAM, dtype, kv=kv, dk=dk), flops((dtype, 4 * n * h * r * dk)),
                       f"SDPA, the memory{' as K and V' if kv else ''}")
                del qg, cross_mask
            del q, mk, mv, out3, ref3
    # K3 at off shapes (33 or 20 regions, 3 or 7 rows an image, 5 heads: the last unit takes one; at dk 13 no
    # span of the first is 16-byte aligned), on its own generator
    g3 = torch.Generator(device="cuda").manual_seed(SEED + 43)
    for bx, rep_, r_, h_ in ((64, 3, 33, 5), (32, 7, 20, HEADS)):
        for kv in (False, True):
            tag = f"grouped_cross_attention{' kv' if kv else ''} {bx}x{rep_} {r_} regions {h_} heads"
            q, mk, mv = (torch.randn(*shape, generator=g3, device=dev).to(dtype)
                         for shape in ((bx * rep_, h_, dk), (bx, h_, r_, dk), (bx, h_, r_, dk)))
            mv_in = None if kv else mv
            valid = random_region_mask(g3, bx, r_, dev)
            out3 = k3.grouped_cross_attention(q, mk, mv_in, valid)
            ref3 = k3.grouped_cross_attention_plain(q, mk, mv_in, valid)
            compare(tag, out3, ref3, rms(mk if kv else mv),
                    fault=k3.grouped_cross_attention_plain(q, mk, mv_in, torch.ones_like(valid)))
            bits(f"{tag} out", out3, ref3, K3_SHARE_LIMIT, K3_FAR_LIMIT)
            del q, mk, mv, out3, ref3
    if dtype == torch.bfloat16:
        ok &= smem_agrees("grouped_cross_attention", "sct_grouped_cross_attention_smem",
                          lambda dk_, s_, rep_, kv_: k3.bf16_smem(s_, rep_, bool(kv_), dk_),
                          [(dk, r, BEAM, 0), (dk, r, BEAM, 1), (dk, r, SCST_SAMPLES, 1), (dk, 64, 500, 0),
                           (dk, 64, 700, 1), (dk, r, 1400, 0), (dk, 33, 3, 0), (dk, 20, 7, 1)])

    # K14 / K15 with k and v apart at the XE shape (256 x 5 captions, dropout 0.1) and at the SCST replay's (64 x
    # 15 samples, causal-only self, no dropout), then the kv modes at the replay's shape; the kv modes at the XE
    # shape in check_decoder_kv
    errs = {"fwd": 0.0, "bwd": 0.0}  # the XE calls with k and v apart, for the kernels line
    for bx, group, train in ((TRAIN_BIG_BATCH, SEQ_PER_IMG, True), (SCST_BATCHES[-1], SCST_SAMPLES, False)):
        nx = bx * group
        for kv in ((False,) if train else (False, True)):
            tq = positions[kv]
            for kind in ("self", "cross"):
                nk, tk = (nx, tq) if kind == "self" else (bx, r)
                if kind == "self":
                    valid = None if not train else (torch.arange(tq, device=dev)[None]
                                                    < torch.randint(2, tq + 1, (nx, 1), generator=gen, device=dev))
                else:
                    valid = random_region_mask(gen, bx, r, dev)
                keep = torch.rand(nx, h, tq, tk, generator=gen, device=dev) < 0.9 if train else None
                qx, kx, vx, dox = rnd(nx, h, tq, dk), rnd(nk, h, tk, dk), rnd(nk, h, tk, dk), rnd(nx, h, tq, dk)
                tag = f"decoder_attention{' kv' if kv else ''} {kind} {nx}x{tq}"

                def run(fn, keep_=keep):
                    if kv:
                        return fwd_bwd(lambda a_, b_: fn(a_, b_, None, valid, kind == "self", keep_, 0.9),
                                       leaves(qx, kx), dox)
                    return fwd_bwd(lambda a_, b_, c_: fn(a_, b_, c_, valid, kind == "self", keep_, 0.9),
                                   leaves(qx, kx, vx), dox)

                (ko,), kgx = run(k14.decoder_attention)
                (po,), pgx = run(k14.decoder_attention_plain)
                # fault: the keep-mask left out (train), else the key mask
                if train:
                    (fo,), _ = run(k14.decoder_attention_plain, None)
                else:
                    fo = k14.decoder_attention_plain(qx, kx, None if kv else vx, None, False, None, 0.9)
                err = compare(tag, ko, po, rms(kx if kv else vx), fault=fo)
                if train:
                    errs["fwd"] = max(errs["fwd"], err)
                for i, nm in enumerate(("dq", "dkv") if kv else ("dq", "dk", "dv")):
                    err = compare(f"{tag} {nm}", kgx[i], pgx[i], pgx[i].float().abs().max().item())
                    if train:
                        errs["bwd"] = max(errs["bwd"], err)
                    bits(f"{tag} {nm}", kgx[i], pgx[i], K15_SHARE_LIMIT, K15_FAR_LIMIT)
                bits(f"{tag} out", ko, po, K14_SHARE_LIMIT, K14_FAR_LIMIT)
                del qx, kx, vx, dox, ko, kgx, po, pgx, fo
    ok &= check_decoder_kv(gen, dtype, results, dk, timing=timing and timed_kv, key=f"decoder_attention kv dk{dk}")
    if dtype == torch.bfloat16:
        tq, tqk = positions[False], positions[True]
        ok &= smem_agrees("decoder_attention_bwd", "sct_decoder_attention_bwd_smem",
                          lambda dk_, tq_, tk_, g_, kv_: k14.bf16_backward_smem(tq_, tk_, g_, dk_, bool(kv_)),
                          [(dk, tq, tq, 1, 0), (dk, tq, r, SEQ_PER_IMG, 0), (dk, tq, r, SCST_SAMPLES, 0),
                           (dk, tqk, r, SCST_SAMPLES, 1), (dk, tqk, tqk, 1, 1), (dk, 64, 64, 8, 0), (dk, 64, 64, 9, 0),
                           (dk, 64, 64, 9, 1)])
        ok &= smem_agrees("decoder_attention", "sct_decoder_attention_smem",
                          lambda dk_, tq_, tk_, g_, keep_, kv_: k14.bf16_forward_smem(tq_, tk_, g_, bool(keep_), dk_,
                                                                                    bool(kv_)),
                          [(dk, tq, tq, 1, 1, 0), (dk, tq, r, SEQ_PER_IMG, 1, 0), (dk, tq, r, SCST_SAMPLES, 0, 0),
                           (dk, tqk, r, SEQ_PER_IMG, 1, 1), (dk, 64, 64, 24, 1, 0), (dk, 64, 64, 25, 1, 0),
                           (dk, 64, 64, 30, 1, 1)])
    if not (timing and not timed_kv):
        return ok

    # times of the unshared pair (one decoder layer's self + cross calls) at the XE shape, k and v apart
    tq, bx, nx = positions[False], TRAIN_BIG_BATCH, TRAIN_BIG_BATCH * SEQ_PER_IMG
    pair = []
    for kind in ("self", "cross"):
        nk, tk = (nx, tq) if kind == "self" else (bx, r)
        valid = (torch.arange(tq, device=dev)[None] < torch.randint(2, tq + 1, (nx, 1), generator=gen, device=dev)
                 if kind == "self" else random_region_mask(gen, bx, r, dev))
        keep = torch.rand(nx, h, tq, tk, generator=gen, device=dev) < 0.9
        pair.append((rnd(nx, h, tq, dk), rnd(nk, h, tk, dk), rnd(nk, h, tk, dk), valid, kind == "self", keep,
                     rnd(nx, h, tq, dk)))
    fwd, bwd = decoder_pair_times(pair, tq)
    shapes = [(nx, nx, tq), (nx, bx, r)]
    for key, times, nbytes, ops, err in (
            (f"decoder_attention dk{dk}", fwd, sum(k14_bytes(nq, nk, tk, dtype, tq=tq, dk=dk) for nq, nk, tk in shapes),
             sum(decoder_attention_flops(nq, tk, tq=tq, dk=dk) for nq, _, tk in shapes), errs["fwd"]),
            (f"decoder_attention_bwd dk{dk}", bwd, sum(k15_bytes(nq, nk, tk, dtype, tq=tq, dk=dk)
                                                       for nq, nk, tk in shapes),
             sum(decoder_attention_flops(nq, tk, backward=True, tq=tq, dk=dk) for nq, _, tk in shapes), errs["bwd"])):
        record(key, err, times, nbytes, flops((dtype, ops)), "SDPA, bool mask, K/V repeated")
    del pair
    torch.cuda.empty_cache()
    return ok


def decoder_pair_times(pair, tq: int, kv: bool = False):
    """Held turns of one decoder slot's pair of calls (self + cross; each
    (q, k, v, key_valid, causal, keep, dout)) in bf16: forward, then
    backward, each [kernel, plain version, SDPA with K/V repeated and a bool
    mask] and, with `kv` (v is k; the kv modes timed), the unshared kernel on
    the tensor passed twice last."""
    from sparse_caption_tpu_torch.kernels import decoder_attention as k14

    def library_args(q, k, v, valid, causal):
        g = q.shape[0] // k.shape[0]
        m = valid.repeat_interleave(g, 0)[:, None, None, :]
        if causal:
            m = m & torch.tril(torch.ones(tq, tq, dtype=torch.bool, device=q.device))
        return q, k.repeat_interleave(g, 0), v.repeat_interleave(g, 0), m

    kernel = lambda q, k, v, *a: k14.decoder_attention(q, k, None if kv else v, *a)  # noqa: E731
    impls = [("kernel", kernel), ("plain", k14.decoder_attention_plain)]
    if kv:
        impls.append(("before", k14.decoder_attention))
    graphs = {name: [] for name in ("kernel", "plain", "library", "before")}
    for q, k, v, valid, causal, keep, dout in pair:
        for impl, fn in impls:
            ins = leaves(q, k) if kv else leaves(q, k, v)
            graphs[impl].append((fn(ins[0], ins[1], ins[-1], valid, causal, keep, 0.9), ins, dout))
        lq, lk, lv, lm = library_args(q, k, v, valid, causal)
        ins = leaves(lq, lk) if kv else leaves(lq, lk, lv)
        graphs["library"].append((F.scaled_dot_product_attention(ins[0], ins[1], ins[-1], attn_mask=lm), ins, dout))
    lib_in = [library_args(q, k, v, valid, causal) for q, k, v, valid, causal, _, _ in pair]

    def forward(fn):
        for q, k, v, valid, causal, keep, _ in pair:
            fn(q, k, v, valid, causal, keep, 0.9)

    def backward(impl):
        for out, ins, dout in graphs[impl]:
            torch.autograd.grad(out, ins, dout, retain_graph=True)

    fwd_fns = [lambda: forward(kernel), lambda: forward(k14.decoder_attention_plain),
               lambda: [F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lm) for lq, lk, lv, lm in lib_in]]
    bwd_fns = [lambda: backward("kernel"), lambda: backward("plain"), lambda: backward("library")]
    if kv:
        fwd_fns.append(lambda: forward(k14.decoder_attention))
        bwd_fns.append(lambda: backward("before"))
    with torch.no_grad():
        fwd = turns_ms(*fwd_fns)
    bwd = turns_ms(*bwd_fns)
    del graphs, lib_in
    return fwd, bwd


def check_decoder_kv(gen, dtype, results: dict, dk: int, timing: bool = True,
                     key: str = "decoder_attention kv") -> bool:
    """K14 / K15's kv modes (v=None: an ACORT kv-shared decoder layer, one
    tensor is K and V) at ACORT's XE shape (256 x 5 captions of 26
    positions, dropout 0.1; the self call with pad keys, the cross call over
    36 regions read once per image) at head width `dk`: element-wise and in
    bf16 bit by bit (`rounding_share`) against the plain version given the
    tensor as k and v, and bit-equal to the unshared kernels given it twice
    (the same arithmetic; autograd adds their dK and dV in the dtype, as
    K15's kv mode does), with a planted fault (V read one key row on). With
    `timing`, the bf16 times of the pair of calls, forward and backward: the
    kv modes, the unshared kernels on the tensor passed twice (`before_ms`),
    the plain version and SDPA, beside the bound with the shared tensor
    counted once, as rows `key` and `key` with "_bwd" after the kernel's
    name."""
    from sparse_caption_tpu_torch.kernels import decoder_attention as k14

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    h, r, tq, bx = HEADS, REGIONS, ACORT_LEN, TRAIN_BIG_BATCH
    nx = bx * SEQ_PER_IMG
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    ok = True
    errs = {"fwd": 0.0, "bwd": 0.0}
    pair = []

    def held(name, out, ref, scale, fault=None):
        nonlocal ok
        err, good, worst = close(out, ref, out.dtype, scale)
        log(f"[kernel] {name} dk{dk} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(f"{name} dk{dk}", fault, ref, out.dtype, scale)
        if dtype == torch.bfloat16:
            ok &= rounding_share(f"{name} dk{dk}", out, ref, *((K14_SHARE_LIMIT, K14_FAR_LIMIT) if name.endswith(
                "out") else (K15_SHARE_LIMIT, K15_FAR_LIMIT)))
        return err

    for kind in ("self", "cross"):
        nk, tk = (nx, tq) if kind == "self" else (bx, r)
        if kind == "self":
            valid = torch.arange(tq, device=dev)[None] < torch.randint(2, tq + 1, (nx, 1), generator=gen, device=dev)
        else:
            valid = random_region_mask(gen, bx, r, dev)
        keep = torch.rand(nx, h, tq, tk, generator=gen, device=dev) < 0.9
        qx, kvx, dox = rnd(nx, h, tq, dk), rnd(nk, h, tk, dk), rnd(nx, h, tq, dk)
        causal = kind == "self"

        def run(fn, v_of):
            return fwd_bwd(lambda a_, b_: fn(a_, b_, v_of(b_), valid, causal, keep, 0.9), leaves(qx, kvx), dox)

        (ko,), kg = run(k14.decoder_attention, lambda b_: None)
        (to,), tg = run(k14.decoder_attention, lambda b_: b_)  # the unshared kernels, the tensor twice
        (po,), pg = run(k14.decoder_attention_plain, lambda b_: None)
        (fo,), fg = run(k14.decoder_attention_plain, lambda b_: b_.roll(1, 2))  # fault: V one key row on
        tag = f"decoder_attention kv {kind} T={tq}"
        errs["fwd"] = max(errs["fwd"], held(f"{tag} out", ko, po, rms(kvx), fault=fo))
        for i, nm in enumerate(("dq", "dkv")):
            errs["bwd"] = max(errs["bwd"], held(f"{tag} {nm}", kg[i], pg[i], pg[i].float().abs().max().item(),
                                                fault=fg[i] if nm == "dkv" else None))
        same = [int((a != b_).sum()) for a, b_ in ((ko, to), (kg[0], tg[0]), (kg[1], tg[1]))]
        good = not any(same)
        log(f"[kernel] {tag} dk{dk} {dname}: the kv modes vs the unshared kernels given the tensor twice, bit for "
            f"bit (out, dq, dkv differing elements {same}) {'ok' if good else 'FAIL'}")
        ok &= good
        pair.append((qx, kvx, kvx, valid, causal, keep, dox))
        del ko, kg, to, tg, po, pg, fo, fg
    if timing and dtype == torch.bfloat16:
        fwd, bwd = decoder_pair_times(pair, tq, kv=True)
        shapes = [(nx, nx, tq), (nx, bx, r)]
        name, tail = key.split(" ", 1)
        for row, times, nbytes, ops, err in (
                (key, fwd, sum(k14_bytes(nq, nk, tk, dtype, tq=tq, dk=dk, kv=True) for nq, nk, tk in shapes),
                 sum(decoder_attention_flops(nq, tk, tq=tq, dk=dk) for nq, _, tk in shapes), errs["fwd"]),
                (f"{name}_bwd {tail}", bwd, sum(k15_bytes(nq, nk, tk, dtype, tq=tq, dk=dk, kv=True)
                                                for nq, nk, tk in shapes),
                 sum(decoder_attention_flops(nq, tk, backward=True, tq=tq, dk=dk) for nq, _, tk in shapes),
                 errs["bwd"])):
            ms, plain_ms, lib_ms, before_ms = times
            bnd, by = bound_ms(nbytes, flops((dtype, ops)))
            log(f"[kernel] {row} {dname}: ms={ms:.4f} before_ms={before_ms:.4f} (the unshared kernel, the tensor "
                f"twice) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA, bool mask, K/V repeated) "
                f"bound_ms={bnd:.4f} ({by}; held windows in turns)")
            results[row] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                                before_ms=before_ms)
    del pair
    torch.cuda.empty_cache()
    return ok


def check_acort_small_kernels(gen, dtype, results: dict, timing: bool = True) -> bool:
    """Head width 32 (ACORT-small's and ORT-small's d256 over 8 heads) at
    ACORT-small's shapes (26 positions): `check_width_kernels`, the kv modes
    timed."""
    return check_width_kernels(gen, dtype, results, DK_SMALL, {False: ACORT_LEN, True: ACORT_LEN}, True, timing)


def check_xsmall_kernels(gen, dtype, results: dict, timing: bool = True) -> bool:
    """Head width 13 (ORT-xsmall's d104 over 8 heads; the kernels' padded
    instance, staged at 16): `check_width_kernels` at ORT-xsmall's shapes (17
    positions) and the kv modes at ACORT's (26), the unshared kernels (the
    ones ORT-xsmall runs) timed."""
    return check_width_kernels(gen, dtype, results, DK_XSMALL, {False: MAX_LEN, True: ACORT_LEN}, False, timing)


def radix_reward_inputs() -> dict:
    """K10's radix check's inputs at ACORT-small's SCST shape (64 images x 15
    samples of 25 digits against 5 refs each), all from seeded generators:
    ids (on the card), img, the df table's tensors, the ref pack, the radix
    spec, the reward's keyword arguments and the DeviceReward."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 10)
    with tempfile.TemporaryDirectory() as log_dir:
        tok, _ = acort_tokenizer(log_dir, ACORT_SMALL_FLAGS)
    b, steps = SCST_BATCHES[-1], ACORT_LEN - 1
    reward, pack = scst_reward_setup(b, dev, tok=tok)
    spec = reward.regroup
    base, eos, bos = spec.base, spec.base + 2, spec.base + 1
    rows = b * SCST_SAMPLES
    ids = torch.randint(1, base + 1, (rows, steps), generator=gen, dtype=torch.int32)
    for i in range(0, rows, 4):  # every fourth row: digits of one of its image's refs (then eos)
        digits = tok.encode(f"w{(i * 7) % 196 + 4} w{(i * 3) % 196 + 4} w{i % 196 + 4}", max_seq_length=ACORT_LEN)[1:]
        ids[i, : len(digits)] = torch.tensor(digits[:steps], dtype=torch.int32)
    eos_at = torch.randint(1, steps + 3, (rows, 1), generator=gen)
    ids = torch.where((torch.arange(steps)[None] == eos_at) & (torch.arange(rows)[:, None] % 4 != 0),
                      torch.full_like(ids, eos), ids)
    ids[1, 0], ids[2, -1] = eos, eos
    ids[3::9, 3], ids[5::11, 6] = 0, bos
    ids[6, :] = 0
    ids[6, :2] = torch.tensor([bos, 2])  # a one-digit tail
    ids[7, :4] = torch.tensor([spec.n_words // base + 1, spec.n_words % base, base, base])  # the <unk> slot, past it
    tbl = reward.table.to(dev)
    return dict(ids=ids.to(dev), img=torch.arange(b, device=dev, dtype=torch.int32).repeat_interleave(SCST_SAMPLES),
                tensors={"hi": tbl.hi, "lo": tbl.lo, "val": tbl.val}, pack=pack, spec=spec, reward=reward,
                kw=dict(probe=reward.table.probe, ref_len=reward.table.ref_len, bleu_weight=SCST_BLEU))


def radix_reward_sides(inp: dict) -> tuple:
    """(radix mode, word mode on the plain regroup's words, the CPU plain
    version on those words) of K10 on `radix_reward_inputs`."""
    from sparse_caption_tpu_torch.kernels import cider_reward as k10

    ids, img, tensors, pack, kw = inp["ids"], inp["img"], inp["tensors"], inp["pack"], inp["kw"]
    words = k10.radix_to_word(ids, inp["spec"])
    got = k10.cider_reward(ids, img, tensors, pack, radix=inp["spec"], **kw)
    word_mode = k10.cider_reward(words, img, tensors, pack, **kw)
    ref = k10.cider_reward_plain(words.cpu(), img.cpu(), {k: v.cpu() for k, v in tensors.items()},
                                 {k: v.cpu() for k, v in pack.items()}, **kw).to(ids.device)
    return got, word_mode, ref


def check_radix_reward(results: dict, timing: bool = True) -> bool:
    """K10's radix mode (ACORT's digit rows, regrouped into words in the
    kernel's prologue) at ACORT-small's SCST shape, 64 images x 15 samples of
    25 digits against 5 refs each: bit-equal to K10's word mode run on the
    plain regroup's word ids (`radix_to_word`), and within the reward bounds
    of the plain version; rows with eos first and last, pad and bos mid-row,
    a one-digit tail, words at and past the <unk> slot, and refs' own digits
    (rewards far from 0). A row outside the bound is logged with its digits,
    words, image and both rewards. Planted fault: the word mode on a regroup
    that does not stop at eos. With `timing`: the radix mode, the word mode on
    the same rows' words, and the plain version (regroup + reward), in held
    turns."""
    from sparse_caption_tpu_torch.kernels import cider_reward as k10

    inp = radix_reward_inputs()
    ids, img, tensors, pack, kw, spec, reward = (inp[k] for k in ("ids", "img", "tensors", "pack", "kw", "spec",
                                                                  "reward"))
    dev, rows, steps, eos = ids.device, ids.shape[0], ids.shape[1], spec.base + 2
    words = k10.radix_to_word(ids, spec)
    got, word_mode, ref = radix_reward_sides(inp)
    equal = bool(torch.equal(got, word_mode))
    err = (got - ref).abs()
    outside = err > REWARD_RTOL * ref.abs() + REWARD_ATOL
    within = not bool(outside.any())
    for r in torch.nonzero(outside).flatten().tolist()[:8]:
        log(f"[kernel] cider_reward radix row {r} outside the bound: image {int(img[r])}, digits {ids[r].tolist()}, "
            f"words {words[r].tolist()}, kernel {got[r].item():.9e} word mode {word_mode[r].item():.9e} "
            f"plain {ref[r].item():.9e}")
    no_eos = torch.where(ids == eos, torch.ones_like(ids), ids)  # the fault: digits past eos kept
    fault = k10.cider_reward(k10.radix_to_word(no_eos, spec), img, tensors, pack, **kw)
    caught = not torch.equal(fault, got)
    log(f"[kernel] cider_reward radix: {rows} rows of {steps} digits ({words.shape[1]} word slots), rewards in "
        f"[{ref.min().item():.4f}, {ref.max().item():.4f}], {int((ref > 0.01).sum())} above 0.01; bit-equal to the "
        f"word mode on the plain regroup's words={equal}; max_abs_err vs the plain version {err.max().item():.3e} "
        f"(rtol {REWARD_RTOL}, atol {REWARD_ATOL}) {'ok' if equal and within else 'FAIL'}")
    log(f"[fault] cider_reward radix without the eos truncation: {'caught' if caught else 'MISSED'}")
    ok = equal and within and caught and int((ref > 0.01).sum()) > 0
    if timing:
        t_r, t_w, t_p = turns_ms(lambda: k10.cider_reward(ids, img, tensors, pack, radix=spec, **kw),
                                 lambda: k10.cider_reward(words, img, tensors, pack, **kw),
                                 lambda: k10.cider_reward_plain(k10.radix_to_word(ids, spec), img, tensors, pack, **kw))
        ghi, glo, _, _, _ = k10.grams(words, 3, 0, 2)
        slots = ((k10.mix(ghi, glo) & (reward.table.size - 1))[..., None]
                 + torch.arange(reward.table.probe, device=dev)) % reward.table.size
        pack_bytes = sum(v[torch.unique(img.long())].numel() * v.element_size() for v in pack.values())
        bnd, by = bound_ms(ids.numel() * 4 + img.numel() * 4 + pack_bytes + torch.unique(slots).numel() * 12
                           + rows * 4, {})
        log(f"[kernel] cider_reward radix: ms={t_r:.4f} word_mode_ms={t_w:.4f} (the same rows' words) "
            f"plain_ms={t_p:.4f} library_ms=null bound_ms={bnd:.4f} ({by}; held windows in turns)")
        results["cider_reward radix"] = dict(max_abs_err=err.max().item(), ms=t_r, word_mode_ms=t_w, plain_ms=t_p,
                                             library_ms=None, bound_ms=bnd, bound_by=by)
    return ok


def check_decoder_attention_kernels(gen, results: dict, timing: bool = True) -> bool:
    """K14 and K15 against the plain version with autograd: at the ORT XE
    step's shape (256 images x 5 captions) in f32 and bf16 and at the SCST
    replay's (64 x 15 samples) in f32, causal self-attention over 17 tokens
    (pad keys after each caption's end; causal only in the replay) and
    cross-attention over 36 regions with one K/V row per image (image 0 with
    every region padded), each with and without a dropout keep-mask; planted
    faults (the causal rule dropped in the forward, the keep-mask dropped in
    the backward); in bf16 K14's output and K15's dq, dk, dv also bit by bit
    (`rounding_share`); with `timing`, the bf16 times of one decoder layer's
    pair of calls (self + cross) at the XE shape into the JSON line, and
    K15's f32 time at the replay's shape, kernel, plain version and SDPA in
    held turns."""
    from sparse_caption_tpu_torch.kernels import decoder_attention as k14

    dev = torch.device("cuda")
    h, dk, tq, r = HEADS, DK, MAX_LEN, REGIONS
    ok = True

    def inputs(dtype, b, g, kind, with_keep, pad_keys=True):
        n = b * g
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
        if kind == "self":
            nk, tk, causal = n, tq, True
            ends = torch.randint(2, tq + 1, (n, 1), generator=gen, device=dev)
            valid = (torch.arange(tq, device=dev)[None] < ends) if pad_keys else None
        else:
            nk, tk, causal = b, r, False
            valid = random_region_mask(gen, b, r, dev)
            valid[0] = False
        keep = (torch.rand(n, h, tq, tk, generator=gen, device=dev) < 0.9) if with_keep else None
        return (rnd(n, h, tq, dk), rnd(nk, h, tk, dk), rnd(nk, h, tk, dk), valid, causal, keep), rnd(n, h, tq, dk)

    def run(fn, args, dout, **change):
        q, k, v, valid, causal, keep = args
        kw = dict(dict(key_valid=valid, causal=causal, keep=keep, keep_prob=0.9), **change)
        ins = leaves(q, k, v)
        out = fn(*ins, **kw)
        return out.detach(), torch.autograd.grad(out, ins, dout)

    def p_agreement(label, args):
        """K14's P~ against K15's, bit for bit: K14's output with V = the
        identity (v[b, h, j] = e_j) is P~ itself, and K15's dV with dO = the
        identity (dO[n, h, i] = e_i) on one group member at a time, the others'
        dO 0, is that member's P~ transposed. Tq, Tk <= 64 = dk."""
        q, k, _, valid, causal, keep = args
        nk, _, tk, _ = k.shape
        n, _, tq_, _ = q.shape
        g = n // nk
        eye = torch.eye(dk, device=dev, dtype=q.dtype)
        v = eye[:tk].expand(nk, h, tk, dk).contiguous()
        ins = leaves(q, k, v)
        out = k14.decoder_attention(*ins, valid, causal, keep, 0.9)
        p14 = out.detach()[..., :tk]
        p15 = torch.empty_like(p14)
        for m in range(g):
            dout = torch.zeros_like(q)
            dout.view(nk, g, h, tq_, dk)[:, m] = eye[:tq_]
            dv = torch.autograd.grad(out, ins[2], dout, retain_graph=True)[0]
            p15.view(nk, g, h, tq_, tk)[:, m] = dv[..., :tq_].transpose(-1, -2)
        differ = int((p14 != p15).sum())
        log(f"[kernel] {label}: K14's P~ vs K15's, bit for bit: {differ} of {p14.numel()} elements differ "
            f"({differ / p14.numel():.6f}) {'ok' if differ == 0 else 'FAIL'}")
        return differ == 0

    errs = {"fwd": 0.0, "bwd": 0.0}
    cases = [(dt, TRAIN_BIG_BATCH, SEQ_PER_IMG, kind, kp, True) for dt in (torch.float32, torch.bfloat16)
             for kind in ("self", "cross") for kp in (True, False)]
    cases += [(torch.float32, SCST_BATCHES[-1], SCST_SAMPLES, kind, kp, False) for kind in ("self", "cross")
              for kp in (True, False)]
    for dtype, b, g, kind, with_keep, pad_keys in cases:
        args, dout = inputs(dtype, b, g, kind, with_keep, pad_keys)
        label = (f"decoder_attention {kind} {b}x{g}{' keep' if with_keep else ''}"
                 f"{' causal-only' if kind == 'self' and not pad_keys else ''}")
        dname = str(dtype).split(".")[-1]
        kout, kg = run(k14.decoder_attention, args, dout)
        pout, pg = run(k14.decoder_attention_plain, args, dout)
        err, good, worst = close(kout, pout, dtype, rms(args[2]))
        log(f"[kernel] {label} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} {'ok' if good else 'FAIL'}")
        ok &= good
        if dtype == torch.bfloat16:
            errs["fwd"] = max(errs["fwd"], err)
        if kind == "self":  # fault: the causal rule dropped
            ok &= fault_caught(f"{label} causal ignored", run(k14.decoder_attention_plain, args, dout, causal=False)[0],
                               pout, dtype, rms(args[2]))
        fg = run(k14.decoder_attention_plain, args, dout, keep=None)[1] if with_keep else None
        # bf16: the plain version rounds dP, dS and each product to bf16 and
        # sums a group's dK / dV in bf16, so its error follows the largest
        # gradient entries (s = max |ref|, as K7's check); f32: the sums' scale
        for i, nm in enumerate(("dq", "dk", "dv")):
            err, good, worst = close(kg[i], pg[i], dtype, pg[i].float().abs().max().item(), rms(pg[i]))
            log(f"[kernel] {label} {nm} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
                f"{'ok' if good else 'FAIL'}")
            ok &= good
            if dtype == torch.bfloat16:
                errs["bwd"] = max(errs["bwd"], err)
            if fg is not None and nm != "dk":  # fault: the keep-mask dropped in the backward
                ok &= fault_caught(f"{label} {nm} keep ignored in the backward", fg[i], pg[i], dtype,
                                   pg[i].float().abs().max().item(), rms(pg[i]))
        if dtype == torch.bfloat16:  # bit by bit against the card's plain version
            ok &= rounding_share(f"{label} out", kout, pout, K14_SHARE_LIMIT, K14_FAR_LIMIT)
            for i, nm in enumerate(("dq", "dk", "dv")):
                ok &= rounding_share(f"{label} {nm}", kg[i], pg[i], K15_SHARE_LIMIT, K15_FAR_LIMIT)
            ok &= p_agreement(label, args)
        if kind == "cross":  # image 0 has no valid region: uniform weights, no gradient to its q or k
            zero = bool((kg[0][:g] == 0).all() and (kg[1][0] == 0).all())
            msg = f"[kernel] {label} {dname}: all-padded image: dq and dk exactly 0={zero}"
            if not with_keep:
                uniform = (kout[:g].float() - args[2][0].float().mean(1)[None, :, None]).abs().max().item()
                msg += f", output - mean(v) max {uniform:.3e}"
            log(msg)
            ok &= zero
        del args, dout, kout, kg, pout, pg, fg
    # off shapes, on inputs of their own generator: the other key tiles (Tk =
    # 9: one 16-key tile; Tk = 64: four), and a group whose members' rows
    # straddle the 16-row tiles (3 x 20 positions); padded keys, one K/V row
    # with every key padded, the keep-mask
    g15 = torch.Generator(device=dev).manual_seed(SEED + 15)
    for dtype in (torch.float32, torch.bfloat16):
        for kind, b_, g_, tq_, tk_ in (("self", 16, 1, 9, 9), ("cross", 16, 3, 20, 64)):
            n_, nk_ = b_ * g_, b_ * g_ if kind == "self" else b_
            rnd = lambda *shape: torch.randn(*shape, generator=g15, device=dev).to(dtype)  # noqa: E731
            valid = torch.arange(tk_, device=dev)[None] < torch.randint(1, tk_ + 1, (nk_, 1), generator=g15, device=dev)
            valid[0] = False
            keep = torch.rand(n_, h, tq_, tk_, generator=g15, device=dev) < 0.9
            args = (rnd(n_, h, tq_, dk), rnd(nk_, h, tk_, dk), rnd(nk_, h, tk_, dk), valid, kind == "self", keep)
            dout = rnd(n_, h, tq_, dk)
            kout, kg = run(k14.decoder_attention, args, dout)
            pout, pg = run(k14.decoder_attention_plain, args, dout)
            label = f"decoder_attention {kind} {b_}x{g_} Tq={tq_} Tk={tk_} keep"
            dname = str(dtype).split(".")[-1]
            for nm, kt, pt, sc in (("out", kout, pout, rms(args[2])),) + tuple(
                    (nm, kg[i], pg[i], pg[i].float().abs().max().item()) for i, nm in enumerate(("dq", "dk", "dv"))):
                err, good, worst = close(kt, pt, dtype, sc, rms(pt) if nm != "out" else 0.0)
                log(f"[kernel] {label} {nm} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
                    f"{'ok' if good else 'FAIL'}")
                ok &= good
                if dtype == torch.bfloat16 and nm != "out":
                    ok &= rounding_share(f"{label} {nm}", kt, pt, K15_SHARE_LIMIT, K15_FAR_LIMIT)
            if dtype == torch.bfloat16:
                ok &= p_agreement(label, args)
            del args, dout, kout, kg, pout, pg
    ok &= smem_agrees("decoder_attention_bwd", "sct_decoder_attention_bwd_smem",
                      lambda dk_, tq_, tk_, g_, kv_: k14.bf16_backward_smem(tq_, tk_, g_, dk_, bool(kv_)),
                      [(64, tq, tq, 1, 0), (64, tq, r, SEQ_PER_IMG, 0), (64, tq, r, SCST_SAMPLES, 0),
                       (64, 64, 64, 5, 0), (64, 64, 64, 6, 0), (64, 64, 64, 6, 1), (64, tq, r, SCST_SAMPLES, 1)])
    ok &= smem_agrees("decoder_attention", "sct_decoder_attention_smem",
                      lambda dk_, tq_, tk_, g_, keep_, kv_: k14.bf16_forward_smem(tq_, tk_, g_, bool(keep_), dk_,
                                                                                bool(kv_)),
                      [(64, tq, tq, 1, 1, 0), (64, tq, r, SEQ_PER_IMG, 1, 0), (64, tq, r, SCST_SAMPLES, 0, 0),
                       (64, tq, r, SCST_SAMPLES, 1, 0), (64, 64, 64, 16, 1, 0), (64, 64, 64, 17, 1, 0),
                       (64, 20, 64, 3, 1, 0), (64, 64, 64, 17, 1, 1), (64, tq, r, SEQ_PER_IMG, 1, 1)])
    if not timing:
        return ok

    # times: one decoder layer's pair of calls at the XE shape in bf16, with dropout
    dtype, es, n = torch.bfloat16, 2, TRAIN_BIG_BATCH * SEQ_PER_IMG
    pair = [inputs(dtype, TRAIN_BIG_BATCH, SEQ_PER_IMG, kind, True) for kind in ("self", "cross")]

    def forward(fn, calls=pair, only=None):
        for i, (args, _) in enumerate(calls):
            q, k, v, valid, causal, keep = args
            if only is None or i == only:
                fn(q, k, v, valid, causal, keep, 0.9)

    def library_inputs(args):
        """SDPA's inputs: K/V repeated to the query rows, a dense bool mask (no keep-mask: SDPA draws its own)."""
        q, k, v, valid, causal, _ = args
        g = q.shape[0] // k.shape[0]
        if valid is None:  # the replay's causal-only self call
            valid = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool, device=dev)
        mask = valid.repeat_interleave(g, 0)[:, None, None, :]
        if causal:
            mask = mask & torch.tril(torch.ones(tq, tq, dtype=torch.bool, device=dev))
        return leaves(q, k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)), mask

    graphs = {"kernel": [], "plain": [], "library": []}
    for args, dout in pair:
        for impl, fn in (("kernel", k14.decoder_attention), ("plain", k14.decoder_attention_plain)):
            ins = leaves(*args[:3])
            graphs[impl].append((fn(*ins, *args[3:], 0.9), ins, dout))
        ins, mask = library_inputs(args)
        graphs["library"].append((F.scaled_dot_product_attention(*ins, attn_mask=mask), ins, dout))

    def backward(impl, only=None):
        for i, (out, ins, dout) in enumerate(graphs[impl]):
            if only is None or i == only:
                torch.autograd.grad(out, ins, dout, retain_graph=True)

    lib_in = [library_inputs(args) for args, _ in pair]
    with torch.no_grad():
        fwd = turns_ms(lambda: forward(k14.decoder_attention), lambda: forward(k14.decoder_attention_plain),
                       lambda: [F.scaled_dot_product_attention(*i, attn_mask=m) for i, m in lib_in],
                       lambda: forward(k14.decoder_attention, only=0), lambda: forward(k14.decoder_attention, only=1))
    bwd = turns_ms(lambda: backward("kernel"), lambda: backward("plain"), lambda: backward("library"),
                   lambda: backward("kernel", 0), lambda: backward("kernel", 1))
    for name, times in (("decoder_attention", fwd), ("decoder_attention_bwd", bwd)):
        log(f"[kernel] {name} bf16 at {TRAIN_BIG_BATCH}x{SEQ_PER_IMG}: self call ms={times[3]:.4f}, "
            f"cross call ms={times[4]:.4f} (in the same turns)")
    shapes = [(n, n, tq), (n, TRAIN_BIG_BATCH, r)]  # (query rows, K/V rows, keys) of the self and cross calls
    for name, (ms, plain_ms, lib_ms, *_), nbytes, ops, err in (
            ("decoder_attention", fwd, sum(k14_bytes(nq, nk, tk, dtype) for nq, nk, tk in shapes),
             sum(decoder_attention_flops(nq, tk) for nq, _, tk in shapes), errs["fwd"]),
            ("decoder_attention_bwd", bwd, sum(k15_bytes(nq, nk, tk, dtype) for nq, nk, tk in shapes),
             sum(decoder_attention_flops(nq, tk, backward=True) for nq, _, tk in shapes), errs["bwd"])):
        bnd, by = bound_ms(nbytes, flops((dtype, ops)))
        log(f"[kernel] {name} bf16 self + cross at {TRAIN_BIG_BATCH}x{SEQ_PER_IMG} ({n} rows): ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA, bool mask, K/V repeated) bound_ms={bnd:.4f} "
            f"({by}; held windows in turns)")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)
    results["decoder_attention"].update(self_ms=fwd[3], cross_ms=fwd[4])
    results["decoder_attention_bwd"].update(self_ms=bwd[3], cross_ms=bwd[4])
    del pair, lib_in
    # the replay's pair (f32, 64 x 15, causal-only self, no dropout): K15 alone, then forward + backward
    rpair = [inputs(torch.float32, SCST_BATCHES[-1], SCST_SAMPLES, kind, False, False) for kind in ("self", "cross")]
    for impl, fn in (("kernel", k14.decoder_attention), ("plain", k14.decoder_attention_plain)):
        graphs[impl] = []
        for args, dout in rpair:
            ins = leaves(*args[:3])
            graphs[impl].append((fn(*ins, *args[3:], 0.9), ins, dout))
    rlib = [library_inputs(args) for args, _ in rpair]
    with torch.no_grad():
        t_fk, t_fp, t_fl = turns_ms(lambda: forward(k14.decoder_attention, rpair),
                                    lambda: forward(k14.decoder_attention_plain, rpair),
                                    lambda: [F.scaled_dot_product_attention(*i, attn_mask=m) for i, m in rlib])
    t_bk, t_bp, t_k, t_p = turns_ms(lambda: backward("kernel"), lambda: backward("plain"),
                                    lambda: [run(k14.decoder_attention, a, d) for a, d in rpair],
                                    lambda: [run(k14.decoder_attention_plain, a, d) for a, d in rpair])
    nr = SCST_BATCHES[-1] * SCST_SAMPLES
    rshapes = [(nr, nr, tq), (nr, SCST_BATCHES[-1], r)]
    f_bound = bound_ms(sum(k14_bytes(nq, nk, tk, torch.float32, keep=False, valid=vd)
                           for (nq, nk, tk), vd in zip(rshapes, (False, True))),
                       flops((torch.float32, sum(decoder_attention_flops(nq, tk) for nq, _, tk in rshapes))))
    r_bound = bound_ms(sum(k15_bytes(nq, nk, tk, torch.float32, keep=False, valid=vd)
                           for (nq, nk, tk), vd in zip(rshapes, (False, True))),
                       flops((torch.float32, sum(decoder_attention_flops(nq, tk, backward=True)
                                                 for nq, _, tk in rshapes))))
    log(f"[kernel] decoder_attention f32 self + cross at the replay shape {SCST_BATCHES[-1]}x{SCST_SAMPLES}: "
        f"ms={t_fk:.4f} plain_ms={t_fp:.4f} library_ms={t_fl:.4f} (SDPA, bool mask, K/V repeated) "
        f"bound_ms={f_bound[0]:.4f} ({f_bound[1]}; held windows in turns)")
    log(f"[kernel] decoder_attention_bwd f32 self + cross at the replay shape {SCST_BATCHES[-1]}x{SCST_SAMPLES}: "
        f"ms={t_bk:.4f} plain_ms={t_bp:.4f} bound_ms={r_bound[0]:.4f} ({r_bound[1]}); forward + backward ms={t_k:.4f} "
        f"plain_ms={t_p:.4f} (held windows in turns)")
    results["decoder_attention"].update(replay_f32_ms=t_fk, replay_f32_plain_ms=t_fp, replay_f32_library_ms=t_fl,
                                        replay_f32_bound_ms=f_bound[0])
    results["decoder_attention_bwd"].update(replay_f32_ms=t_bk, replay_f32_plain_ms=t_bp)
    return ok


# ---------------------------------------------------------------- main path
def build_model(seed: int):
    """Paper-width relation_transformer_prune in f32 on the card, random
    weights and supermask logits from the seed, masks folded."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedEmbedding, MaskedLinear

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model("relation_transformer_prune")(**PAPER, mask_cfg=MaskConfig("supermask"), device="cuda",
                                                    generator=gen)
    kept = total = 0
    for m in model.modules():
        if isinstance(m, (MaskedLinear, MaskedEmbedding)):
            logits = torch.randn(m.weight.shape, generator=gen, device="cuda") * 2.0 + 1.0
            m.fold_mask_(logits)
            kept += int((logits > 0).sum())
            total += logits.numel()
    log(f"[model] supermask folded: {kept / total:.3f} of {total} masked weights kept")
    return model


def make_batch(gen, b, dtype, device="cuda"):
    att = torch.randn(b, REGIONS, PAPER["att_feat_size"], generator=gen, device=device).to(dtype)
    mask = random_region_mask(gen, b, REGIONS, device).float()
    boxes = random_boxes(gen, b, REGIONS, device)
    return att, mask, boxes


def caption(model, batch, opt=None):
    """``encode`` + ``generate`` with ``opt`` (default: beam 5)."""
    from sparse_caption_tpu_torch.decoding import generate

    memory = model.encode(*batch)
    return generate(model, memory, dict(opt or {"beam_size": BEAM}, max_seq_length=model.max_seq_length))


def captions_per_image(opt=None) -> int:
    opt = opt or {"beam_size": BEAM}
    return int(opt.get("num_random_sample", 0)) or int(opt["beam_size"])


def run_main_path(model_bf16, gen, b, expected, make=make_batch, label="main", opt=None) -> dict:
    from sparse_caption_tpu_torch.kernels import launch_counts, reset_launch_counts

    batch = make(gen, b, torch.bfloat16)
    seq, lp = caption(model_bf16, batch, opt)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    seq, lp = caption(model_bf16, batch, opt)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == expected, f"launch counts {counts} != {expected}"
    steps = model_bf16.max_seq_length
    rows = captions_per_image(opt)
    assert seq.shape == (b, rows, steps) and lp.shape == (b, rows, steps)
    assert bool(torch.isfinite(lp).all()), "non-finite log-probs"
    assert int(seq.min()) >= 0 and int(seq.max()) < model_bf16.vocab_size
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caption(model_bf16, batch, opt)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    enc_ms = time_ms(lambda: model_bf16.encode(*batch), iters=3, warmup=1)
    log(f"[{label}] bf16 batch {b}: {b / best:.1f} captions/s (best of 3: {best * 1e3:.1f} ms per encode+decode; "
        f"encode alone {enc_ms:.1f} ms); launches {counts}")
    return counts


def path_topk_times(model, batch, results: dict, label: str) -> None:
    """K4 on the logits that one caption run of `model` hands it (every decode
    step's rows, constraints and width, captured as the beam search calls
    K4), in held windows in turns with its plain version and one library call
    over the same calls; times per call. K4's selection costs more where many
    of a row's entries round to its best bf16 log-prob, as in a random-weight
    model's flat rows, than on the kernel phase's N(0, 1) logits."""
    from sparse_caption_tpu_torch.decoding import beam as beam_mod
    from sparse_caption_tpu_torch.kernels import beam_topk as k4

    calls = []

    def capture(logits, k, **kw):
        calls.append((logits.clone(), k, {key: v.clone() if torch.is_tensor(v) else v for key, v in kw.items()}))
        return k4.beam_topk(logits, k, **kw)

    with mock.patch.object(beam_mod, "beam_topk", capture):
        caption(model, batch)
    ties, spread = 0.0, 0.0  # entries of a row at its best log-prob (in the logits' dtype); the logits' std
    for x, _, _ in calls:
        lp = torch.log_softmax(x, dim=-1)
        ties += float((lp == lp.max(dim=1, keepdim=True).values).sum(dim=1).float().mean())
        spread += float(x.float().std(dim=1).mean())
        del lp
    t_k, t_p, t_l = (t / len(calls) for t in turns_ms(
        lambda: [k4.beam_topk(x, k, **kw) for x, k, kw in calls],
        lambda: [k4.beam_topk_plain(x, k, **kw) for x, k, kw in calls],
        lambda: [torch.topk(torch.log_softmax(x, dim=-1), k) for x, k, _ in calls]))
    rows, vocab = calls[0][0].shape
    bnd = bound_ms(k4_bytes(rows, vocab, calls[0][1], calls[0][0].dtype), {})[0]
    log(f"[kernel] beam_topk on the {label} path's logits ({len(calls)} calls of {rows} rows, "
        f"on average {ties / len(calls):.1f} entries at the row's best log-prob, logits' std {spread / len(calls):.4f}): "
        f"ms={t_k:.4f} plain_ms={t_p:.4f} "
        f"library_ms={t_l:.4f} bound_ms={bnd:.4f} per call (held windows in turns)")
    results["beam_topk"].update({f"{label}_path_ms": t_k, f"{label}_path_plain_ms": t_p,
                                 f"{label}_path_library_ms": t_l, f"{label}_path_ties": ties / len(calls),
                                 f"{label}_path_logit_std": spread / len(calls)})
    del calls


def profile_window(label: str, fn) -> tuple:
    """Device time by kernel over one call of `fn` (torch.profiler), and the
    device's busy share of that same window's wall time. Returns (device
    ms, wall ms, {kernel: device ms})."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # `fn` has run before (each caller's timed steps); step 1 warms the
    # profiler up (its start-up costs seconds of host time);
    # step 2 is the recorded window, timed on the host around the same calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the step's own range ("ProfilerStep#2") and the optimizers' annotations
    # ("Optimizer.step#Adam.step") span their kernels on the device's timeline
    # too; they are not kernels, and counting them would count those twice
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and dev_us(e) > 0
              and not e.key.startswith(("ProfilerStep", "Optimizer."))]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    # one stream, so kernels do not overlap; the profiler's per-call host work
    # lengthens the window, so the share is a lower bound for an unprofiled run
    log(f"[profile] {label}: device kernels {total_ms:.1f} ms in {wall_ms:.1f} ms wall of the same window, "
        f"busy {total_ms / wall_ms:.1%}, {sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -dev_us(e))[:15]:
        log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    # the host's side of the same window: where the issuing thread spends its time
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0 and not e.key.startswith("ProfilerStep")]
    log(f"[profile] {label}: host self time {sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms, top ops:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[profile]   host {e.self_cpu_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:80]}")
    return total_ms, wall_ms, {e.key: dev_us(e) / 1e3 for e in events}


@contextlib.contextmanager
def plain_attention_calls():
    """Counts, while inside, the calls of the plain ``scaled_dot_attention``
    through every module of the port that holds it, and of K2's and K3's
    plain backward versions (yields a 1-list)."""
    import sparse_caption_tpu_torch.kernels.ancestry_self_attention as k2
    import sparse_caption_tpu_torch.kernels.grouped_cross_attention as k3
    import sparse_caption_tpu_torch.ops.attention as attention

    calls = [0]

    def counting(original):
        def fn(*args, **kwargs):
            calls[0] += 1
            return original(*args, **kwargs)
        return fn

    original = attention.scaled_dot_attention
    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("sparse_caption_tpu_torch") and getattr(m, "scaled_dot_attention", None) is original]
    with contextlib.ExitStack() as stack:
        for m in holders:
            stack.enter_context(mock.patch.object(m, "scaled_dot_attention", counting(original)))
        for m, name in ((k2, "ancestry_self_attention_backward_plain"), (k3, "grouped_cross_attention_backward_plain")):
            stack.enter_context(mock.patch.object(m, name, counting(getattr(m, name))))
        yield calls


def teacher_forced_logprobs(model, memory, seq):
    """Per-token log-probs (B, K, T) of the captions ``seq`` (B, K, T) under
    ``model`` by teacher forcing from BOS (eval mode, the model's device)."""
    b, k, t = seq.shape
    rows = seq.reshape(b * k, t)
    tokens = torch.cat([torch.full((b * k, 1), model.bos_id, dtype=rows.dtype, device=rows.device), rows], dim=1)
    lp = model.decode_teacher_forced(memory, tokens)  # (B * K, T, V)
    return lp.float().gather(-1, rows[..., None])[..., 0].reshape(b, k, t)


def tie_aware_match(seq_card, lp_card, seq_cpu, lp_cpu, rescore, eos_id: int, tol: float = WHOLE_PATH_LP_TOL):
    """The card's captions against the CPU's, with near-ties allowed.

    Rows (image, beam) with identical tokens must have per-token log-probs
    within ``tol``. A row whose tokens differ is rescored on the CPU
    (``rescore(seq) -> per-token log-probs (B, K, T)``, teacher forcing with
    the same weights): it is accepted only if the CPU's score of the card's
    caption (its log-probs summed up to and including the first EOS) is
    within ``tol`` of the CPU beam's own score for that row, and the card's
    per-token log-probs equal that rescoring within ``tol``: the two decodes
    then chose between captions that tie to rounding. Plain torch on CPU
    tensors. Returns (ok, rows accepted as ties, max |log-prob error|)."""
    seq_card, lp_card = seq_card.cpu(), lp_card.cpu().float()
    lp_cpu = lp_cpu.float()
    differ = (seq_card != seq_cpu).any(-1)
    err = (lp_card - lp_cpu)[~differ].abs().max().item() if bool((~differ).any()) else 0.0
    if not bool(differ.any()):
        return err <= tol, 0, err
    def upto_eos(seq):  # positions up to and including the first EOS
        is_eos = (seq == eos_id).long()
        return (is_eos.cumsum(-1) - is_eos) == 0

    rescored = rescore(seq_card).float() * upto_eos(seq_card)
    score_gap = (rescored.sum(-1) - (lp_cpu * upto_eos(seq_cpu)).sum(-1)).abs()[differ]
    token_err = (lp_card * upto_eos(seq_card) - rescored).abs().amax(-1)[differ]
    ties = (score_gap <= tol) & (token_err <= tol)
    return err <= tol and bool(ties.all()), int(ties.sum()), max(err, token_err.max().item())


def whole_path_check(model_f32, gen, make=make_batch, label="whole-path", opt=None) -> bool:
    """f32 on the card (kernels) vs the CPU (plain versions) on the same
    weights: identical captions but for near-ties (``tie_aware_match``);
    ``opt``: the beam search's (default beam 5; diverse groups too)."""
    batch = make(gen, CHECK_BATCH, torch.float32)
    seq_gpu, lp_gpu = caption(model_f32, batch, opt)
    model_cpu = copy.deepcopy(model_f32).to("cpu")
    batch_cpu = tuple(x.cpu() for x in batch)
    seq_cpu, lp_cpu = caption(model_cpu, batch_cpu, opt)
    memory = model_cpu.encode(*batch_cpu)
    good, n_ties, err = tie_aware_match(seq_gpu, lp_gpu, seq_cpu, lp_cpu,
                                        lambda seq: teacher_forced_logprobs(model_cpu, memory, seq), model_cpu.eos_id)
    same = bool(torch.equal(seq_gpu.cpu(), seq_cpu))
    log(f"[{label}] f32 batch {CHECK_BATCH}: tokens identical={same}, rows accepted as near-ties {n_ties}; "
        f"log-prob max_abs_err={err:.3e} (tol {WHOLE_PATH_LP_TOL}) {'ok' if good else 'FAIL'}")
    if not same:
        rows = (seq_gpu.cpu() != seq_cpu).any(-1).nonzero().tolist()
        log(f"[{label}] differing (image, beam) rows: {rows[:10]}")
    return good


# ------------------------------------------------------------- train path
def build_train_model(seed: int, dropout: bool = True, mask_type: str = "supermask"):
    """Paper-width relation_transformer_prune in f32 on the card with its
    masks kept as parameters (supermask logits at 5.0, other types' 0/1
    masks at 1), random weights from the seed."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rates = {} if dropout else dict(dropout_rate=0.0, drop_prob_src=0.0)
    return get_model("relation_transformer_prune")(
        **PAPER, **rates, mask_cfg=MaskConfig(mask_type, MASK_INIT, keep_masks=True), device="cuda", generator=gen)


def make_train_batch(gen, b, device="cuda"):
    att, mask, boxes = make_batch(gen, b, torch.float32, device)
    seqs = torch.randint(4, PAPER["vocab_size"], (b * SEQ_PER_IMG, TRAIN_T), generator=gen, device=device)
    seqs[:, 0] = 2  # BOS
    return dict(att_feats=att, att_masks=mask, boxes=boxes, seqs=seqs,
                seq_masks=torch.ones(b * SEQ_PER_IMG, TRAIN_T, device=device))


def make_train_step(model, precision: str, config=TRAIN_CONFIG):
    from sparse_caption_tpu_torch.engine.optim import build_mask_optimizer, build_weight_optimizer, make_schedule
    from sparse_caption_tpu_torch.engine.training import make_xe_step
    from sparse_caption_tpu_torch.ops.masked import split_params
    from sparse_caption_tpu_torch.pruning import TRAINABLE_MASKS

    config = dict(config, train_precision=precision)
    params, masks = split_params(model)
    opt_w = build_weight_optimizer(params.values(), config, make_schedule(config, steps_per_epoch=1000))
    opt_m = build_mask_optimizer(masks.values(), config, trainable=model.mask_cfg is not None
                                 and model.mask_cfg.mask_type in TRAINABLE_MASKS)
    return make_xe_step(model, opt_w, opt_m, config)


def run_train_phase(model, gen, b, precision, expected, config=TRAIN_CONFIG, make=make_train_batch,
                    label="train") -> dict:
    """1 warm-up + TRAIN_STEPS XE steps: the first counted one checks the
    launch counts, then 3 timed windows of 3 steps (steps/s: best window)."""
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.kernels import launch_counts, reset_launch_counts

    step = make_train_step(model, precision, config)
    batch = make(gen, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, loss, aux = step(TrainState(), batch)  # warm-up
    first = float(loss)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_attention_calls() as plain:
        state, loss, aux = step(state, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == expected, f"train launch counts {counts} != {expected}"
    assert plain[0] == 0, f"the plain scaled_dot_attention ran {plain[0]} times in a {label} step"
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state, loss, aux = step(state, batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 3)
    last = float(loss)
    assert state.step == TRAIN_STEPS + 1 and all(map(math.isfinite, (first, last))), (state, first, last)
    log(f"[{label}] {precision} batch {b}x{SEQ_PER_IMG}: {1 / best:.2f} steps/s ({best * 1e3:.1f} ms per step, best "
        f"window of 3); loss {first:.4f} -> {last:.4f} over {state.step} steps; mask sparsity "
        f"{float(aux.get('mask_sparsity', float('nan'))):.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches per step {counts}")
    return counts


def whole_step_check(seed: int, gen, build=None, make=make_train_batch, config=TRAIN_CONFIG,
                     label="whole-step", context=contextlib.nullcontext) -> bool:
    """One f32 XE step at 2 images x 5, dropout 0, the same mask uniforms, on
    the card (kernels) and on the CPU (plain versions), from the same
    weights: loss, every gradient, every param and mask after the update.
    `build` makes the model without dropout (default: the ORT's); both steps
    run inside `context()` (``card_ss_tokens``: the CPU takes the card's
    scheduled samples)."""
    from sparse_caption_tpu_torch.engine.optim import make_schedule
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.ops.rng import TrainRandom

    model_gpu = build() if build else build_train_model(seed, dropout=False)
    model_cpu = copy.deepcopy(model_gpu).to("cpu")
    batch = make(gen, WHOLE_STEP_BATCH)
    results = {}
    with context():
        for name, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            dev = next(model.parameters()).device
            step = make_train_step(model, "fp32", config)
            rng = TrainRandom(torch.Generator().manual_seed(seed + 7))  # uniforms drawn on the CPU, then moved
            _, loss, _ = step(TrainState(), {k: v.to(dev) for k, v in batch.items()}, rng)
            results[name] = (float(loss), {n: (p.grad.cpu(), p.detach().cpu()) for n, p in model.named_parameters()})
    (loss_g, got), (loss_c, ref) = results["cuda"], results["cpu"]
    ok = abs(loss_g - loss_c) <= STEP_LOSS_RTOL * abs(loss_c)
    log(f"[{label}] f32 batch {WHOLE_STEP_BATCH}x{SEQ_PER_IMG}: loss card {loss_g:.7f} cpu {loss_c:.7f} "
        f"{'ok' if ok else 'FAIL'}")
    top = max(g.abs().max().item() for g, _ in ref.values())
    lr_w = make_schedule(config, steps_per_epoch=1000)(0)  # the first update's LR (noam: 512^-0.5 10000^-1.5)
    worst = {"grad": 0.0, "param": 0.0, "mask": 0.0}
    by_tensor, elementwise_ok = [], 0
    for n, (g_ref, p_ref) in ref.items():
        g_got, p_got = got[n]
        g_tol = STEP_GRAD_TOL * g_ref.abs().max().item() + STEP_GRAD_FLOOR * top
        out = (g_got - g_ref).abs() > g_tol
        elementwise_ok += not bool(out.any())
        norm_ratio = ((g_got - g_ref).norm() / (STEP_GRAD_NORM_TOL * g_ref.norm()
                                                + STEP_GRAD_FLOOR * top * g_ref.numel() ** 0.5)).item()
        rows = int(out.reshape(out.shape[0], -1).any(1).sum())
        by_tensor.append((((g_got - g_ref).abs() / g_tol).max().item(), n, norm_ratio, int(out.sum()), rows,
                          out.shape[0]))
        worst["grad"] = max(worst["grad"], norm_ratio)
        if n.endswith(".mask"):
            # Adam's first update -lr g / (|g| + eps), lr 100, eps 1e-2: slope <= 1e4
            p_tol = 100.0 / 1e-2 * g_tol + 2.0 ** -22 * p_ref.abs()
            kind = "mask"
        else:
            # ~ -lr sign(g): an entry may move either way by lr, plus f32 rounding of p -+ lr
            p_tol = 2 * lr_w * (1 + 2.0 ** -20) + 2.0 ** -20 * p_ref.abs()
            kind = "param"
        worst[kind] = max(worst[kind], ((p_got - p_ref).abs() / p_tol).max().item())
    for ratio, n, norm_ratio, n_out, rows, n_rows in sorted(by_tensor, reverse=True)[:5]:
        log(f"[{label}]   gradient {n}: element-wise worst err/allowed {ratio:.3f} ({n_out} elements in {rows} of "
            f"{n_rows} rows outside), norm-wise err/allowed {norm_ratio:.3f}")
    good = all(v <= 1 for v in worst.values())
    log(f"[{label}] gradients: {elementwise_ok} of {len(ref)} tensors within the element-wise bound ({STEP_GRAD_TOL} "
        f"of each tensor's max + {STEP_GRAD_FLOOR} of the largest, {top:.3e}); worst norm-wise err/allowed "
        f"{worst['grad']:.3f}; params {worst['param']:.3f}, masks {worst['mask']:.3f} {'ok' if good else 'FAIL'}")
    return ok and good


# --------------------------------------------------------------- SCST path
def k2_bwd_bytes(n: int, t: int, h: int = HEADS, dk: int = DK, kv: bool = False) -> int:
    """Bytes K2's backward must move at step t (f32): q and dout in; the (t +
    1) slots of the K and V caches in, of both gradient buffers in and out;
    dq, dk_t and dv_t out. The kv mode: one cache in, one gradient buffer in
    and out, no dv_t."""
    return 4 * n * h * dk * ((4 + 3 * (t + 1)) if kv else (5 + 6 * (t + 1)))


def k3_bwd_bytes(images: int, rep: int, regions: int = REGIONS, h: int = HEADS, dk: int = DK,
                 kv: bool = False) -> int:
    """Bytes K3's backward must move (f32): q, dout in and dq out (a row
    each); the memory K, V in and dK, dV out (an image each; the kv mode:
    one memory in, its one gradient out); the mask."""
    return 4 * (3 * images * rep * h * dk + (2 if kv else 4) * images * h * regions * dk) + images * regions


def check_decode_backward_kernels(gen, results: dict, timing: bool = True) -> bool:
    """K2's and K3's backward kernels (supermask SCST's gradient pass, f32,
    heads of 64) against their plain versions (the autograd of the plain
    forwards) at the pass's shapes, element by element within F32_TOL, each
    element's bound widened by its tensor's rms (a sum of t + 1 slots, or of
    an image's 15 rows, taken in another order; an element that cancels to
    near 0 is held to its tensor's scale):
    - K2 at 960 rows (64 x 15), 8 heads, T_max 17, steps 0, 8 and 16, the
      cache gradient the later steps left random: dq, dk_t, dv_t and the
      buffer after (slots < t added to, slot t zeroed, the rest untouched);
      faults planted: slot t's own contribution left out, and the later
      steps' sum left out of dk_t (the order of the cache's gradients);
      then 17 steps of ``decode_self_attention`` with gradients, the cache
      threaded through each step, against the same steps written out of
      place (each attends a fresh stack of its slots) under autograd;
    - K3 at 64 images x 15 rows, 36 regions, padded regions and image 0
      with none valid: dq, dK, dV; masked regions' dK exactly 0, image 0's
      dV its rows' mean dout; fault planted: each image's dK / dV from its
      first row alone.
    With `timing`: kernel, plain version and SDPA's forward + backward on
    the gathered cache (K2) or with the memory as K/V (K3), in held turns."""
    from sparse_caption_tpu_torch.kernels import KERNELS
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
    from sparse_caption_tpu_torch.ops.attention import NEG_INF

    dev, dt = torch.device("cuda"), torch.float32
    n, h, dk, t_max = SCST_BATCHES[-1] * SCST_SAMPLES, HEADS, DK, MAX_LEN
    ok = True

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def held(name, got, ref, fault=None):
        nonlocal ok
        err, good, worst = close(got, ref, dt, sum_scale=rms(ref))
        log(f"[kernel] {name} f32: max_abs_err={err:.3e} worst err/allowed={worst:.3f} {'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, dt, 0.0, rms(ref))
        return err

    # K2's backward, one step at a time
    q, ck, cv, dout = rnd(n, h, dk), rnd(n, h, t_max, dk), rnd(n, h, t_max, dk), rnd(n, h, dk)
    dck0, dcv0 = rnd(n, h, t_max, dk), rnd(n, h, t_max, dk)  # the later steps' contributions

    def k2_run(fn, t):
        dck, dcv = dck0.clone(), dcv0.clone()
        return (*fn(q, ck, cv, dout, dck, dcv, t), dck, dcv)

    errs = []
    for t in K2_BWD_STEPS:
        got, ref = k2_run(k2.ancestry_self_attention_backward, t), k2_run(k2.ancestry_self_attention_backward_plain, t)
        errs.append(held(f"ancestry_self_attention_bwd t={t} dq", got[0], ref[0]))
        own_k = ref[1] - dck0[:, :, t]  # slot t's own dK (0 at t = 0: one slot, whose score gradient is 0)
        errs.append(held(f"ancestry_self_attention_bwd t={t} dk_t", got[1], ref[1], fault=dck0[:, :, t] if t else None))
        if t == t_max - 1:
            ok &= fault_caught(f"ancestry_self_attention_bwd t={t} dk_t without the later steps' sum", own_k, ref[1],
                               dt, 0.0, rms(ref[1]))
        errs.append(held(f"ancestry_self_attention_bwd t={t} dv_t", got[2], ref[2], fault=dcv0[:, :, t]))
        errs.append(held(f"ancestry_self_attention_bwd t={t} dcache_k", got[3], ref[3]))
        errs.append(held(f"ancestry_self_attention_bwd t={t} dcache_v", got[4], ref[4]))
        untouched = bool(torch.equal(got[3][:, :, t + 1:], dck0[:, :, t + 1:])) and not got[3][:, :, t].any()
        log(f"[kernel] ancestry_self_attention_bwd t={t}: slot t zeroed, slots past t untouched "
            f"{'ok' if untouched else 'FAIL'}")
        ok &= untouched
        del got, ref, own_k

    # 17 steps through the cache threaded under autograd, against the out-of-place steps
    g17 = torch.Generator(device=dev).manual_seed(SEED + 17 * 17)
    qs, ks, vs, gs = ([torch.randn(n, h, dk, generator=g17, device=dev).requires_grad_(i < 3) for _ in range(t_max)]
                      for i in range(4))
    cache_k, cache_v = torch.zeros(n, h, t_max, dk, device=dev), torch.zeros(n, h, t_max, dk, device=dev)
    before = KERNELS["ancestry_self_attention_bwd"].launches
    outs = [k2.decode_self_attention(qs[t], ks[t], vs[t], cache_k, cache_v, None, t) for t in range(t_max)]
    got = torch.autograd.grad(outs, qs + ks + vs, gs)
    launched = KERNELS["ancestry_self_attention_bwd"].launches - before
    ref_outs = [k2.ancestry_self_attention_plain(qs[t], torch.stack(ks[: t + 1], 2), torch.stack(vs[: t + 1], 2),
                                                 None, t) for t in range(t_max)]
    want = torch.autograd.grad(ref_outs, qs + ks + vs, gs)
    for name, a, b in (("dq", torch.stack(got[:t_max]), torch.stack(want[:t_max])),
                       ("dk", torch.stack(got[t_max:2 * t_max]), torch.stack(want[t_max:2 * t_max])),
                       ("dv", torch.stack(got[2 * t_max:]), torch.stack(want[2 * t_max:]))):
        errs.append(held(f"decode_self_attention {t_max} steps, the cache threaded: {name}", a, b))
    log(f"[kernel] decode_self_attention {t_max} steps: {launched} K2 backward launches "
        f"{'ok' if launched == t_max else 'FAIL'}")
    ok &= launched == t_max
    del qs, ks, vs, gs, outs, got, ref_outs, want, cache_k, cache_v

    times = {}
    if timing:
        for t in K2_BWD_STEPS:
            q4 = q[:, :, None].clone().requires_grad_()
            kg = ck[:, :, : t + 1].contiguous().requires_grad_()
            vg = cv[:, :, : t + 1].contiguous().requires_grad_()
            d4 = dout[:, :, None]
            dck, dcv = dck0.clone(), dcv0.clone()
            times[t] = turns_ms(lambda: k2.ancestry_self_attention_backward(q, ck, cv, dout, dck, dcv, t),
                                lambda: k2.ancestry_self_attention_backward_plain(q, ck, cv, dout, dck, dcv, t),
                                lambda: torch.autograd.grad(F.scaled_dot_product_attention(q4, kg, vg), (q4, kg, vg),
                                                            d4))
            bnd = bound_ms(k2_bwd_bytes(n, t), {})[0]
            log(f"[kernel] ancestry_self_attention_bwd f32 {n} rows t={t}: ms={times[t][0]:.4f} "
                f"plain_ms={times[t][1]:.4f} library_ms={times[t][2]:.4f} (SDPA fwd + bwd, gathered cache) "
                f"bound_ms={bnd:.4f} (bytes; held windows in turns)")
        last = K2_BWD_STEPS[-1]
        bnd, by = bound_ms(k2_bwd_bytes(n, last), {})
        results["ancestry_self_attention_bwd"] = dict(
            max_abs_err=max(errs), ms=times[last][0], plain_ms=times[last][1], library_ms=times[last][2],
            bound_ms=bnd, bound_by=by, **{f"t{t}_{k}": v for t in K2_BWD_STEPS
                                          for k, v in zip(("ms", "plain_ms", "library_ms"), times[t])})
    del q, ck, cv, dout, dck0, dcv0

    # K3's backward: one image's rows summed in the kernel in a fixed order
    b, rep = SCST_BATCHES[-1], SCST_SAMPLES
    q, dout = rnd(b * rep, h, dk), rnd(b * rep, h, dk)
    mk, mv = rnd(b, h, REGIONS, dk), rnd(b, h, REGIONS, dk)
    mask = random_region_mask(gen, b, REGIONS, dev)
    mask[0] = False  # no valid region: the fill gives every region the same weight
    got = k3.grouped_cross_attention_backward(q, mk, mv, mask, dout)
    ref = k3.grouped_cross_attention_backward_plain(q, mk, mv, mask, dout)
    first = dout.reshape(b, rep, h, dk).clone()
    first[:, 1:] = 0  # each image's first row alone
    fault = k3.grouped_cross_attention_backward_plain(q, mk, mv, mask, first.reshape(b * rep, h, dk))
    errs = [held("grouped_cross_attention_bwd dq", got[0], ref[0]),
            held("grouped_cross_attention_bwd dK", got[1], ref[1], fault=fault[1]),
            held("grouped_cross_attention_bwd dV", got[2], ref[2], fault=fault[2])]
    dropped = ~mask[:, None, :, None].expand_as(got[1])
    zero_dk = not got[1][dropped].any()
    mean_dv = dout[:rep].sum(0)[:, None, :].expand(h, REGIONS, dk) / REGIONS
    err0, good0, _ = close(got[2][0], mean_dv, dt, sum_scale=rms(mean_dv))
    log(f"[kernel] grouped_cross_attention_bwd: masked regions' dK exactly 0 {'ok' if zero_dk else 'FAIL'}; "
        f"image 0 (no valid region) dV - its rows' mean dout max {err0:.3e} {'ok' if good0 else 'FAIL'}; "
        f"{int(mask.sum())} of {mask.numel()} regions valid")
    ok &= zero_dk and good0
    del got, ref, fault, first
    if timing:
        qg = q.reshape(b, rep, h, dk).transpose(1, 2).contiguous().requires_grad_()  # (B, h, rep, dk)
        kl, vl = mk.clone().requires_grad_(), mv.clone().requires_grad_()
        fill = torch.zeros(b, 1, 1, REGIONS, device=dev).masked_fill(~mask[:, None, None, :], NEG_INF)
        dg = dout.reshape(b, rep, h, dk).transpose(1, 2).contiguous()
        t_k, t_p, t_l = turns_ms(lambda: k3.grouped_cross_attention_backward(q, mk, mv, mask, dout),
                                 lambda: k3.grouped_cross_attention_backward_plain(q, mk, mv, mask, dout),
                                 lambda: torch.autograd.grad(F.scaled_dot_product_attention(qg, kl, vl, fill),
                                                             (qg, kl, vl), dg))
        bnd, by = bound_ms(k3_bwd_bytes(b, rep), {})
        log(f"[kernel] grouped_cross_attention_bwd f32 {b}x{rep}: ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
            f"(SDPA fwd + bwd, float mask) bound_ms={bnd:.4f} ({by}; held windows in turns)")
        results["grouped_cross_attention_bwd"] = dict(max_abs_err=max(errs), ms=t_k, plain_ms=t_p, library_ms=t_l,
                                                      bound_ms=bnd, bound_by=by)
    return ok


def check_scst_kernels(gen, results: dict) -> bool:
    """K8, K9 and K10 against their plain versions at the SCST path's shapes
    (f32, its dtype), each with a planted fault; timings."""
    from sparse_caption_tpu_torch.kernels import cider_reward as k10
    from sparse_caption_tpu_torch.kernels import keyed_dropout as k8
    from sparse_caption_tpu_torch.kernels import sample_step as k9
    from sparse_caption_tpu_torch.ops.rng import SAMPLE_SITE

    dev, dtype = torch.device("cuda"), torch.float32
    ok = True

    def record(name, err, ms, plain_ms, lib_ms, nbytes, ops):
        bnd, by = bound_ms(nbytes, ops)
        log(f"[kernel] {name} f32: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms={bnd:.4f} ({by}; held windows in turns)")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)

    def exact(name, out, ref) -> bool:
        same = bool(torch.equal(out, ref))
        log(f"[kernel] {name}: {'exact' if same else 'DIFFERS'} ({int((out != ref).sum())} of {ref.numel()} differ)")
        return same

    # K8 at the replay shape of the FFN site: 5 x 15 rows, 17 steps, 2048 wide
    n, tl, d, kp, key, site = 5 * SCST_SAMPLES, MAX_LEN, PAPER["dim_feedforward"], 0.9, 0x5EED5EED12345, 4242
    keep = k8.keyed_keep_mask(key, site, 0, n, tl, d, kp, dev)
    ok &= exact("keyed_keep_mask replay vs plain", keep, k8.keyed_keep_mask_plain(key, site, 0, n, tl, d, kp, dev))
    steps = torch.cat([k8.keyed_keep_mask(key, site, step, n, 1, d, kp, dev) for step in range(tl)], 1)
    ok &= exact("keyed_keep_mask replay vs 17 step draws", keep, steps)

    def flat_keyed(t0, tl_):  # fault: the counter is the flat element index, not (t, row, column)
        e4 = torch.arange((n * tl_ * d + 3) // 4, device=dev)
        words = k8.philox4x32_10(torch.full_like(e4, site), torch.full_like(e4, t0), torch.zeros_like(e4), e4, key)
        return k8.keep_from_bits(torch.stack(words, -1).flatten()[: n * tl_ * d].reshape(n, tl_, d), kp)

    n_diff = int((flat_keyed(0, tl) != torch.cat([flat_keyed(step, 1) for step in range(tl)], 1)).sum())
    log(f"[fault] keyed_keep_mask keyed by flat index: replay vs step draws differ in {n_diff} elements "
        f"{'caught' if n_diff else 'MISSED'}")
    ok &= n_diff > 0
    log(f"[kernel] keyed_keep_mask: keep rate {keep.float().mean().item():.5f} (keep_prob {kp})")
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.randn(n, tl, d, generator=gen, device=dev).to(xdt).requires_grad_()
        out = k8.keyed_dropout(x, key, site, 0, kp)
        (gx,) = torch.autograd.grad(out, x, torch.ones_like(out))
        ok &= exact(f"keyed_dropout apply {str(xdt).split('.')[-1]}", out.detach(),
                    k8.keyed_dropout_plain(x.detach(), key, site, 0, kp))
        ok &= exact(f"keyed_dropout apply backward {str(xdt).split('.')[-1]}", gx,
                    k8.keyed_dropout_plain(torch.ones_like(x), key, site, 0, kp))
    record("keyed_dropout", 0.0, *turns_ms(lambda: k8.keyed_keep_mask(key, site, 0, n, tl, d, kp, dev),
                                           lambda: k8.keyed_keep_mask_plain(key, site, 0, n, tl, d, kp, dev)), None,
           n * tl * d, {})
    x32 = torch.randn(n, tl, d, generator=gen, device=dev)
    apply_ms, apply_plain_ms = turns_ms(lambda: k8.keyed_dropout(x32, key, site, 0, kp),
                                        lambda: k8.keyed_dropout_plain(x32, key, site, 0, kp))
    log(f"[kernel] keyed_dropout apply f32: ms={apply_ms:.4f} plain_ms={apply_plain_ms:.4f} "
        f"(bound {bound_ms(2 * 4 * n * tl * d, {})[0]:.4f}, bytes)")

    # K9 at 64 x 15 rows over the vocabulary
    n, vocab, t_max, step = 64 * SCST_SAMPLES, PAPER["vocab_size"], MAX_LEN, 5
    logits = torch.randn(n, vocab, generator=gen, device=dev) * 3.0
    prev = torch.randint(4, vocab, (n,), generator=gen, device=dev, dtype=torch.int32)
    unfinished = torch.rand(n, generator=gen, device=dev) < 0.8
    logits[:, 3] += 4.0 * (torch.rand(n, generator=gen, device=dev) < 0.3)  # some rows finish here
    k9_err = 0.0
    for label, kw in (("random T=1", dict(temperature=1.0)), ("random T=0.7 ban", dict(temperature=0.7, ban_prev=True)),
                      ("greedy ban", dict(greedy=True, ban_prev=True))):
        outs = {}
        for impl, fn in (("kernel", k9.sample_step), ("plain", k9.sample_step_plain)):
            u = unfinished.clone()
            seq = torch.zeros(n, t_max, dtype=torch.int32, device=dev)
            lp = torch.zeros(n, t_max, device=dev)
            nxt = fn(logits, prev, u, seq, lp, step, key=key, site=SAMPLE_SITE, **kw)
            outs[impl] = (nxt, u, seq, lp)
        (kn, ku, ks, kl), (pn, pu, ps, pl) = outs["kernel"], outs["plain"]
        c = k9.sample_logprobs(logits, prev, kw.get("ban_prev", False))
        z = c if kw.get("greedy") else c / kw["temperature"] + k9.gumbel_noise(key, SAMPLE_SITE, step, n, vocab, dev)
        differ = kn != pn
        # a token may differ only at a near-tie: the plain z at the kernel's token within f32 rounding of the max
        z_max = z.max(1).values
        tie_ok = bool(((z_max - z.gather(1, kn.long()[:, None])[:, 0]).abs() <= allowed(z_max, dtype))[differ].all())
        same = ~differ
        lp_err, lp_good, lp_worst = close(kl[:, step][same], pl[:, step][same], dtype)
        k9_err = max(k9_err, lp_err)
        rest = bool(torch.equal(ku[same], pu[same]) and torch.equal(ks[same], ps[same]))
        log(f"[kernel] sample_step {label}: tokens differing {int(differ.sum())}/{n} (near-ties ok={tie_ok}); chosen "
            f"log-prob max_abs_err={lp_err:.3e} worst err/allowed={lp_worst:.3f}; latch and seq equal={rest}")
        ok &= tie_ok and lp_good and rest
        if label.startswith("random T=0.7"):  # fault: the chosen log-prob taken after the temperature
            fault = c.gather(1, pn.long()[:, None])[:, 0] / kw["temperature"]
            ok &= fault_caught("sample_step chosen log-prob tempered", fault, pl[:, step], dtype, 0.0)
    g = k9.gumbel_noise(key, SAMPLE_SITE, step, n, vocab, dev)
    u = unfinished.clone()
    seq, lp = torch.zeros(n, t_max, dtype=torch.int32, device=dev), torch.zeros(n, t_max, device=dev)

    def library():
        lps = torch.log_softmax(logits, dim=-1)
        return lps.gather(1, torch.argmax(lps + g, dim=-1, keepdim=True))

    k9_times = turns_ms(lambda: k9.sample_step(logits, prev, u, seq, lp, step, key=key, site=SAMPLE_SITE),
                        lambda: k9.sample_step_plain(logits, prev, u, seq, lp, step, key=key, site=SAMPLE_SITE),
                        library)
    _, logged = k9_skip_model(logits, k9.sample_logprobs(logits, prev, False),
                              k9.keyed_uniform(key, SAMPLE_SITE, step, n, vocab, dev), "random", 1.0)
    bnd, by = k9_bound(n, vocab, torch.float32, int(logged.sum()))
    log(f"[kernel] sample_step f32: ms={k9_times[0]:.4f} plain_ms={k9_times[1]:.4f} library_ms={k9_times[2]:.4f} "
        f"bound_ms={bnd:.4f} ({by}: {int(logged.sum())} entries take the logs; held windows in turns)")
    results["sample_step"] = dict(max_abs_err=k9_err, ms=k9_times[0], plain_ms=k9_times[1], library_ms=k9_times[2],
                                  bound_ms=bnd, bound_by=by)

    # K10: 64 images x 15 captions of 17 tokens against 5 refs each
    b = 64
    table, pack = scst_reward_setup(b, dev)
    tbl = table.to(dev)
    tensors = {"hi": tbl.hi, "lo": tbl.lo, "val": tbl.val}
    ids = torch.randint(4, 200, (b * SCST_SAMPLES, MAX_LEN), generator=gen, device=dev, dtype=torch.int32)
    eos_at = torch.randint(3, MAX_LEN + 4, (b * SCST_SAMPLES, 1), generator=gen, device=dev)
    ids = torch.where(torch.arange(MAX_LEN, device=dev)[None] == eos_at, torch.full_like(ids, 3), ids)
    ids[::7, 2] = 0  # pad / bos noise inside some captions
    ids[::11, 4] = 2
    ids[::5, 6:10] = ids[::5, 2:6]  # repeated grams
    img = torch.arange(b, device=dev, dtype=torch.int32).repeat_interleave(SCST_SAMPLES)
    kw = dict(probe=table.probe, ref_len=table.ref_len, bleu_weight=SCST_BLEU)
    got = k10.cider_reward(ids, img, tensors, pack, **kw)
    ref = k10.cider_reward_plain(ids, img, tensors, pack, **kw)
    err = (got - ref).abs()
    good = bool((err <= REWARD_RTOL * ref.abs() + REWARD_ATOL).all())
    log(f"[kernel] cider_reward: {b * SCST_SAMPLES} captions, rewards in [{ref.min().item():.4f}, "
        f"{ref.max().item():.4f}], max_abs_err={err.max().item():.3e} (rtol {REWARD_RTOL}, atol {REWARD_ATOL}) "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    for label, target, fake in (("without the length penalty", "length_penalty", lambda lh, rl: torch.ones_like(rl)),
                                ("without first-occurrence dedup", "first_occurrence", lambda eqv, gvalid: gvalid)):
        with mock.patch.object(k10, target, fake):
            fault = k10.cider_reward_plain(ids, img, tensors, pack, **kw)
        frac = ((fault - ref).abs() > REWARD_RTOL * ref.abs() + REWARD_ATOL).float().mean().item()
        log(f"[fault] cider_reward {label}: {frac:.3f} of captions outside the tolerance "
            f"{'caught' if frac > 0 else 'MISSED'}")
        ok &= frac > 0
    ghi, glo, _, _, _ = k10.grams(ids, 3, 0, 2)
    slots = ((k10.mix(ghi, glo) & (table.size - 1))[..., None] + torch.arange(table.probe, device=dev)) % table.size
    used = torch.unique(img.long())
    pack_bytes = sum(v[used].numel() * v.element_size() for v in pack.values())
    record("cider_reward", err.max().item(), *turns_ms(lambda: k10.cider_reward(ids, img, tensors, pack, **kw),
                                                       lambda: k10.cider_reward_plain(ids, img, tensors, pack, **kw)),
           None,
           ids.numel() * 4 + img.numel() * 4 + pack_bytes + torch.unique(slots).numel() * 12 + ids.shape[0] * 4, {})
    return ok


def scst_reward_setup(b: int, device, seed: int = 2, gts=None, tok=None):
    """(df table, ref pack on `device`) of b images with 5 synthetic refs
    each (token ids as words, bench.py:354-362), or the given `gts`, and the
    df of those refs. With `tok` (ACORT's radix tokenizer): (the run's
    DeviceReward, its ref pack), the reward regrouping digits in K10."""
    from sparse_caption_tpu_torch.kernels import _build
    from sparse_caption_tpu_torch.metrics.cider import build_df_pickle, load_df_pickle
    from sparse_caption_tpu_torch.scst.device_reward import DeviceReward, DfTable, scst_ref_pack

    rng = np.random.default_rng(seed)
    if gts is None:
        gts = [[" ".join(f"w{i}" for i in rng.integers(4, 200, rng.integers(8, 15))) for _ in range(5)]
               for _ in range(b)]
    path = _build.BUILD_DIR.parent / "scst_smoke" / f"df_{b}.p"
    path.parent.mkdir(parents=True, exist_ok=True)
    build_df_pickle(gts, str(path))
    df, ref_len = load_df_pickle(str(path))
    if tok is not None:
        reward = DeviceReward(tok, df, ref_len, {"scst_bleu_weight": list(SCST_BLEU)})
        return reward, reward.ref_pack(gts, device)
    tok2id = {w: i for i, w in enumerate(["<pad>", "<unk>", "<bos>", "<eos>"])}
    tok2id.update({f"w{i}": i for i in range(4, PAPER["vocab_size"])})
    table = DfTable.build(df, ref_len, tok2id)
    return table, scst_ref_pack(gts, df, table, tok2id, PAPER["vocab_size"], device)


def freeze_masks(model, gen, sparsity: float, label: str):
    """mask_freeze's frozen 0/1 masks, kept as parameters (bench.py:340-344:
    kept where a uniform >= the sparsity)."""
    from sparse_caption_tpu_torch.ops.masked import split_params

    _, masks = split_params(model)
    with torch.no_grad():
        for m in masks.values():
            m.copy_((torch.rand(m.shape, generator=gen, device="cuda") >= sparsity).float())
    kept = sum(int(m.sum()) for m in masks.values()) / sum(m.numel() for m in masks.values())
    log(f"[{label}] mask_freeze: {len(masks)} masks, {kept:.4f} of the masked weights kept")
    return model


def build_scst_model(seed: int):
    """Paper-width relation_transformer_prune in f32 on the card, mask_freeze
    at 0.9875, random weights from the seed, dropout on."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model("relation_transformer_prune")(
        **PAPER, mask_cfg=MaskConfig("mask_freeze", keep_masks=True), device="cuda", generator=gen)
    return freeze_masks(model, gen, SCST_SPARSITY, "scst")


def build_updown_scst(seed: int):
    """Paper-width up_down_lstm_prune in f32 on the card, mask_freeze at
    0.991, random weights from the seed, dropout 0.1 (the paper's Up-Down
    SCST, resources/commands_pruning.sh:113)."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model("up_down_lstm_prune")(**UPDOWN, drop_prob_lm=UPDOWN_DROP, device="cuda", generator=gen,
                                            mask_cfg=MaskConfig("mask_freeze", keep_masks=True))
    return freeze_masks(model, gen, UPDOWN_SCST_SPARSITY, "updown scst")


def is_supermask(model) -> bool:
    return model.mask_cfg is not None and model.mask_cfg.is_supermask


def supermask_logits(model, gen, label: str):
    """The supermask logits drawn N(0, SUPERMASK_LOGIT_STD) from `gen`, so
    that the Bernoulli samples vary from step to step."""
    from sparse_caption_tpu_torch.ops.masked import split_params

    _, masks = split_params(model)
    with torch.no_grad():
        for m in masks.values():
            m.copy_(torch.randn(m.shape, generator=gen, device="cuda") * SUPERMASK_LOGIT_STD)
    n = sum(m.numel() for m in masks.values())
    kept = sum(float(torch.sigmoid(m).sum()) for m in masks.values()) / n
    log(f"[{label}] supermask: {len(masks)} masks, {n} logits N(0, {SUPERMASK_LOGIT_STD}), expected kept share "
        f"{kept:.4f}")
    return model


def build_supermask_scst(seed: int):
    """Paper-width relation_transformer_prune in f32 on the card, a training
    supermask (MaskConfig("supermask", 5.0), masks kept), random weights and
    mask logits from the seed, dropout on (0.1, the source 0.5)."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model("relation_transformer_prune")(
        **PAPER, mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True), device="cuda", generator=gen)
    return supermask_logits(model, gen, "supermask scst")


def build_supermask_updown(seed: int):
    """Paper-width up_down_lstm_prune in f32 on the card, a training
    supermask, random weights and mask logits from the seed, dropout 0.1."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model("up_down_lstm_prune")(**UPDOWN, drop_prob_lm=UPDOWN_DROP, device="cuda", generator=gen,
                                            mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    return supermask_logits(model, gen, "updown supermask scst")


def supermask_scst_launches(layers: int, steps: int, names) -> dict:
    """Launches of one supermask ORT SCST step: the sampling phase (a
    train-mode encode and `steps` decode steps, no gradients) and the
    gradient pass (the same encode, cache and steps with gradients, their
    backward), the reward between. Each phase draws K5 keyed sets: the
    encode's, the cross K/V projection's and one a step."""
    enc_k6, dec_k6 = 1 + 2 * layers, 1 + 3 * layers
    sets = 2 + steps
    counts = {name: 0 for name in names}
    counts.update(box_attention_train=2 * layers, box_attention_bwd=layers, ancestry_self_attention=2 * layers * steps,
                  ancestry_self_attention_bwd=layers * steps, grouped_cross_attention=2 * layers * steps,
                  grouped_cross_attention_bwd=layers * steps, supermask_keyed=2 * sets, supermask_bwd=sets,
                  add_ref_layernorm=2 * (enc_k6 + steps * dec_k6), add_ref_layernorm_bwd=enc_k6 + steps * dec_k6,
                  keyed_keep_mask=2 * 3 * layers * (steps + 1), keyed_dropout=3 * (1 + layers) * (steps + 1),
                  sample_step=steps, cider_reward=1, vocab_log_softmax=steps, vocab_log_softmax_bwd=steps)
    return counts


def supermask_updown_scst_launches(steps: int, names) -> dict:
    """Launches of one supermask Up-Down SCST step: the mask_freeze step's
    (``updown_scst_launches``) but every masked product drawn as a keyed set
    in both phases (the encode's and one a step), none cached."""
    counts = updown_scst_launches(steps, names)
    counts.update(supermask=0, supermask_keyed=2 * (1 + steps))
    return counts


def make_scst(model, table, samples: int = SCST_SAMPLES, config=SCST_CONFIG):
    """The SCST step of `model` with the reward of `table` (a DfTable, or an
    ACORT run's DeviceReward)."""
    from sparse_caption_tpu_torch.engine.optim import build_mask_optimizer, build_weight_optimizer, make_schedule
    from sparse_caption_tpu_torch.engine.training import make_scst_step
    from sparse_caption_tpu_torch.ops.masked import split_params
    from sparse_caption_tpu_torch.scst.device_reward import DeviceReward, make_reward_fn

    config = dict(config, scst_num_samples=samples)
    params, masks = split_params(model)
    opt_w = build_weight_optimizer(params.values(), config, make_schedule(config))
    # the mask Adam (lr 100, eps 1e-2) trains a supermask; mask_freeze's masks stay
    opt_m = build_mask_optimizer(masks.values(), config, trainable=is_supermask(model))
    reward_fn = table.fn if isinstance(table, DeviceReward) else make_reward_fn(table, bleu_weight=SCST_BLEU)
    step = make_scst_step(model, opt_w, opt_m, config, reward_fn)
    step.reward = reward_fn
    return step


def scst_launches(layers: int, steps: int, n_masked: int, names) -> dict:
    """Launches of one SCST step: a train-mode encode and `steps` decode steps
    without gradients, the reward, then the replay's encode and decoder pass
    with their backward. Masked weights are multiplied one tensor a launch
    once per sampling phase (kept until the next update), and as one K5 set
    in the replay."""
    enc_k6, dec_k6 = 1 + 2 * layers, 1 + 3 * layers
    counts = {name: 0 for name in names}
    counts.update(box_attention_train=2 * layers, box_attention_bwd=layers, ancestry_self_attention=layers * steps,
                  grouped_cross_attention=layers * steps, supermask=n_masked + 1, supermask_bwd=1,
                  add_ref_layernorm=enc_k6 + steps * dec_k6 + enc_k6 + dec_k6, add_ref_layernorm_bwd=enc_k6 + dec_k6,
                  keyed_keep_mask=3 * layers * (steps + 3), keyed_dropout=(1 + layers) * (steps + 5),
                  sample_step=steps, cider_reward=1, vocab_log_softmax=1, vocab_log_softmax_bwd=1,
                  decoder_attention=2 * layers, decoder_attention_bwd=2 * layers)
    return counts


def updown_scst_launches(steps: int, names) -> dict:
    """Launches of one Up-Down SCST step: the sampling phase (a train-mode
    encode and `steps` decode steps without gradients: each of the 11 masked
    tensors multiplied once, kept until the update; two LSTM cells, the
    attention, the sampling step and two keyed dropouts per step, two in
    the encode), the reward, then the replay: the encode's 3 masked tensors
    as one K5 set and each unrolled step's 8 as another (fresh products on
    every call, as flax samples them), and the backward of each set."""
    sets = 1 + steps
    counts = {name: 0 for name in names}
    counts.update(supermask=11 + sets, supermask_bwd=sets, keyed_dropout=3 * (2 + 2 * steps),
                  lstm_cell=4 * steps, lstm_cell_bwd=2 * steps, additive_attention=2 * steps,
                  additive_attention_bwd=steps, sample_step=steps, cider_reward=1, vocab_log_softmax=1,
                  vocab_log_softmax_bwd=1)
    return counts


def scst_batch(gen, b, pack):
    att, mask, boxes = make_batch(gen, b, torch.float32, pack["hi"].device)
    return dict(att_feats=att, att_masks=mask, boxes=boxes, ref_pack=pack)


def updown_scst_batch(gen, b, pack):
    att, mask, fc = make_updown_batch(gen, b, torch.float32, pack["hi"].device)
    return dict(att_feats=att, att_masks=mask, fc_feats=fc, ref_pack=pack)


def run_scst_phase(model, gen, b, expected, samples=SCST_SAMPLES, make=scst_batch, label="scst", tok=None,
                   config=SCST_CONFIG, steps=SCST_STEPS) -> tuple:
    """1 warm-up + `steps` steps at b x samples; every step's launches must
    equal `expected`, and the plain scaled_dot_attention (and K2's and K3's
    plain backward) never runs. `tok`: ACORT's radix tokenizer, whose device
    reward scores the digits. Returns (counts per step, step, state, batch)."""
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.kernels import launch_counts, reset_launch_counts

    table, pack = scst_reward_setup(b, "cuda", tok=tok)
    step = make_scst(model, table, samples, config)
    batch = make(gen, b, pack)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, loss, aux = step(TrainState(), batch)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with plain_attention_calls() as plain:
        for _ in range(steps):
            state, loss, aux = step(state, batch)
        torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps
    counts = launch_counts()
    assert counts == {k: steps * v for k, v in expected.items()}, f"{label} launch counts {counts} != {steps} x {expected}"
    assert plain[0] == 0, f"the plain attention versions ran {plain[0]} times in {steps} {label} steps"
    assert math.isfinite(float(loss)) and state.step == steps + 1
    log(f"[{label}] f32 batch {b}x{samples}: {1 / per_step:.3f} steps/s, {b * samples / per_step:.1f} "
        f"samples/s ({per_step * 1e3:.1f} ms per step, mean of {steps}); loss {float(loss):.5f}, avg_sample "
        f"{float(aux['avg_sample']):.5f}, avg_reward {float(aux['avg_reward']):.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per step {expected}")
    return expected, step, state, batch


def replay_check(model, gen, make=make_batch, samples=SCST_SAMPLES, label="replay", max_len=MAX_LEN) -> bool:
    """At 5 x samples with dropout on: the replay's log-probs at non-pad
    positions equal the sampling decode's (ORT: K14 over the sequence vs
    K2/K3 over the cache; a supermask ORT: the decode run again with
    gradients, K13 against K9; Up-Down: the same unrolled steps with and
    without gradients)."""
    from sparse_caption_tpu_torch.decoding import generate
    from sparse_caption_tpu_torch.engine.training import scan_log_probs
    from sparse_caption_tpu_torch.ops.rng import KeyedStream, decode_train_keys

    batch = make(gen, SCST_BATCHES[0], torch.float32)
    opt = {"num_random_sample": samples, "beam_size": 0, "max_seq_length": max_len, "decode_train": True}
    with torch.no_grad():
        memory = model.encode(*batch, train=True, rng=KeyedStream(11))
        seq, seq_lp = generate(model, memory, opt, rng=12)
        flat = seq.reshape(-1, max_len).long()
        seqs_in = torch.cat([torch.full((flat.shape[0], 1), model.bos_id, device=flat.device), flat], 1)
    if is_supermask(model) and not getattr(model, "STEPWISE_REPLAY", False):
        # supermask ORT: the gradient pass re-runs the decode with gradients (K2's and K3's backward ready)
        at = scan_log_probs(model, model.encode(*batch, train=True, rng=KeyedStream(11)), flat, 12).detach()
    else:
        with torch.no_grad():
            lp = model.decode_teacher_forced(memory, seqs_in, train=True,
                                             rng=KeyedStream(decode_train_keys(12).dropout))
            at = lp.gather(2, flat[..., None])[..., 0]
    valid = flat != model.pad_id
    gap = (at - seq_lp.reshape(-1, max_len))[valid].abs().max().item()
    log(f"[{label}] f32 {SCST_BATCHES[0]}x{samples}: {int(valid.sum())} non-pad positions, worst |replay - "
        f"sampling| log-prob {gap:.3e} (tol {REPLAY_LP_TOL}) {'ok' if gap <= REPLAY_LP_TOL else 'FAIL'}")
    return gap <= REPLAY_LP_TOL


def scst_whole_step_check(seed: int, gen, build=build_scst_model, make=make_batch, label="scst-step", tok=None,
                          config=SCST_CONFIG, max_len=MAX_LEN) -> bool:
    """One f32 SCST step at 2 x 3 with dropout on, on the card and on the CPU
    from the same weights and seed (`build`; inputs from `make` in the
    model's COLLATE_FIELDS order); the card's tokens feed both replays (and
    under beam-sample SCST the card's search decisions both gradient passes).
    `tok`: ACORT's radix tokenizer (its device reward; refs from its decode).
    A training supermask's keyed draws: the flips of every set the card draws
    are counted (``keyed_flip_counts``), and the CPU takes the card's samples
    (``card_sample_bits``): a flipped sample is a different weight, not
    rounding, and the bound holds rounding."""
    from sparse_caption_tpu_torch.engine.training import TrainState

    from sparse_caption_tpu_torch.scst.device_reward import DfTable

    model_gpu = build(seed)
    model_cpu = copy.deepcopy(model_gpu).to("cpu")
    supermask, flips = is_supermask(model_cpu), []
    counting = (lambda: keyed_flip_counts(flips)) if supermask else contextlib.nullcontext
    card_p = card_sigmoids(model_gpu, model_cpu) if supermask else None
    on_cpu = (lambda: card_sample_bits(card_p)) if supermask else contextlib.nullcontext
    inputs = dict(zip(model_gpu.COLLATE_FIELDS, make(gen, SCST_CHECK_BATCH, torch.float32)))
    # the sampling phase reads no reference; each image's refs are then its
    # first sample (every third word dropped) and four unrelated captions, so
    # that the leave-one-out rewards, and with them the gradients, are far
    # from 0 (the near-uniform policy's loss stays near 0: lp is ~ -log V at
    # every token and the rewards of an image sum to 0)
    with counting():
        res = make_scst(model_gpu, DfTable.build({}, 0.0, {}), SCST_CHECK_SAMPLES, config).sample_fn(TrainState(),
                                                                                                   inputs)
    rng = np.random.default_rng(seed)
    gts = []
    for rows in res["sample"].cpu().tolist():
        if tok is None:
            first = rows[0][:rows[0].index(3)] if 3 in rows[0] else rows[0]
            ref0 = " ".join(f"w{i}" for j, i in enumerate(first) if j % 3 != 2 and i > 3)
        else:  # the radix digits decoded to words
            ref0 = " ".join(w for j, w in enumerate(tok.decode(rows[0]).split()) if j % 3 != 2 and w != "<unk>")
        gts.append([ref0] + [" ".join(f"w{i}" for i in rng.integers(4, 200, 10)) for _ in range(4)])
    table, pack = scst_reward_setup(SCST_CHECK_BATCH, "cuda", gts=gts, tok=tok)
    batch_gpu = dict(inputs, ref_pack=pack)
    batch_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                 for k, v in batch_gpu.items()}
    step_gpu = make_scst(model_gpu, table, SCST_CHECK_SAMPLES, config)
    step_cpu = make_scst(model_cpu, table, SCST_CHECK_SAMPLES, config)
    with on_cpu():
        res_cpu = step_cpu.sample_fn(TrainState(), batch_cpu)
    n_tok = int((res["sample"].cpu() != res_cpu["sample"]).sum())
    flat = res["sample"].reshape(-1, max_len)
    img = torch.arange(SCST_CHECK_BATCH, device="cuda", dtype=torch.int32).repeat_interleave(SCST_CHECK_SAMPLES)
    r_gpu = step_gpu.reward(flat, img, pack).cpu()
    r_cpu = step_cpu.reward(flat.cpu(), img.cpu(), batch_cpu["ref_pack"])
    r_err = (r_gpu - r_cpu).abs()
    r_ok = bool((r_err <= REWARD_RTOL * r_cpu.abs() + REWARD_ATOL).all())
    with counting():
        _, loss_g, _ = step_gpu.grad_fn(TrainState(), batch_gpu, res)
    with on_cpu():
        card = {"sample": res["sample"].cpu()}
        if "decisions" in res:  # beam-sample SCST: the card's search decisions, replayed on both
            card["decisions"] = res["decisions"].to("cpu")
        _, loss_c, _ = step_cpu.grad_fn(TrainState(), batch_cpu, card)
    if supermask:
        log_flips(label, flips)
    loss_ok = abs(float(loss_g) - float(loss_c)) <= SCST_LOSS_TOL
    ref = {n: p.grad for n, p in model_cpu.named_parameters()}
    got = {n: p.grad.cpu() for n, p in model_gpu.named_parameters()}
    top = max(g.abs().max().item() for g in ref.values())
    worst, worst_name, elementwise_ok, by_tensor = 0.0, "", 0, []
    for n, g_ref in ref.items():
        diff = got[n] - g_ref
        out = diff.abs() > STEP_GRAD_TOL * g_ref.abs().max().item() + STEP_GRAD_FLOOR * top
        elementwise_ok += not bool(out.any())
        ratio = (diff.norm() / (STEP_GRAD_NORM_TOL * g_ref.norm() + STEP_GRAD_FLOOR * top * g_ref.numel() ** 0.5)).item()
        by_tensor.append((ratio, n, int(out.sum()), int(out.reshape(out.shape[0], -1).any(1).sum()), out.shape[0]))
        if ratio > worst:
            worst, worst_name = ratio, n
    for ratio, n, n_out, rows, n_rows in sorted(by_tensor, reverse=True)[:5]:
        log(f"[{label}]   gradient {n}: norm-wise err/allowed {ratio:.3f} ({n_out} elements in {rows} of {n_rows} rows "
            f"outside the element-wise bound)")
    log(f"[{label}] f32 {SCST_CHECK_BATCH}x{SCST_CHECK_SAMPLES}, dropout on: sampled tokens differing card vs CPU "
        f"{n_tok}/{flat.numel()}; rewards {[round(x, 4) for x in r_cpu.tolist()]}, largest gradient {top:.3e}; "
        f"rewards max_abs_err {r_err.max().item():.3e} (rtol {REWARD_RTOL}, atol "
        f"{REWARD_ATOL}) {'ok' if r_ok else 'FAIL'}; loss card {float(loss_g):.7f} cpu {float(loss_c):.7f} "
        f"{'ok' if loss_ok else 'FAIL'}; gradients: {elementwise_ok} of {len(ref)} tensors within the element-wise "
        f"bound, worst norm-wise err/allowed {worst:.3f} ({worst_name}) {'ok' if worst <= 1 else 'FAIL'}")
    return r_ok and loss_ok and worst <= 1


def keyed_uniform_at(draw, idx: torch.Tensor) -> torch.Tensor:
    """The keyed supermask uniforms of ``draw`` at the flat weight indices
    ``idx`` (int64): ``KeyedDraw.uniform`` evaluated at those elements only."""
    from sparse_caption_tpu_torch.kernels.keyed_dropout import philox4x32_10

    c = idx // 4
    words = torch.stack(philox4x32_10(torch.full_like(c, draw.site), torch.full_like(c, draw.t), c,
                                      torch.zeros_like(c), draw.key), dim=-1)
    return (words.gather(1, (idx % 4)[:, None])[:, 0] >> 8).to(torch.float32) * 2.0 ** -24


@contextlib.contextmanager
def keyed_flip_counts(counts: list):
    """Inside the context, every keyed supermask set the card draws appends
    (t, flips, samples) to ``counts``: the samples [u < sigmoid(m)] of the set
    that differ between the card's sigmoid (K5's, torch's CUDA sigmoid bit for
    bit) and the CPU's on the same mask logits and the same keyed u. The
    sigmoids differ in the last bit at some elements; a u on the 2^-24 grid
    between the two flips that element's sample."""
    import sparse_caption_tpu_torch.ops.masked as masked

    differ = {}  # (data_ptr, version) -> (indices, the card's sigmoid there, the CPU's)

    def where_differ(m):
        key = (m.data_ptr(), m._version)
        if key not in differ:
            sg = torch.sigmoid(m.detach()).flatten()
            sc = torch.sigmoid(m.detach().cpu()).flatten().to(m.device)
            idx = (sg != sc).nonzero()[:, 0]
            differ[key] = (idx, sg[idx], sc[idx])
        return differ[key]

    def count(ms, draws):
        flips = samples = 0
        for m, draw in zip(ms, draws):
            idx, sg, sc = where_differ(m)
            u = keyed_uniform_at(draw, idx)
            flips += int(((u < sg) != (u < sc)).sum())
            samples += m.numel()
        counts.append((draws[0].t, flips, samples))

    set_fn, one_fn = masked.supermask_weights, masked.supermask_weight

    def weights(ws, ms, us=None, mode="sample", bypass=False):
        if mode == "keyed" and ms[0].is_cuda:
            count(list(ms), list(us))
        return set_fn(ws, ms, us, mode, bypass)

    def weight(w, m, u=None, mode="sample", bypass=False):
        if mode == "keyed" and m.is_cuda:
            count([m], [u])
        return one_fn(w, m, u, mode, bypass)

    with mock.patch.object(masked, "supermask_weights", weights), mock.patch.object(masked, "supermask_weight", weight):
        yield counts


def card_sigmoids(model_gpu, model_cpu) -> dict:
    """{id of a CPU mask: the card's sigmoid of the same logits (on the CPU)}
    for ``card_sample_bits``, taken before either side updates its masks.
    ``model_cpu`` is a copy of ``model_gpu`` (its masks the same values, any
    weight dtype)."""
    from sparse_caption_tpu_torch.ops.masked import _Prunable

    return {id(mc.mask): torch.sigmoid(mg.mask.detach()).cpu()
            for mg, mc in zip(model_gpu.modules(), model_cpu.modules())
            if isinstance(mg, _Prunable) and mg.mask is not None}


@contextlib.contextmanager
def card_sample_bits(card_p: dict):
    """The CPU model's keyed supermask draws take the card's samples: each
    mask's threshold is the card's sigmoid of the same logits
    (``card_sigmoids``), so that the same keyed u gives the card's sample on
    both sides (the CPU's own sigmoid still gives the straight-through
    gradient). The plain version's u is integer arithmetic, so the card
    computes it for the CPU (the same bits, in a fraction of the time)."""
    from sparse_caption_tpu_torch.kernels import supermask as k5

    plain = k5.supermask_weight_plain
    dev = "cuda" if torch.cuda.is_available() else "cpu"

    def shared(w, m, u=None, mode="sample", bypass=False):
        if mode == "keyed" and id(m) in card_p:
            # -1 < sigmoid and 2 > sigmoid: the card's sample under the CPU's comparison
            u = torch.where(u.uniform(w.shape, dev).cpu() < card_p[id(m)], -1.0, 2.0).to(w.device)
            mode = "sample"
        return plain(w, m, u, mode, bypass)

    with mock.patch.object(k5, "supermask_weight_plain", shared):
        yield


def log_flips(label: str, counts: list) -> int:
    """Logs the keyed sets' flips in call order; returns their sum."""
    total = sum(f for _, f, _ in counts)
    log(f"[{label}] supermask sample flips card vs CPU in each of the {len(counts)} keyed sets (t: flips), in call "
        f"order: {', '.join(f'{t}: {f}' for t, f, _ in counts)}; {total} of {sum(n for _, _, n in counts)} samples")
    return total


# ----------------------------------------------------------- Up-Down path
def bf16_tanh_agrees() -> bool:
    """K12's bf16 tanh (a table of tanhf results and its two limits) against
    the plain version's `torch.tanh`, bit for bit on all 65,536 bf16 values
    (NaN for NaN)."""
    from sparse_caption_tpu_torch.kernels import _build

    x = torch.arange(-32768, 32768, device="cuda", dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    y = torch.empty_like(x)
    fn = _build.library("additive_attention").sct_bf16_tanh
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    if fn(x.data_ptr(), y.data_ptr(), x.numel(), _build.stream_handle(x)) != 0:
        raise RuntimeError("sct_bf16_tanh failed to launch")
    ref = torch.tanh(x)
    bad = int((~((y.view(torch.int16) == ref.view(torch.int16)) | (torch.isnan(y) & torch.isnan(ref)))).sum())
    log(f"[rounding] additive_attention bf16 tanh: {bad} of {x.numel()} bf16 values differ from torch.tanh "
        f"{'ok' if bad == 0 else 'FAIL'}")
    return bad == 0


def check_updown_kernels(gen, dtype, results: dict, timing: bool = True) -> bool:
    """K11, K12 and K13 against their plain versions: K11 and K12 forward at
    the serving shape (1024 images x 5 beams), K13 forward at the XE shape
    (256 x 5 captions x 17 steps); backwards in f32 at the XE shape; each with
    a planted fault; K12 in bf16 also bit by bit (forward at the serving and
    SCST shapes and at off shapes, backward at the XE shape), its serving
    output against the training-mode forward's; bf16 times (with `timing`:
    forward at the serving shape, and forward + backward at the XE shape as
    `xe_ms`) into the JSON line."""
    from sparse_caption_tpu_torch.kernels import additive_attention as k12
    from sparse_caption_tpu_torch.kernels import lstm_cell as k11
    from sparse_caption_tpu_torch.kernels import vocab_log_softmax as k13

    dev = torch.device("cuda")
    es = ESIZE[dtype]
    dname = str(dtype).split(".")[-1]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    h, a, d, r, vocab = UPDOWN["rnn_size"], UPDOWN["att_hid_size"], UPDOWN["rnn_size"], REGIONS, UPDOWN["vocab_size"]
    n_s, b_s = UPDOWN_BATCHES[-1] * BEAM, UPDOWN_BATCHES[-1]  # serving rows, images
    n_t, b_t = TRAIN_BIG_BATCH * SEQ_PER_IMG, TRAIN_BIG_BATCH  # XE rows, images
    turns = turns_ms if timing else no_turns
    ok = True

    def compare(name, out, ref, scale=0.0, sum_scale=0.0, fault=None):
        nonlocal ok
        err, good, worst = close(out, ref, out.dtype, scale, sum_scale)
        log(f"[kernel] {name} {str(out.dtype).split('.')[-1]}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"median|ref|={ref.float().abs().median().item():.3e} scale={max(scale, sum_scale):.3f} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, out.dtype, scale, sum_scale)
        return err

    def record(name, err, ms, plain_ms, lib_ms, nbytes, ops, xe_ms):
        bnd, by = bound_ms(nbytes, ops)
        log(f"[kernel] {name} {dname}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms={bnd:.4f} ({by}) xe_ms={xe_ms:.4f} (held windows in turns)")
        if dtype == torch.bfloat16:
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                                 bound_by=by, xe_ms=xe_ms)

    # K11: gate pre-activations (N, 4H) from the two GEMMs, cell state (N, H)
    gx, gh, c = rnd(n_s, 4 * h), rnd(n_s, 4 * h), rnd(n_s, h)
    (hk, ck), (hp, cp) = k11.lstm_cell(gx, gh, c), k11.lstm_cell_plain(gx, gh, c)
    swap = lambda g: torch.cat([g[:, h:2 * h], g[:, :h], g[:, 2 * h:]], dim=1)  # noqa: E731  i and f swapped
    scale = rms(cp)  # a one-ulp difference of a term carried through c' = f c + i g
    err = max(compare("lstm_cell h'", hk, hp, scale), compare("lstm_cell c'", ck, cp, scale,
                                                               fault=k11.lstm_cell_plain(swap(gx), swap(gh), c)[1]))
    tg = leaves(rnd(n_t, 4 * h), rnd(n_t, 4 * h), rnd(n_t, h))
    cot = (rnd(n_t, h), rnd(n_t, h))
    _, kg = fwd_bwd(k11.lstm_cell, tg, cot)
    _, pg = fwd_bwd(k11.lstm_cell_plain, tg, cot)
    if dtype == torch.float32:
        for nm, kt, pt in zip(("d gx", "d gh", "d c"), kg, pg):
            compare(f"lstm_cell_bwd {nm}", kt, pt)
    else:  # bit by bit: the forward's rounding points, and autograd's in the backward
        ok &= rounding_share("lstm_cell h'", hk, hp, K11_SHARE_LIMIT, K11_FAR_LIMIT)
        ok &= rounding_share("lstm_cell c'", ck, cp, K11_SHARE_LIMIT, K11_FAR_LIMIT)
        for nm, kt, pt in zip(("d gates", "d c"), kg[1:], pg[1:]):
            ok &= rounding_share(f"lstm_cell_bwd {nm}", kt, pt, K11_SHARE_LIMIT, K11_FAR_LIMIT)
        ok &= bool(torch.equal(kg[0], kg[1]))  # d gx = d gh
    del kg, pg
    fns = [lambda: k11.lstm_cell(gx, gh, c), lambda: k11.lstm_cell_plain(gx, gh, c)]
    try:
        torch.ops.aten._thnn_fused_lstm_cell(gx, gh, c)
        fns.append(lambda: torch.ops.aten._thnn_fused_lstm_cell(gx, gh, c))
    except RuntimeError as exc:  # a dtype the library kernel does not take
        log(f"[kernel] lstm_cell {dname}: aten._thnn_fused_lstm_cell refused: {str(exc).splitlines()[0]}")
    ms, plain_ms, *lib = turns(*fns)
    xe_ms, xe_plain_ms = turns(lambda: fwd_bwd(k11.lstm_cell, tg, cot), lambda: fwd_bwd(k11.lstm_cell_plain, tg, cot))
    record("lstm_cell", err, ms, plain_ms, lib[0] if lib else None, k11_bytes(n_s, h, dtype), {}, xe_ms)
    log(f"[kernel] lstm_cell {dname} fwd+bwd at {n_t}x{h}: plain_ms={xe_plain_ms:.4f} "
        f"bound_ms={bound_ms(k11_bytes(n_t, h, dtype, backward=True), {})[0]:.4f}")
    del gx, gh, c, hk, ck, hp, cp, tg, cot

    # K12: p_att (B, R, A), att (B, R, D), the rows' att_h (N, A); scores O(1)
    # (w ~ N(0, 1 / A)); padded regions, and image 0 with every region padded
    def k12_inputs(b, n, g=gen, r=r, d=d, a=a):
        mask = random_region_mask(g, b, r, dev)
        mask[0] = False
        w = (torch.randn(a, generator=g, device=dev) / a ** 0.5).to(dtype)
        x = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(dtype)  # noqa: E731
        return x(b, r, a), x(n, a), w, (torch.ones(1, device=dev) * 0.3).to(dtype), mask, x(b, r, d)

    p_att, att_h, w, bias, mask, att = k12_inputs(b_s, n_s)
    out_k = k12.additive_attention(p_att, att_h, w, bias, mask, att)
    out_p = k12.additive_attention_plain(p_att, att_h, w, bias, mask, att)
    err = compare("additive_attention", out_k, out_p, rms(att),  # fault: softmax over every region, no renorm
                  fault=k12.additive_attention_plain(p_att, att_h, w, bias, torch.ones_like(mask), att))
    zero = bool((out_k[:BEAM] == 0).all())
    log(f"[kernel] additive_attention {dname}: image with every region padded gives zeros={zero}")
    ok &= zero
    if dtype == torch.bfloat16:
        ok &= bf16_tanh_agrees()
        ok &= rounding_share("additive_attention out", out_k, out_p, K12_SHARE_LIMIT, K12_FAR_LIMIT)
    # serving (no input requires a gradient) against the training-mode forward, bit for bit
    held = leaves(p_att, att_h, w, bias, att)
    out_t = k12.additive_attention(held[0], held[1], held[2], held[3], mask, held[4])
    same = bool(torch.equal(out_t.detach(), out_k)) and out_t.requires_grad
    log(f"[kernel] additive_attention {dname}: serving output equals the training-mode forward's bit for bit={same}")
    ok &= same
    del held, out_t
    ti = k12_inputs(b_t, n_t)
    tin = leaves(ti[0], ti[1], ti[2], ti[3], ti[5])
    run12 = lambda fn: (lambda p, q, w_, b_, at: fn(p, q, w_, b_, ti[4], at))  # noqa: E731
    cot = rnd(n_t, d)
    _, kg = fwd_bwd(run12(k12.additive_attention), tin, cot)
    _, pg = fwd_bwd(run12(k12.additive_attention_plain), tin, cot)
    if dtype == torch.float32:
        for nm, kt, pt in zip(("d p_att", "d att_h"), kg[:2], pg[:2]):
            compare(f"additive_attention_bwd {nm}", kt, pt)
        compare("additive_attention_bwd d att", kg[4], pg[4])
        # d w and d bias sum the score gradients over images x rows x regions;
        # d bias is 0 in exact arithmetic (a softmax ignores a shift of every
        # score), so both sides give rounding noise of the size of d w's sums
        dw_scale = pg[2].float().abs().max().item()
        for nm, kt, pt in zip(("d w", "d bias"), kg[2:4], pg[2:4]):
            compare(f"additive_attention_bwd {nm}", kt, pt, sum_scale=dw_scale)
    else:  # bit by bit against autograd's bf16 gradients of the plain version
        for nm, i in (("d p_att", 0), ("d att_h", 1), ("d att", 4)):
            ok &= rounding_share(f"additive_attention_bwd {nm}", kg[i], pg[i], K12_BWD_SHARE_LIMIT, K12_BWD_FAR_LIMIT)
    del kg, pg
    # the Up-Down SCST shape: 60 samples per image, in 4 chunks of rows; bf16
    # checks, and the off shapes (the general path where D is off the 16-byte
    # vector), on inputs of their own generator
    b_c = UPDOWN_SCST_BATCHES[-1]
    g12 = torch.Generator(device=dev).manual_seed(SEED + 12)
    si = k12_inputs(b_c, b_c * UPDOWN_SCST_SAMPLES, gen if dtype == torch.float32 else g12)
    if dtype == torch.float32:
        sin = leaves(si[0], si[1], si[2], si[3], si[5])
        run_s = lambda fn: (lambda p, q, w_, b_, at: fn(p, q, w_, b_, si[4], at))  # noqa: E731
        scot = rnd(b_c * UPDOWN_SCST_SAMPLES, d)
        (so_k,), sg_k = fwd_bwd(run_s(k12.additive_attention), sin, scot)
        (so_p,), sg_p = fwd_bwd(run_s(k12.additive_attention_plain), sin, scot)
        compare(f"additive_attention {b_c}x{UPDOWN_SCST_SAMPLES}", so_k, so_p, rms(si[5]))
        dw_scale = sg_p[2].float().abs().max().item()
        for nm, kt, pt, sc in zip(("d p_att", "d att_h", "d w", "d bias", "d att"), sg_k, sg_p,
                                  (0.0, 0.0, dw_scale, dw_scale, 0.0)):
            compare(f"additive_attention_bwd {nm} {b_c}x{UPDOWN_SCST_SAMPLES}", kt, pt, sum_scale=sc)
        del sin, scot, so_k, sg_k, so_p, sg_p
    else:
        so_k, so_p = k12.additive_attention(*si), k12.additive_attention_plain(*si)
        compare(f"additive_attention {b_c}x{UPDOWN_SCST_SAMPLES}", so_k, so_p, rms(si[5]))
        ok &= rounding_share(f"additive_attention {b_c}x{UPDOWN_SCST_SAMPLES} out", so_k, so_p, K12_SHARE_LIMIT,
                             K12_FAR_LIMIT)
        del so_k, so_p
    del si
    for r_x, a_x, d_x, rows_x in K12_OFF_SHAPES:
        xi = k12_inputs(b_c, b_c * rows_x, g12, r_x, d_x, a_x)
        xo_k, xo_p = k12.additive_attention(*xi), k12.additive_attention_plain(*xi)
        tag = f"R={r_x} A={a_x} D={d_x} rows={rows_x}"
        compare(f"additive_attention {tag}", xo_k, xo_p, rms(xi[5]))
        ok &= bool((xo_k[:rows_x] == 0).all())
        if dtype == torch.bfloat16:
            ok &= rounding_share(f"additive_attention {tag} out", xo_k, xo_p, K12_SHARE_LIMIT, K12_FAR_LIMIT)
        del xi, xo_k, xo_p
    ms, plain_ms = turns(lambda: k12.additive_attention(p_att, att_h, w, bias, mask, att),
                            lambda: k12.additive_attention_plain(p_att, att_h, w, bias, mask, att))
    xe_ms, xe_plain_ms = turns(lambda: fwd_bwd(run12(k12.additive_attention), tin, cot),
                                  lambda: fwd_bwd(run12(k12.additive_attention_plain), tin, cot))
    log(f"[kernel] additive_attention {dname} fwd+bwd at {n_t} rows: plain_ms={xe_plain_ms:.4f} bound_ms="
        f"{bound_ms(k12_bytes(b_t, SEQ_PER_IMG, r, a, d, dtype, backward=True), {})[0]:.4f}")
    record("additive_attention", err, ms, plain_ms, None, k12_bytes(b_s, BEAM, r, a, d, dtype),
           flops((torch.float32, n_s * r * (4 * a + 2 * d))), xe_ms)
    if dtype == torch.bfloat16:
        results["additive_attention"]["xe_plain_ms"] = xe_plain_ms
    del p_att, att_h, att, out_k, out_p, ti, tin, cot

    # K13: the XE step's logits (256 x 5 x 17 rows x 10000) with an offset of
    # 100, so that a log-sum-exp without the max shift overflows
    rows = n_t * MAX_LEN
    x = (torch.randn(rows, vocab, generator=gen, device=dev) * 3 + 100).to(dtype)
    yk, yp = k13.vocab_log_softmax(x), k13.vocab_log_softmax_plain(x)
    xf = x.float()
    no_shift = (xf - torch.log(torch.exp(xf).sum(dim=-1, keepdim=True))).to(dtype)
    err = compare("vocab_log_softmax", yk, yp, fault=no_shift)
    del yk, yp, xf, no_shift
    if dtype == torch.bfloat16:  # the ORT generator's train site: bf16 logits, f32 log-probs
        compare("vocab_log_softmax to f32", k13.vocab_log_softmax(x, torch.float32),
                k13.vocab_log_softmax_plain(x, torch.float32))
    dy = torch.randn(rows, vocab, generator=gen, device=dev).to(dtype)
    xl = leaves(x)
    del x
    if dtype == torch.float32:
        (yp,), (gp,) = fwd_bwd(k13.vocab_log_softmax_plain, xl, dy)
        _, (gk,) = fwd_bwd(k13.vocab_log_softmax, xl, dy)
        # dx = dy - p sum(dy): p times a 10,000-term sum whose rounding follows its order
        sum_scale = yp.max().exp().item() * vocab ** 0.5 * rms(dy)
        err = max(err, compare("vocab_log_softmax_bwd dx", gk, gp, sum_scale=sum_scale))
        del gk, gp, yp
    return ok  # K13's times: check_norm_softmax_kernels


def check_norm_softmax_kernels(gen, results: dict, dtypes=(torch.float32, torch.bfloat16),
                               timing: bool = True) -> bool:
    """K6 and K13 in `dtypes`, on inputs drawn from `gen` alone: at the main
    path's shapes (K6 over the ORT XE step's 21,760 x 512 rows with the
    keep-mask, and norm-only; K13 over its 21,760 x 10,000 logits, f32 ->
    f32, bf16 -> bf16 and bf16 -> f32) every output element-wise against the
    plain version, with the bounds of check_train_kernels; in bf16 also bit
    by bit: K6's s exactly (one rounding of x + round(y / keep_prob)), K6's n,
    dx, dy and K13's y by `rounding_share`; K6's da and db bitwise equal over
    two runs; the off-width shapes (K6 at d = 37 and 500, K13 at V = 37 and
    9,999, 333 rows), which take the scalar paths and the vector tails; K6's
    forward at the serving decode step (10,240 x 512, y given, no keep). With
    `timing`, each variant's kernel, plain version and one library call as
    medians of 5 windows taken in turns (inputs made outside the timed
    window), beside the byte bound (`k6_bytes`, `k13_bytes`); the bf16 times
    (and K13's f32 and bf16 -> f32) go into the JSON line."""
    from sparse_caption_tpu_torch.kernels import add_ref_layernorm as k6
    from sparse_caption_tpu_torch.kernels import vocab_log_softmax as k13

    dev = torch.device("cuda")
    dn = lambda dt: str(dt).split(".")[-1]  # noqa: E731
    ok = True

    def compare(name, out, ref, scale=0.0, sum_scale=0.0):
        nonlocal ok
        err, good, worst = close(out, ref, out.dtype, scale, sum_scale)
        log(f"[kernel] {name} {dn(out.dtype)}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"scale={max(scale, sum_scale):.3f} {'ok' if good else 'FAIL'}")
        ok &= good
        return err

    def exact(name, out, ref):
        nonlocal ok
        same = bool(torch.equal(out, ref))
        log(f"[kernel] {name}: {'exact' if same else 'DIFFERS'} ({int((out != ref).sum())} of {ref.numel()} "
            f"elements differ)")
        ok &= same

    def bits(name, out, ref, share, far):
        nonlocal ok
        ok &= rounding_share(name, out, ref, share, far)

    def times(name, nbytes, kernel, plain, library) -> dict:
        ms, plain_ms, lib_ms = turns_ms(kernel, plain, library)
        bnd, by = bound_ms(nbytes, {})
        log(f"[kernel] {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bnd:.4f} "
            f"({by}; medians of 5 windows in turns)")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)

    # ---- K6
    d = PAPER["d_model"]
    k6_rows = TRAIN_BIG_BATCH * SEQ_PER_IMG * MAX_LEN
    k6_out: dict = {}

    def k6_inputs(dtype, rows, width):
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
        x, y = rnd(rows, width), rnd(rows, width)
        a = (torch.rand(width, generator=gen, device=dev) + 0.5).to(dtype)
        b = rnd(width)
        keep = torch.rand(rows, width, generator=gen, device=dev) < 0.9
        return x, y, a, b, keep, rnd(rows, width), rnd(rows, width)

    def k6_check(dtype, rows, width, tag):
        x, y, a, b, keep, gs, gn = k6_inputs(dtype, rows, width)
        ins = leaves(x, y, a, b)

        def run(fn):
            return fwd_bwd(lambda x_, y_, a_, b_: fn(x_, y_, a_, b_, keep, 0.9), ins, (gs, gn))

        (ks, kn), kg = run(k6.add_ref_layernorm)
        (ps, pn), pg = run(k6.add_ref_layernorm_plain)
        err = max(compare(f"add_ref_layernorm s {tag}", ks, ps, rms(ps)),
                  compare(f"add_ref_layernorm n {tag}", kn, pn, rms(pn)))
        for nm, kt, pt in zip(("dx", "dy"), kg[:2], pg[:2]):
            err = max(err, compare(f"add_ref_layernorm {nm} {tag}", kt, pt, rms(pt)))
        sum_scale = (rows ** 0.5) * rms(gn)
        for nm, kt, pt in zip(("da", "db"), kg[2:], pg[2:]):
            err = max(err, compare(f"add_ref_layernorm {nm} {tag}", kt, pt, sum_scale=sum_scale))
        if dtype == torch.bfloat16:
            exact(f"add_ref_layernorm s {tag} bf16 (bit for bit)", ks, ps)
            for nm, kt, pt in (("n", kn, pn), ("dx", kg[0], pg[0]), ("dy", kg[1], pg[1])):
                bits(f"add_ref_layernorm {nm} {tag}", kt, pt, K6_SHARE_LIMIT, K6_FAR_LIMIT)
        _, kg2 = run(k6.add_ref_layernorm)
        exact(f"add_ref_layernorm da, db {tag} {dn(dtype)} repeated run",
              torch.cat([kg2[2], kg2[3]]), torch.cat([kg[2], kg[3]]))
        return err, (x, y, a, b, keep, gs, gn, ins, run)

    for dtype in dtypes:
        err, (x, y, a, b, keep, gs, gn, ins, run) = k6_check(dtype, k6_rows, d, f"{k6_rows}x{d}")
        # norm only (the first norm of each stack): no y, gs, keep or dy
        nins = leaves(x, a, b)
        (kn,), kg = fwd_bwd(lambda x_, a_, b_: k6.add_ref_layernorm(x_, None, a_, b_), nins, gn)
        (pn,), pg = fwd_bwd(lambda x_, a_, b_: k6.add_ref_layernorm_plain(x_, None, a_, b_), nins, gn)
        err = max(err, compare(f"add_ref_layernorm norm only n", kn, pn, rms(pn)),
                  compare(f"add_ref_layernorm norm only dx", kg[0], pg[0], rms(pg[0])))
        for nm, kt, pt in zip(("da", "db"), kg[1:], pg[1:]):
            err = max(err, compare(f"add_ref_layernorm norm only {nm}", kt, pt, sum_scale=(k6_rows ** 0.5) * rms(gn)))
        if dtype == torch.bfloat16:
            bits("add_ref_layernorm norm only n", kn, pn, K6_SHARE_LIMIT, K6_FAR_LIMIT)
            bits("add_ref_layernorm norm only dx", kg[0], pg[0], K6_SHARE_LIMIT, K6_FAR_LIMIT)
        del nins, kn, kg, pn, pg
        if timing:
            lib_ins = leaves(x, y, a, b)

            def lib_run():
                s_ = torch.add(lib_ins[0], lib_ins[1])
                n_ = F.layer_norm(s_, (d,), lib_ins[2], lib_ins[3], 1e-6)
                return torch.autograd.grad((s_, n_), lib_ins, (gs, gn))

            t = times(f"add_ref_layernorm fwd+bwd {k6_rows}x{d} keep {dn(dtype)}", k6_bytes(k6_rows, d, dtype),
                      lambda: run(k6.add_ref_layernorm), lambda: run(k6.add_ref_layernorm_plain), lib_run)
            if dtype == torch.bfloat16:
                k6_out.update(max_abs_err=err, **t)
            else:
                k6_out.update({f"f32_{key}": v for key, v in t.items()})
            del lib_ins
        del x, y, a, b, keep, gs, gn, ins, run
        for width in K6_OFF_WIDTHS:
            k6_check(dtype, OFF_ROWS, width, f"{OFF_ROWS}x{width}")
        # the serving decode step: y given, no keep-mask, no gradient
        x, y, a, b, _, _, _ = k6_inputs(dtype, SERVE_ROWS, d)
        with torch.no_grad():
            ks, kn = k6.add_ref_layernorm(x, y, a, b)
            ps, pn = k6.add_ref_layernorm_plain(x, y, a, b)
            compare(f"add_ref_layernorm serve s {SERVE_ROWS}x{d}", ks, ps, rms(ps))
            compare(f"add_ref_layernorm serve n {SERVE_ROWS}x{d}", kn, pn, rms(pn))
            if dtype == torch.bfloat16:
                exact(f"add_ref_layernorm serve s {SERVE_ROWS}x{d} bf16 (bit for bit)", ks, ps)
                bits(f"add_ref_layernorm serve n {SERVE_ROWS}x{d}", kn, pn, K6_SHARE_LIMIT, K6_FAR_LIMIT)
            if timing and dtype == torch.bfloat16:
                t = times(f"add_ref_layernorm serve fwd {SERVE_ROWS}x{d} {dn(dtype)}",
                          k6_bytes(SERVE_ROWS, d, dtype, keep=False, backward=False),
                          lambda: k6.add_ref_layernorm(x, y, a, b), lambda: k6.add_ref_layernorm_plain(x, y, a, b),
                          lambda: F.layer_norm(torch.add(x, y), (d,), a, b, 1e-6))
                k6_out.update({f"serve_fwd_{key}": v for key, v in t.items()})
        del x, y, a, b, ks, kn, ps, pn
        torch.cuda.empty_cache()
    if k6_out:
        results["add_ref_layernorm"] = k6_out

    # ---- K13: logits with an offset of 100 (a log-sum-exp without the max shift overflows)
    vocab, k13_rows = UPDOWN["vocab_size"], TRAIN_BIG_BATCH * SEQ_PER_IMG * MAX_LEN
    pairs = ([(torch.float32, torch.float32)] if torch.float32 in dtypes else []) + (
        [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)] if torch.bfloat16 in dtypes else [])
    k13_out: dict = {}

    def k13_check(tin, tout, rows, width, tag):
        x = (torch.randn(rows, width, generator=gen, device=dev) * 3 + 100).to(tin)
        dy = torch.randn(rows, width, generator=gen, device=dev).to(tout)
        xl = leaves(x)

        def run(fn):
            return fwd_bwd(lambda v: fn(v, tout), xl, dy)

        (yk,), (gk,) = run(k13.vocab_log_softmax)
        (yp,), (gp,) = run(k13.vocab_log_softmax_plain)
        err = compare(f"vocab_log_softmax y {tag}", yk, yp)
        # dx = dy - p sum(dy): p times a V-term sum whose rounding follows its order
        sum_scale = yp.float().max().exp().item() * width ** 0.5 * rms(dy)
        err = max(err, compare(f"vocab_log_softmax_bwd dx {tag}", gk, gp, sum_scale=sum_scale))
        if tout == torch.bfloat16:
            bits(f"vocab_log_softmax y {tag}", yk, yp, K13_SHARE_LIMIT, K13_FAR_LIMIT)
        return err, xl, dy, run

    for tin, tout in pairs:
        tag = f"{dn(tin)}->{dn(tout)}"
        err, xl, dy, run = k13_check(tin, tout, k13_rows, vocab, f"{tag} {k13_rows}x{vocab}")
        if timing:
            t = times(f"vocab_log_softmax fwd+bwd {tag} {k13_rows}x{vocab}", k13_bytes(k13_rows, vocab, tin, tout),
                      lambda: run(k13.vocab_log_softmax), lambda: run(k13.vocab_log_softmax_plain),
                      lambda: fwd_bwd(lambda v: torch.log_softmax(v, dim=-1, dtype=tout), xl, dy))
            if tin == tout == torch.bfloat16:
                k13_out.update(max_abs_err=err, xe_ms=t["ms"], **t)
            else:
                prefix = "f32" if tin == torch.float32 else "bf16_to_f32"
                k13_out.update({f"{prefix}_{key}": v for key, v in t.items()})
        del xl, dy, run
        torch.cuda.empty_cache()
        for width in K13_OFF_WIDTHS:
            k13_check(tin, tout, OFF_ROWS, width, f"{tag} {OFF_ROWS}x{width}")
    if k13_out:
        results["vocab_log_softmax"] = k13_out
    return ok


def build_updown(seed: int, train: bool = False, dropout: bool = True):
    """Paper-width up_down_lstm_prune in f32 on the card, random weights from
    the seed: for serving with random supermask logits folded, for training
    with its masks kept as parameters (init 5.0)."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedEmbedding, MaskedLinear

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = MaskConfig("supermask", MASK_INIT, keep_masks=True) if train else MaskConfig("supermask")
    model = get_model("up_down_lstm_prune")(**UPDOWN, drop_prob_lm=UPDOWN_DROP if dropout else 0.0, mask_cfg=cfg,
                                            device="cuda", generator=gen)
    if not train:
        for m in model.modules():
            if isinstance(m, (MaskedLinear, MaskedEmbedding)):
                m.fold_mask_(torch.randn(m.weight.shape, generator=gen, device="cuda") * 2.0 + 1.0)
    return model


def make_updown_batch(gen, b, dtype, device="cuda"):
    att = torch.randn(b, REGIONS, UPDOWN["att_feat_size"], generator=gen, device=device).to(dtype)
    mask = random_region_mask(gen, b, REGIONS, device).to(dtype)
    fc = torch.randn(b, UPDOWN["fc_feat_size"], generator=gen, device=device).to(dtype)
    return att, mask, fc


def make_updown_train_batch(gen, b, device="cuda"):
    att, mask, fc = make_updown_batch(gen, b, torch.float32, device)
    seqs = torch.randint(4, UPDOWN["vocab_size"], (b * SEQ_PER_IMG, TRAIN_T), generator=gen, device=device)
    seqs[:, 0] = 2  # BOS
    return dict(att_feats=att, att_masks=mask, fc_feats=fc, seqs=seqs,
                seq_masks=torch.ones(b * SEQ_PER_IMG, TRAIN_T, device=device))


def greedy_check(model_f32, gen, label="updown greedy") -> bool:
    """Greedy decode, f32 batch 8, on the card (kernels) and on the CPU
    (plain versions): identical tokens but for near-ties (``tie_aware_match``),
    log-probs within 1e-4."""
    from sparse_caption_tpu_torch.decoding import generate

    batch = make_updown_batch(gen, CHECK_BATCH, torch.float32)
    opt = {"beam_size": 1, "max_seq_length": MAX_LEN}
    seq_gpu, lp_gpu = generate(model_f32, model_f32.encode(*batch), opt)
    model_cpu = copy.deepcopy(model_f32).to("cpu")
    memory = model_cpu.encode(*(x.cpu() for x in batch))
    seq_cpu, lp_cpu = generate(model_cpu, memory, opt)
    good, n_ties, err = tie_aware_match(seq_gpu, lp_gpu, seq_cpu, lp_cpu,
                                        lambda seq: teacher_forced_logprobs(model_cpu, memory, seq), model_cpu.eos_id)
    log(f"[{label}] f32 batch {CHECK_BATCH}: tokens identical={bool(torch.equal(seq_gpu.cpu(), seq_cpu))} "
        f"({len(torch.unique(seq_cpu))} distinct), rows accepted as near-ties {n_ties}; log-prob "
        f"max_abs_err={err:.3e} (tol {WHOLE_PATH_LP_TOL}) {'ok' if good else 'FAIL'}")
    return good


# ------------------------------------------------------------- prune path
@contextlib.contextmanager
def uncounted():
    """Launches inside (a kernel held against its plain version) leave the
    launch counts as they were."""
    from sparse_caption_tpu_torch.kernels import KERNELS

    saved = {name: k.launches for name, k in KERNELS.items()}
    try:
        yield
    finally:
        for name, k in KERNELS.items():
            k.launches = saved[name]


def f32_quantile_index(n: int, q: float) -> tuple:
    """``jnp.quantile``'s index arithmetic (jax's ``_quantile``, linear), written
    again in torch f32 ops on the host: the reference that the wrapper's
    ``quantile_index`` is held to. Returns (lo, hi, lw, hw) with lw and hw
    0-dim f32 tensors."""
    nf, qf = torch.tensor(float(n), dtype=torch.float32), torch.tensor(q, dtype=torch.float32)
    pos = qf * (nf - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    lw = 1 - hw
    zero = torch.zeros((), dtype=torch.float32)
    return int(torch.clamp(lo, zero, nf - 1)), int(torch.clamp(hi, zero, nf - 1)), lw, hw


def k16_case(label: str, ws, pools, q: float, dist: bool = False, measured=None) -> bool:
    """K16 against its plain version on one set: every pool's threshold and
    every mask bit for bit (dist: the plain selection on K16's own stats,
    and K16's stats against torch.mean / torch.std), and each pool's pruned
    count equal to the count of criteria <= the threshold that the f32 index
    reference (``f32_quantile_index``) gives on the sorted pool. `measured`
    collects the largest |th - th_plain| and |mask - mask_plain| (max_abs_err)
    and the count of mask elements that differ (mask_mismatches)."""
    from sparse_caption_tpu_torch.kernels import magnitude_threshold as k16

    masks, th, stats = k16.magnitude_masks(ws, pools, q, dist)
    masks_p, th_p, _ = k16.magnitude_masks_plain(ws, pools, q, dist, stats=stats)
    torch.cuda.synchronize()
    mismatches = sum(int((a != b).sum()) for a, b in zip(masks, masks_p))
    err = max((th - th_p).abs().max().item(), float(mismatches > 0))  # a mask element differs by 1
    if measured is not None:
        measured["max_abs_err"] = max(measured.get("max_abs_err", 0.0), err)
        measured["mask_mismatches"] = measured.get("mask_mismatches", 0) + mismatches
    same_masks = mismatches == 0
    same_th = bool(torch.equal(th, th_p))
    ok, worst_stats, index_ok, count_ok = same_masks and same_th, 0.0, True, True
    if dist:
        own = torch.stack([k16.tensor_stats_plain(w) for w in ws])
        worst_stats = max(((stats[:, 0] - own[:, 0]).abs() / own[:, 1]).max().item(),
                          ((stats[:, 1] - own[:, 1]).abs() / own[:, 1]).max().item())
        ok &= worst_stats <= K16_STATS_TOL
    crits = [k16.criterion_plain(w, stats[i] if dist else None) for i, w in enumerate(ws)]
    for p in range(max(pools) + 1):
        members = [i for i, pp in enumerate(pools) if pp == p]
        ordered = torch.sort(torch.cat([crits[i].reshape(-1) for i in members])).values
        n = ordered.numel()
        lo, hi, lw, hw = f32_quantile_index(n, q)
        index_ok &= (lo, hi, lw.item(), hw.item()) == k16.quantile_index(n, q)
        v = ordered[[lo, hi]].cpu()
        th_ref = v[0] * lw + v[1] * hw  # two f32 products and one add, on the host
        expected = int(torch.searchsorted(ordered, th_ref.to(ordered.device).reshape(1), right=True))
        pruned = sum(int((masks[i] == 0).sum()) for i in members)
        count_ok &= pruned == expected and bool(th[p].cpu() == th_ref)
    ok &= index_ok and count_ok
    n_all = sum(w.numel() for w in ws)
    zeros = sum(int((m == 0).sum()) for m in masks)
    log(f"[k16] {label}: {len(ws)} tensors, {max(pools) + 1} pools, {n_all} weights, q={q:.6f}: masks equal "
        f"{same_masks} ({mismatches} differ), thresholds equal {same_th} (max |diff| {err:.3e}), f32 index "
        f"{index_ok}, pruned counts {count_ok} ({zeros} pruned, {zeros / n_all:.4f})" + (f", stats worst err/std {worst_stats:.2e}" if dist else "")
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def magnitude_weights(gen, layers: int = PAPER["num_layers"]):
    """f32 weights at the ORT's masked shapes, Glorot-uniform scale, one of
    them with a block of exact zeros (a pruned checkpoint's ties) and one
    on a grid of 1/256 (many equal magnitudes)."""
    ws = []
    for i, (o, n) in enumerate(masked_shapes(layers)):
        w = (torch.rand(o, n, generator=gen, device="cuda") * 2 - 1) * (6.0 / (o + n)) ** 0.5
        if i == 1:
            w[:, : n // 3] = 0.0
        elif i == 2:
            w = torch.round(w * 256) / 256
        ws.append(w.contiguous())
    return ws


def check_magnitude_kernels(gen, results: dict, timing: bool = True) -> bool:
    """K16 against its plain version (``k16_case``): the ORT's 105 masked
    tensors as 105 pools (mag_*_uniform) and as one pool of 55,331,840 (blind,
    and dist with per-tensor stats) at the schedule's sparsities; the 8-layer
    ORT's 139 (more than one table of 128) the same ways; off shapes (a chunk
    and one weight, single weights, a tensor of equal magnitudes). The
    kernels line's max_abs_err and mask_mismatches are those of every case.
    Times (with `timing`): K16 on the blind pool, its plain version and the
    compare alone, in turns, and one library call (``torch.kthvalue`` at
    ranks lo and hi of the built pool) after them, beside the byte bound;
    K16 on the 105 pools and on the dist pool; a profile of one K16 call
    (its passes by name)."""
    from sparse_caption_tpu_torch.kernels import magnitude_threshold as k16
    from sparse_caption_tpu_torch.pruning.engine import gradual_sparsity_target

    ws = magnitude_weights(gen)
    per_tensor, one_pool = list(range(len(ws))), [0] * len(ws)
    n_all = sum(w.numel() for w in ws)
    ok, measured = True, results.setdefault("magnitude_threshold", {})
    schedule = [gradual_sparsity_target(PRUNE_TARGET, s, PRUNE_EPOCH_STEPS, 3, prune_frequency=PRUNE_FREQ)
                for s in (2, 4, 6, 8)]
    for q in schedule:
        ok &= k16_case("uniform", ws, per_tensor, q, measured=measured)
        ok &= k16_case("blind", ws, one_pool, q, measured=measured)
    ok &= k16_case("dist", ws, one_pool, PRUNE_TARGET, dist=True, measured=measured)
    ok &= k16_case("dist per tensor", ws, per_tensor, 0.5, dist=True, measured=measured)
    deep = magnitude_weights(gen, layers=8)
    ok &= len(deep) > k16.MAX_TENSORS
    ok &= k16_case("8 layers, uniform", deep, list(range(len(deep))), PRUNE_TARGET, measured=measured)
    ok &= k16_case("8 layers, blind", deep, [0] * len(deep), PRUNE_TARGET, measured=measured)
    ok &= k16_case("8 layers, dist", deep, [0] * len(deep), 0.5, dist=True, measured=measured)
    del deep
    off = [torch.randn(k16.CHUNK + 1, generator=gen, device="cuda"), torch.randn(1, generator=gen, device="cuda"),
           torch.full((37, 3), -0.25, device="cuda"), torch.randn(3, 5, generator=gen, device="cuda")]
    for q in (0.0, 0.5, 0.999, 1.0):
        ok &= k16_case("off shapes", off, list(range(len(off))), q, measured=measured)
        ok &= k16_case("off shapes, one pool", off, [0] * len(off), q, measured=measured)
    if not timing:
        return ok
    q = PRUNE_TARGET
    lo, hi, _, _ = k16.quantile_index(n_all, q)
    pool = torch.cat([w.abs().reshape(-1) for w in ws])
    _, th, _ = k16.magnitude_masks(ws, one_pool, q)
    ms, plain_ms, cmp_ms = turns_ms(
        lambda: k16.magnitude_masks(ws, one_pool, q), lambda: k16.magnitude_masks_plain(ws, one_pool, q),
        lambda: [(w.abs() > th[0]).float() for w in ws])
    # kthvalue of one slice this long takes about 0.4 s a call: two held calls, not 5 windows of 20
    lib_ms = time_ms(lambda: (torch.kthvalue(pool, lo + 1), torch.kthvalue(pool, hi + 1)), iters=2, warmup=1,
                     hold=True)
    uniform_ms, dist_ms = turns_ms(lambda: k16.magnitude_masks(ws, per_tensor, q),
                                   lambda: k16.magnitude_masks(ws, one_pool, q, dist=True))
    profile_window(f"K16, one pool of {n_all}", lambda: k16.magnitude_masks(ws, one_pool, q))
    bnd, by = bound_ms(8 * n_all, {})
    dist_bnd = bound_ms(12 * n_all, {})[0]
    log(f"[kernel] magnitude_threshold f32, one pool of {n_all}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} (torch.kthvalue at ranks lo, hi) compare_ms={cmp_ms:.4f} bound_ms={bnd:.4f} ({by}); "
        f"105 pools ms={uniform_ms:.4f}; dist ms={dist_ms:.4f} bound_ms={dist_bnd:.4f} (held windows in turns)")
    measured.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by, compare_ms=cmp_ms,
                    uniform_ms=uniform_ms, dist_ms=dist_ms, dist_bound_ms=dist_bnd)
    return ok


def run_prune_phase(gen, results: dict, expected_step: dict) -> tuple:
    """The paper's gradual magnitude pruning on the paper-width ORT
    (``PRUNE_TYPE``, bf16 XE at 15 x 5): PRUNE_STEPS steps, the gradual hook
    (``engine/prune_training.py gradual_prune``) after each, its four updates
    on the card (K16), the launch counts of that run asserted. After each
    update (uncounted): the masks and thresholds equal the plain version's on
    the same weights, the pruned counts those of the f32 index, and one pool
    of every weight held the same way (blind, dist); after the next step every
    pruned weight's gradient is exactly 0. Then the hook's whole update once
    more in a held window (K16 writing the mask parameters), and, timed on
    the host clock: a one-shot mag_blind prune through the host ``update_masks_once``, a SNIP
    saliency over 2 batches, and the lottery rewind to a ``torch.save``'d init
    snapshot (weights equal to the snapshot's, masks kept). Returns (ok, the
    run's launch counts)."""
    from sparse_caption_tpu_torch.engine import checkpoints, prune_training
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.kernels import launch_counts, magnitude_threshold as k16, reset_launch_counts
    from sparse_caption_tpu_torch.ops.masked import split_params
    from sparse_caption_tpu_torch.pruning import engine as prune_engine

    model = build_train_model(SEED, mask_type=PRUNE_TYPE)
    cfg = dict(TRAIN_CONFIG, prune_sparsity_target=PRUNE_TARGET, prune_gradual_frequency=PRUNE_FREQ)
    step = make_train_step(model, "bf16", cfg)
    batch = make_train_batch(gen, TRAIN_BATCH)
    pairs = prune_engine.mask_weight_pairs(model)
    ok, updates, last_pruned = True, [], None
    with tempfile.TemporaryDirectory() as tmp:
        init_path = checkpoints.save_checkpoint(os.path.join(tmp, "model_init.pt"), model)
        torch.cuda.synchronize()
        reset_launch_counts()
        state = TrainState()
        for _ in range(PRUNE_STEPS):
            state, loss, _ = step(state, batch)
            if last_pruned is not None:  # the step after an update ran on the pruned weights
                with uncounted():
                    zero_grad = all(not bool(mw.weight.grad[m].any()) for mw, m in zip(pairs, last_pruned))
                log(f"[prune] step {state.step}: loss {float(loss):.4f}; every pruned weight's gradient is 0: "
                    f"{zero_grad}")
                ok &= zero_grad and math.isfinite(float(loss))
            st = prune_training.gradual_prune(model, cfg, state.step, PRUNE_EPOCH_STEPS, PRUNE_MAX_STEP)
            if st is None:
                continue
            updates.append(st)
            with uncounted():
                ws = [mw.weight.detach() for mw in pairs]
                masks_p, _, _ = k16.magnitude_masks_plain(ws, list(range(len(ws))), st)
                same = all(torch.equal(mw.mask.detach(), m) for mw, m in zip(pairs, masks_p))
                log(f"[prune] update {len(updates)} after step {state.step} to {st:.6f}: the hook's masks equal the "
                    f"plain version's {same}")
                ok &= same
                measured = results["magnitude_threshold"]
                ok &= k16_case(f"update {len(updates)} uniform", ws, list(range(len(ws))), st, measured=measured)
                ok &= k16_case(f"update {len(updates)} blind", ws, [0] * len(ws), st, measured=measured)
                ok &= k16_case(f"update {len(updates)} dist", ws, [0] * len(ws), st, dist=True, measured=measured)
                last_pruned = [mw.mask.detach() == 0 for mw in pairs]
        torch.cuda.synchronize()
        counts = launch_counts()
        expected = {name: n * PRUNE_STEPS for name, n in expected_step.items()}
        expected["magnitude_threshold"] = len(updates)
        ok &= counts == expected and len(updates) == 4 and updates[-1] == PRUNE_TARGET
        log(f"[prune] {PRUNE_TYPE} bf16 {TRAIN_BATCH}x{SEQ_PER_IMG}: {PRUNE_STEPS} steps, updates to {updates}; "
            f"launches {counts} {'ok' if counts == expected else f'FAIL (expected {expected})'}")
        _, masks = split_params(model)
        sparsity = float(prune_engine.mask_sparsity(masks, PRUNE_TYPE)[0])
        log(f"[prune] mask sparsity {sparsity:.6f}; best checkpoint allowed: "
            f"{prune_training.allow_best_checkpoint(model, cfg)}")
        ok &= abs(sparsity - PRUNE_TARGET) < 1e-3 and prune_training.allow_best_checkpoint(model, cfg)
        with uncounted():  # the hook's whole update as it runs (the same masks again), K16 writing the parameters
            update_ms = time_ms(lambda: prune_engine.update_masks_once_device(model, PRUNE_TYPE, PRUNE_TARGET),
                                hold=True)
        log(f"[prune] update_masks_once_device, {len(pairs)} pools: ms={update_ms:.4f} (a held window)")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prune_engine.update_masks_once(model, "mag_blind", PRUNE_TARGET)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        n_all = sum(mw.mask.numel() for mw in pairs)
        zeros = sum(int((mw.mask == 0).sum()) for mw in pairs)
        ok &= zeros == int(PRUNE_TARGET * n_all)
        snip_batches = [make_train_batch(gen, TRAIN_BATCH) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saliency = prune_training.snip_saliency(model, snip_batches, cfg)
        torch.cuda.synchronize()
        snip_s = time.perf_counter() - t0
        ok &= len(saliency) == len(pairs) and all(bool(torch.isfinite(g).all()) for g in saliency.values())
        kept = {mw.name: mw.mask.detach().clone() for mw in pairs}
        prune_training.lottery_rewind(model, init_path)
        snapshot = checkpoints.load_checkpoint(init_path)["params"]
        params, masks = split_params(model)
        rewound = all(torch.equal(p.detach().cpu(), snapshot[n]) for n, p in params.items())
        masks_kept = all(torch.equal(masks[n], kept[n]) for n in kept)
        ok &= rewound and masks_kept
    log(f"[prune] host one-shot mag_blind over {n_all} weights: {host_s:.3f} s ({zeros} pruned); SNIP saliency over "
        f"2 batches: {snip_s:.3f} s (host clock); lottery rewind: weights equal the snapshot {rewound}, masks kept "
        f"{masks_kept} {'ok' if ok else 'FAIL'}")
    results["magnitude_threshold"].update(host_update_s=host_s, snip_s=snip_s, update_ms=update_ms)
    return ok, counts


# --------------------------------------------------------------- ACORT path
def acort_tokenizer(log_dir: str, flags=ACORT_FLAGS):
    """(the radix tokenizer, the run config it completed): `flags` over a
    synthetic word vocabulary of ACORT_WORDS words written into `log_dir`
    (the artifact the word tokenizer reads); the tokenizer writes the vocab
    size and the special ids into the config, as in a training run."""
    from sparse_caption_tpu_torch.config import Config
    from sparse_caption_tpu_torch.tokenizers import get_tokenizer

    words = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(ACORT_WORDS - 4)]
    os.makedirs(os.path.join(log_dir, "tokenizer"), exist_ok=True)
    with open(os.path.join(log_dir, "tokenizer", "word.vocab.json"), "w") as f:
        json.dump({"model_type": "word", "vocab": words}, f)
    config = Config(log_dir=log_dir, **flags)
    tok = get_tokenizer(config.tokenizer)(config)
    got = dict(vocab_size=config.vocab_size, pad_id=config.pad_token_id, bos_id=config.bos_token_id,
               eos_id=config.eos_token_id, unk_id=1)
    assert got == ACORT_BASE, (got, ACORT_BASE)
    return tok, config


def build_acort(config, seed: int, dropout: bool = True, unique: int = 2):
    """ACORT (base, base-AL or small, as `config` says; `unique` layers a
    side) in f32 on the card through the model's ``from_config``, random
    weights from the seed (dense: the recipe prunes nothing)."""
    from sparse_caption_tpu_torch.config import Config
    from sparse_caption_tpu_torch.models import get_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    extra = {} if dropout else dict(dropout_rate=0.0)
    if not dropout:
        config = Config(**dict(config.to_dict(), drop_prob_src=0.0))
    model = get_model(config.caption_model).from_config(config, device="cuda", generator=gen, **extra)
    assert len(model.box_encoder_layers) == len(model.decoder_layers) == unique, f"{unique} unique layers a side"
    return model


def build_ort(flags: dict, seed: int, dropout: bool = True):
    """One of the recipe's dense ORT baselines (`flags`: ORT-xsmall's or
    ORT-small's) in f32 on the card through ``from_config``, random weights
    from the seed."""
    from sparse_caption_tpu_torch.config import Config
    from sparse_caption_tpu_torch.models import get_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    config = Config(**(flags if dropout else dict(flags, drop_prob_src=0.0)))
    extra = {} if dropout else dict(dropout_rate=0.0)
    return get_model(config.caption_model).from_config(config, device="cuda", generator=gen, **extra)


def build_qk_ort(seed: int, dropout: bool = True):
    """QK_ORT in f32 on the card, random weights from the seed."""
    from sparse_caption_tpu_torch.models import get_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rates = {} if dropout else dict(dropout_rate=0.0, drop_prob_src=0.0)
    return get_model("relation_transformer")(**QK_ORT, **rates, device="cuda", generator=gen)


def make_acort_train_batch(gen, b, device="cuda"):
    """ACORT's XE batch: b images x 5 captions of 27 radix tokens (BOS, then
    random digits)."""
    att, mask, boxes = make_batch(gen, b, torch.float32, device)
    seqs = torch.randint(1, ACORT_BASE["bos_id"], (b * SEQ_PER_IMG, ACORT_LEN + 1), generator=gen, device=device)
    seqs[:, 0] = ACORT_BASE["bos_id"]
    return dict(att_feats=att, att_masks=mask, boxes=boxes, seqs=seqs,
                seq_masks=torch.ones(b * SEQ_PER_IMG, ACORT_LEN + 1, device=device))


def run_acort_phase(gen) -> tuple:
    """ACORT-base: beam-5 serving in bf16 at batch 50 and 2048 with the launch
    counts asserted (the kv modes of K1, K2 and K3; K4 at V = 771), a
    profile at 2048, captions decoded to words, the f32 batch-8 card-vs-CPU
    check; the dense XE step (noam, dropout on) in bf16 at 15 x 5 and 256 x
    5 with the launch counts asserted (the kv modes of K1's train variant
    and K7; K13 at V = 771; K14 / K15 with the one tensor as k and v) and a
    profile at 256 x 5, the card-vs-CPU f32 step at 2 x 5; then the small qk
    ORT's card-vs-CPU decode and step. Returns (ok, serving counts, XE
    counts)."""
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.kernels import KERNELS

    with tempfile.TemporaryDirectory() as log_dir:
        tok, config = acort_tokenizer(log_dir)
    slots, steps = ACORT_SLOTS, ACORT_LEN
    model = build_acort(config, SEED)
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    serve = {name: 0 for name in KERNELS}
    serve.update(box_attention_kv=slots, ancestry_self_attention_kv=slots * steps,
                 grouped_cross_attention_kv=slots * steps, beam_topk=steps,
                 add_ref_layernorm=(1 + 2 * slots) + steps * (1 + 3 * slots))
    torch.cuda.reset_peak_memory_stats()
    for b in (EVAL_BATCH, BIG_BATCH):
        serve_counts = run_main_path(model_bf16, gen, b, serve, label="acort")
    log(f"[acort] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batch = make_batch(gen, BIG_BATCH, torch.bfloat16)
    profile_window(f"ACORT encode + decode, bf16 batch {BIG_BATCH}", lambda: caption(model_bf16, batch))
    seq, _ = caption(model_bf16, tuple(x[:2] for x in batch))
    log(f"[acort] captions of images 0 and 1 (random weights): {[tok.decode(seq[i, 0].tolist()) for i in range(2)]}")
    del model_bf16, batch
    if not whole_path_check(model, gen, label="acort whole-path"):
        return False, None, None
    del model
    torch.cuda.empty_cache()

    train = {name: 0 for name in KERNELS}
    train.update(box_attention_train_kv=slots, box_attention_bwd_kv=slots,
                 add_ref_layernorm=(1 + 2 * slots) + (1 + 3 * slots),
                 add_ref_layernorm_bwd=(1 + 2 * slots) + (1 + 3 * slots), vocab_log_softmax=1,
                 vocab_log_softmax_bwd=1, decoder_attention_kv=2 * slots, decoder_attention_bwd_kv=2 * slots)
    train_model = build_acort(config, SEED)
    for b in (TRAIN_BATCH, TRAIN_BIG_BATCH):
        train_counts = run_train_phase(train_model, gen, b, "bf16", train, ACORT_CONFIG, make_acort_train_batch,
                                       "acort train")
    step, state = make_train_step(train_model, "bf16", ACORT_CONFIG), [TrainState()]
    batch = make_acort_train_batch(gen, TRAIN_BIG_BATCH)
    profile_window(f"ACORT XE step, bf16 batch {TRAIN_BIG_BATCH}x{SEQ_PER_IMG}",
                   lambda: state.append(step(state.pop(), batch)[0]))
    del train_model, step, state, batch
    torch.cuda.empty_cache()
    if not whole_step_check(SEED, gen, lambda: build_acort(config, SEED, dropout=False), make_acort_train_batch,
                            ACORT_CONFIG, "acort whole-step"):
        return False, None, None

    # qk sharing through the unshared kernels, q's projection passed as k
    qk = build_qk_ort(SEED)
    good = whole_path_check(qk, gen, label="qk whole-path")
    del qk
    good &= whole_step_check(SEED, gen, lambda: build_qk_ort(SEED, dropout=False), make_train_batch, QK_CONFIG,
                             "qk whole-step")
    torch.cuda.empty_cache()
    return good, serve_counts, train_counts


def acort_scst_launches(names) -> dict:
    """Launches of one ACORT SCST step: `scst_launches` over its 6 slots and
    25 sampled steps, dense (no K5), through the kv modes of K1, K7, K2, K3,
    K14 and K15."""
    counts = scst_launches(ACORT_SLOTS, ACORT_LEN - 1, 0, names)
    counts.update(supermask=0, supermask_bwd=0)
    return to_kv(counts)


def favour_word_digits(model):
    """`model` with its generator's bias raised by 4 on digits 1..13: a pair
    of digits then mostly decodes to one of the first 169 x 13 words of the
    vocabulary (a random model's pairs are <unk>, a value past the 10,000
    words, 98% of the time), so that sampled captions differ in words and
    the SCST rewards, and with them the gradients, are far from 0."""
    with torch.no_grad():
        model.generator.proj.bias[1:14] += 4.0
    return model


def run_acort_small_phase(gen) -> tuple:
    """ACORT-small (d256 over 8 heads: the dk 32 kernels) on the recipe's
    three paths at full width. Beam-5 serving in bf16 at batch 50 and 2048
    with the launch counts asserted, a profile at 2048, the f32 batch-8
    card-vs-CPU decode; the dense XE step (noam, dropout 0.1 / 0.5) in bf16
    at 15 x 5 and 256 x 5, counts asserted, the card-vs-CPU f32 step at 2 x
    5; the SCST stage (drop_prob_src 0.1, 15 random samples, the sample
    baseline, CIDEr-D + BLEU-4 of the digits regrouped in K10's radix mode,
    f32) at 5 x 15 and 64 x 15, counts asserted, a profile at 64 x 15, the
    replay at 5 x 15 and the card-vs-CPU step at 2 x 3 with dropout on.
    Returns (ok, serving counts, XE counts, SCST counts)."""
    from sparse_caption_tpu_torch.config import Config
    from sparse_caption_tpu_torch.kernels import KERNELS

    with tempfile.TemporaryDirectory() as log_dir:
        tok, config = acort_tokenizer(log_dir, ACORT_SMALL_FLAGS)
    slots, steps = ACORT_SLOTS, ACORT_LEN
    model = build_acort(config, SEED)
    assert model.d_model // model.num_heads == DK_SMALL
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    serve = {name: 0 for name in KERNELS}
    serve.update(box_attention_kv=slots, ancestry_self_attention_kv=slots * steps,
                 grouped_cross_attention_kv=slots * steps, beam_topk=steps,
                 add_ref_layernorm=(1 + 2 * slots) + steps * (1 + 3 * slots))
    torch.cuda.reset_peak_memory_stats()
    for b in (EVAL_BATCH, BIG_BATCH):
        serve_counts = run_main_path(model_bf16, gen, b, serve, label="acort-small")
    log(f"[acort-small] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batch = make_batch(gen, BIG_BATCH, torch.bfloat16)
    profile_window(f"ACORT-small encode + decode, bf16 batch {BIG_BATCH}", lambda: caption(model_bf16, batch))
    del model_bf16, batch
    if not whole_path_check(model, gen, label="acort-small whole-path"):
        return False, None, None, None
    del model
    torch.cuda.empty_cache()

    train = {name: 0 for name in KERNELS}
    train.update(box_attention_train_kv=slots, box_attention_bwd_kv=slots,
                 add_ref_layernorm=(1 + 2 * slots) + (1 + 3 * slots),
                 add_ref_layernorm_bwd=(1 + 2 * slots) + (1 + 3 * slots), vocab_log_softmax=1,
                 vocab_log_softmax_bwd=1, decoder_attention_kv=2 * slots, decoder_attention_bwd_kv=2 * slots)
    train_model = build_acort(config, SEED)
    for b in (TRAIN_BATCH, TRAIN_BIG_BATCH):
        train_counts = run_train_phase(train_model, gen, b, "bf16", train, ACORT_SMALL_CONFIG, make_acort_train_batch,
                                       "acort-small train")
    del train_model
    torch.cuda.empty_cache()
    if not whole_step_check(SEED, gen, lambda: build_acort(config, SEED, dropout=False), make_acort_train_batch,
                            ACORT_SMALL_CONFIG, "acort-small whole-step"):
        return False, None, None, None

    # SCST: the recipe's fine-tune of ACORT-small
    scst_config = Config(**dict(config.to_dict(), drop_prob_src=ACORT_SMALL_SCST_DROP_SRC))
    build_scst = lambda seed: favour_word_digits(build_acort(scst_config, seed))  # noqa: E731
    scst_model = build_scst(SEED)
    expected = acort_scst_launches(KERNELS)
    for b in SCST_BATCHES:
        scst_counts, step, state, batch = run_scst_phase(scst_model, gen, b, expected, label="acort-small scst",
                                                         tok=tok, config=ACORT_SMALL_SCST_CONFIG)
    held = [state]
    profile_window(f"ACORT-small SCST step, f32 batch {SCST_BATCHES[-1]}x{SCST_SAMPLES}",
                   lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held
    good = replay_check(scst_model, gen, label="acort-small replay", max_len=steps - 1)
    del scst_model
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED, gen, build_scst, make_batch, "acort-small scst-step", tok=tok,
                                  config=ACORT_SMALL_SCST_CONFIG, max_len=steps - 1)
    return good, serve_counts, train_counts, scst_counts


def run_ort_xsmall_phase(gen) -> tuple:
    """ORT-xsmall (d104 over 8 heads: the dk 13 kernels) through its normal
    entry points at the recipe's width: beam-5 serving in bf16 at batch 50
    and 2048 with the launch counts asserted and a profile at 2048, the f32
    batch-8 card-vs-CPU decode; the dense XE step (noam, dropout 0.1 / 0.5,
    clip 0.1) in bf16 at 15 x 5 and 256 x 5 with the counts asserted, the
    card-vs-CPU f32 step at 2 x 5 without dropout. Then, untimed, the same
    two card-vs-CPU checks for ORT-small (dk 32, unshared) and ACORT-base-AL
    (kv, one layer in all six slots). Returns (ok, serving counts, XE
    counts)."""
    from sparse_caption_tpu_torch.kernels import KERNELS

    layers, steps = ORT_XSMALL_FLAGS["num_layers"], MAX_LEN
    model = build_ort(ORT_XSMALL_FLAGS, SEED)
    assert model.d_model // model.num_heads == DK_XSMALL
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    serve = {name: 0 for name in KERNELS}
    serve.update(box_attention=layers, ancestry_self_attention=layers * steps,
                 grouped_cross_attention=layers * steps, beam_topk=steps,
                 add_ref_layernorm=(1 + 2 * layers) + steps * (1 + 3 * layers))
    torch.cuda.reset_peak_memory_stats()
    for b in (EVAL_BATCH, BIG_BATCH):
        serve_counts = run_main_path(model_bf16, gen, b, serve, label="ort-xsmall")
    log(f"[ort-xsmall] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batch = make_batch(gen, BIG_BATCH, torch.bfloat16)
    profile_window(f"ORT-xsmall encode + decode, bf16 batch {BIG_BATCH}", lambda: caption(model_bf16, batch))
    del model_bf16, batch
    if not whole_path_check(model, gen, label="ort-xsmall whole-path"):
        return False, None, None
    del model
    torch.cuda.empty_cache()

    train = {name: 0 for name in KERNELS}
    train.update(box_attention_train=layers, box_attention_bwd=layers,
                 add_ref_layernorm=(1 + 2 * layers) + (1 + 3 * layers),
                 add_ref_layernorm_bwd=(1 + 2 * layers) + (1 + 3 * layers), vocab_log_softmax=1,
                 vocab_log_softmax_bwd=1, decoder_attention=2 * layers, decoder_attention_bwd=2 * layers)
    train_model = build_ort(ORT_XSMALL_FLAGS, SEED)
    for b in (TRAIN_BATCH, TRAIN_BIG_BATCH):
        train_counts = run_train_phase(train_model, gen, b, "bf16", train, ORT_XSMALL_CONFIG, make_train_batch,
                                       "ort-xsmall train")
    del train_model
    torch.cuda.empty_cache()
    good = whole_step_check(SEED, gen, lambda: build_ort(ORT_XSMALL_FLAGS, SEED, dropout=False), make_train_batch,
                            ORT_XSMALL_CONFIG, "ort-xsmall whole-step")

    # ORT-small (dk 32, unshared) and ACORT-base-AL (kv, one layer a side): the card against the CPU
    small = build_ort(ORT_SMALL_FLAGS, SEED)
    good &= whole_path_check(small, gen, label="ort-small whole-path")
    del small
    good &= whole_step_check(SEED, gen, lambda: build_ort(ORT_SMALL_FLAGS, SEED, dropout=False), make_train_batch,
                             ORT_SMALL_CONFIG, "ort-small whole-step")
    with tempfile.TemporaryDirectory() as log_dir:
        _, al_config = acort_tokenizer(log_dir, ACORT_BASE_AL_FLAGS)
    al = build_acort(al_config, SEED, unique=1)
    good &= whole_path_check(al, gen, label="acort-base-al whole-path")
    del al
    good &= whole_step_check(SEED, gen, lambda: build_acort(al_config, SEED, dropout=False, unique=1),
                             make_acort_train_batch, ACORT_CONFIG, "acort-base-al whole-step")
    torch.cuda.empty_cache()
    return good, serve_counts, train_counts


def run_supermask_scst_phase(gen) -> tuple:
    """Supermask SCST: the paper-width ORT (64 x 15; the 5 x 15 timing is
    cut for the run's time limit) and Up-Down (16 x 60; 5 x 60 likewise)
    with a training supermask, every decode
    step drawing fresh keyed masks (K5's keyed mode) in the sampling phase
    and again in the gradient pass (the ORT's: the decode run again with
    gradients through K2's and K3's backward; Up-Down's: its unrolled
    replay), f32, dropout on, the mask Adam: 1 warm-up + SUPERMASK_SCST_STEPS
    steps at each batch with the launch counts asserted (fixed from step to
    step; no plain attention or plain K2 / K3 backward), steps/s, samples/s,
    peak memory, a profile of one step at the larger batch; the gradient
    pass's log-probs against the sampling decode's at the smaller batch; one
    step at 2 x 3 card against CPU (the same keyed bits on both). Returns
    (all held, ORT launches a step, Up-Down launches a step)."""
    from sparse_caption_tpu_torch.kernels import KERNELS

    good = True
    model = build_supermask_scst(SEED + 15)
    expected = supermask_scst_launches(PAPER["num_layers"], MAX_LEN, KERNELS)
    for b in SCST_BATCHES[-1:]:  # the larger batch only (the run's time limit)
        ort_counts, step, state, batch = run_scst_phase(model, gen, b, expected, label="supermask scst",
                                                        steps=SUPERMASK_SCST_STEPS)
    held = [state]
    profile_window(f"supermask SCST step, f32 batch {SCST_BATCHES[-1]}x{SCST_SAMPLES}",
                   lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held, state
    good &= replay_check(model, gen, label="supermask replay")
    del model
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 15, gen, build_supermask_scst, label="supermask scst-step")
    torch.cuda.empty_cache()

    ud = build_supermask_updown(SEED + 15)
    expected = supermask_updown_scst_launches(MAX_LEN, KERNELS)
    for b in UPDOWN_SCST_BATCHES[-1:]:  # the larger batch only (the run's time limit)
        ud_counts, step, state, batch = run_scst_phase(ud, gen, b, expected, UPDOWN_SCST_SAMPLES, updown_scst_batch,
                                                       "updown supermask scst", steps=SUPERMASK_SCST_STEPS)
    held = [state]
    profile_window(f"Up-Down supermask SCST step, f32 batch {UPDOWN_SCST_BATCHES[-1]}x{UPDOWN_SCST_SAMPLES}",
                   lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held, state
    good &= replay_check(ud, gen, make_updown_batch, UPDOWN_SCST_SAMPLES, "updown supermask replay")
    del ud
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 15, gen, build_supermask_updown, make_updown_batch,
                                  "updown supermask scst-step")
    torch.cuda.empty_cache()
    return good, ort_counts, ud_counts


# ------------------------------------------------- decode variants, raw geometry
def bounded_raw_wg(gen, h: int, dtype):
    """A raw-geometry wg projection (h, 4) with +-0.04 on the x / y log-deltas
    (|.| <= 6.91 on random_boxes) and +-0.05 on the w / h ones (|.| <= 3.0)
    and a bias of 1: w_g = relu(wg . geo + 1) lies in [0.15, 1.85], away from
    relu's kink (see check_kernels)."""
    dev = torch.device("cuda")
    signs = torch.randint(0, 2, (h, 4), generator=gen, device=dev).float() * 2 - 1
    return ((signs * torch.tensor([0.04, 0.04, 0.05, 0.05], device=dev)).to(dtype),
            torch.ones(h, device=dev).to(dtype))


def nucleus_cutoff_sums(c, method: str, temperature: float, exact: bool = False):
    """(N, 2) the plain version's prefix sums (``torch.cumsum`` of the sorted
    probabilities) just before and at its last kept entry of each row: the
    nucleus keeps entries while the sum before them stays below p. With
    `exact`, (N, 4): then the same two prefixes summed in f64 (exact for the
    f32 probabilities, as the kernel's fixed-point sums are)."""
    from sparse_caption_tpu_torch.decoding.sample import divide_by_temperature, modified_sample_logits

    probs = torch.softmax(divide_by_temperature(c, temperature), dim=-1)
    sorted_p = torch.sort(probs, dim=-1, descending=True, stable=True).values
    n_keep = (modified_sample_logits(c, method, temperature) > -1e29).sum(-1, keepdim=True)
    sums = []
    for csum in (torch.cumsum(sorted_p, dim=-1), torch.cumsum(sorted_p.double(), dim=-1))[:2 if exact else 1]:
        before = torch.where(n_keep > 1, csum.gather(1, (n_keep - 2).clamp(min=0)), torch.zeros_like(csum[:, :1]))
        sums.append(torch.cat([before, csum.gather(1, n_keep - 1)], dim=1))
    return torch.cat([x.double() for x in sums], dim=1) if exact else sums[0]


def near_p(sums, p: float):
    """Rows whose cutoff sums lie within NUCLEUS_NEAR_ULPS f32 ulps of p; with
    the exact sums beside them (``nucleus_cutoff_sums(..., exact=True)``),
    also rows where either lies within them, or where the plain version's
    rounding alone put a cutoff sum on the other side of p than its exact
    value (the kernel sums exactly)."""
    p32 = float(np.float32(p))
    near = ((sums - p32).abs() <= NUCLEUS_NEAR_ULPS * float(np.spacing(np.float32(p)))).any(-1)
    if sums.shape[1] == 4:
        near |= ((sums[:, :2] < p32) != (sums[:, 2:] < p32)).any(-1)
    return near


def sample_z(c, method: str, temperature: float, noise):
    """What K9 takes the argmax of, from the plain version's pieces: c the
    (banned) log-probs, noise the Gumbel noise (the uniforms for ``gumbel``)."""
    from sparse_caption_tpu_torch.decoding.sample import divide_by_temperature, modified_sample_logits

    if method == "gumbel":
        return c + -torch.log(-torch.log(noise + 1e-20) + 1e-20)
    if method == "greedy":
        return c
    if method == "random":
        return divide_by_temperature(c, temperature) + noise
    return modified_sample_logits(c, method, temperature) + noise


def sample_mode_cases(logits, prev, unfinished, cases, lp_errs: dict, label: str, faults: bool = False,
                      held_lp: bool = False) -> bool:
    """K9's wrapper against its plain version on one set of rows, each case
    (method, temperature, ban) of `cases` drawing the same keyed bits: tokens
    equal but for near-ties of the draw and nucleus rows next to p; chosen
    log-probs within K9_LP_TOL (1 + |lp|); the latch and seq equal. With
    `held_lp` (bf16 rows on the held path, whose log-probs are K13's: the
    peaked rows, where a dominant entry's log-prob lies near 0 and sums of
    its row's small terms in two orders round it apart by many bf16 ulps),
    the chosen log-probs of the live rows equal K13's at their tokens bit for
    bit, their distance from the plain version's logged. With `faults`, the
    planted faults (top-k ties dropped, the
    nucleus's log-probs not renormalised, the Gumbel method tempered).
    lp_errs: each mode's largest chosen log-prob error, updated."""
    from sparse_caption_tpu_torch.decoding.sample import divide_by_temperature
    from sparse_caption_tpu_torch.kernels import sample_step as k9
    from sparse_caption_tpu_torch.ops.rng import SAMPLE_SITE

    dev, ok = logits.device, True
    (n, vocab), t_max, step, key = logits.shape, MAX_LEN, 5, 0x5EED5EED12345
    for method, temperature, ban in cases:
        kw = dict(key=key, site=SAMPLE_SITE, temperature=temperature, ban_prev=ban, sample_method=method)
        outs = {}
        for impl, fn in (("kernel", k9.sample_step), ("plain", k9.sample_step_plain)):
            u = unfinished.clone()
            seq = torch.zeros(n, t_max, dtype=torch.int32, device=dev)
            lp = torch.zeros(n, t_max, device=dev)
            nxt = fn(logits, prev, u, seq, lp, step, **kw)
            outs[impl] = (nxt, u, seq, lp)
        (kn, ku, ks, kl), (pn, pu, ps, pl) = outs["kernel"], outs["plain"]
        c = k9.sample_logprobs(logits, prev, ban)
        draw = k9.keyed_uniform if method == "gumbel" else k9.gumbel_noise
        noise = draw(key, SAMPLE_SITE, step, n, vocab, dev)
        z = sample_z(c, method, temperature, noise)
        differ = kn != pn
        z_max = z.max(1).values
        tie = (z_max - z.gather(1, kn.long()[:, None])[:, 0]).abs() <= allowed(z_max, torch.float32)
        mode, top = k9.parse_sample_method(method)
        near = near_p(nucleus_cutoff_sums(c, method, temperature, exact=True), top) if mode == "nucleus" \
            else torch.zeros_like(differ)
        tokens_ok = bool((tie | near)[differ].all())
        same = ~differ
        lp_all = (kl[:, step] - pl[:, step]).abs()
        apart = torch.zeros_like(differ)
        if mode == "nucleus":  # a row next to p: the plain version's log-prob with one entry fewer or more kept,
            # but where its cutoff sum is p without rounding (four quarters at 0.5): there the rule is exact
            alt = (kl[:, step, None] - nucleus_lp_apart(c, method, temperature, kn)).abs().min(-1).values
            rounded = near & ~nucleus_exact_at_p(c, method, temperature, top)
            apart = rounded & (alt < lp_all)
            lp_all = torch.where(rounded, torch.minimum(lp_all, alt), lp_all)
        lp_err = lp_all[same]
        lp_ref = pl[:, step].abs()[same]
        ratio = lp_err / (K9_LP_TOL * (1 + lp_ref))
        lp_ok = bool((ratio <= 1).all())
        rule = f"tol {K9_LP_TOL} (1 + |lp|)"
        if held_lp and logits.dtype == torch.bfloat16:
            rule = "K13's bits at the live rows' tokens"
            from sparse_caption_tpu_torch.kernels import vocab_log_softmax as k13

            y13 = k13.vocab_log_softmax(logits).float().gather(1, kn.long()[:, None])[:, 0]
            lp_ok = bool(torch.equal(kl[unfinished, step], y13[unfinished]))
            apart = same & (kl[:, step] != pl[:, step])
            ulps = bf16_ulps(kl[apart, step], pl[apart, step]) if apart.any() else torch.zeros(1)
            far = (ulps > 1).sum().item() / max(int(same.sum()), 1)
            log(f"[kernel] sample_step {method} {label}: chosen log-probs equal K13's bit for bit={lp_ok}; against "
                f"the plain rule (rounded_log_softmax) {int(apart.sum())} of {int(same.sum())} apart, by at most "
                f"{lp_all[same].max().item():.3e} ({ulps.max().item():.0f} bf16 ulps); far share (> 1 ulp) "
                f"{far:.6f}")
        worst = int(lp_err.argmax())
        lp_errs[mode] = max(lp_errs.get(mode, 0.0), lp_err[worst].item())
        rest = bool(torch.equal(ku[same], pu[same]) and torch.equal(ks[same], ps[same]))
        kept = (modified_kept(c, method, temperature) if mode in ("topk", "nucleus") else None)
        shape = f", kept a row {kept.min().item()}..{kept.max().item()}" if kept is not None else ""
        name = f"sample_step {method} T={temperature}{' ban' if ban else ''}"
        log(f"[kernel] {name} {label}: tokens differing {int(differ.sum())}/{n} (near-ties or rows next to p: "
            f"ok={tokens_ok}){shape}; nucleus rows with a cutoff sum within {NUCLEUS_NEAR_ULPS} ulps of p "
            f"{int(near.sum())} (tokens differing among them {int((differ & near).sum())}, kept sets one entry "
            f"apart {int((apart & same).sum())}); chosen log-prob "
            f"max_abs_err={lp_err[worst].item():.3e} at |lp| {lp_ref[worst].item():.3f}, worst err/allowed "
            f"{ratio.max().item():.3f} ({rule}) {'ok' if lp_ok else 'FAIL'}; "
            f"latch and seq equal={rest}")
        ok &= tokens_ok and lp_ok and rest
        if not faults:
            continue
        if (method, temperature, ban) == ("top3", 1.0, False):  # fault: ties at the k-th value dropped
            scaled = divide_by_temperature(c, temperature)
            kth = torch.topk(scaled, 3, dim=-1).values[:, -1:]
            w_f = torch.argmax(torch.where(scaled > kth, scaled, -1e30) + noise, dim=-1)
            n_f = int((w_f != pn.long()).sum())
            log(f"[fault] sample_step top-k with ties dropped {label}: {n_f} tokens differ "
                f"{'caught' if n_f else 'MISSED'}")
            ok &= n_f > 0
        if (method, temperature, ban) == ("top0.9", 0.7, False):  # fault: the kept log-probs not renormalised
            probs = torch.softmax(divide_by_temperature(c, temperature), dim=-1)
            fault = torch.log(probs.gather(1, pn.long()[:, None]))[:, 0]
            n_f = int(((fault - pl[:, step]).abs() > K9_LP_TOL * (1 + pl[:, step].abs())).sum())
            log(f"[fault] sample_step nucleus log-probs not renormalised {label}: {n_f} chosen log-probs outside "
                f"the tolerance {'caught' if n_f else 'MISSED'}")
            ok &= n_f > 0
        if (method, temperature, ban) == ("gumbel", 0.7, True):  # fault: the Gumbel method tempered
            w_f = torch.argmax(divide_by_temperature(c, temperature) - torch.log(-torch.log(noise + 1e-20) + 1e-20),
                               dim=-1)
            n_f = int((w_f != pn.long()).sum())
            log(f"[fault] sample_step gumbel tempered {label}: {n_f} tokens differ {'caught' if n_f else 'MISSED'}")
            ok &= n_f > 0
    return ok


def nucleus_exact_at_p(c, method: str, temperature: float, p: float):
    """(N,) rows where a cutoff sum of the plain version (``nucleus_cutoff_sums``)
    equals p and equals the same prefix summed in f64: no rounding decides them."""
    sums, p32 = nucleus_cutoff_sums(c, method, temperature, exact=True), float(np.float32(p))
    return ((sums[:, :2] == p32) & (sums[:, :2] == sums[:, 2:])).any(-1)


def nucleus_lp_apart(c, method: str, temperature: float, tokens):
    """(N, 2) the plain nucleus's log-prob of `tokens` with one entry fewer and
    one more kept (in its stable descending order; -1e30 where the token is
    not kept): on a row whose cutoff sum lies next to p, exact prefix sums and
    ``torch.cumsum``'s rounding may keep one entry apart, and the kept mass,
    the denominator, with it."""
    from sparse_caption_tpu_torch.decoding.sample import divide_by_temperature

    scaled = divide_by_temperature(c, temperature)
    unnormalized = torch.exp(scaled - scaled.max(dim=-1, keepdim=True).values)
    probs = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order).scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                                             .expand_as(order).contiguous())
    n_keep = modified_kept(c, method, temperature)[:, None]
    tok = tokens.long()[:, None]
    out = []
    for delta in (-1, 1):
        keep = ranks < (n_keep + delta).clamp(1, probs.shape[1])
        denom = torch.where(keep, probs, 0.0).sum(dim=-1, keepdim=True)
        out.append(torch.where(keep.gather(1, tok), torch.log(probs.gather(1, tok) / denom), -1e30)[:, 0])
    return torch.stack(out, dim=-1)


def modified_kept(c, method: str, temperature: float):
    """(N,) the plain filter's kept entries a row."""
    from sparse_caption_tpu_torch.decoding.sample import modified_sample_logits

    return (modified_sample_logits(c, method, temperature) > -1e29).sum(-1)


def sample_rows(gen, n: int, vocab: int, dtype, scale: float = 3.0):
    """(logits, prev, unfinished) for K9's checks: logits at `scale`, a row of
    equal logits (every entry ties), a row of eight equal top logits (top-3's
    k-th value ties), a row of four equal logits carrying the row
    (probabilities of 1/4 exactly, and at p = 0.5 the cutoff sum 0.5 equals p),
    a flat row (scale 0.05: the nucleus at p = 0.9 keeps about 90%), a row
    whose banned token is its largest logit and one whose banned token is its
    second (a ban inside the top k); the other fed tokens at random."""
    dev = torch.device("cuda")
    logits = torch.randn(n, vocab, generator=gen, device=dev) * scale
    logits[0] = 0
    logits[1, :8] = 4 * scale
    logits[2] = -1000
    logits[2, :4] = 10
    logits[3] *= 0.05 / scale
    prev = torch.randint(min(4, vocab - 1), vocab, (n,), generator=gen, device=dev, dtype=torch.int32)
    top2 = torch.topk(logits[4:6], 2, dim=-1).indices
    prev[4], prev[5] = top2[0, 0], top2[1, 1]
    unfinished = torch.rand(n, generator=gen, device=dev) < 0.8
    return logits.to(dtype), prev, unfinished


def entry_bound_rows(n: int, vocab: int, dtype, key: int, site: int, t: int, bump: float) -> tuple:
    """Rows on which K9's entry rule decides the token: each row's logits are
    0 but `bump` at j, the column whose keyed u at step t lies nearest 1
    (1 - u about 1e-4 over 10,000 columns, g about 9). j wins every row (at
    bump 0.25 and T = K9_BOUND_TEMPERATURE its a lies 125 above the others',
    with |a| about 4,500; at bump 25 and T 1, 25), its warp draws z_ref =
    z_j, and its own bound lim lies within a few 1e-3 of its 1 - u: a margin
    below the add's rounding at |a| 4,500, or one grid point of u more
    skipped, skips the winner on some rows and moves the token. Returns
    (logits (n, vocab) in dtype, j (n,))."""
    from sparse_caption_tpu_torch.kernels import sample_step as k9

    dev = torch.device("cuda")
    j = torch.argmax(k9.keyed_uniform(key, site, t, n, vocab, dev), dim=1)
    logits = torch.zeros(n, vocab, device=dev)
    logits[torch.arange(n, device=dev), j] = bump
    return logits.to(dtype), j


def check_entry_bound(dtype) -> bool:
    """K9's held path where its entry rule decides (``entry_bound_rows``):
    random at T = K9_BOUND_TEMPERATURE (bump 0.25), random and Gumbel at T 1
    (bump 25), 2,048 rows at V = 10,000 in `dtype`: the kernel's and the
    plain version's tokens are j on every row. The rows must tell each
    mutant of the rule apart: ``k9_skip_model`` with the fault planted (no
    delta, no scaled term, one u more skipped) moves the token on some row
    of some case (the counts logged)."""
    from sparse_caption_tpu_torch.kernels import sample_step as k9
    from sparse_caption_tpu_torch.ops.rng import SAMPLE_SITE

    dev = torch.device("cuda")
    n, vocab, key, t = 2048, PAPER["vocab_size"], 0x5EED5EED12345, 7
    ok, moved = True, {f: 0 for f in ("no_delta", "no_scale", "kmax")}
    prev = torch.zeros(n, dtype=torch.int32, device=dev)
    u = k9.keyed_uniform(key, SAMPLE_SITE, t, n, vocab, dev)
    for method, temperature, bump in (("random", K9_BOUND_TEMPERATURE, 0.25), ("random", 1.0, 25.0),
                                      ("gumbel", 1.0, 25.0)):
        logits, want = entry_bound_rows(n, vocab, dtype, key, SAMPLE_SITE, t, bump)
        toks = {}
        for impl, fn in (("kernel", k9.sample_step), ("plain", k9.sample_step_plain)):
            seq = torch.zeros(n, MAX_LEN, dtype=torch.int32, device=dev)
            toks[impl] = fn(logits, prev, torch.ones(n, dtype=torch.bool, device=dev), seq,
                            torch.zeros(n, MAX_LEN, device=dev), t, key=key, site=SAMPLE_SITE,
                            temperature=temperature, sample_method=method).long()
        good = bool(torch.equal(toks["kernel"], want) and torch.equal(toks["plain"], want))
        c = k9.sample_logprobs(logits, prev, False)
        faults = {}
        for f in moved:
            token, _ = k9_skip_model(logits, c, u, method, temperature, fault=f)
            faults[f] = int((token != want).sum())
            moved[f] += faults[f]
        log(f"[kernel] sample_step {method} T={temperature} {str(dtype).split('.')[-1]} entry-bound rows (step {t}, "
            f"{n} rows, bump {bump}): kernel rows off j {int((toks['kernel'] != want).sum())}, plain "
            f"{int((toks['plain'] != want).sum())}; rows a planted fault moves (model) {faults} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    powered = all(v > 0 for v in moved.values())
    log(f"[kernel] sample_step entry-bound rows tell every planted fault apart: {powered} {moved}")
    return ok and powered


def check_sample_modes(gen, results: dict, timing: bool = True) -> bool:
    """K9's modes against their plain versions on the card, drawing the same
    keyed bits (``sample_mode_cases``): f32 at the SCST sampling shape (64 x
    15 rows) and bf16 at the sampling-serve shape (2048 x 5), each case of
    K9_MODE_CASES (top-k's three instances: k 1 and 3 (4 candidates a
    thread), 20 (32), 40 and k = V (the radix select); the nucleus at p 0.9
    and 0.5; Gumbel, random and greedy on the held path) on ``sample_rows``
    (ties everywhere, ties at the k-th, four quarters at p = 0.5, a flat row,
    a ban inside the top k); the held path's cases K9_HELD_CASES on peaked
    rows (scale K9_PEAKED_SCALE: few entries take the logs, the share logged
    from ``k9_skip_model``) and on rows where its entry rule decides the
    token (``check_entry_bound``); then ACORT's radix vocabulary (V = 771,
    f32 and bf16, every case with k = 771: the streaming path) and V =
    NUCLEUS_MAX_VOCAB (f32 and bf16, 256 rows, K9_LONG_CASES: the most
    shared memory a row may take; random, Gumbel and greedy on the
    streaming path). A planted fault each at V = 10,000 (top-k ties dropped,
    the nucleus's log-probs not renormalised, the Gumbel method tempered).
    The kernel's shared-memory sizes against the wrapper's. Times in bf16 at
    2048 x 5; the Gumbel mode's bound counts its operations on this run's
    rows (the entries the rule lets take the logs)."""
    from sparse_caption_tpu_torch.kernels import sample_step as k9
    from sparse_caption_tpu_torch.ops.rng import SAMPLE_SITE

    dev = torch.device("cuda")
    vocab, t_max, step, key = PAPER["vocab_size"], MAX_LEN, 5, 0x5EED5EED12345
    lp_errs = {"gumbel": 0.0, "topk": 0.0, "nucleus": 0.0}  # the largest chosen log-prob error of each mode
    modes = k9.MODES
    ok = smem_agrees("sample_step", "sct_sample_smem", k9.sample_smem,
                     [(vocab, modes["nucleus"], 0), (vocab, modes["topk"], 3), (vocab, modes["topk"], 33),
                      (k9.NUCLEUS_MAX_VOCAB, modes["nucleus"], 0), (vocab, modes["gumbel"], 0)])
    for dtype, v, n in ((torch.float32, 771, 960), (torch.bfloat16, 771, 960),
                        (torch.float32, k9.NUCLEUS_MAX_VOCAB, 256), (torch.bfloat16, k9.NUCLEUS_MAX_VOCAB, 256)):
        logits, prev, unfinished = sample_rows(gen, n, v, dtype)
        cases = K9_MODE_CASES + ((f"top{v}", 1.0, True),) if v == 771 else K9_LONG_CASES
        ok &= sample_mode_cases(logits, prev, unfinished, cases, {}, f"{str(dtype).split('.')[-1]} V={v}")
        del logits
    for dtype, n in ((torch.float32, SCST_BATCHES[-1] * SCST_SAMPLES), (torch.bfloat16, BIG_BATCH * SAMPLE_ROWS)):
        dname = str(dtype).split(".")[-1]
        logits, prev, unfinished = sample_rows(gen, n, vocab, dtype, scale=K9_PEAKED_SCALE)
        ok &= sample_mode_cases(logits, prev, unfinished, K9_HELD_CASES, {}, f"{dname} peaked", held_lp=True)
        for method, temperature, ban in K9_HELD_CASES[:3]:
            c = k9.sample_logprobs(logits, prev, ban)
            _, logged = k9_skip_model(logits, c, k9.keyed_uniform(key, SAMPLE_SITE, step, n, vocab, dev),
                                      method, temperature, prev if ban else None)
            log(f"[kernel] sample_step {method} T={temperature}{' ban' if ban else ''} {dname} peaked: on the held "
                f"path {logged.float().mean().item():.6f} of the entries take the logs")
        del logits
        ok &= check_entry_bound(dtype)
    for dtype, n in ((torch.float32, SCST_BATCHES[-1] * SCST_SAMPLES), (torch.bfloat16, BIG_BATCH * SAMPLE_ROWS)):
        dname = str(dtype).split(".")[-1]
        logits, prev, unfinished = sample_rows(gen, n, vocab, dtype)
        ok &= sample_mode_cases(logits, prev, unfinished, K9_MODE_CASES + ((f"top{vocab}", 1.0, True),), lp_errs,
                                dname, faults=True)
        if not timing or dtype != torch.bfloat16:
            continue
        seq, lp = torch.zeros(n, t_max, dtype=torch.int32, device=dev), torch.zeros(n, t_max, device=dev)
        u = unfinished.clone()
        # the Gumbel method's noise with sample.py's eps, formed once outside the timed call (as the random
        # mode's library yardstick takes its g)
        u_keyed = k9.keyed_uniform(key, SAMPLE_SITE, step, n, vocab, dev)
        g_eps = -torch.log(-torch.log(u_keyed + 1e-20) + 1e-20)
        _, logged = k9_skip_model(logits, k9.sample_logprobs(logits, prev, False), u_keyed, "gumbel", 1.0)
        del u_keyed

        def gumbel_library():
            lps = torch.log_softmax(logits, dim=-1)
            return lps.gather(1, torch.argmax(lps + g_eps, dim=-1, keepdim=True))

        libraries = {
            "top-k": lambda: torch.multinomial(torch.softmax(torch.topk(torch.log_softmax(logits, dim=-1), 3).values
                                                             .float(), dim=-1), 1),
            "nucleus": lambda: nucleus_library(logits, 0.9, 0.7),
            "gumbel": gumbel_library,
        }
        for label, mode, method, temperature in (("gumbel", "gumbel", "gumbel", 1.0), ("top-k", "topk", "top3", 1.0),
                                                 ("nucleus", "nucleus", "top0.9", 0.7)):
            kw = dict(key=key, site=SAMPLE_SITE, temperature=temperature, sample_method=method)
            ms, plain_ms, lib_ms = turns_ms(lambda kw=kw: k9.sample_step(logits, prev, u, seq, lp, step, **kw),
                                            lambda kw=kw: k9.sample_step_plain(logits, prev, u, seq, lp, step, **kw),
                                            libraries[label])
            if mode == "gumbel":
                bnd, by = k9_bound(n, vocab, dtype, int(logged.sum()))
            else:
                bnd, by = bound_ms(k9_bytes(n, vocab, dtype), flops((torch.float32, 8 * n * vocab)))
            log(f"[kernel] sample_step {label} {dname} at {n} rows: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bnd:.4f} ({by}; held windows in turns)")
            results[f"sample_step {label}"] = dict(max_abs_err=lp_errs[mode], ms=ms, plain_ms=plain_ms,
                                                   library_ms=lib_ms, bound_ms=bnd, bound_by=by)
        del g_eps, logged
    return ok


def nucleus_library(logits, p: float, temperature: float):
    """The nucleus draw as PyTorch calls: softmax, ``torch.sort``, cumsum, the
    kept prefix, ``torch.multinomial`` (the library yardstick of K9's nucleus mode)."""
    probs = torch.softmax(torch.log_softmax(logits.float(), dim=-1) / temperature, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True)
    keep = torch.cumsum(sorted_p, dim=-1) - sorted_p < p
    return order.gather(1, torch.multinomial(sorted_p * keep, 1))


def diverse_rows(gen, images: int, width: int, p: int, vocab: int, dtype) -> tuple:
    """(logits, div_tokens) for K4's diverse checks: each image's p
    earlier-group tokens, its first word chosen twice (three times in every
    other image). Even images: the repeated word leads its rows (6.0) and the
    last token follows (5.5), so that penalised entries win; odd images: every
    token 0.1 above the row's largest logit, so that the penalties drop them
    below unpenalised entries (a penalised value left in a thread's best, or
    a token left unmarked, moves the threshold or the value)."""
    dev = torch.device("cuda")
    n = images * width
    logits = torch.randn(n, vocab, generator=gen, device=dev)
    toks = torch.randint(4, vocab, (images, p), generator=gen, device=dev, dtype=torch.int32)
    toks[:, 1] = toks[:, 0]  # a word that two earlier beams chose
    toks[::2, 2 % p] = toks[::2, 0]  # and three, in every other image
    rows = torch.arange(n, device=dev)
    per_row = toks.repeat_interleave(width, 0).long()
    even = (rows // width) % 2 == 0
    top = logits.max(1).values
    for j in range(p):
        logits[rows, per_row[:, j]] = torch.where(even, logits[rows, per_row[:, j]], top + 0.1)
    logits[rows[even], per_row[even, p - 1]] = 5.5
    logits[rows[even], per_row[even, 0]] = 6.0
    return logits.to(dtype), toks


def check_diverse_topk(gen, results: dict, timing: bool = True) -> bool:
    """K4 with the diverse-beam penalty against its plain version on the
    card, on ``diverse_rows``: 2048 images x 2 rows (the third group of a
    beam-6 / 3-group search, 4 earlier-group tokens an image) at k 2 and 512
    x 2 with 256 tokens an image (the held path), 256 x 2 at V = 771 (the
    scalar path) and 100 images x 40 rows at k 40 (the radix select), f32
    and bf16, every other penalty on, lambda DIVERSE_LAMBDA_CHECK
    (``check_beam_topk``, the penalised entries as touched ones; the raw
    log-probs K13's bit for bit up to k 32); the penalised winners' values
    equal raw - count x lambda bit for bit (the count first; lambda
    subtracted once an occurrence rounds apart, counted as the planted
    fault). Times in bf16 at 2048 x 2."""
    from sparse_caption_tpu_torch.kernels import beam_topk as k4

    ok, vocab, lam = True, PAPER["vocab_size"], DIVERSE_LAMBDA_CHECK
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for images, width, p, v in ((BIG_BATCH, DIVERSE["beam_size"] // DIVERSE["group_size"], 4, vocab),
                                    (512, 2, k4.MAX_DIVERSITY, vocab), (256, 2, 4, ACORT_BASE["vocab_size"]),
                                    (100, 40, 6, vocab)):
            n = images * width
            logits, toks = diverse_rows(gen, images, width, p, v, dtype)
            kw = dict(k4_constraints(gen, n, v), div_tokens=toks, div_lambda=lam)
            tag = f" diverse P={p}" + (f" V={v}" if v != vocab else "")
            good, err = check_beam_topk(logits, kw, dtype, tag, widths=(width,))
            ok &= good
            vals, idx, raw = k4.beam_topk(logits, width, **kw)
            pvals, pidx, _ = k4.beam_topk_plain(logits, width, **kw)
            counts = k4.diversity_counts(toks, v).repeat_interleave(width, 0).gather(1, idx.long())
            other = (idx == kw["ban_token"][:, None]) | (kw["ban_eos"][:, None] & (idx == kw["eos_id"])) | \
                (idx == kw["unk_id"])
            pen = (counts > 0) & ~other
            want = raw - counts * lam
            once = raw.clone()
            for _ in range(int(counts.max().item())):
                once = torch.where(counts > _, once - lam, once)
            exact = bool(torch.equal(vals[pen], want[pen]))
            apart = int((once[pen] != want[pen]).sum())
            log(f"[kernel] beam_topk{tag} k={width} {dname}: {int(pen.sum())} penalised winners, values = raw - "
                f"count x lambda bit for bit={exact}; lambda subtracted once an occurrence differs at {apart} of them "
                f"{'caught' if apart else 'MISSED'}; values and indices equal the plain version's bit for bit in "
                f"{int(((vals == pvals) & (idx == pidx)).all(1).sum())} of {n} rows")
            ok &= exact and apart > 0
            if timing and dtype == torch.bfloat16 and width <= k4.REGISTER_K and p == 4 and v == vocab:
                ms, plain_ms, lib_ms = turns_ms(lambda: k4.beam_topk(logits, width, **kw),
                                                lambda: k4.beam_topk_plain(logits, width, **kw),
                                                lambda: torch.topk(torch.log_softmax(logits, dim=-1), width))
                bnd, by = bound_ms(k4_bytes(n, v, width, dtype, p), flops((torch.float32, 4 * n * v)))
                log(f"[kernel] beam_topk diverse {dname} at {n} rows: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={bnd:.4f} ({by}; held windows in turns)")
                results["beam_topk diverse"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                                    bound_ms=bnd, bound_by=by)
    return ok


def check_raw_geometry_kernels(gen, dtype, results: dict, timing: bool = True) -> bool:
    """K1 and K7 on the raw 4-wide geometry against their plain versions:
    K1 at the serving shape (2048 images, dk 64) with its log-bias, K1's
    train variant and K7 at the XE shape (256 images, dropout keep-mask),
    element-wise and in bf16 by ``rounding_share``, an image with no valid
    region, a planted fault each (the bias dropped, the wg gradient dropped);
    then every instance (dk 64, 32, 13, unshared and kv) at 64 images; the
    geometry weights bounded (``bounded_raw_wg``). Times of the dk 64
    unshared instances in bf16."""
    from sparse_caption_tpu_torch.kernels import box_attention as k1
    from sparse_caption_tpu_torch.kernels import box_attention_bwd as k7
    from sparse_caption_tpu_torch.ops.attention import NEG_INF, scaled_dot_attention

    dev, ok = torch.device("cuda"), True
    dname = str(dtype).split(".")[-1]
    h, r = HEADS, REGIONS
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731

    def compare(name, out, ref, scale=0.0, sum_scale=0.0, fault=None):
        nonlocal ok
        err, good, worst = close(out, ref, dtype, scale, sum_scale)
        log(f"[kernel] {name} raw geometry {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(f"{name} raw geometry", fault, ref, dtype, scale, sum_scale)
        return err

    def inputs(b, dk, kv):
        q, k = rnd(b, h, r, dk), rnd(b, h, r, dk)
        v = None if kv else rnd(b, h, r, dk)
        boxes = random_boxes(gen, b, r, dev)
        mask = random_region_mask(gen, b, r, dev)
        mask[0] = False
        return q, k, v, boxes, mask

    def bias_build(boxes, wg_w, wg_b, mask):  # the torch ops that make SDPA's float bias
        return k1.box_log_bias_plain(boxes, wg_w, wg_b, dtype).masked_fill(~mask[:, None, None, :], NEG_INF)

    # K1 at the serving shape
    wg_w, wg_b = bounded_raw_wg(gen, h, dtype)
    q, k, v, boxes, mask = inputs(BIG_BATCH, DK, False)
    args = (q, k, v, boxes, wg_w, wg_b, mask)
    bias = k1.box_log_bias_plain(boxes, wg_w, wg_b, dtype)
    bias_k = torch.empty(BIG_BATCH, h, r, r, device=dev, dtype=dtype)
    out = k1.box_attention(*args, bias_out=bias_k)
    ref = k1.box_attention_plain(*args)
    err1 = compare("box_attention", out, ref, rms(v), fault=scaled_dot_attention(q, k, v, mask))  # bias dropped
    if dtype == torch.bfloat16:
        ok &= rounding_share("box_attention raw geometry log-bias", bias_k, bias, BIAS_SHARE_LIMIT)
        ok &= rounding_share("box_attention raw geometry out", out, ref, K1_SHARE_LIMIT, K1_FAR_LIMIT)
    else:
        compare("box_attention log-bias", bias_k, bias)
    if timing and dtype == torch.bfloat16:
        float_mask = bias_build(boxes, wg_w, wg_b, mask).to(dtype).contiguous()
        ms, plain_ms, lib_ms = turns_ms(lambda: k1.box_attention(*args), lambda: k1.box_attention_plain(*args),
                                        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask))
        nb = BIG_BATCH
        bnd, by = bound_ms(k1_bytes(nb, h, r, DK, dtype, 4),
                           flops((dtype, 4 * nb * h * r * r * DK), (torch.float32, 2 * nb * r * r * 4 * h)))
        log(f"[kernel] box_attention raw geometry {dname}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bnd:.4f} ({by}; held windows in turns)")
        results["box_attention raw geometry"] = dict(max_abs_err=err1, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                                     bound_ms=bnd, bound_by=by)
    del q, k, v, out, ref, bias, bias_k

    # K1's train variant and K7 at the XE shape
    b = TRAIN_BIG_BATCH
    q, k, v, boxes, mask = inputs(b, DK, False)
    dout = rnd(b, h, r, DK)
    keep = torch.rand(b, h, r, r, generator=gen, device=dev) < 0.9

    def k7_run(fn, keep_, q=q, k=k, v=v, boxes=boxes, mask=mask, dout=dout, wg_w=wg_w, wg_b=wg_b):
        ins = leaves(*(x for x in (q, k, v) if x is not None), wg_w, wg_b)
        vv = ins[2] if v is not None else None
        out = fn(ins[0], ins[1], vv, boxes, ins[-2], ins[-1], mask, keep_, 0.9)
        return out.detach(), torch.autograd.grad(out, ins, dout)

    kout, kg = k7_run(k7.box_attention_train, keep)
    pout, pg = k7_run(k1.box_attention_plain, keep)
    compare("box_attention train fwd", kout, pout, rms(v))
    err7 = 0.0
    for i, nm in enumerate(("dq", "dk", "dv")):
        err7 = max(err7, compare(f"box_attention_bwd {nm}", kg[i], pg[i], pg[i].float().abs().max().item()))
    for i, nm in ((3, "d wg_w"), (4, "d wg_b")):
        err7 = max(err7, compare(f"box_attention_bwd {nm}", kg[i], pg[i], sum_scale=pg[i].float().abs().max().item(),
                                 fault=torch.zeros_like(pg[i]) if nm == "d wg_w" else None))
    if dtype == torch.bfloat16:
        ok &= rounding_share("box_attention raw geometry train fwd", kout, pout, K1_SHARE_LIMIT, K1_FAR_LIMIT)
        for i, nm in enumerate(("dq", "dk", "dv")):
            ok &= rounding_share(f"box_attention_bwd raw geometry {nm}", kg[i], pg[i], K7_SHARE_LIMIT, K7_FAR_LIMIT)
    if timing and dtype == torch.bfloat16:
        ins_k, ins_p = leaves(q, k, v, wg_w, wg_b), leaves(q, k, v, wg_w, wg_b)
        out_k = k7.box_attention_train(ins_k[0], ins_k[1], ins_k[2], boxes, ins_k[3], ins_k[4], mask, keep, 0.9)
        out_p = k1.box_attention_plain(ins_p[0], ins_p[1], ins_p[2], boxes, ins_p[3], ins_p[4], mask, keep, 0.9)
        ins_l = leaves(q, k, v)
        out_l = F.scaled_dot_product_attention(*ins_l, attn_mask=bias_build(boxes, wg_w, wg_b, mask).to(dtype))
        ms, plain_ms, lib_ms = turns_ms(lambda: torch.autograd.grad(out_k, ins_k, dout, retain_graph=True),
                                        lambda: torch.autograd.grad(out_p, ins_p, dout, retain_graph=True),
                                        lambda: torch.autograd.grad(out_l, ins_l, dout, retain_graph=True))
        bnd, by = bound_ms(k7_bytes(b, h, r, DK, dtype, 4),
                           flops((dtype, 10 * b * h * r * r * DK), (torch.float32, 4 * b * r * r * 4 * h)))
        log(f"[kernel] box_attention_bwd raw geometry {dname}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bnd:.4f} ({by}; held windows in turns)")
        results["box_attention_bwd raw geometry"] = dict(max_abs_err=err7, ms=ms, plain_ms=plain_ms,
                                                         library_ms=lib_ms, bound_ms=bnd, bound_by=by)
    del q, k, v, dout, keep, kout, kg, pout, pg

    # every instance: head widths 64, 32, 13, unshared and kv, at 64 images
    for dk in (DK, DK_SMALL, DK_XSMALL):
        for kv in (False, True):
            tag = f"dk{dk}{' kv' if kv else ''}"
            q, k, v, boxes, mask = inputs(64, dk, kv)
            dout = rnd(64, h, r, dk)
            keep = torch.rand(64, h, r, r, generator=gen, device=dev) < 0.9
            scale = rms(k if kv else v)
            compare(f"box_attention {tag}", k1.box_attention(q, k, v, boxes, wg_w, wg_b, mask),
                    k1.box_attention_plain(q, k, v, boxes, wg_w, wg_b, mask), scale)
            run = lambda fn: k7_run(fn, keep, q, k, v, boxes, mask, dout)  # noqa: E731
            (kout, kg), (pout, pg) = run(k7.box_attention_train), run(k1.box_attention_plain)
            compare(f"box_attention train fwd {tag}", kout, pout, scale)
            names = ("dq", "dkv") if kv else ("dq", "dk", "dv")
            for i, nm in enumerate(names):
                compare(f"box_attention_bwd {nm} {tag}", kg[i], pg[i], pg[i].float().abs().max().item())
            for i, nm in ((-2, "d wg_w"), (-1, "d wg_b")):
                compare(f"box_attention_bwd {nm} {tag}", kg[i], pg[i], sum_scale=pg[i].float().abs().max().item())
    return ok


def check_decode_variant_kernels(gen, results: dict, timing: bool = True) -> bool:
    """The decode variants' kernel modes: K9's sample methods, K4's
    diverse-beam penalty, K1 / K7 on the raw geometry (f32 and bf16)."""
    ok = check_sample_modes(gen, results, timing)
    ok &= check_diverse_topk(gen, results, timing)
    for dtype in (torch.float32, torch.bfloat16):
        ok &= check_raw_geometry_kernels(gen, dtype, results, timing)
        torch.cuda.empty_cache()
    return ok


def sample_path_check(model_f32, gen, method: str, temperature: float, label: str) -> bool:
    """Sampling (5 samples an image) f32 on the card against the CPU at batch
    8, the same weights and the same keyed noise: each sample's tokens equal,
    and its log-probs within WHOLE_PATH_LP_TOL up to its first EOS; a sample
    whose tokens differ passes only at a near-tie of its first differing
    draw: the CPU's argmax value there (its own log-probs of the common
    prefix, teacher-forced, filtered, plus the noise) within
    WHOLE_PATH_LP_TOL (1 + |z|) of the card token's, or, in the nucleus
    mode, a cutoff sum within NUCLEUS_PATH_TIE of p (the card's log-probs
    move it by rounding)."""
    from sparse_caption_tpu_torch.kernels import sample_step as k9
    from sparse_caption_tpu_torch.ops.rng import SAMPLE_SITE

    opt = {"num_random_sample": SAMPLE_ROWS, "beam_size": 0, "sample_method": method, "temperature": temperature}
    batch = make_batch(gen, CHECK_BATCH, torch.float32)
    seq_gpu, lp_gpu = (x.cpu() for x in caption(model_f32, batch, opt))
    model_cpu = copy.deepcopy(model_f32).to("cpu")
    batch_cpu = tuple(x.cpu() for x in batch)
    seq_cpu, lp_cpu = caption(model_cpu, batch_cpu, opt)
    n, t_len = CHECK_BATCH * SAMPLE_ROWS, seq_cpu.shape[-1]
    sg, sc = seq_gpu.reshape(n, t_len), seq_cpu.reshape(n, t_len)
    is_eos = (sc == model_cpu.eos_id).long()
    upto = (is_eos.cumsum(-1) - is_eos) == 0
    differ = (sg != sc).any(-1)
    err = (lp_gpu.reshape(n, t_len) - lp_cpu.reshape(n, t_len)).abs()[~differ][upto[~differ]].max().item()
    ties, good = 0, err <= WHOLE_PATH_LP_TOL
    if bool(differ.any()):
        memory = model_cpu.encode(*batch_cpu)
        tokens = torch.cat([torch.full((n, 1), model_cpu.bos_id, dtype=sc.dtype), sc], dim=1)
        with torch.no_grad():
            lps = torch.log_softmax(model_cpu.decode_teacher_forced(memory, tokens).float(), dim=-1)  # (N, T + 1, V)
        for row in differ.nonzero()[:, 0].tolist():
            t = int((sg[row] != sc[row]).nonzero()[0, 0])
            c = lps[row: row + 1, t]
            noise = (k9.keyed_uniform if method == "gumbel" else k9.gumbel_noise)(0, SAMPLE_SITE, t, n, c.shape[1],
                                                                                  "cpu")[row: row + 1]
            z = sample_z(c, method, temperature, noise)[0]
            z_gap = (z[sg[row, t]] - z[sc[row, t]]).abs().item()
            tie = z_gap <= WHOLE_PATH_LP_TOL * (1 + z[sc[row, t]].abs().item())
            mode, top = k9.parse_sample_method(method)
            if mode == "nucleus":
                tie |= bool(((nucleus_cutoff_sums(c, method, temperature) - top).abs() <= NUCLEUS_PATH_TIE).any())
            log(f"[{label}] sample {row} first differs at step {t}: card {int(sg[row, t])} cpu {int(sc[row, t])}, "
                f"CPU draw values apart by {z_gap:.3e} {'(a near-tie)' if tie else 'FAIL'}")
            ties += tie
            good &= tie
    log(f"[{label}] f32 batch {CHECK_BATCH} x {SAMPLE_ROWS} samples, {method} T={temperature}: tokens identical="
        f"{not bool(differ.any())}, samples accepted as near-ties {ties}; log-prob max_abs_err={err:.3e} "
        f"(tol {WHOLE_PATH_LP_TOL}) {'ok' if good else 'FAIL'}")
    return good


def bound_raw_geometry(model, seed: int):
    """``model`` with every encoder layer's raw-geometry wg bounded
    (``bounded_raw_wg``): last-bit differences at relu's kink would turn into
    gradient differences (the card-vs-CPU checks)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for layer in model.box_encoder_layers:
            w, bias = bounded_raw_wg(g, model.num_heads, torch.float32)
            layer.self_attn.wg.weight.copy_(w)
            layer.self_attn.wg.bias.copy_(bias)
    return model


def run_decode_variants_phase(gen) -> tuple:
    """The decode variants and the raw geometry at the paper ORT's width,
    through ``encode`` + ``generate`` and ``make_xe_step``: sampling serve (5
    samples an image, SAMPLE_METHODS) and diverse beam serve (DIVERSE) on the
    paper ORT (masks folded, bf16, batch 50 and 2048, the launch counts
    asserted), each checked card against CPU at f32 batch 8; the raw-geometry
    ORT (RAW_FLAGS, ``from_config``): beam-5 serving (bf16, 50 and 2048) and
    the dense XE step (15 x 5 f32 and bf16, 256 x 5 bf16), its card-vs-CPU
    decode and step (geometry weights bounded). Returns (ok, {path: launch
    counts})."""
    from sparse_caption_tpu_torch.kernels import KERNELS
    from sparse_caption_tpu_torch.kernels.sample_step import parse_sample_method

    layers, steps, paths, good = PAPER["num_layers"], MAX_LEN, {}, True
    model = build_model(SEED)
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    base = {name: 0 for name in KERNELS}
    base.update(box_attention=layers, ancestry_self_attention=layers * steps, grouped_cross_attention=layers * steps,
                add_ref_layernorm=(1 + 2 * layers) + steps * (1 + 3 * layers))
    for method, temperature in SAMPLE_METHODS:
        expected = dict(base, **{f"sample_step_{parse_sample_method(method)[0]}": steps})
        opt = {"num_random_sample": SAMPLE_ROWS, "beam_size": 0, "sample_method": method, "temperature": temperature}
        for b in (EVAL_BATCH, BIG_BATCH):
            paths[f"sample_serve_{method}"] = run_main_path(model_bf16, gen, b, expected,
                                                            label=f"sample serve {method} T={temperature}", opt=opt)
    batch = make_batch(gen, BIG_BATCH, torch.bfloat16)
    nucleus = {"num_random_sample": SAMPLE_ROWS, "beam_size": 0, "sample_method": "top0.9", "temperature": 0.7}
    profile_window(f"encode + nucleus sampling, bf16 batch {BIG_BATCH}x{SAMPLE_ROWS}",
                   lambda: caption(model_bf16, batch, nucleus))
    groups = DIVERSE["group_size"]
    expected = dict(base, ancestry_self_attention=groups * layers * steps,
                    grouped_cross_attention=groups * layers * steps, beam_topk=steps,
                    beam_topk_diverse=(groups - 1) * steps,
                    add_ref_layernorm=(1 + 2 * layers) + groups * steps * (1 + 3 * layers))
    for b in (EVAL_BATCH, BIG_BATCH):
        paths["diverse_serve"] = run_main_path(model_bf16, gen, b, expected, label="diverse beam serve",
                                               opt=dict(DIVERSE))
    profile_window(f"encode + diverse beam {DIVERSE['beam_size']} / {groups} groups, bf16 batch {BIG_BATCH}",
                   lambda: caption(model_bf16, batch, dict(DIVERSE)))
    del model_bf16, batch
    for method, temperature in SAMPLE_METHODS:
        good &= sample_path_check(model, gen, method, temperature, f"sample {method} whole-path")
    good &= whole_path_check(model, gen, label="diverse beam whole-path", opt=dict(DIVERSE))
    del model
    torch.cuda.empty_cache()

    raw = build_ort(RAW_FLAGS, SEED)
    assert raw.box_encoder_layers[0].self_attn.wg.weight.shape == (HEADS, 4)
    raw_bf16 = copy.deepcopy(raw).to(torch.bfloat16)
    serve = dict(base, box_attention=0, box_attention_raw=layers, beam_topk=steps)
    for b in (EVAL_BATCH, BIG_BATCH):
        paths["raw_serve"] = run_main_path(raw_bf16, gen, b, serve, label="raw-geometry serve")
    del raw_bf16
    good &= whole_path_check(bound_raw_geometry(raw, SEED + 1), gen, label="raw-geometry whole-path")
    del raw
    torch.cuda.empty_cache()
    train = {name: 0 for name in KERNELS}
    train.update(box_attention_train_raw=layers, box_attention_bwd_raw=layers,
                 add_ref_layernorm=(1 + 2 * layers) + (1 + 3 * layers),
                 add_ref_layernorm_bwd=(1 + 2 * layers) + (1 + 3 * layers), vocab_log_softmax=1,
                 vocab_log_softmax_bwd=1, decoder_attention=2 * layers, decoder_attention_bwd=2 * layers)
    train_model = build_ort(RAW_FLAGS, SEED)
    for b, precision in ((TRAIN_BATCH, "fp32"), (TRAIN_BATCH, "bf16"), (TRAIN_BIG_BATCH, "bf16")):
        paths["raw_train_step"] = run_train_phase(train_model, gen, b, precision, train, RAW_CONFIG, make_train_batch,
                                                  "raw-geometry train")
    del train_model
    torch.cuda.empty_cache()
    good &= whole_step_check(SEED, gen, lambda: bound_raw_geometry(build_ort(RAW_FLAGS, SEED, dropout=False), SEED + 1),
                             make_train_batch, RAW_CONFIG, "raw-geometry whole-step")
    torch.cuda.empty_cache()
    return good, paths


# ------------------------------------- scheduled sampling, beam-sample SCST
def k9_ss_bytes(sampled: int, n: int, vocab: int, dtype) -> int:
    """Bytes K9's ss mode must move: the log-prob rows of the `sampled` rows
    whose coin came up, read once (a row whose coin fails reads none); every
    row's teacher token read and its input token written (int32 each)."""
    return sampled * vocab * ESIZE[dtype] + n * 8


def k2_bwd_anc_bytes(anc: torch.Tensor, t: int, h: int = HEADS, dk: int = DK, kv: bool = False) -> int:
    """Bytes K2's backward must move at step t through the map `anc` (B, K,
    T_max), f32: q and dout in and dq, dk_t, dv_t out a row; each distinct
    (row, slot) pair the map names over slots 0..t once: its K and V slots
    in, both gradient buffers' slots in and out (slot t: each row's own,
    read and zeroed); the map's columns 0..t (int32). The kv mode: one cache
    and one gradient buffer, no dv_t."""
    b, k, _ = anc.shape
    rows = anc[:, :, : t + 1].long() + torch.arange(b, device=anc.device)[:, None, None] * k
    pairs = int(torch.unique(rows * (t + 1) + torch.arange(t + 1, device=anc.device)).numel())
    return 4 * h * dk * ((4 if kv else 5) * b * k + (3 if kv else 6) * pairs) + 4 * b * k * (t + 1)


def anc_map(kind: str, b: int, k: int, t_max: int, t: int, gen=None, device="cuda") -> torch.Tensor:
    """A (B, K, T_max) int32 ancestry map as beam search leaves it at step t
    (slot t the identity: each row wrote it itself): `identity`,
    `from_beam_0` (every earlier slot read from beam 0, the collision of step
    0's choice) or `random` (each earlier slot from a random beam of the image)."""
    ident = torch.arange(k, device=device, dtype=torch.int32)[None, :, None].expand(b, k, t_max)
    if kind == "identity":
        anc = ident.clone()
    elif kind == "from_beam_0":
        anc = torch.zeros(b, k, t_max, dtype=torch.int32, device=device)
    else:
        anc = torch.randint(0, k, (b, k, t_max), generator=gen, device=device, dtype=torch.int32)
    anc[:, :, t] = ident[:, :, t]
    return anc.contiguous()


def ss_rounding_rows(lp, draw, rows: slice):
    """``lp`` (bf16) with the rows `rows` rewritten so that their draw hinges
    on the noise's rounding to bf16: each such row's columns a (its largest
    noise) and b (its largest noise below a's) hold log-probs 0 and v, the
    rest -30, v a bf16 value near g_a - g_b at which the winner of the two
    under JAX's bf16 noise differs from the winner under the same noise
    unrounded (f32). Returns (lp, rows rewritten); a row with no such v
    nearby keeps its values."""
    from sparse_caption_tpu_torch.kernels import sample_step as k9

    dev, vocab = lp.device, lp.shape[1]
    idx = torch.arange(lp.shape[0], device=dev)[rows]
    bits = k9.keyed_bits(draw.key, k9.SS_NOISE_SITE, torch.full((1,), draw.t, device=dev), idx, vocab)
    g_f32 = -torch.log(-torch.log(((bits >> 25) * 2 + 1).to(torch.float32) * 2.0 ** -8))
    g_b16 = draw.noise(lp.shape[0], vocab, torch.bfloat16, dev)[rows].float()
    a = g_b16.argmax(1)
    col_b = torch.where(g_b16 < g_b16.gather(1, a[:, None]), g_b16, -1e9).argmax(1)
    (ba, bb), (fa, fb) = ((g.gather(1, a[:, None]), g.gather(1, col_b[:, None])) for g in (g_b16, g_f32))
    # candidates: the 33 bf16 values around g_a - g_b (consecutive bit patterns)
    near = (ba - bb).to(torch.bfloat16).view(torch.int16).to(torch.int32) + torch.arange(-16, 17, device=dev)
    v = near.to(torch.int16).view(torch.bfloat16).float()
    a_first = (a < col_b)[:, None]
    wins = [torch.where(a_first, (v + gb).to(torch.bfloat16) > ga.to(torch.bfloat16),
                        (v + gb).to(torch.bfloat16) >= ga.to(torch.bfloat16)) for ga, gb in ((ba, bb), (fa, fb))]
    hinge = wins[0] != wins[1]
    found = hinge.any(1)
    pick = v.gather(1, hinge.float().argmax(1)[:, None])[:, 0]
    out = lp.clone()
    r = idx[found]
    out[r] = -30.0
    out[r, a[found]] = 0.0
    out[r, col_b[found]] = pick[found].to(torch.bfloat16)
    return out, int(found.sum())


def check_ss_kernels(gen, results: dict, timing: bool = True) -> bool:
    """K9's ss mode (Up-Down's scheduled sampling) against its plain version
    on the card, on the same keyed draws, at the 256 x 5 XE step's rows and
    the vocabulary of 10,000, f32 and bf16 (a row of equal log-probs, where
    the first index must win): the tokens bit for bit at ss_prob 0.25 (the
    path's) and 1.0 (every row sampled); faults planted: the coin inverted,
    and in bf16 the noise formed in f32 (JAX's categorical forms it in the
    log-probs' dtype), which rows 1-256 are built to show
    (``ss_rounding_rows``). Times (bf16, and f32 beside) in held turns against the
    plain version and the library composition log_softmax + noise + argmax +
    where."""
    from sparse_caption_tpu_torch.kernels import sample_step as k9

    dev, ok = torch.device("cuda"), True
    n, vocab, step = SS_CHECK_ROWS, UPDOWN["vocab_size"], 5
    worst = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        lp = torch.log_softmax(torch.randn(n, vocab, generator=gen, device=dev) * 3.0, dim=-1).to(dtype)
        lp[0] = lp[0, 0]  # every entry ties
        teacher = torch.randint(4, vocab, (n,), generator=gen, device=dev, dtype=torch.int32)
        draw = k9.SSDraw(0x55EED0000 + ESIZE[dtype], step)
        if dtype == torch.bfloat16:
            lp, hinged = ss_rounding_rows(lp, draw, slice(1, 1 + SS_HINGE_ROWS))
            log(f"[kernel] scheduled_sample bf16: {hinged} of rows 1-{SS_HINGE_ROWS} rewritten so that their draw "
                f"hinges on the noise's rounding to bf16")
        u = draw.coin_uniform(n, dev)
        for ss_prob in (SS_PROB, 1.0):
            got = k9.scheduled_sample(lp, teacher, ss_prob, draw)
            ref = k9.scheduled_sample_plain(lp, teacher, ss_prob, draw)
            coin = u < ss_prob
            differ = int((got != ref).sum())
            worst = max(worst, int((got.long() - ref.long()).abs().max()))
            good = differ == 0 and bool(torch.equal(got[~coin], teacher[~coin]))
            log(f"[kernel] scheduled_sample {dname} ss_prob={ss_prob} {n} rows: {int(coin.sum())} sampled, tokens "
                f"differing from the plain version {differ} (row 0, all tied: {int(got[0])} plain {int(ref[0])}) "
                f"{'ok' if good else 'FAIL'}")
            ok &= good
            if ss_prob == SS_PROB:  # fault: the coin inverted
                full = k9.scheduled_sample_plain(lp, teacher, 1.0, draw)
                n_f = int((torch.where(~coin, full, teacher) != got).sum())
                log(f"[fault] scheduled_sample coin inverted {dname}: {n_f} tokens differ "
                    f"{'caught' if n_f else 'MISSED'}")
                ok &= n_f > 0
            elif dtype == torch.bfloat16:  # fault: the noise formed in f32, not rounded through bf16
                bits = k9.keyed_bits(draw.key, k9.SS_NOISE_SITE, torch.full((1,), step, device=dev),
                                     torch.arange(n, device=dev), vocab)
                uf = ((bits >> 25) * 2 + 1).to(torch.float32) * 2.0 ** -8
                z = (lp.float() - torch.log(-torch.log(uf))).to(torch.bfloat16)
                n_f = int((torch.argmax(z, dim=-1).to(torch.int32) != got).sum())
                log(f"[fault] scheduled_sample noise in f32 under bf16: {n_f} tokens differ "
                    f"{'caught' if n_f else 'MISSED'}")
                ok &= n_f > 0
                del bits, uf, z
        if not timing:
            continue
        coin = u < SS_PROB
        g = draw.noise(n, vocab, dtype, dev)
        ms, plain_ms, lib_ms = turns_ms(
            lambda: k9.scheduled_sample(lp, teacher, SS_PROB, draw),
            lambda: k9.scheduled_sample_plain(lp, teacher, SS_PROB, draw),
            lambda: torch.where(coin, torch.argmax(torch.log_softmax(lp, dim=-1) + g, dim=-1).to(torch.int32),
                                teacher))
        bnd, by = bound_ms(k9_ss_bytes(int(coin.sum()), n, vocab, dtype), {})
        log(f"[kernel] scheduled_sample {dname} {n} rows at ss_prob {SS_PROB}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (log_softmax + noise + argmax + where) bound_ms={bnd:.4f} ({by}; held windows "
            f"in turns)")
        entry = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)
        if dtype == torch.bfloat16:
            results["scheduled_sample"] = dict(max_abs_err=float(worst), **entry,
                                               **{f"f32_{k}": v for k, v in results.pop("_ss_f32").items()})
        else:
            results["_ss_f32"] = {k: v for k, v in entry.items() if k != "bound_by"}
        del g
    return ok


def check_k2_bwd_anc_kernels(gen, results: dict, timing: bool = True) -> bool:
    """K2's backward in the ancestry mode (beam-sample SCST's gradient pass:
    64 images x 15 beams, 8 heads of 64, T_max 17, f32) against its plain
    version (the autograd of the plain forward through the map), element by
    element within F32_TOL widened by each tensor's rms, at steps 0, 8 and 16
    and on three maps (K2_ANC_MAPS: the identity; every earlier slot from beam
    0, where one slot takes 15 beams' shares; a random map), the cache
    gradient the later steps left random: dq, dk_t, dv_t and the buffer
    after (slots < t added to, slot t zeroed, later slots untouched); under
    the identity map also against the identity kernel; fault planted:
    the map ignored (the identity kernel's buffer on the other maps). Then 17
    steps of ``decode_self_attention`` with gradients through maps that
    change every step, the cache threaded, against the same steps written out
    of place; the shared memory against the wrapper's formula. Times at the
    random map, each step: the kernel, the plain version, SDPA's forward +
    backward on the gathered cache and the identity kernel on the same
    inputs, in held turns."""
    from sparse_caption_tpu_torch.kernels import KERNELS
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2

    dev, dt = torch.device("cuda"), torch.float32
    b, kb = SCST_BATCHES[-1], SCST_SAMPLES
    n, h, dk, t_max = b * kb, HEADS, DK, MAX_LEN
    ok = smem_agrees("ancestry_self_attention_bwd_anc", "sct_ancestry_self_attention_bwd_anc_smem",
                     k2.anc_bwd_smem_bytes, [(dk, kb, 0), (dk, kb, t_max - 1), (dk, 60, 16), (dk, 32, 1023)])

    def rnd(*shape, g=gen):
        return torch.randn(*shape, generator=g, device=dev)

    def held(name, got, ref, fault=None):
        nonlocal ok
        err, good, worst = close(got, ref, dt, sum_scale=rms(ref))
        log(f"[kernel] {name} f32: max_abs_err={err:.3e} worst err/allowed={worst:.3f} {'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, dt, 0.0, rms(ref))
        return err

    q, ck, cv, dout = rnd(n, h, dk), rnd(n, h, t_max, dk), rnd(n, h, t_max, dk), rnd(n, h, dk)
    dck0, dcv0 = rnd(n, h, t_max, dk), rnd(n, h, t_max, dk)

    def run(fn, t, anc):
        dck, dcv = dck0.clone(), dcv0.clone()
        return (*fn(q, ck, cv, dout, dck, dcv, t, anc), dck, dcv)

    errs, maps = [], {}
    for t in K2_BWD_STEPS:
        for kind in K2_ANC_MAPS:
            anc = maps[(kind, t)] = anc_map(kind, b, kb, t_max, t, gen)
            got = run(k2.ancestry_self_attention_backward, t, anc)
            ref = run(k2.ancestry_self_attention_backward_plain, t, anc)
            ident = run(k2.ancestry_self_attention_backward, t, None)  # the map ignored
            tag = f"ancestry_self_attention_bwd ancestry {kind} t={t}"
            faulty = kind != "identity" and t > 0
            for i, part in enumerate(("dq", "dk_t", "dv_t", "dcache_k", "dcache_v")):
                errs.append(held(f"{tag} {part}", got[i], ref[i],
                                 fault=ident[i] if faulty and part == "dcache_k" else None))
            if kind == "identity":  # the identity kernel's results, but for the order of its sums
                for i, part in enumerate(("dq", "dk_t", "dv_t", "dcache_k", "dcache_v")):
                    errs.append(held(f"{tag} {part} against the identity kernel", got[i], ident[i]))
            untouched = bool(torch.equal(got[3][:, :, t + 1:], dck0[:, :, t + 1:])) and not got[3][:, :, t].any()
            ok &= untouched
            if not untouched:
                log(f"[kernel] {tag}: slot t not zeroed or slots past t touched FAIL")
            del got, ref, ident

    # 17 steps through maps that change every step, the cache threaded under autograd
    g17 = torch.Generator(device=dev).manual_seed(SEED + 38 * 17)
    qs, ks, vs, gs = ([rnd(n, h, dk, g=g17).requires_grad_(i < 3) for _ in range(t_max)] for i in range(4))
    cache_k, cache_v = torch.zeros(n, h, t_max, dk, device=dev), torch.zeros(n, h, t_max, dk, device=dev)
    anc = anc_map("identity", b, kb, t_max, 0)
    steps_maps, outs = [], []
    before = KERNELS["ancestry_self_attention_bwd_anc"].launches
    for t in range(t_max):
        anc = anc.clone()
        anc[:, :, t] = torch.arange(kb, device=dev, dtype=torch.int32)
        steps_maps.append(anc)
        outs.append(k2.decode_self_attention(qs[t], ks[t], vs[t], cache_k, cache_v, anc, t))
        parents = torch.randint(0, kb, (b, kb), generator=g17, device=dev) if t else torch.zeros(
            b, kb, dtype=torch.long, device=dev)
        anc = anc.gather(1, parents[..., None].expand(-1, -1, t_max)).contiguous()
    got = torch.autograd.grad(outs, qs + ks + vs, gs)
    launched = KERNELS["ancestry_self_attention_bwd_anc"].launches - before
    ref_outs = [k2.ancestry_self_attention_plain(qs[t], torch.stack(ks[: t + 1], 2), torch.stack(vs[: t + 1], 2),
                                                 steps_maps[t][:, :, : t + 1].contiguous(), t) for t in range(t_max)]
    want = torch.autograd.grad(ref_outs, qs + ks + vs, gs)
    for name, a, c in (("dq", torch.stack(got[:t_max]), torch.stack(want[:t_max])),
                       ("dk", torch.stack(got[t_max:2 * t_max]), torch.stack(want[t_max:2 * t_max])),
                       ("dv", torch.stack(got[2 * t_max:]), torch.stack(want[2 * t_max:]))):
        errs.append(held(f"decode_self_attention {t_max} steps through changing maps, the cache threaded: {name}", a,
                         c))
    log(f"[kernel] decode_self_attention {t_max} steps through changing maps: {launched} K2 backward ancestry "
        f"launches {'ok' if launched == t_max else 'FAIL'}")
    ok &= launched == t_max
    del qs, ks, vs, gs, outs, got, ref_outs, want, cache_k, cache_v

    if timing:
        times = {}
        for t in K2_BWD_STEPS:
            anc = maps[("random", t)]
            base = torch.arange(b, device=dev)[:, None, None] * kb
            rows = (anc[:, :, : t + 1].long() + base).reshape(n, t + 1)
            slots = torch.arange(t + 1, device=dev)
            kg = ck.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous().requires_grad_()
            vg = cv.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous().requires_grad_()
            q4, d4 = q[:, :, None].clone().requires_grad_(), dout[:, :, None]
            dck, dcv = dck0.clone(), dcv0.clone()
            times[t] = turns_ms(
                lambda: k2.ancestry_self_attention_backward(q, ck, cv, dout, dck, dcv, t, anc),
                lambda: k2.ancestry_self_attention_backward_plain(q, ck, cv, dout, dck, dcv, t, anc),
                lambda: torch.autograd.grad(F.scaled_dot_product_attention(q4, kg, vg), (q4, kg, vg), d4),
                lambda: k2.ancestry_self_attention_backward(q, ck, cv, dout, dck, dcv, t, None))
            bnd = bound_ms(k2_bwd_anc_bytes(anc, t), {})[0]
            log(f"[kernel] ancestry_self_attention_bwd ancestry f32 {n} rows t={t} (random map): "
                f"ms={times[t][0]:.4f} plain_ms={times[t][1]:.4f} library_ms={times[t][2]:.4f} (SDPA fwd + bwd, "
                f"gathered cache) identity-kernel ms={times[t][3]:.4f} bound_ms={bnd:.4f} (bytes; held windows in "
                f"turns)")
        last = K2_BWD_STEPS[-1]
        bnd, by = bound_ms(k2_bwd_anc_bytes(maps[("random", last)], last), {})
        results["ancestry_self_attention_bwd ancestry"] = results["ancestry_self_attention_bwd_anc"] = dict(
            max_abs_err=max(errs), ms=times[last][0], plain_ms=times[last][1], library_ms=times[last][2],
            bound_ms=bnd, bound_by=by, identity_ms=times[last][3],
            **{f"t{t}_{k}": v for t in K2_BWD_STEPS
               for k, v in zip(("ms", "plain_ms", "library_ms", "identity_ms"), times[t])})
    return ok & check_k2_bwd_anc_long(torch.Generator(device=dev).manual_seed(SEED + 42))


def check_k2_bwd_anc_long(gen) -> bool:
    """K2's ancestry-mode backward on long caches (K2_BWD_LONG_CASES: T_max
    1,024, 2 images, 8 heads, a random map) at a middle and the last step,
    against its plain version within F32_TOL widened by each tensor's rms:
    K's slots staged in chunks (``anc_bwd_chunk_slots``: 9 at dk 64 with 15
    beams, 38 at dk 13) and, where the fixed part leaves no room for one
    slot (18 beams at dk 64), read from global memory; the chunk rule's C
    function against the wrapper's."""
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2

    dev, dt, h = torch.device("cuda"), torch.float32, HEADS
    ok = smem_agrees("ancestry_self_attention_bwd_anc", "sct_ancestry_self_attention_bwd_anc_chunk_slots",
                     k2.anc_bwd_chunk_slots, [(dk, kb, t) for dk, _, kb, t_max in K2_BWD_LONG_CASES
                                              for t in (0, 16, t_max - 1)])
    for dk, kv, kb, t_max in K2_BWD_LONG_CASES:
        n = 2 * kb
        q, dout = (torch.randn(n, h, dk, generator=gen, device=dev) for _ in range(2))
        caches = [torch.randn(n, h, t_max, dk, generator=gen, device=dev) for _ in range(1 if kv else 2)]
        dc0 = [torch.randn(n, h, t_max, dk, generator=gen, device=dev) for _ in caches]
        for t in (t_max // 2, t_max - 1):
            anc = anc_map("random", 2, kb, t_max, t, gen)

            def run(fn):
                dcs = [c.clone() for c in dc0]
                out = fn(q, caches[0], None if kv else caches[1], dout, dcs[0], None if kv else dcs[1], t, anc)
                return [x for x in out if x is not None] + dcs

            got, ref = run(k2.ancestry_self_attention_backward), run(k2.ancestry_self_attention_backward_plain)
            worst, good = 0.0, True
            for a, c in zip(got, ref):
                _, fine, w = close(a, c, dt, sum_scale=rms(c))
                worst, good = max(worst, w), good and fine
            cw = k2.anc_bwd_chunk_slots(dk, kb, t)
            how = "read in place" if cw == 0 else f"{-(-(t + 1) // cw)} chunks"
            log(f"[kernel] ancestry_self_attention_bwd ancestry{' kv' if kv else ''} dk{dk} {kb} beams T_max {t_max} "
                f"t={t}: {cw} slots staged at once ({how}), worst err/allowed {worst:.3f} {'ok' if good else 'FAIL'}")
            ok &= good
            del got, ref
        del q, dout, caches, dc0
    return ok


def check_ss_beam_kernels(gen, results: dict, timing: bool = True) -> bool:
    """This slice's kernel modes: K9's ss mode and K2's backward through the map."""
    ok = check_ss_kernels(gen, results, timing)
    torch.cuda.empty_cache()
    ok &= check_k2_bwd_anc_kernels(gen, results, timing)
    torch.cuda.empty_cache()
    return ok


def build_updown_ss(seed: int, dropout: bool = True):
    """The Up-Down XE cell's model (``build_updown(train=True)``) with
    scheduled sampling at SS_PROB and SS_LOGIT_LAYERS logit layers."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return get_model("up_down_lstm_prune")(**UPDOWN, drop_prob_lm=UPDOWN_DROP if dropout else 0.0,
                                           logit_layers=SS_LOGIT_LAYERS, ss_prob=SS_PROB, device="cuda",
                                           mask_cfg=MaskConfig("supermask", MASK_INIT, keep_masks=True),
                                           generator=gen)


@contextlib.contextmanager
def card_ss_tokens(flips: list):
    """The card's scheduled samples for the CPU: the card's step inputs are
    kept, and the CPU's step t takes the card's (its own differ only where a
    coin or a draw lies within rounding of a tie); each CPU step appends its
    count of differing tokens to `flips`."""
    from sparse_caption_tpu_torch.models import up_down as pud

    real, kept = pud.scheduled_sample, []

    def shared(prev, teacher, ss_prob, draw):
        out = real(prev, teacher, ss_prob, draw)
        if prev.is_cuda:
            kept.append(out.cpu())
            return out
        card = kept.pop(0)
        flips.append(int((card != out).sum()))
        return card.to(out.device)

    with mock.patch.object(pud, "scheduled_sample", shared):
        yield


def ort_beam_scst_launches(layers: int, steps: int, n_masked: int, names) -> dict:
    """Launches of one beam-sample SCST step of the mask_freeze ORT: the
    sampling phase (a train-mode encode and a beam search of `steps` steps:
    K2 through the map, K3 and K4 each step; masked weights multiplied one
    tensor a launch, kept until the update), the reward, then the gradient
    pass: the same encode, cache and steps with gradients on the recorded
    decisions (one K5 set for the encode, one for the cross K/V, one a step;
    K13 a step), and their backward (K2's in the ancestry mode)."""
    counts = supermask_scst_launches(layers, steps, names)
    counts.update(supermask_keyed=0, supermask=n_masked + 2 + steps, ancestry_self_attention_bwd=0,
                  ancestry_self_attention_bwd_anc=layers * steps, sample_step=0, beam_topk=steps)
    return counts


def updown_beam_scst_launches(steps: int, names) -> dict:
    """Launches of one beam-sample SCST step of the mask_freeze Up-Down: the
    random-sample step's (``updown_scst_launches``) with K4 a step in the
    sampling phase and, in the gradient pass (the search run again with
    gradients), K13 a step and its backward."""
    counts = updown_scst_launches(steps, names)
    counts.update(sample_step=0, beam_topk=steps, vocab_log_softmax=steps, vocab_log_softmax_bwd=steps)
    return counts


def beam_replay_check(model, gen, make=make_batch, beams=SCST_SAMPLES, label="beam replay", max_len=MAX_LEN) -> bool:
    """At 5 x beams with dropout on: the gradient pass's forced search
    (``beam_log_probs``: the decode again with gradients, K13 a step, on the
    sampling search's decisions) gives the sampling search's beams, and its
    chosen log-probs the sampling search's (K4's) at every non-pad position."""
    from sparse_caption_tpu_torch.decoding import generate
    from sparse_caption_tpu_torch.engine.training import beam_log_probs
    from sparse_caption_tpu_torch.ops.rng import KeyedStream

    batch = make(gen, SCST_BATCHES[0], torch.float32)
    opt = {"beam_size": beams, "max_seq_length": max_len, "decode_train": True}
    with torch.no_grad():
        memory = model.encode(*batch, train=True, rng=KeyedStream(11))
        seq, seq_lp, decisions = generate(model, memory, opt, rng=12, return_decisions=True)
    seq2, lp2 = beam_log_probs(model, model.encode(*batch, train=True, rng=KeyedStream(11)), decisions, 12)
    same = bool(torch.equal(seq2, seq))
    valid = seq != model.pad_id
    gap = (lp2.detach() - seq_lp)[valid].abs().max().item()
    good = same and gap <= REPLAY_LP_TOL
    log(f"[{label}] f32 {SCST_BATCHES[0]}x{beams}: forced search's beams equal the sampling search's {same}; "
        f"{int(valid.sum())} non-pad positions, worst |gradient pass - sampling| log-prob {gap:.3e} (tol "
        f"{REPLAY_LP_TOL}) {'ok' if good else 'FAIL'}")
    return good


def run_ss_beam_phase(gen, t0: float) -> tuple:
    """Up-Down's scheduled sampling and beam-sample SCST at paper width:
    - ``updown_ss_train_step``: the Up-Down supermask XE step at ss_prob 0.25
      and 2 logit layers (dropout 0.1; 15 x 5 f32 and bf16, 256 x 5 bf16; 1
      warm-up + 10 steps each, the launch counts asserted: K9's ss mode a
      step from t = 1, K13 a step), a profile at 256 x 5, and the f32 step
      at 2 x 5 without dropout card against CPU, the CPU taking the card's
      scheduled samples (its own differing ones counted);
    - ``ort_beam_scst_step``: the paper ORT's sparse SCST (mask_freeze at
      0.9875) with beam search of width 15 in place of 15 random samples, at
      64 x 15 (the 5 x 15 timing cut for the time limit; 1 warm-up + BEAM_SCST_STEPS steps, the counts
      asserted: K4 a step, K2's backward through the map), a profile at 64 x
      15, the gradient pass's log-probs against the sampling search's, one
      step at 2 x 3 beams card against CPU (the card's decisions on both);
    - ``updown_beam_scst_step``: the same for Up-Down (mask_freeze 0.991,
      beam 60) at 16 x 60.
    `t0`: the build's start, for the ``[time]`` lines. Returns (ok, {path:
    launch counts})."""
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.kernels import KERNELS

    good, paths, steps = True, {}, MAX_LEN
    expected = {name: 0 for name in KERNELS}
    expected.update(supermask=1 + steps, supermask_bwd=1 + steps, lstm_cell=2 * steps, lstm_cell_bwd=2 * steps,
                    additive_attention=steps, additive_attention_bwd=steps, vocab_log_softmax=steps,
                    vocab_log_softmax_bwd=steps, scheduled_sample=steps - 1)
    ud = build_updown_ss(SEED + 38)
    for b, precision in ((TRAIN_BATCH, "fp32"), (TRAIN_BATCH, "bf16"), (TRAIN_BIG_BATCH, "bf16")):
        paths["updown_ss_train_step"] = run_train_phase(ud, gen, b, precision, expected, UPDOWN_CONFIG,
                                                        make_updown_train_batch, "updown ss train")
    step, state = make_train_step(ud, "bf16", UPDOWN_CONFIG), [TrainState()]
    batch = make_updown_train_batch(gen, TRAIN_BIG_BATCH)
    profile_window(f"Up-Down XE step with scheduled sampling, bf16 batch {TRAIN_BIG_BATCH}x{SEQ_PER_IMG}",
                   lambda: state.append(step(state.pop(), batch)[0]))
    del ud, step, state, batch
    torch.cuda.empty_cache()
    flips: list = []
    good &= whole_step_check(SEED, gen, lambda: build_updown_ss(SEED + 38, dropout=False), make_updown_train_batch,
                             UPDOWN_CONFIG, "updown ss whole-step", context=lambda: card_ss_tokens(flips))
    log(f"[updown ss whole-step] scheduled-sample tokens of the CPU differing from the card's, step by step: {flips} "
        f"(the CPU took the card's)")
    good &= len(flips) == steps - 1
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began (ORT beam-sample SCST)")
    model = build_scst_model(SEED + 39)
    expected = ort_beam_scst_launches(PAPER["num_layers"], steps, len(masked_shapes()), KERNELS)
    for b in SCST_BATCHES[-1:]:  # the larger batch only (the run's time limit)
        paths["ort_beam_scst_step"], step, state, batch = run_scst_phase(
            model, gen, b, expected, label="ort beam scst", config=BEAM_SCST_CONFIG, steps=BEAM_SCST_STEPS)
    held = [state]
    profile_window(f"ORT beam-sample SCST step, f32 batch {SCST_BATCHES[-1]}x{SCST_SAMPLES}",
                   lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held, state
    good &= beam_replay_check(model, gen, label="ort beam replay")
    del model
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 39, gen, label="ort beam scst-step", config=BEAM_SCST_CONFIG)
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began (Up-Down beam-sample SCST)")
    ud = build_updown_scst(SEED + 39)
    expected = updown_beam_scst_launches(steps, KERNELS)
    for b in UPDOWN_SCST_BATCHES[-1:]:  # the larger batch only (the run's time limit)
        paths["updown_beam_scst_step"], step, state, batch = run_scst_phase(
            ud, gen, b, expected, UPDOWN_SCST_SAMPLES, updown_scst_batch, "updown beam scst", config=BEAM_SCST_CONFIG,
            steps=BEAM_SCST_STEPS)
    held = [state]
    profile_window(f"Up-Down beam-sample SCST step, f32 batch {UPDOWN_SCST_BATCHES[-1]}x{UPDOWN_SCST_SAMPLES}",
                   lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held, state
    good &= beam_replay_check(ud, gen, make_updown_batch, UPDOWN_SCST_SAMPLES, "updown beam replay")
    del ud
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 39, gen, build_updown_scst, make_updown_batch, "updown beam scst-step",
                                  config=BEAM_SCST_CONFIG)
    torch.cuda.empty_cache()
    return good, paths


# ------------------------------------------- supermask and beam-sample SCST at ACORT's and ORT-xsmall's widths
def check_k2_bwd_width_kernels(gen, results: dict, timing: bool = True, timed: int = BWD_TIMED_CASES) -> bool:
    """K2's backward at the instances of BWD_WIDTH_CASES (the kv mode at dk
    64 / 32 / 13, the unshared mode at 32 / 13; f32) against its plain
    version at the SCST gradient pass's shapes (64 images x 15 rows, 8
    heads, the decode's T_max), element by element within F32_TOL widened by
    each tensor's rms: the identity kernel and the ancestry mode on the maps
    BWD_ANC_MAPS (the identity, every slot from beam 0, random), at the
    first, a middle and the last step, the cache
    gradient the later steps left random: dq, dk_t (, dv_t) and the buffers
    after (slots < t added to, slot t zeroed, later slots untouched). Faults
    planted in the kv mode: the V term left out of the one buffer, and the
    score term left out. Then 25 steps of ``decode_self_attention`` in the kv
    mode at ACORT-small's width, through maps that change every step and
    through the identity, the one cache threaded under autograd, against
    the same steps written out of place; the ancestry mode's shared memory
    against the wrapper's formula. Timed (the first `timed` cases: by
    default the path instances; the last step, both modes): the kernel, the
    plain version and SDPA's forward + backward on the gathered cache (one
    tensor as K and V under kv), in held turns."""
    from sparse_caption_tpu_torch.kernels import KERNELS
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2

    dev, dt = torch.device("cuda"), torch.float32
    b, kb = SCST_BATCHES[-1], SCST_SAMPLES
    n, h = b * kb, HEADS
    ok = smem_agrees("ancestry_self_attention_bwd_anc", "sct_ancestry_self_attention_bwd_anc_smem",
                     k2.anc_bwd_smem_bytes, [(dk, kb, t) for dk in (64, 32, 13) for t in (0, ACORT_LEN - 2)])

    def rnd(*shape, g=gen):
        return torch.randn(*shape, generator=g, device=dev)

    def held(name, got, ref, fault=None):
        nonlocal ok
        err, good, worst = close(got, ref, dt, sum_scale=rms(ref))
        if not good:
            log(f"[kernel] {name} f32: max_abs_err={err:.3e} worst err/allowed={worst:.3f} FAIL")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, dt, 0.0, rms(ref))
        return err

    for case, (tag, dk, kv, t_max) in enumerate(BWD_WIDTH_CASES):
        q, dout = rnd(n, h, dk), rnd(n, h, dk)
        caches = [rnd(n, h, t_max, dk) for _ in range(1 if kv else 2)]
        dc0 = [rnd(n, h, t_max, dk) for _ in caches]
        parts = ("dq", "dk_t", "dcache") if kv else ("dq", "dk_t", "dv_t", "dcache_k", "dcache_v")

        def run(fn, t, anc, cs=caches, d0=dc0):
            dcs = [c.clone() for c in d0]
            out = fn(q, cs[0], cs[1] if len(cs) == 2 else None, dout, dcs[0], dcs[1] if len(dcs) == 2 else None,
                     t, anc)
            return [x for x in out if x is not None] + dcs

        errs = {"identity": [], "ancestry": []}
        maps = {}
        for t in (0, t_max // 2, t_max - 1):
            for kind in ("none",) + BWD_ANC_MAPS:  # "none": the identity kernel; then the ancestry mode's maps
                anc = None if kind == "none" else anc_map(kind, b, kb, t_max, t, gen)
                maps[(kind, t)] = anc
                got = run(k2.ancestry_self_attention_backward, t, anc)
                ref = run(k2.ancestry_self_attention_backward_plain, t, anc)
                mode = "identity" if anc is None else "ancestry"
                name = f"ancestry_self_attention_bwd {tag} {kind} t={t}"
                if kv and t == t_max - 1:
                    # the unshared plain version given the one cache twice: its dcache_k holds the score term
                    # alone (the V term left out), its dcache_v the V term alone (the score term left out)
                    alone = run(k2.ancestry_self_attention_backward_plain, t, anc, caches * 2, dc0 * 2)
                    ok &= fault_caught(f"{name} dcache, the V term left out", alone[3], ref[2], dt, 0.0, rms(ref[2]))
                    ok &= fault_caught(f"{name} dcache, the score term left out", alone[4], ref[2], dt, 0.0,
                                       rms(ref[2]))
                    del alone
                for i, part in enumerate(parts):
                    errs[mode].append(held(f"{name} {part}", got[i], ref[i]))
                buf = got[len(parts) - len(caches)]
                untouched = bool(torch.equal(buf[:, :, t + 1:], dc0[0][:, :, t + 1:])) and not buf[:, :, t].any()
                ok &= untouched
                if not untouched:
                    log(f"[kernel] {name}: slot t not zeroed or slots past t touched FAIL")
                del got, ref
        log(f"[kernel] ancestry_self_attention_bwd {tag} f32 {n} rows T_max {t_max}: identity max_abs_err="
            f"{max(errs['identity']):.3e}, ancestry ({', '.join(BWD_ANC_MAPS)}) max_abs_err="
            f"{max(errs['ancestry']):.3e} at steps 0, {t_max // 2}, {t_max - 1} {'ok' if ok else 'FAIL'}")
        if timing and case < timed:
            last = t_max - 1
            for mode, anc in (("", None), ("ancestry ", maps[("random", last)])):
                rows_ = None if anc is None else (anc[:, :, : last + 1].long() + torch.arange(
                    b, device=dev)[:, None, None] * kb).reshape(n, last + 1)
                slots = torch.arange(last + 1, device=dev)

                def gathered(c):
                    if rows_ is None:
                        return c[:, :, : last + 1].contiguous().requires_grad_()
                    return c.transpose(1, 2)[rows_, slots].transpose(1, 2).contiguous().requires_grad_()

                kg = gathered(caches[0])
                vg = kg if kv else gathered(caches[1])
                q4, d4 = q[:, :, None].clone().requires_grad_(), dout[:, :, None]
                dcs = [c.clone() for c in dc0]
                cv, dcv = (None, None) if kv else (caches[1], dcs[1])
                wrt = (q4, kg) if kv else (q4, kg, vg)
                t_k, t_p, t_l = turns_ms(
                    lambda: k2.ancestry_self_attention_backward(q, caches[0], cv, dout, dcs[0], dcv, last, anc),
                    lambda: k2.ancestry_self_attention_backward_plain(q, caches[0], cv, dout, dcs[0], dcv, last, anc),
                    lambda: torch.autograd.grad(F.scaled_dot_product_attention(q4, kg, vg), wrt, d4))
                nbytes = k2_bwd_bytes(n, last, h, dk, kv) if anc is None else k2_bwd_anc_bytes(anc, last, h, dk, kv)
                bnd, by = bound_ms(nbytes, {})
                row = f"ancestry_self_attention_bwd {mode}{tag}"
                log(f"[kernel] {row} f32 {n} rows t={last}{' (random map)' if anc is not None else ''}: ms={t_k:.4f} "
                    f"plain_ms={t_p:.4f} library_ms={t_l:.4f} (SDPA fwd + bwd, gathered cache) bound_ms={bnd:.4f} "
                    f"({by}; held windows in turns)")
                results[row] = dict(max_abs_err=max(errs["identity" if anc is None else "ancestry"]), ms=t_k,
                                    plain_ms=t_p, library_ms=t_l, bound_ms=bnd, bound_by=by)
                del kg, vg, q4, dcs
        del q, dout, caches, dc0
    torch.cuda.empty_cache()

    # 25 steps in the kv mode at ACORT-small's width, the one cache threaded under autograd
    dk, t_max = DK_SMALL, ACORT_LEN - 1
    g25 = torch.Generator(device=dev).manual_seed(SEED + 40 * 25)
    for changing in (True, False):
        qs, ks, gs = ([rnd(n, h, dk, g=g25).requires_grad_(i < 2) for _ in range(t_max)] for i in range(3))
        cache = torch.zeros(n, h, t_max, dk, device=dev)
        anc = anc_map("identity", b, kb, t_max, 0)
        step_maps, outs = [], []
        entry = "ancestry_self_attention_bwd_anc_kv" if changing else "ancestry_self_attention_bwd_kv"
        before = KERNELS[entry].launches
        for t in range(t_max):
            anc = anc.clone()
            anc[:, :, t] = torch.arange(kb, device=dev, dtype=torch.int32)
            step_maps.append(anc if changing else None)
            outs.append(k2.decode_self_attention(qs[t], ks[t], None, cache, None, step_maps[-1], t))
            parents = torch.randint(0, kb, (b, kb), generator=g25, device=dev) if t else torch.zeros(
                b, kb, dtype=torch.long, device=dev)
            anc = anc.gather(1, parents[..., None].expand(-1, -1, t_max)).contiguous()
        got = torch.autograd.grad(outs, qs + ks, gs)
        launched = KERNELS[entry].launches - before
        ref_outs = [k2.ancestry_self_attention_plain(qs[t], torch.stack(ks[: t + 1], 2), None,
                                                     None if m is None else m[:, :, : t + 1].contiguous(), t)
                    for t, m in enumerate(step_maps)]
        want = torch.autograd.grad(ref_outs, qs + ks, gs)
        how = "through changing maps" if changing else "identity"
        for name, a, c in (("dq", torch.stack(got[:t_max]), torch.stack(want[:t_max])),
                           ("dk", torch.stack(got[t_max:]), torch.stack(want[t_max:]))):
            err = held(f"decode_self_attention kv dk32 {t_max} steps {how}, the cache threaded: {name}", a, c)
            log(f"[kernel] decode_self_attention kv dk32 {t_max} steps {how}, the one cache threaded: {name} "
                f"max_abs_err={err:.3e}")
        log(f"[kernel] decode_self_attention kv dk32 {t_max} steps {how}: {launched} {entry} launches "
            f"{'ok' if launched == t_max else 'FAIL'}")
        ok &= launched == t_max
        del qs, ks, gs, outs, got, ref_outs, want, cache
    return ok


def check_k3_bwd_width_kernels(gen, results: dict, timing: bool = True, timed: int = BWD_TIMED_CASES) -> bool:
    """K3's backward at the instances of BWD_WIDTH_CASES against its plain
    version at 64 images x 15 rows, 36 regions, padded regions and image 0
    with none valid, element by element within F32_TOL widened by each
    tensor's rms: dq, dK and dV (the kv mode: dq and the one memory's
    gradient dK + dV); masked regions' dK exactly 0 (unshared); image 0's dV
    (kv: its dmem) its rows' mean dout. Faults planted: each image's memory
    gradient from its first row alone; in the kv mode, the V term left out.
    The shared memory against the wrapper's formula. Timed (the first
    `timed` cases: by default the path instances): the kernel, the plain
    version and SDPA's forward + backward with the memory as K and V."""
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
    from sparse_caption_tpu_torch.ops.attention import NEG_INF

    dev, dt = torch.device("cuda"), torch.float32
    b, rep, h = SCST_BATCHES[-1], SCST_SAMPLES, HEADS
    ok = smem_agrees("grouped_cross_attention_bwd", "sct_grouped_cross_attention_bwd_smem", k3.bwd_smem,
                     [(dk, REGIONS, rep, kv) for dk in (64, 32, 13) for kv in (0, 1)] + [(13, 64, 60, 1)])

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for case, (tag, dk, kv, _) in enumerate(BWD_WIDTH_CASES):
        q, dout = rnd(b * rep, h, dk), rnd(b * rep, h, dk)
        mems = [rnd(b, h, REGIONS, dk) for _ in range(1 if kv else 2)]
        mv = None if kv else mems[1]
        mask = random_region_mask(gen, b, REGIONS, dev)
        mask[0] = False  # no valid region: the fill gives every region the same weight
        got = [x for x in k3.grouped_cross_attention_backward(q, mems[0], mv, mask, dout) if x is not None]
        ref = [x for x in k3.grouped_cross_attention_backward_plain(q, mems[0], mv, mask, dout) if x is not None]
        first = dout.reshape(b, rep, h, dk).clone()
        first[:, 1:] = 0  # each image's first row alone
        fault = k3.grouped_cross_attention_backward_plain(q, mems[0], mv, mask, first.reshape(b * rep, h, dk))
        name = f"grouped_cross_attention_bwd {tag}"
        errs, good = [], True
        for i, part in enumerate(("dq", "dmem") if kv else ("dq", "dK", "dV")):
            err, fine, worst = close(got[i], ref[i], dt, sum_scale=rms(ref[i]))
            errs.append(err)
            good &= fine
            if i:
                good &= fault_caught(f"{name} {part}, the first row alone", fault[i], ref[i], dt, 0.0, rms(ref[i]))
        if kv:  # the V term left out: the unshared plain version's dK on the one memory
            alone = k3.grouped_cross_attention_backward_plain(q, mems[0], mems[0], mask, dout)
            good &= fault_caught(f"{name} dmem, the V term left out", alone[1], ref[1], dt, 0.0, rms(ref[1]))
        dropped = ~mask[:, None, :, None].expand_as(got[1])
        zero_dk = kv or not got[1][dropped].any()
        mean_dv = dout[:rep].sum(0)[:, None, :].expand(h, REGIONS, dk) / REGIONS
        err0, good0, _ = close(got[-1][0], mean_dv, dt, sum_scale=rms(mean_dv))
        good &= zero_dk and good0
        log(f"[kernel] {name} f32 {b}x{rep}: max_abs_err={max(errs):.3e}; masked regions' dK exactly 0 "
            f"{'ok' if zero_dk else 'FAIL'}{' (unshared)' if not kv else ''}; image 0 (no valid region) "
            f"{'dmem' if kv else 'dV'} - its rows' mean dout max {err0:.3e} {'ok' if good else 'FAIL'}")
        ok &= good
        del got, ref, fault, first
        if timing and case < timed:
            qg = q.reshape(b, rep, h, dk).transpose(1, 2).contiguous().requires_grad_()
            kl = mems[0].clone().requires_grad_()
            vl = kl if kv else mems[1].clone().requires_grad_()
            fill = torch.zeros(b, 1, 1, REGIONS, device=dev).masked_fill(~mask[:, None, None, :], NEG_INF)
            dg = dout.reshape(b, rep, h, dk).transpose(1, 2).contiguous()
            wrt = (qg, kl) if kv else (qg, kl, vl)
            t_k, t_p, t_l = turns_ms(lambda: k3.grouped_cross_attention_backward(q, mems[0], mv, mask, dout),
                                     lambda: k3.grouped_cross_attention_backward_plain(q, mems[0], mv, mask, dout),
                                     lambda: torch.autograd.grad(F.scaled_dot_product_attention(qg, kl, vl, fill),
                                                                 wrt, dg))
            bnd, by = bound_ms(k3_bwd_bytes(b, rep, REGIONS, h, dk, kv), {})
            log(f"[kernel] {name} f32 {b}x{rep}: ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} (SDPA fwd + "
                f"bwd, float mask) bound_ms={bnd:.4f} ({by}; held windows in turns)")
            results[name] = dict(max_abs_err=max(errs), ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bnd,
                                 bound_by=by)
        del q, dout, mems, mv
    return ok & check_k3_bwd_shapes(torch.Generator(device=dev).manual_seed(SEED + 43))


def check_k3_bwd_shapes(gen) -> bool:
    """K3's backward at every head width, unshared and kv, at the off shapes
    K3_BWD_SHAPES (1 region and 1 row; 33 regions, where no dk 13 span is
    16-byte aligned; 64 regions and 16 rows, one round of the block's 16
    warps past the 15 of the paths; 64 x 60, four rounds), 4 images, 8
    heads, the last image with no valid region: against the plain version
    within F32_TOL widened by each tensor's rms; masked regions' dK exactly 0
    (unshared); the shared memory against the wrapper's formula."""
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3

    dev, dt, b, h = torch.device("cuda"), torch.float32, 4, HEADS
    ok = smem_agrees("grouped_cross_attention_bwd", "sct_grouped_cross_attention_bwd_smem", k3.bwd_smem,
                     [(dk, s, rep, kv) for dk in (64, 32, 13) for s, rep in K3_BWD_SHAPES for kv in (0, 1)])
    for dk in (64, 32, 13):
        for kv in (False, True):
            for regions, rep in K3_BWD_SHAPES:
                q, dout = (torch.randn(b * rep, h, dk, generator=gen, device=dev) for _ in range(2))
                mems = [torch.randn(b, h, regions, dk, generator=gen, device=dev) for _ in range(1 if kv else 2)]
                mv = None if kv else mems[1]
                mask = torch.rand(b, regions, generator=gen, device=dev) < 0.7
                mask[:, 0] = True
                mask[-1] = False
                got = [x for x in k3.grouped_cross_attention_backward(q, mems[0], mv, mask, dout) if x is not None]
                ref = [x for x in k3.grouped_cross_attention_backward_plain(q, mems[0], mv, mask, dout)
                       if x is not None]
                worst, good = 0.0, True
                for a, c in zip(got, ref):
                    _, fine, w = close(a, c, dt, sum_scale=rms(c))
                    worst, good = max(worst, w), good and fine
                zero_dk = kv or not got[1][~mask[:, None, :, None].expand_as(got[1])].any()
                if not (good and zero_dk):
                    log(f"[kernel] grouped_cross_attention_bwd{' kv' if kv else ''} dk{dk} S={regions} rep={rep}: "
                        f"worst err/allowed {worst:.3f}, masked dK exactly 0 {zero_dk} FAIL")
                ok &= good and zero_dk
                del q, dout, mems, mv, got, ref
    log(f"[kernel] grouped_cross_attention_bwd at dk 64 / 32 / 13, unshared and kv, (S, rep) {K3_BWD_SHAPES}: "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def slot_set_layers(gen):
    """ACORT-small's masked layers of one decode step (kv, the plan (0, 0, 0,
    1, 1, 1)) in call order, each shared layer once per slot, as
    ``Transformer._decode_step_masked`` lists them: a supermask model on the
    card (logits N(0, 1)), and the list."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    flags = {k: v for k, v in ACORT_SMALL_FLAGS.items() if k not in ("caption_model", "tokenizer", "radix_base")}
    flags.update(vocab_size=ACORT_BASE["vocab_size"], share_layer_encoder=(0, 0, 0, 1, 1, 1),
                 share_layer_decoder=(0, 0, 0, 1, 1, 1), dropout_rate=0.0, drop_prob_src=0.0)
    model = get_model("relation_transformer_prune")(**flags, mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True),
                                                    device="cuda", generator=gen)
    return supermask_logits(model, gen, "slot draws"), model._decode_step_masked()


def check_slot_draws(gen, results: dict, timing: bool = True) -> bool:
    """The keyed draws of a shared layer's slots (``ops/rng.py mask_draws``):
    ACORT-small's decode-step set (44 products, the shared layers once per
    slot) through ``mask_set`` under a step view, one K5 keyed launch each
    way; each call's product against the plain sample of its own draw
    (``slot_site(site, k)`` at the layer's k-th call) bit for bit, the
    slots' products differing; the shared weights' and logits' gradients
    (each the sum over its calls) against the plain version's autograd.
    Fault planted: every slot under slot 0's draw. Timed: the keyed set's
    forward and backward launches alone, against the plain version's
    autograd; beside them the set through autograd (which adds the sums of a
    shared layer's gradients over its calls)."""
    from sparse_caption_tpu_torch.kernels import KERNELS
    from sparse_caption_tpu_torch.kernels import supermask as k5
    from sparse_caption_tpu_torch.ops.masked import mask_set
    from sparse_caption_tpu_torch.ops.rng import KeyedStream

    model, calls = slot_set_layers(gen)
    stream = KeyedStream(0x5107_5EED_0000_0001).at(7)
    seen, plain_ws, fault_ws = {}, [], []
    for m in calls:
        k = seen.get(m, 0)
        seen[m] = k + 1
        u = stream.for_slot(k).mask_uniform(m, m.weight.shape, "cuda")
        plain_ws.append(k5.supermask_weight_plain(m.weight, m.mask, u, "sample"))
        fault_ws.append(k5.supermask_weight_plain(m.weight, m.mask, stream.mask_uniform(m, m.weight.shape, "cuda"),
                                                  "sample"))
    before = KERNELS["supermask_keyed"].launches
    with mask_set(calls, stream):
        got = [m.effective_weight(stream) for m in calls]
    launched = KERNELS["supermask_keyed"].launches - before
    exact = all(torch.equal(a, p) for a, p in zip(got, plain_ws))
    shared = [i for i, m in enumerate(calls) if seen[m] > 1]
    first = {}
    differ = True
    for i in shared:
        m = calls[i]
        if m in first:
            differ &= not torch.equal(got[i], got[first[m]])
        else:
            first[m] = i
    caught = any(not torch.equal(a, f) for a, f in zip(got, fault_ws))
    gs = [torch.randn(w.shape, generator=gen, device="cuda") for w in got]
    params = [p for m in seen for p in (m.weight, m.mask)]
    g_got = torch.autograd.grad(got, params, gs)
    g_ref = torch.autograd.grad(plain_ws, params, gs)
    err = max((a - r).abs().max().item() for a, r in zip(g_got, g_ref))
    grads_ok = all(close(a, r, torch.float32)[1] for a, r in zip(g_got, g_ref))
    ok = exact and differ and caught and grads_ok and launched == 1
    log(f"[kernel] supermask keyed slots: ACORT-small's decode-step set, {len(calls)} products of {len(seen)} layers "
        f"({len(shared)} calls of shared layers), {launched} K5 keyed launch; each call's product against the plain "
        f"sample of its slot's draw {'exact' if exact else 'DIFFERS'}; a shared layer's slots differ "
        f"{'ok' if differ else 'FAIL'}; gradients summed over the calls max_abs_err={err:.3e} "
        f"{'ok' if grads_ok else 'FAIL'}")
    log(f"[fault] supermask keyed slots, every slot under slot 0's draw: {'caught' if caught else 'MISSED'}")
    if timing:
        draws = []
        seen = {}
        for m in calls:
            k = seen.get(m, 0)
            seen[m] = k + 1
            draws.append(stream.for_slot(k).mask_draw(m, m.weight.shape, "cuda"))
        ws, ms = [m.weight for m in calls], [m.mask for m in calls]

        bit_units = k5.unit_offsets([w.numel() for w in ws])[:-1]

        def launches():  # K5's keyed forward and backward launches alone, a gradient per call
            _, bits = k5.launch_forward(ws, ms, draws, k5.MODES["keyed"])
            k5.launch_backward(gs, ws, ms, bits, bit_units, k5.MODES["keyed"], False)

        def keyed():  # through autograd, which also sums a shared layer's gradients over its calls
            torch.autograd.grad(k5.supermask_weights(ws, ms, draws, "keyed"), params, gs)

        def plain():
            torch.autograd.grad([k5.supermask_weight_plain(w, m, d, "keyed") for w, m, d in zip(ws, ms, draws)],
                                params, gs)

        t_k, t_auto, t_p = turns_ms(launches, keyed, plain)
        n_set = sum(w.numel() for w in ws)
        bnd, by = bound_ms(k5_bytes(n_set, torch.float32, mode="keyed"), {})
        log(f"[kernel] supermask keyed slots f32 ({n_set} weights, fwd + bwd launches): ms={t_k:.4f} "
            f"plain_ms={t_p:.4f} library_ms=null bound_ms={bnd:.4f} ({by}; held windows in turns); through "
            f"autograd {t_auto:.4f} ms, {t_auto - t_k:.4f} ms more")
        # where the set's time through autograd goes: its device kernels (K5's and the rest: autograd's sums of a
        # shared layer's gradients, the Function's glue) against the wall time of the same profiled call
        dev_ms, wall_ms, by_kernel = profile_window("supermask keyed slots through autograd, f32", keyed)
        k5_ms = sum(ms for name, ms in by_kernel.items() if "supermask" in name)
        log(f"[kernel] supermask keyed slots through autograd, one profiled call: device kernels {dev_ms:.4f} ms "
            f"(K5 {k5_ms:.4f}, the rest {dev_ms - k5_ms:.4f} in {sum(1 for n in by_kernel if 'supermask' not in n)} "
            f"kernel kinds) in {wall_ms:.4f} ms wall; the host's share {1 - dev_ms / wall_ms:.1%}")
        results["supermask keyed slots"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=bnd,
                                                bound_by=by, autograd_ms=t_auto, autograd_device_ms=dev_ms,
                                                autograd_k5_ms=k5_ms, autograd_wall_ms=wall_ms)
    del model, calls, got, plain_ws, fault_ws
    return ok


def check_shared_width_kernels(gen, results: dict, timing: bool = True) -> bool:
    """This slice's kernel instances: K2's and K3's backward at dk 32 / 13
    and in the kv mode, and the keyed draws of a shared layer's slots."""
    ok = check_k2_bwd_width_kernels(gen, results, timing)
    torch.cuda.empty_cache()
    ok &= check_k3_bwd_width_kernels(gen, results, timing)
    torch.cuda.empty_cache()
    ok &= check_slot_draws(gen, results, timing)
    torch.cuda.empty_cache()
    return ok


def to_kv(counts: dict) -> dict:
    """Launch counts of a kv-shared model: the attention kernels' launches
    moved to their kv entry points."""
    for name in ("box_attention_train", "box_attention_bwd", "ancestry_self_attention", "ancestry_self_attention_bwd",
                 "ancestry_self_attention_bwd_anc", "grouped_cross_attention", "grouped_cross_attention_bwd",
                 "decoder_attention", "decoder_attention_bwd"):
        counts[f"{name}_kv"], counts[name] = counts[name], 0
    return counts


def dense_beam_scst_launches(layers: int, steps: int, names) -> dict:
    """Launches of one beam-sample SCST step of a dense ORT (no K5):
    ``ort_beam_scst_launches`` without the masked products."""
    counts = ort_beam_scst_launches(layers, steps, 0, names)
    counts.update(supermask=0, supermask_bwd=0)
    return counts


def build_acort_prune(config, seed: int, label: str, scst: bool = True, dropout: bool = True):
    """ACORT (`config`: base or small, 2 unique layers a side) as
    relation_transformer_prune under a training supermask (masks kept) in f32
    on the card through ``from_config``, random weights from the seed; the
    mask logits N(0, SUPERMASK_LOGIT_STD) with `scst` (the supermask SCST
    phases'), else at MASK_INIT (the XE cells')."""
    from sparse_caption_tpu_torch.config import Config
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    extra = {} if dropout else dict(dropout_rate=0.0)
    if not dropout:
        config = Config(**dict(config.to_dict(), drop_prob_src=0.0))
    model = get_model("relation_transformer_prune").from_config(
        config, MaskConfig("supermask", MASK_INIT, keep_masks=True), device="cuda", generator=gen, **extra)
    assert len(model.box_encoder_layers) == len(model.decoder_layers) == 2
    return supermask_logits(model, gen, label) if scst else model


def build_xsmall_supermask(seed: int):
    """ORT-xsmall (ORT_XSMALL_FLAGS) as relation_transformer_prune under a
    training supermask in f32 on the card through ``from_config``, random
    weights and mask logits N(0, 1) from the seed, dropout on."""
    from sparse_caption_tpu_torch.config import Config
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model("relation_transformer_prune").from_config(
        Config(**ORT_XSMALL_FLAGS), MaskConfig("supermask", MASK_INIT, keep_masks=True), device="cuda", generator=gen)
    return supermask_logits(model, gen, "ort-xsmall supermask scst")


def timed_scst(model, gen, batches, expected, label: str, steps: int, **kw) -> tuple:
    """``run_scst_phase`` at each of `batches`, then a profile of one step at
    the last (its busy share). Returns the launches of a step."""
    for b in batches:
        counts, step, state, batch = run_scst_phase(model, gen, b, expected, label=label, steps=steps, **kw)
    held = [state]
    samples = kw.get("samples", SCST_SAMPLES)
    profile_window(f"{label} step, f32 batch {batches[-1]}x{samples}", lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held, state
    return counts


def run_shared_width_scst_phase(gen, t0: float) -> tuple:
    """Supermask and beam-sample SCST at ACORT's and ORT-xsmall's widths, f32,
    dropout on, each timed path 1 warm-up + its steps with the launch
    counts asserted, steps/s, peak memory and a profile (busy share):
    - ``acort_small_beam_scst_step``: ACORT-small's SCST stage (dense, kv,
      shared layers, dk 32, the radix reward) with beam search of width 15
      at 5 x 15 and 64 x 15 (K2's backward through the map in the kv mode,
      K3's kv backward), the forced search's beams and log-probs against
      the sampling search's, one step at 2 x 3 card against CPU;
    - ``acort_small_supermask_scst_step``: the same model as
      relation_transformer_prune under a training supermask (logits N(0,
      1)), random samples, at 5 x 15 and 64 x 15 (every slot of a shared
      layer its own keyed draw, K2's and K3's kv backward), the replay, one
      step at 2 x 3 card against CPU (the CPU taking the card's samples);
    - ``ort_xsmall_supermask_scst_step`` and ``ort_xsmall_beam_scst_step``:
      ORT-xsmall (dk 13) under a training supermask with random samples, and
      dense with beam search, each at 64 x 15 and card against CPU at 2 x 3;
    - ``acort_base_supermask_train_step``: ACORT-base under a training
      supermask (logits 5.0), the XE step in bf16 at 15 x 5 and 256 x 5, a
      profile at 256 x 5, the f32 step at 2 x 5 card against CPU;
    - ``acort_base_supermask_scst_step``: its supermask SCST step at 2 x 3
      card against CPU, the card's launches counted (the kv dk 64
      instances).
    `t0`: the build's start, for the ``[time]`` lines. Returns (ok, {path:
    launch counts})."""
    from sparse_caption_tpu_torch.config import Config
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.kernels import KERNELS, launch_counts, reset_launch_counts

    good, paths = True, {}
    with tempfile.TemporaryDirectory() as log_dir:
        tok, config = acort_tokenizer(log_dir, ACORT_SMALL_FLAGS)
        _, base_config = acort_tokenizer(log_dir, ACORT_FLAGS)
    scst_config = Config(**dict(config.to_dict(), drop_prob_src=ACORT_SMALL_SCST_DROP_SRC))
    steps = ACORT_LEN - 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began (ACORT-small beam-sample SCST)")
    build_beam = lambda seed: favour_word_digits(build_acort(scst_config, seed))  # noqa: E731
    model = build_beam(SEED + 41)
    paths["acort_small_beam_scst_step"] = timed_scst(
        model, gen, SCST_BATCHES, to_kv(dense_beam_scst_launches(ACORT_SLOTS, steps, KERNELS)),
        "acort-small beam scst", BEAM_SCST_STEPS, tok=tok, config=ACORT_SMALL_BEAM_CONFIG)
    good &= beam_replay_check(model, gen, label="acort-small beam replay", max_len=steps)
    del model
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 41, gen, build_beam, make_batch, "acort-small beam scst-step", tok=tok,
                                  config=ACORT_SMALL_BEAM_CONFIG, max_len=steps)
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began (ACORT-small supermask SCST)")
    build_sm = lambda seed: favour_word_digits(  # noqa: E731
        build_acort_prune(scst_config, seed, "acort-small supermask scst"))
    model = build_sm(SEED + 41)
    paths["acort_small_supermask_scst_step"] = timed_scst(
        model, gen, SCST_BATCHES, to_kv(supermask_scst_launches(ACORT_SLOTS, steps, KERNELS)),
        "acort-small supermask scst", SUPERMASK_SCST_STEPS, tok=tok, config=ACORT_SMALL_SCST_CONFIG)
    good &= replay_check(model, gen, label="acort-small supermask replay", max_len=steps)
    del model
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 41, gen, build_sm, make_batch, "acort-small supermask scst-step", tok=tok,
                                  config=ACORT_SMALL_SCST_CONFIG, max_len=steps)
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began (ORT-xsmall supermask and beam-sample SCST)")
    model = build_xsmall_supermask(SEED + 41)
    paths["ort_xsmall_supermask_scst_step"] = timed_scst(
        model, gen, SCST_BATCHES[-1:], supermask_scst_launches(PAPER["num_layers"], MAX_LEN, KERNELS),
        "ort-xsmall supermask scst", SUPERMASK_SCST_STEPS)
    del model
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 41, gen, build_xsmall_supermask, label="ort-xsmall supermask scst-step")
    build_xs = lambda seed: build_ort(ORT_XSMALL_FLAGS, seed)  # noqa: E731
    model = build_xs(SEED + 41)
    paths["ort_xsmall_beam_scst_step"] = timed_scst(
        model, gen, SCST_BATCHES[-1:], dense_beam_scst_launches(PAPER["num_layers"], MAX_LEN, KERNELS),
        "ort-xsmall beam scst", BEAM_SCST_STEPS, config=BEAM_SCST_CONFIG)
    del model
    torch.cuda.empty_cache()
    good &= scst_whole_step_check(SEED + 41, gen, build_xs, label="ort-xsmall beam scst-step",
                                  config=BEAM_SCST_CONFIG)
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began (ACORT-base supermask XE and SCST)")
    slots = ACORT_SLOTS
    train = {name: 0 for name in KERNELS}
    train.update(box_attention_train_kv=slots, box_attention_bwd_kv=slots, supermask=1, supermask_bwd=1,
                 add_ref_layernorm=(1 + 2 * slots) + (1 + 3 * slots),
                 add_ref_layernorm_bwd=(1 + 2 * slots) + (1 + 3 * slots), vocab_log_softmax=1,
                 vocab_log_softmax_bwd=1, decoder_attention_kv=2 * slots, decoder_attention_bwd_kv=2 * slots)
    xe_model = build_acort_prune(base_config, SEED + 41, "acort-base supermask train", scst=False)
    for b in (TRAIN_BATCH, TRAIN_BIG_BATCH):
        paths["acort_base_supermask_train_step"] = run_train_phase(
            xe_model, gen, b, "bf16", train, ACORT_CONFIG, make_acort_train_batch, "acort-base supermask train")
    step, state = make_train_step(xe_model, "bf16", ACORT_CONFIG), [TrainState()]
    batch = make_acort_train_batch(gen, TRAIN_BIG_BATCH)
    profile_window(f"ACORT-base supermask XE step, bf16 batch {TRAIN_BIG_BATCH}x{SEQ_PER_IMG}",
                   lambda: state.append(step(state.pop(), batch)[0]))
    del xe_model, step, state, batch
    torch.cuda.empty_cache()
    good &= whole_step_check(SEED, gen, lambda: build_acort_prune(base_config, SEED + 41, "", scst=False,
                                                                  dropout=False),
                             make_acort_train_batch, ACORT_CONFIG, "acort-base supermask whole-step")
    torch.cuda.empty_cache()
    expected = to_kv(supermask_scst_launches(slots, steps, KERNELS))
    expected["cider_reward"] = 2  # the check scores the card's samples once more, beside the step's own reward
    reset_launch_counts()
    good &= scst_whole_step_check(SEED + 41, gen, lambda seed: favour_word_digits(
        build_acort_prune(base_config, seed, "acort-base supermask scst")), make_batch,
        "acort-base supermask scst-step", tok=tok, config=ACORT_BASE_SCST_CONFIG, max_len=steps)
    counts = launch_counts()
    assert counts == expected, f"acort-base supermask scst-step launch counts {counts} != {expected}"
    log(f"[acort-base supermask scst-step] the card's launches (one sampling pass, one gradient pass, two rewards): "
        f"{counts}")
    paths["acort_base_supermask_scst_step"] = counts
    torch.cuda.empty_cache()
    return good, paths


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from sparse_caption_tpu_torch.engine.training import TrainState
    from sparse_caption_tpu_torch.kernels import KERNELS, _build, build_all

    card = card_line()
    log(f"[setup] card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    per_lib = build_all(verbose=True)
    log(f"[setup] kernels built in {time.perf_counter() - t0:.1f}s; each library's own compile seconds: "
        f"{ {name: round(sec, 1) for name, sec in per_lib.items()} }")
    if per_lib:
        slowest = max(per_lib, key=per_lib.get)
        log(f"[setup] the slowest library: {slowest}, {per_lib[slowest]:.1f}s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results: dict = {}
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        ok &= check_kernels(gen, dtype, results)
        ok &= check_train_kernels(gen, dtype, results)
        ok &= check_updown_kernels(gen, dtype, results)
        torch.cuda.empty_cache()
    # their own generators: the later phases keep the inputs that earlier slices drew for them
    ok &= check_norm_softmax_kernels(torch.Generator(device="cuda").manual_seed(SEED + 6), results)
    torch.cuda.empty_cache()
    ok &= check_decoder_attention_kernels(torch.Generator(device="cuda").manual_seed(SEED + 14), results)
    torch.cuda.empty_cache()
    ok &= check_scst_kernels(gen, results)
    torch.cuda.empty_cache()
    ok &= check_decode_backward_kernels(torch.Generator(device="cuda").manual_seed(SEED + 15), results)
    torch.cuda.empty_cache()
    ok &= check_magnitude_kernels(torch.Generator(device="cuda").manual_seed(SEED + 16), results)
    torch.cuda.empty_cache()
    g12 = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for dtype in (torch.float32, torch.bfloat16):
        ok &= check_acort_kernels(g12, dtype, results)
        torch.cuda.empty_cache()
    g32 = torch.Generator(device="cuda").manual_seed(SEED + 32)
    for dtype in (torch.float32, torch.bfloat16):
        ok &= check_acort_small_kernels(g32, dtype, results)
        torch.cuda.empty_cache()
    g13 = torch.Generator(device="cuda").manual_seed(SEED + 34)
    for dtype in (torch.float32, torch.bfloat16):
        ok &= check_xsmall_kernels(g13, dtype, results)
        torch.cuda.empty_cache()
    ok &= check_radix_reward(results)
    ok &= check_decode_variant_kernels(torch.Generator(device="cuda").manual_seed(SEED + 36), results)
    torch.cuda.empty_cache()
    ok &= check_ss_beam_kernels(torch.Generator(device="cuda").manual_seed(SEED + 38), results)
    torch.cuda.empty_cache()
    ok &= check_shared_width_kernels(torch.Generator(device="cuda").manual_seed(SEED + 40), results)
    if not ok:
        log("[kernel] a kernel disagrees with its plain version")
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # serving: encode + beam-5 generate
    model = build_model(SEED)
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    layers = PAPER["num_layers"]
    serve = {name: 0 for name in KERNELS}
    serve.update(box_attention=layers, ancestry_self_attention=layers * MAX_LEN,
                 grouped_cross_attention=layers * MAX_LEN, beam_topk=MAX_LEN,
                 add_ref_layernorm=(1 + 2 * layers) + MAX_LEN * (1 + 3 * layers))
    run_main_path(model_bf16, gen, EVAL_BATCH, serve)
    serve_counts = run_main_path(model_bf16, gen, BIG_BATCH, serve)
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batch = make_batch(gen, BIG_BATCH, torch.bfloat16)
    profile_window(f"encode + decode, bf16 batch {BIG_BATCH}", lambda: caption(model_bf16, batch))
    del model_bf16
    if not whole_path_check(model, gen):
        return 1
    del model
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # training: the supermask XE step
    n_masked = len(masked_shapes())
    train = {name: 0 for name in KERNELS}
    train.update(box_attention_train=layers, box_attention_bwd=layers, supermask=1, supermask_bwd=1,
                 add_ref_layernorm=(1 + 2 * layers) + (1 + 3 * layers),
                 add_ref_layernorm_bwd=(1 + 2 * layers) + (1 + 3 * layers), vocab_log_softmax=1,
                 vocab_log_softmax_bwd=1, decoder_attention=2 * layers, decoder_attention_bwd=2 * layers)
    train_model = build_train_model(SEED)
    for b, precision in ((TRAIN_BATCH, "fp32"), (TRAIN_BATCH, "bf16"), (TRAIN_BIG_BATCH, "bf16")):
        train_counts = run_train_phase(train_model, gen, b, precision, train)
    step, state = make_train_step(train_model, "bf16"), [TrainState()]
    batch = make_train_batch(gen, TRAIN_BIG_BATCH)
    profile_window(f"XE step, bf16 batch {TRAIN_BIG_BATCH}x{SEQ_PER_IMG}",
                   lambda: state.append(step(state.pop(), batch)[0]))
    del train_model
    torch.cuda.empty_cache()
    if not whole_step_check(SEED, gen):
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # pruning: gradual magnitude (K16 in the hook), then one-shot, SNIP and the lottery rewind
    good, prune_counts = run_prune_phase(torch.Generator(device="cuda").manual_seed(SEED + 17), results, train)
    torch.cuda.empty_cache()
    if not good:
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # SCST: the paper's sparse self-critical step
    scst_model = build_scst_model(SEED)
    scst = scst_launches(layers, MAX_LEN, n_masked, KERNELS)
    for b in SCST_BATCHES:
        scst_counts, step, state, batch = run_scst_phase(scst_model, gen, b, scst)
    held = [state]
    profile_window(f"SCST step, f32 batch {SCST_BATCHES[-1]}x{SCST_SAMPLES}",
                   lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held
    if not replay_check(scst_model, gen):
        return 1
    del scst_model
    torch.cuda.empty_cache()
    if not scst_whole_step_check(SEED, gen):
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # Up-Down: beam-5 serving (K11, K12, K4) and the supermask XE step
    updown = build_updown(SEED)
    updown_bf16 = copy.deepcopy(updown).to(torch.bfloat16)
    ud_serve = {name: 0 for name in KERNELS}
    ud_serve.update(lstm_cell=2 * MAX_LEN, additive_attention=MAX_LEN, beam_topk=MAX_LEN)
    torch.cuda.reset_peak_memory_stats()
    for b in UPDOWN_BATCHES:
        ud_serve_counts = run_main_path(updown_bf16, gen, b, ud_serve, make_updown_batch, "updown")
    log(f"[updown] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batch = make_updown_batch(gen, UPDOWN_BATCHES[-1], torch.bfloat16)
    profile_window(f"Up-Down encode + decode, bf16 batch {UPDOWN_BATCHES[-1]}", lambda: caption(updown_bf16, batch))
    path_topk_times(updown_bf16, batch, results, "updown")
    del updown_bf16, batch
    if not whole_path_check(updown, gen, make_updown_batch, "updown whole-path") or not greedy_check(updown, gen):
        return 1
    del updown
    torch.cuda.empty_cache()
    ud_sets = 1 + MAX_LEN  # fresh samples: the encode's set of 3 tensors, then a set of 8 per step
    ud_train = {name: 0 for name in KERNELS}
    ud_train.update(supermask=ud_sets, supermask_bwd=ud_sets, lstm_cell=2 * MAX_LEN, lstm_cell_bwd=2 * MAX_LEN,
                    additive_attention=MAX_LEN, additive_attention_bwd=MAX_LEN, vocab_log_softmax=1,
                    vocab_log_softmax_bwd=1)
    ud_model = build_updown(SEED, train=True)
    for b, precision in ((TRAIN_BATCH, "fp32"), (TRAIN_BATCH, "bf16"), (TRAIN_BIG_BATCH, "bf16")):
        ud_train_counts = run_train_phase(ud_model, gen, b, precision, ud_train, UPDOWN_CONFIG,
                                          make_updown_train_batch, "updown train")
    step, state = make_train_step(ud_model, "bf16", UPDOWN_CONFIG), [TrainState()]
    batch = make_updown_train_batch(gen, TRAIN_BIG_BATCH)
    profile_window(f"Up-Down XE step, bf16 batch {TRAIN_BIG_BATCH}x{SEQ_PER_IMG}",
                   lambda: state.append(step(state.pop(), batch)[0]))
    del ud_model, step, state, batch
    torch.cuda.empty_cache()
    if not whole_step_check(SEED, gen, lambda: build_updown(SEED, train=True, dropout=False),
                            make_updown_train_batch, UPDOWN_CONFIG, "updown whole-step"):
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # Up-Down sparse SCST: the paper's recipe through the sampling decode and the unrolled replay
    ud_scst_model = build_updown_scst(SEED)
    ud_scst = updown_scst_launches(MAX_LEN, KERNELS)
    for b in UPDOWN_SCST_BATCHES:
        ud_scst_counts, step, state, batch = run_scst_phase(ud_scst_model, gen, b, ud_scst, UPDOWN_SCST_SAMPLES,
                                                            updown_scst_batch, "updown scst")
    held = [state]
    profile_window(f"Up-Down SCST step, f32 batch {UPDOWN_SCST_BATCHES[-1]}x{UPDOWN_SCST_SAMPLES}",
                   lambda: held.append(step(held.pop(), batch)[0]))
    del step, batch, held
    if not replay_check(ud_scst_model, gen, make_updown_batch, UPDOWN_SCST_SAMPLES, "updown replay"):
        return 1
    del ud_scst_model
    torch.cuda.empty_cache()
    if not scst_whole_step_check(SEED, gen, build_updown_scst, make_updown_batch, "updown scst-step"):
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # ACORT-base: serving and the dense XE step through the kv modes, and the qk ORT
    good, acort_serve_counts, acort_train_counts = run_acort_phase(torch.Generator(device="cuda").manual_seed(SEED + 13))
    if not good:
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # ACORT-small: serving, XE and the SCST stage through the dk 32 kernels and K10's radix mode
    good, small_serve, small_train, small_scst = run_acort_small_phase(
        torch.Generator(device="cuda").manual_seed(SEED + 33))
    if not good:
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # ORT-xsmall: serving and the dense XE step through the dk 13 kernels; ORT-small's and ACORT-base-AL's checks
    good, xsmall_serve, xsmall_train = run_ort_xsmall_phase(torch.Generator(device="cuda").manual_seed(SEED + 35))
    if not good:
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # supermask SCST: fresh keyed masks at every decode step, the ORT's gradient pass through K2's and K3's backward
    good, sm_scst, ud_sm_scst = run_supermask_scst_phase(torch.Generator(device="cuda").manual_seed(SEED + 15))
    if not good:
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # the decode variants (sampling methods, diverse beam) and the raw 4-wide geometry at the paper ORT's width
    good, variant_paths = run_decode_variants_phase(torch.Generator(device="cuda").manual_seed(SEED + 37))
    if not good:
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    # Up-Down's scheduled sampling (K9's ss mode) and beam-sample SCST (K2's backward through the map)
    good, ss_beam_paths = run_ss_beam_phase(torch.Generator(device="cuda").manual_seed(SEED + 39), t0)
    if not good:
        return 1

    # supermask and beam-sample SCST at ACORT's and ORT-xsmall's widths (K2's and K3's backward at dk 32 / 13 and
    # in the kv mode, a fresh keyed draw for each slot of a shared layer), ACORT-base's supermask XE
    good, shared_width_paths = run_shared_width_scst_phase(torch.Generator(device="cuda").manual_seed(SEED + 41), t0)
    if not good:
        return 1

    log(f"[time] {time.perf_counter() - t0:.1f}s since the build began")
    paths = {"serve": serve_counts, "train_step": train_counts, "scst_step": scst_counts,
             "updown_serve": ud_serve_counts, "updown_train_step": ud_train_counts,
             "updown_scst_step": ud_scst_counts, "prune_update": prune_counts, "acort_serve": acort_serve_counts,
             "acort_train_step": acort_train_counts}
    paths.update(zip(ACORT_SMALL_PATHS, (small_serve, small_train, small_scst)))
    paths.update(zip(XSMALL_PATHS, (xsmall_serve, xsmall_train)))
    paths.update(zip(SUPERMASK_PATHS, (sm_scst, ud_sm_scst)))
    paths.update(variant_paths)
    paths.update(ss_beam_paths)
    paths.update(shared_width_paths)
    kernels = []
    for name in _build.SOURCES:
        entries = [e for e, k in KERNELS.items() if k.library_name == name]
        by_path = {path: sum(counts[e] for e in entries) for path, counts in paths.items()}
        src = _build.CSRC / f"{name}.cu"
        kernels.append(dict(name=name, route="cuda", source=str(src.relative_to(_build.CSRC.parents[2])),
                            replaces=REPLACES[name], launches=sum(by_path.values()), launches_by_path=by_path,
                            **results[name]))
    # the kv modes and the radix vocabulary's width: their own entries, launches on ACORT's paths
    for mode, library, entries, replaces in ACORT_MODES:
        by_path = {path: sum(paths[path][e] for e in entries) for path in ("acort_serve", "acort_train_step")}
        src = _build.CSRC / f"{library}.cu"
        kernels.append(dict(name=mode, route="cuda", source=str(src.relative_to(_build.CSRC.parents[2])),
                            replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
                            **results[mode]))
    # ACORT-small's instances (head width 32), K10's radix mode and ORT-xsmall's instances (head width 13):
    # their own entries, launches on their model's paths
    for modes, model_paths in ((ACORT_SMALL_MODES, ACORT_SMALL_PATHS), (XSMALL_MODES, XSMALL_PATHS),
                               (SUPERMASK_MODES, SUPERMASK_PATHS), (VARIANT_MODES, VARIANT_PATHS),
                               (SS_BEAM_MODES, SS_BEAM_PATHS)):
        for mode, library, entries, replaces in modes:
            by_path = {path: sum(paths[path][e] for e in entries) for path in model_paths}
            src = _build.CSRC / f"{library}.cu"
            kernels.append(dict(name=mode, route="cuda", source=str(src.relative_to(_build.CSRC.parents[2])),
                                replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
                                **results[mode]))
    # this slice's instances: their own entries, launches on the paths of their width
    for mode, library, entries, replaces, model_paths in SHARED_WIDTH_MODES:
        by_path = {path: sum(paths[path][e] for e in entries) for path in model_paths}
        src = _build.CSRC / f"{library}.cu"
        kernels.append(dict(name=mode, route="cuda", source=str(src.relative_to(_build.CSRC.parents[2])),
                            replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
                            **results[mode]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def whole_step_seeds(n: int) -> int:
    """The card-vs-CPU XE step alone, on the batches of generator seeds 0..n-1."""
    from sparse_caption_tpu_torch.kernels import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    ok = True
    for seed in range(n):
        log(f"[whole-step] data seed {seed}")
        ok &= whole_step_check(SEED, torch.Generator(device="cuda").manual_seed(seed))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--whole-step-seeds" and torch.cuda.is_available():
        sys.exit(whole_step_seeds(int(sys.argv[2])))
    sys.exit(main())
