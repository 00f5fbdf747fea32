"""Helpers of ``chip_smoke.py`` on the CPU: the card-vs-CPU caption check
(``tie_aware_match``: a caption that differs from the CPU's is accepted only
where the two tie to rounding under the CPU's own teacher-forced scores) and
the byte counts that the kernels' bounds are computed from."""

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_common import KW
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.models import get_model

EOS = 3
# per-token log-probs of a toy scorer: tokens 5 and 6 tie, 7 does not
TABLE = torch.tensor([0.0, -4.0, -4.0, -0.5, -4.0, -1.0, -1.0, -2.0, -1.5, -0.25])


def _toy(seq):
    return TABLE[seq]


@pytest.mark.parametrize("swap,accepted", [(6, True), (7, False)])
def test_tie_aware_match_accepts_only_a_tie_swap(swap, accepted):
    seq_cpu = torch.tensor([[[5, 8, EOS, 0], [9, 8, 5, EOS]]])  # (B, K, T)
    seq_card = seq_cpu.clone()
    seq_card[0, 0, 0] = swap  # token 5 of beam 0 replaced: a tie (6) or not (7)
    ok, n_ties, _ = chip_smoke.tie_aware_match(seq_card, _toy(seq_card) * (seq_card != 0), seq_cpu,
                                               _toy(seq_cpu) * (seq_cpu != 0), _toy, EOS)
    assert ok is accepted
    assert n_ties == int(accepted)


def test_tie_aware_match_on_a_model_rejects_a_beam_swap():
    """A small ORT's beam-5 captions: identical ones pass with no tie taken; the
    card's beams 0 and 1 of an image swapped (scores apart) fail."""
    torch.manual_seed(0)
    model = get_model("relation_transformer")(**KW, device="cpu").eval()
    g = torch.Generator().manual_seed(1)
    att = torch.randn(2, 5, KW["att_feat_size"], generator=g)
    xy = torch.rand(2, 5, 2, generator=g) * 400
    boxes = torch.cat([xy, xy + 10 + torch.rand(2, 5, 2, generator=g) * 190], -1)
    memory = model.encode(att, torch.ones(2, 5), boxes)
    seq, lp = generate(model, memory, {"beam_size": 5, "max_seq_length": KW["max_seq_length"]})

    def rescore(s):
        return chip_smoke.teacher_forced_logprobs(model, memory, s)

    # the rescoring is the beam's own scoring
    torch.testing.assert_close(rescore(seq) * (lp != 0), lp, rtol=0, atol=1e-5)
    assert chip_smoke.tie_aware_match(seq, lp, seq, lp, rescore, model.eos_id) == (True, 0, 0.0)
    swapped, lp_swapped = seq.clone(), lp.clone()
    swapped[0, [0, 1]], lp_swapped[0, [0, 1]] = seq[0, [1, 0]], lp[0, [1, 0]]
    assert (lp[0, 0].sum() - lp[0, 1].sum()).abs() > 1e-3
    ok, n_ties, _ = chip_smoke.tie_aware_match(swapped, lp_swapped, seq, lp, rescore, model.eos_id)
    assert not ok and n_ties == 0


# ----------------------------------------------------- K6 / K13 byte counts
ROWS, D, VOCAB = 21760, 512, 10000  # the ORT XE step: 256 x 5 captions x 17 steps


@pytest.mark.parametrize("dtype,keep,per_element", [
    # forward x, y, keep in, s, n out; backward gn, gs, s, keep in, dx, dy out
    (torch.bfloat16, True, (2 + 2 + 1 + 2 + 2) + (2 + 2 + 2 + 1 + 2 + 2)),
    (torch.float32, True, (4 + 4 + 1 + 4 + 4) + (4 + 4 + 4 + 1 + 4 + 4)),
    (torch.bfloat16, False, (2 + 2 + 2 + 2) + (2 + 2 + 2 + 2 + 2)),
])
def test_k6_bytes_count_each_tensor_once(dtype, keep, per_element):
    es = 2 if dtype == torch.bfloat16 else 4
    # per row: the stats (mean, std in f32) written forward, read backward;
    # per column: a, b read forward, a read and da, db written backward
    want = ROWS * D * per_element + ROWS * 8 * 2 + D * es * 5
    assert chip_smoke.k6_bytes(ROWS, D, dtype, keep=keep) == want
    assert per_element == {(2, True): 20, (4, True): 38, (2, False): 18}[(es, keep)]


def test_k6_bytes_serving_forward():
    rows = 2048 * 5  # the serving decode step: beam 5 over 2048 images
    # no keep-mask, forward only: x, y in, s, n out
    assert chip_smoke.k6_bytes(rows, D, torch.bfloat16, keep=False, backward=False) == \
        rows * D * 8 + rows * 8 + 2 * D * 2


@pytest.mark.parametrize("tin,tout,per_element", [
    # forward x in, y out; backward dy, x in, dx out
    (torch.float32, torch.float32, 4 + 4 + 4 + 4 + 4),
    (torch.bfloat16, torch.bfloat16, 2 + 2 + 2 + 2 + 2),
    (torch.bfloat16, torch.float32, 2 + 4 + 4 + 2 + 2),  # the ORT generator's train site: 14
])
def test_k13_bytes_count_each_tensor_once(tin, tout, per_element):
    # per row: the stats (max, log-sum in f32) written forward, read backward
    assert chip_smoke.k13_bytes(ROWS, VOCAB, tin, tout) == ROWS * VOCAB * per_element + ROWS * 16


# ------------------------------------------------ K15 / K3 bytes and operations
N_XE, IMAGES = 256 * 5, 256  # the ORT XE step's caption rows and images


@pytest.mark.parametrize("kind,keep,want", [
    # per (row, head): q, dO read and dq written, 17 x 64 bf16 each; per (K/V
    # row, head): k, v read and dk, dv written, Tk x 64 each; the keep-mask one
    # byte per (row, head, position, key); key validity one byte per (K/V row, key)
    ("self", True, 1280 * 8 * (3 * 17 * 64 * 2) + 1280 * 8 * (4 * 17 * 64 * 2) + 1280 * 8 * 17 * 17 + 1280 * 17),
    ("self", False, 1280 * 8 * (3 * 17 * 64 * 2) + 1280 * 8 * (4 * 17 * 64 * 2) + 1280 * 17),
    # cross: one K/V row per image (36 regions) for its 5 captions
    ("cross", True, 1280 * 8 * (3 * 17 * 64 * 2) + 256 * 8 * (4 * 36 * 64 * 2) + 1280 * 8 * 17 * 36 + 256 * 36),
    ("cross", False, 1280 * 8 * (3 * 17 * 64 * 2) + 256 * 8 * (4 * 36 * 64 * 2) + 256 * 36),
])
def test_k15_bytes_count_each_tensor_once(kind, keep, want):
    nk, tk = (N_XE, 17) if kind == "self" else (IMAGES, 36)
    assert chip_smoke.k15_bytes(N_XE, nk, tk, torch.bfloat16, keep=keep) == want
    # with the keep-mask 159 MB (self) and 111 MB (cross), as the kernel's note says
    assert round(want / 1e6) == {("self", True): 159, ("self", False): 156, ("cross", True): 111,
                                 ("cross", False): 105}[(kind, keep)]


@pytest.mark.parametrize("kind,backward,want", [
    # S = QK^T and P V forward; S again, dPd = dO V^T, dQ, dK, dV backward:
    # 2 x rows x heads x 17 x Tk x 64 a product
    ("self", False, 2 * 2 * 1280 * 8 * 17 * 17 * 64),
    ("self", True, 5 * 2 * 1280 * 8 * 17 * 17 * 64),
    ("cross", True, 5 * 2 * 1280 * 8 * 17 * 36 * 64),
])
def test_decoder_attention_flops_count_each_product(kind, backward, want):
    tk = 17 if kind == "self" else 36
    assert chip_smoke.decoder_attention_flops(N_XE, tk, backward=backward) == want


def test_k14_bytes_read_the_memory_once_per_image():
    # q in, out out per caption row; k, v in once per image; keep and validity flags
    want = 1280 * 8 * 2 * 17 * 64 * 2 + 256 * 8 * 2 * 36 * 64 * 2 + 1280 * 8 * 17 * 36 + 256 * 36
    assert chip_smoke.k14_bytes(N_XE, IMAGES, 36, torch.bfloat16) == want


@pytest.mark.parametrize("dtype,beams,want", [
    # serving: 2048 images, K and V (8 heads x 36 regions x 64) read once per
    # image, q read and out written per beam row (8 x 64), the region mask
    (torch.bfloat16, 5, 2048 * 2 * 8 * 36 * 64 * 2 + 2048 * 5 * 2 * 8 * 64 * 2 + 2048 * 36),
    (torch.float32, 15, 2048 * 2 * 8 * 36 * 64 * 4 + 2048 * 15 * 2 * 8 * 64 * 4 + 2048 * 36),
    ("kv", 5, 2048 * 1 * 8 * 36 * 64 * 2 + 2048 * 5 * 2 * 8 * 64 * 2 + 2048 * 36),  # ACORT: one array is K and V
])
def test_k3_bytes_read_one_memory_row_per_image(dtype, beams, want):
    kv = dtype == "kv"
    assert chip_smoke.k3_bytes(2048, beams, torch.bfloat16 if kv else dtype, kv=kv) == want
    if beams == 5:  # 151 MB of memory K / V and 21 MB of q and out (the kernel's note)
        assert round(2048 * 2 * 8 * 36 * 64 * 2 / 1e6) == 151 and round(2048 * 5 * 2 * 8 * 64 * 2 / 1e6) == 21


@pytest.mark.parametrize("backward,per_unit", [
    (False, 4 + 4 + 1 + 1 + 1),  # forward: gx, gh (4 gates each) and c in, h', c' out
    (True, (4 + 4 + 1 + 1 + 1) + (4 + 4 + 1 + 1 + 1 + 4 + 1)),  # + gx, gh, c, dh', dc' in, d gates, dc out
])
def test_k11_bytes_count_each_tensor_once(backward, per_unit):
    rows, units = 1024 * 5, 1000  # Up-Down serving: 1024 images x beam 5, rnn 1000
    assert chip_smoke.k11_bytes(rows, units, torch.bfloat16, backward=backward) == rows * units * per_unit * 2


# ------------------------------------------------------ K4 / K12 byte counts
@pytest.mark.parametrize("dtype,rows,k", [
    (torch.bfloat16, 2048 * 5, 5),  # ORT serving: 2048 images x beam 5
    (torch.bfloat16, 1024 * 5, 5),  # Up-Down serving: 1024 images x beam 5
    (torch.float32, 2048 * 5, 40),
])
def test_k4_bytes_read_the_logits_once(dtype, rows, k):
    es = 2 if dtype == torch.bfloat16 else 4
    # logits in; per row the banned token (int32) and the bad-ending flag (one
    # byte) in; k values (f32), indices (int32) and raw log-probs (f32) out
    want = rows * VOCAB * es + rows * (4 + 1) + rows * k * (4 + 4 + 4)
    assert chip_smoke.k4_bytes(rows, VOCAB, k, dtype) == want
    if (dtype, rows, k) == (torch.bfloat16, 10240, 5):  # 205 MB: 0.0613 ms at 3.35 TB/s (the kernel's note)
        assert round(want / 1e6) == 205 and round(want / 3.35e12 * 1e3, 4) == 0.0613


@pytest.mark.parametrize("backward", [False, True])
def test_k12_bytes_read_the_memory_once_per_image(backward):
    images, rows, regions, a, d = 1024, 5, 36, 512, 1000  # Up-Down serving, bf16
    n = images * rows
    # forward: p_att and att per image, att_h in and out per row, w and the
    # bias, the region mask (one byte a region)
    fwd = images * regions * a * 2 + images * regions * d * 2 + n * a * 2 + n * d * 2 + a * 2 + 2 + images * regions
    want = fwd
    if backward:
        saved = n * regions * 4 * 2  # prob and weight (f32), written forward, read backward
        bwd_in = images * regions * (a + d) * 2 + n * a * 2 + a * 2 + images * regions + n * d * 2  # ... and dout
        bwd_out = images * regions * (a + d) * 2 + n * a * 2 + a * 2 + 2  # d p_att, d att, d att_h, d w, d bias
        want = fwd + saved + bwd_in + saved + bwd_out
    assert chip_smoke.k12_bytes(images, rows, regions, a, d, torch.bfloat16, backward=backward) == want
    if not backward:  # 127 MB: 0.0379 ms at 3.35 TB/s (the kernel's note)
        assert round(want / 1e6) == 127 and round(want / 3.35e12 * 1e3, 4) == 0.0379


# ------------------------------------------- K4 rows next to a bf16 midpoint
def test_bf16_round_matches_torch():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 100
    # exact midpoints between bf16 neighbours: ties go to the even one
    mids = (x.to(torch.bfloat16).float().view(torch.int32) | 0x8000).view(torch.float32)
    for v in (x, mids):
        got = chip_smoke.bf16_round(v.numpy())
        assert torch.equal(torch.from_numpy(got), v.to(torch.bfloat16).float())


@pytest.mark.parametrize("count,midpoint,kept,moved", [
    # log 742 = 6.6093492..., 2.6e-5 below the midpoint 6.609375 of 6.59375
    # (odd) and 6.625 (even); 1024 + log 742 rounds to 1030.609375
    (742, 6.609375, -6.59375, -6.625),
    # log 9474 = 9.1563062..., 2.8e-5 above the midpoint 9.15625 of 9.125
    # (even) and 9.1875 (odd)
    (9474, 9.15625, -9.1875, -9.125),
])
def test_k4_midpoint_counts_by_hand(count, midpoint, kept, moved):
    counts = chip_smoke.k4_midpoint_counts(VOCAB)
    assert count in counts and all(1 <= n <= VOCAB for n in counts)
    log_sum = torch.tensor(count, dtype=torch.float64).log().float()
    m = torch.tensor(1024.0)
    assert abs(float(log_sum) - midpoint) < 2.0 ** -14
    assert float((m - m - log_sum).to(torch.bfloat16)) == kept
    assert float((m - (m + log_sum)).to(torch.bfloat16)) == moved


# ------------------------------------------------------------- K5 bytes
ORT_MASKED = 55_331_840  # the ORT's set: its 105 masked tensors


@pytest.mark.parametrize("dtype,bits,mode,bypass,per_weight,bit_passes", [
    # forward: w, m (and u) in, w_eff out; backward: g, w (and m) in, dw and
    # dm (f32) out; the sample as one bit a weight, written once and read once
    (torch.bfloat16, True, "sample", False, (2 + 4 + 4 + 2) + (2 + 2 + 4 + 2 + 4), 2),  # 26.25 B a weight
    (torch.bfloat16, False, "sample", False, (2 + 4 + 4 + 2) + (2 + 2 + 4 + 4 + 2 + 4), 0),  # u and m read again
    (torch.float32, True, "sample", True, (4 + 4 + 4 + 4) + (4 + 4 + 4 + 4), 2),  # bypass: no m in the backward
    (torch.bfloat16, True, "multiply", False, (2 + 4 + 2) + (2 + 2 + 4 + 2 + 4), 0),  # s = m: no u, no bits
])
def test_k5_bytes_count_each_tensor_once(dtype, bits, mode, bypass, per_weight, bit_passes):
    want = ORT_MASKED * per_weight + bit_passes * ORT_MASKED // 8
    assert chip_smoke.k5_bytes(ORT_MASKED, dtype, bits, mode, bypass) == want
    # a set's bits round up to whole bytes
    assert chip_smoke.k5_bytes(9, dtype, bits, mode, bypass) == 9 * per_weight + bit_passes * 2


def test_k5_bound_of_the_ort_set():
    # 26.25 B a weight in bf16: 1.452 GB, 0.4336 ms at 3.35 TB/s
    bound, by = chip_smoke.bound_ms(chip_smoke.k5_bytes(ORT_MASKED, torch.bfloat16), {})
    assert by == "bytes" and bound == pytest.approx(ORT_MASKED * 26.25 / 3.35e12 * 1e3)
    assert bound == pytest.approx(0.43357, abs=1e-5)


@pytest.mark.parametrize("n", [1, 7, 512, 5_120_000, 16_777_220, 55_331_840])
@pytest.mark.parametrize("q", [0.0, 0.5629629629629629, 0.8, 1.0])
def test_f32_quantile_index_agrees_with_the_wrapper(n, q):
    """chip_smoke's torch f32 reference of the quantile index, which holds
    ``quantile_index`` on the card, agrees with it here (the CPU test of
    ``quantile_index`` itself is against lax, test_torch_port_pruning.py)."""
    from sparse_caption_tpu_torch.kernels.magnitude_threshold import quantile_index

    lo, hi, lw, hw = chip_smoke.f32_quantile_index(n, q)
    assert (lo, hi, lw.item(), hw.item()) == quantile_index(n, q)


@pytest.mark.parametrize("kv", [False, True])
def test_dk32_bytes_count_the_shared_tensor_once(kv):
    """The bounds of ACORT-small's instances: rows of 32 elements, and with the
    one tensor as k and v (K14 / K15, K3's kv mode) that tensor read once
    and, in K15, its one gradient written once. XE shape: 1280 captions of
    26 positions over 256 images of 36 regions, bf16, 8 heads."""
    n, b, t, r, h, dk = 1280, 256, 26, 36, 8, 32
    rows14 = 2 * n * t + (1 if kv else 2) * b * r  # q, out; k and v (or the one tensor)
    assert chip_smoke.k14_bytes(n, b, r, torch.bfloat16, tq=t, dk=dk, kv=kv) == \
        rows14 * h * dk * 2 + n * h * t * r + b * r
    rows15 = 3 * n * t + (2 if kv else 4) * b * r  # q, dO, dq; k, v, dk, dv (or the tensor and its gradient)
    assert chip_smoke.k15_bytes(n, b, r, torch.bfloat16, tq=t, dk=dk, kv=kv) == \
        rows15 * h * dk * 2 + n * h * t * r + b * r
    assert chip_smoke.decoder_attention_flops(n, r, tq=t, dk=dk) == 4 * n * h * t * r * dk
    assert chip_smoke.k3_bytes(2048, 5, torch.bfloat16, kv=kv, dk=dk) == \
        ((1 if kv else 2) * 2048 * 36 + 2 * 2048 * 5) * h * dk * 2 + 2048 * 36


def test_acort_scst_launches_by_hand():
    """One ACORT SCST step's launches (6 slots, 25 sampled digits, dense,
    the kv modes): the sampling encode and the replay's each run K1's train
    variant once a slot, K7 once a slot, K2 and K3 once a slot and step,
    the replay's K14 and K15 twice a slot (all in their kv modes), K6
    13 a pass of the encoder and 19 of the decoder (each step of the 25, and
    the replay), the keep-masks 3 a slot of every pass, the applied dropouts
    (PE or the source projection, and one FFN a slot) of every pass and of
    the replay's two backward passes, one sampling step a step, one reward."""
    from sparse_caption_tpu_torch.kernels import KERNELS

    counts = chip_smoke.acort_scst_launches(KERNELS)
    want = dict(box_attention_train_kv=12, box_attention_bwd_kv=6, ancestry_self_attention_kv=150,
                grouped_cross_attention_kv=150, add_ref_layernorm=13 + 25 * 19 + 13 + 19, add_ref_layernorm_bwd=32,
                keyed_keep_mask=3 * 6 * 28, keyed_dropout=7 * 30, sample_step=25, cider_reward=1,
                vocab_log_softmax=1, vocab_log_softmax_bwd=1, decoder_attention_kv=12, decoder_attention_bwd_kv=12)
    assert {k: v for k, v in counts.items() if v} == want


@pytest.mark.parametrize("t, slots", [(0, 1), (8, 9), (16, 17)])
def test_k2_bwd_bytes_count_each_slot_once(t, slots):
    """K2's backward at step t (f32, 960 rows, 8 heads of 64): q, dout in;
    dq, dk_t, dv_t out; the t + 1 slots of K and V in, of dK and dV in and
    out."""
    row = 960 * 8 * 64 * 4
    assert chip_smoke.k2_bwd_bytes(960, t) == row * (2 + 3 + 2 * slots + 2 * slots + 2 * slots)


def test_k3_bwd_bytes_read_one_memory_row_per_image():
    """K3's backward (f32, 64 images x 15 rows, 8 heads of 64, 36 regions):
    q, dout in and dq out a row; K, V in and dK, dV out an image; the mask."""
    assert chip_smoke.k3_bwd_bytes(64, 15) == (3 * 960 * 8 * 64 + 4 * 64 * 8 * 36 * 64) * 4 + 64 * 36


def test_supermask_scst_launches_by_hand():
    """One supermask ORT SCST step's launches (6 layers, 17 steps): each of
    the two phases runs the encode (K1's train variant a layer; one keyed
    K5 set), the cross K/V projection (a keyed set) and 17 decode steps (K2
    and K3 a layer, one keyed set, K6 19 a step); the gradient pass's
    backward runs K7 a layer, K2's and K3's backward a layer and step, the
    sets' backward (19), K6's 13 + 17 x 19, K13's 17 and the applied
    dropouts again; one sampling step a step, one reward. Up-Down's is the
    mask_freeze step's with every product keyed: 18 sets a phase."""
    from sparse_caption_tpu_torch.kernels import KERNELS

    counts = chip_smoke.supermask_scst_launches(6, 17, KERNELS)
    want = dict(box_attention_train=12, box_attention_bwd=6, ancestry_self_attention=204,
                ancestry_self_attention_bwd=102, grouped_cross_attention=204, grouped_cross_attention_bwd=102,
                supermask_keyed=38, supermask_bwd=19, add_ref_layernorm=2 * (13 + 17 * 19),
                add_ref_layernorm_bwd=13 + 17 * 19, keyed_keep_mask=2 * 18 * 18, keyed_dropout=3 * 7 * 18,
                sample_step=17, cider_reward=1, vocab_log_softmax=17, vocab_log_softmax_bwd=17)
    assert {k: v for k, v in counts.items() if v} == want
    ud = chip_smoke.supermask_updown_scst_launches(17, KERNELS)
    assert ud["supermask"] == 0 and ud["supermask_keyed"] == 36 and ud["supermask_bwd"] == 18
    assert ud["lstm_cell"] == 68 and ud["vocab_log_softmax"] == 1


@pytest.mark.parametrize("dtype,rows", [(torch.float32, 64 * 15), (torch.bfloat16, 2048 * 5)])
def test_k9_bytes_read_the_logits_once(dtype, rows):
    """K9 in every mode (its filters work in shared memory): the logits in;
    per row the fed token (int32) and the unfinished flag (one byte) in, the
    token into seq and into next (int32 each), the chosen log-prob (f32)
    and the flag out."""
    es = 2 if dtype == torch.bfloat16 else 4
    assert chip_smoke.k9_bytes(rows, VOCAB, dtype) == rows * VOCAB * es + rows * (4 + 1 + 4 + 4 + 4 + 1)
    if dtype == torch.float32:  # 38.4 MB at the SCST sampling shape (the kernel's note)
        assert round(chip_smoke.k9_bytes(rows, VOCAB, dtype) / 1e6, 1) == 38.4


def test_k4_bytes_with_the_diverse_beam_penalty():
    """K4 with the diversity prologue: as without it, plus each image's
    earlier-group tokens (int32) read once: 2048 images x 2 rows (the third
    group of beam 6 in 3 groups), 4 tokens an image."""
    rows, k, p = 2048 * 2, 2, 4
    want = rows * VOCAB * 2 + rows * (4 + 1) + rows * k * (4 + 4 + 4) + 2048 * p * 4
    assert chip_smoke.k4_bytes(rows, VOCAB, k, torch.bfloat16, p) == want
    assert chip_smoke.k4_bytes(rows, VOCAB, k, torch.bfloat16) == want - 2048 * p * 4


@pytest.mark.parametrize("dim_g", [64, 4])
def test_k1_k7_bytes_by_geometry_width(dim_g):
    """K1 (2048 images) and K7 (256 images), bf16, 8 heads of 64, 36
    regions: q, k, v in and out out (K7: q, k, v, dO in, dq, dk, dv out,
    the keep-mask a byte a (head, pair)); boxes 16 bytes and the mask a
    byte a region; wg (h, dim_g) and its bias (K7: and their gradients)."""
    b, h, r, dk = 2048, 8, 36, 64
    assert chip_smoke.k1_bytes(b, h, r, dk, torch.bfloat16, dim_g) == (
        4 * b * h * r * dk * 2 + b * r * 16 + b * r + h * (dim_g + 1) * 2)
    b = 256
    assert chip_smoke.k7_bytes(b, h, r, dk, torch.bfloat16, dim_g) == (
        7 * b * h * r * dk * 2 + b * h * r * r + b * r * 16 + b * r + 2 * h * (dim_g + 1) * 2)
    # the raw geometry's wg is 4 wide: 60 columns fewer a head, once (K1) and twice (K7)
    if dim_g == 4:
        assert chip_smoke.k1_bytes(2048, h, r, dk, torch.bfloat16) - chip_smoke.k1_bytes(
            2048, h, r, dk, torch.bfloat16, 4) == h * 60 * 2


def test_nucleus_cutoff_sums_and_near_rows():
    """The nucleus check's cutoff sums on a row of four probabilities of 1/4
    (prefix sums 0.25, 0.5, 0.75, 1 exactly) at p = 0.5: the entry whose sum
    before it is 0.5 is not kept, so the sums around the cut are 0.25 and
    0.5, which lie within 4 ulps of p; at p = 0.6 they are 0.5 and 0.75."""
    c = torch.log_softmax(torch.tensor([[10.0, 10.0, 10.0, 10.0] + [-1000.0] * 6]), dim=-1)
    sums = chip_smoke.nucleus_cutoff_sums(c, "top0.5", 1.0)
    assert sums.tolist() == [[0.25, 0.5]] and bool(chip_smoke.near_p(sums, 0.5))
    sums = chip_smoke.nucleus_cutoff_sums(c, "top0.6", 1.0)
    assert sums.tolist() == [[0.5, 0.75]] and not bool(chip_smoke.near_p(sums, 0.6))


@pytest.mark.parametrize("t", [0, 8, 16])
def test_k2_bwd_anc_bytes_count_each_named_slot_once(t):
    """K2's backward through the map (f32, 64 images x 15 beams, 8 heads of
    64): the identity map names every row's t + 1 slots, as the identity
    mode's count, plus the map's columns; with every earlier slot read from
    beam 0, an image's slots < t are one row's, and slot t every row's own."""
    b, k, t_max = 64, 15, 17
    ident = chip_smoke.anc_map("identity", b, k, t_max, t, device="cpu")
    assert chip_smoke.k2_bwd_anc_bytes(ident, t) == chip_smoke.k2_bwd_bytes(b * k, t) + 4 * b * k * (t + 1)
    beam0 = chip_smoke.anc_map("from_beam_0", b, k, t_max, t, device="cpu")
    assert beam0[:, :, :t].eq(0).all() and torch.equal(beam0[:, :, t], ident[:, :, t])
    pairs = b * (t + k)  # t slots of beam 0 an image, then slot t of each beam
    assert chip_smoke.k2_bwd_anc_bytes(beam0, t) == 4 * 8 * 64 * (5 * b * k + 6 * pairs) + 4 * b * k * (t + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_ss_bytes_read_the_sampled_rows_once(dtype):
    """K9's ss mode at 1,280 rows x 10,000: the log-prob rows of the 320
    sampled rows in, a teacher token in and an input token out (int32) a row."""
    assert chip_smoke.k9_ss_bytes(320, 1280, 10000, dtype) == 320 * 10000 * (4 if dtype == torch.float32 else 2) + \
        1280 * 8


def test_beam_scst_launches_by_hand():
    """One beam-sample SCST step of the mask_freeze ORT (6 layers, 17 steps,
    105 masked tensors): the sampling phase's encode and beam search (K1's
    train variant a layer, K2 and K3 a layer and step, K4 a step, the 105
    products once a tensor), the gradient pass's encode, cross K/V and 17
    steps with gradients (K5 sets 1 + 1 + 17, K13 a step, K2's backward in
    the ancestry mode a layer and step, K3's a layer and step, K7 a layer),
    the dropouts of both phases and their backward, one reward; of Up-Down
    (17 steps): the random-sample step's with K4 a step for K9's, and K13
    and its backward a step."""
    from sparse_caption_tpu_torch.kernels import KERNELS

    counts = chip_smoke.ort_beam_scst_launches(6, 17, 105, KERNELS)
    want = dict(box_attention_train=12, box_attention_bwd=6, ancestry_self_attention=204,
                ancestry_self_attention_bwd_anc=102, grouped_cross_attention=204, grouped_cross_attention_bwd=102,
                supermask=105 + 19, supermask_bwd=19, add_ref_layernorm=2 * (13 + 17 * 19),
                add_ref_layernorm_bwd=13 + 17 * 19, keyed_keep_mask=2 * 18 * 18, keyed_dropout=3 * 7 * 18,
                beam_topk=17, cider_reward=1, vocab_log_softmax=17, vocab_log_softmax_bwd=17)
    assert {k: v for k, v in counts.items() if v} == want
    ud = chip_smoke.updown_beam_scst_launches(17, KERNELS)
    assert ud["sample_step"] == 0 and ud["beam_topk"] == 17 and ud["vocab_log_softmax"] == 17
    assert ud["vocab_log_softmax_bwd"] == 17 and ud["supermask"] == 11 + 18 and ud["lstm_cell"] == 68


def _nucleus_row(vocab: int, tops: list, level: float = -1000.0):
    """(1, vocab) f32 log-probs of logits `level` with 10 at `tops`."""
    x = torch.full((1, vocab), level)
    x[0, tops] = 10.0
    return torch.log_softmax(x, dim=-1)


def test_nucleus_exact_at_p_only_where_no_rounding_decides():
    """Four quarters at p = 0.5: the cutoff sum is 0.5 exactly (an exact
    row); a row of 771 equal p at 0.9: 693 / 770-ish sums round (not exact);
    a random row clear of p: not exact."""
    quarters = _nucleus_row(20, [3, 6, 11, 17])
    assert bool(chip_smoke.nucleus_exact_at_p(quarters, "top0.5", 1.0, 0.5)[0])
    equal = torch.log_softmax(torch.zeros(1, 771), dim=-1)
    assert not bool(chip_smoke.nucleus_exact_at_p(equal, "top0.9", 0.7, 0.9)[0])
    rnd = torch.log_softmax(torch.randn(1, 300, generator=torch.Generator().manual_seed(4)) * 3, dim=-1)
    assert not bool(chip_smoke.nucleus_exact_at_p(rnd, "top0.9", 0.7, 0.9)[0])


def test_nucleus_lp_apart_keeps_one_entry_fewer_and_more():
    """The four quarters at p = 0.5 keep two (1/4 / 1/2); one fewer kept
    gives log(1/4 / 1/4) = 0 for the first, one more log(1/4 / 3/4); the
    second quarter is not kept with one fewer (-1e30)."""
    quarters = _nucleus_row(20, [3, 6, 11, 17])
    assert int(chip_smoke.modified_kept(quarters, "top0.5", 1.0)[0]) == 2
    got = chip_smoke.nucleus_lp_apart(quarters, "top0.5", 1.0, torch.tensor([3]))
    torch.testing.assert_close(got, torch.tensor([[0.0, float(torch.log(torch.tensor(1 / 3)))]]))
    second = chip_smoke.nucleus_lp_apart(quarters, "top0.5", 1.0, torch.tensor([6]))
    assert second[0, 0] == -1e30 and torch.isclose(second[0, 1], torch.log(torch.tensor(1 / 3)))


def test_near_p_counts_rows_the_plain_rounding_put_across_p():
    """Cutoff sums (before, at; then their exact values): within 4 ulps of p
    in either; or the rounded sum at the cut 10 ulps above p while its exact
    value lies below (the plain version's rounding alone decided); a row
    clear of p is not near."""
    p, ulp = 0.9, float(np.spacing(np.float32(0.9)))
    p32 = float(np.float32(p))
    rows = torch.tensor([
        [p32 - 0.01, p32 + 2 * ulp, p32 - 0.01, p32 + 2 * ulp],  # within 4 ulps
        [p32 - 0.01, p32 + 10 * ulp, p32 - 0.01, p32 - 10 * ulp],  # rounding crossed p
        [p32 - 0.01, p32 + 0.01, p32 - 0.01, p32 + 0.01],  # clear
    ], dtype=torch.float64)
    assert chip_smoke.near_p(rows, p).tolist() == [True, True, False]
    assert chip_smoke.near_p(rows[:, :2], p).tolist() == [True, False, False]
