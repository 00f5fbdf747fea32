"""Layer and kernel-twin parity of the PyTorch port against the JAX package on
the CPU (f32, 1e-5): RefLayerNorm, PE, masked layers, and the plain versions
behind kernels K1 (box attention), K2 (ancestry self-attention), K3 (grouped
cross-attention) and K4 (beam top-K)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import D, HEADS, R, jax_mask_cfg, port_mask_cfg, t, to_numpy
from sparse_caption_tpu.decoding.beam import NEG_BIG as JAX_NEG_BIG
from sparse_caption_tpu.decoding.beam import _row_topk
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu.ops.masked import MaskedDense, MaskedEmbed
from sparse_caption_tpu_torch.kernels import KERNELS, launch_counts
from sparse_caption_tpu_torch.kernels.ancestry_self_attention import MAX_SLOTS as K2_MAX_SLOTS
from sparse_caption_tpu_torch.kernels.ancestry_self_attention import ancestry_self_attention
from sparse_caption_tpu_torch.kernels.beam_topk import NEG_BIG, beam_topk
from sparse_caption_tpu_torch.kernels.box_attention import box_attention, log_bias_from_geometry
from sparse_caption_tpu_torch.kernels.grouped_cross_attention import bf16_smem as k3_bf16_smem
from sparse_caption_tpu_torch.kernels.grouped_cross_attention import grouped_cross_attention
from sparse_caption_tpu_torch.models import layers as pl
from sparse_caption_tpu_torch.ops.masked import MaskedEmbedding, MaskedLinear
from sparse_caption_tpu_torch.ops.rng import TrainRandom
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _boxes(rng, b, r):
    xy = rng.uniform(0, 400, size=(b, r, 2))
    wh = rng.uniform(10, 200, size=(b, r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _load(layer, jax_vars):
    layer.load_state_dict(convert_jax_variables(to_numpy(jax_vars)))
    return layer


def test_ref_layernorm_matches_jax_and_is_not_nn_layernorm():
    x = np.random.default_rng(0).normal(2.0, 3.0, size=(3, 4, D)).astype(np.float32)
    jln = jl.RefLayerNorm()
    jv = {"params": {"scale": np.linspace(0.5, 1.5, D, dtype=np.float32),
                     "bias": np.linspace(-1, 1, D, dtype=np.float32)}}
    ref = jln.apply(jv, jnp.asarray(x))
    port = pl.RefLayerNorm(D)
    port.load_state_dict({"weight": t(jv["params"]["scale"]), "bias": t(jv["params"]["bias"])})
    _close(port(t(x)), ref)
    torch_ln = torch.nn.LayerNorm(D, eps=1e-6)
    torch_ln.load_state_dict({"weight": t(jv["params"]["scale"]), "bias": t(jv["params"]["bias"])})
    # biased variance inside the sqrt differs from Bessel-corrected std + eps
    assert np.abs(torch_ln(t(x)).detach().numpy() - np.asarray(ref)).max() > 1e-3


@pytest.mark.parametrize("step", [None, 0, 5])
def test_positional_encoding_matches_jax(step):
    x = np.random.default_rng(1).normal(size=(2, 1 if step is not None else 6, D)).astype(np.float32)
    ref = jl.PositionalEncoding(D).apply({}, jnp.asarray(x), t=step)
    _close(pl.PositionalEncoding(D)(t(x), t=step), ref)
    _close(pl.sinusoid_table(50, D), jl.sinusoid_table(50, D))


@pytest.mark.parametrize("mask_type", ["supermask", "mag_blind"])
def test_masked_layers_fold_like_jax(mask_type):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, D)).astype(np.float32)
    ids = np.array([[0, 3, 7]], np.int32)
    for jax_layer, port_layer, arg in (
        (MaskedDense(16, mask_cfg=jax_mask_cfg(mask_type)), MaskedLinear(D, 16, mask_cfg=port_mask_cfg(mask_type)), x),
        (MaskedEmbed(10, D, mask_cfg=jax_mask_cfg(mask_type)), MaskedEmbedding(10, D, mask_cfg=port_mask_cfg(mask_type)),
         ids),
    ):
        jv = to_numpy(jax_layer.init(KEY, jnp.asarray(arg)))
        m = jv["masks"]["mask"]
        jv["masks"]["mask"] = (rng.normal(0, 2, m.shape) if mask_type == "supermask"
                               else rng.uniform(size=m.shape) < 0.5).astype(np.float32)
        ref = jax_layer.apply(jv, jnp.asarray(arg))
        port_layer.load_state_dict(convert_jax_variables(jv, port_mask_cfg(mask_type)))
        port_arg = t(arg).long() if arg.dtype == np.int32 else t(arg)
        _close(port_layer(port_arg), ref)
        with pytest.raises(ValueError, match="folded"):  # a folded mask cannot train
            port_layer(port_arg, TrainRandom(torch.Generator().manual_seed(0)))


def test_box_relational_embedding_matches_jax():
    boxes = _boxes(np.random.default_rng(3), 2, R)
    ref = jl.box_relational_embedding(jnp.asarray(boxes))
    port = pl.box_relational_embedding(t(boxes))
    # the 4 log-deltas agree to 1e-5; the sin/cos arguments reach
    # 100 * |log(1e-3)| = 691 rad, where one f32 ulp is 6.1e-5 rad, so the
    # trig features agree to 2 ulp of the argument
    _close(port, ref, rtol=0, atol=1.25e-4)


def test_k1_box_attention_layer_matches_jax():
    """BoxMultiHeadAttention (projections + K1's plain version) vs the JAX layer."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, R, D)).astype(np.float32)
    boxes = _boxes(rng, 2, R)
    amask = np.ones((2, R), np.float32)
    amask[1, -1] = 0.0
    jlayer = jl.BoxMultiHeadAttention(num_heads=HEADS, d_model=D)
    args = (jnp.asarray(x), jnp.asarray(boxes), jnp.asarray(amask)[:, None, None, :])
    jv = jlayer.init(KEY, *args)
    ref = jlayer.apply(jv, *args)
    port = _load(pl.BoxMultiHeadAttention(HEADS, D), jv)
    with torch.no_grad():
        out = port(t(x), t(boxes), t(amask) != 0)
    _close(out, ref)


def test_k1_plain_log_bias_matches_jax_bit_for_bit_in_bf16():
    """K1's plain log-bias in bf16 is the JAX layer's ``log_wg``
    (layers.py:425-435: the f32 geometry cast to bf16, ``MaskedDense`` as
    ``wg`` with its bias added after the rounded dot, relu, the 1e-6 clamp and
    the log in bf16), bit for bit, over 36 regions, 8 heads and weights that
    put part of w_g below relu's kink. Both start from the JAX package's f32
    geometry: the two frameworks' f32 sin/cos of arguments up to 691 rad
    differ in the last bits (``test_box_relational_embedding_matches_jax``),
    which moves a rounded feature now and then; this test is about the cast
    points after it."""
    rng = np.random.default_rng(6)
    b, r, h = 2, 36, 8
    geo = jl.box_relational_embedding(jnp.asarray(_boxes(rng, b, r)))
    wk = jnp.asarray(rng.normal(0, 0.3, size=(64, h)).astype(np.float32)).astype(jnp.bfloat16)
    wb = jnp.asarray(rng.normal(0.5, 0.5, size=(h,)).astype(np.float32)).astype(jnp.bfloat16)
    w_g = jax.nn.relu(MaskedDense(h).apply({"params": {"kernel": wk, "bias": wb}}, geo.astype(jnp.bfloat16)))
    ref = jnp.log(jnp.maximum(w_g, 1e-6)).transpose(0, 3, 1, 2).astype(jnp.bfloat16)
    port = log_bias_from_geometry(t(geo), t(np.asarray(wk.astype(jnp.float32)).T.copy()).bfloat16(),
                                  t(np.asarray(wb.astype(jnp.float32))).bfloat16(), torch.bfloat16)
    assert port.dtype == torch.bfloat16 and 0.05 < float((np.asarray(w_g.astype(jnp.float32)) == 0).mean()) < 0.95
    np.testing.assert_array_equal(port.view(torch.int16).numpy().view(np.uint16), np.asarray(ref).view(np.uint16))


def test_k1_wrapper_routes_cpu_to_plain_and_checks_inputs():
    rng = np.random.default_rng(5)
    b, h, dk = 2, HEADS, 8
    q, k, v = (t(rng.normal(size=(b, h, R, dk)).astype(np.float32)) for _ in range(3))
    boxes = t(_boxes(rng, b, R))
    wg_w, wg_b = t(rng.normal(size=(h, 64)).astype(np.float32)), t(rng.normal(size=(h,)).astype(np.float32))
    mask = torch.ones(b, R, dtype=torch.bool)
    mask[0, -1] = False
    before = launch_counts()
    out = box_attention(q, k, v, boxes, wg_w, wg_b, mask)
    assert out.shape == q.shape and launch_counts() == before  # the CPU never launches
    with pytest.raises(TypeError):
        box_attention(q, k, v, boxes, wg_w, wg_b, mask.float())
    with pytest.raises(ValueError):
        box_attention(q, k.transpose(2, 3), v, boxes, wg_w, wg_b, mask)
    with pytest.raises(TypeError):
        box_attention(q.double(), k.double(), v.double(), boxes, wg_w.double(), wg_b.double(), mask)


def _jax_mha(x):
    mha = jl.MultiHeadAttention(num_heads=HEADS, d_model=D)
    return mha, mha.init(KEY, x, x, x)


@pytest.mark.parametrize("with_ancestry", [False, True])
@pytest.mark.parametrize("step", [0, 3])
def test_k2_decode_self_matches_jax(with_ancestry, step):
    """MultiHeadAttention.decode_self (fused qkv + K2's plain version) vs JAX,
    with an arbitrary ancestor map or the identity."""
    rng = np.random.default_rng(6 + step)
    b, kb, t_max, dk = 2, 3, 6, D // HEADS
    n = b * kb
    x_t = rng.normal(size=(n, 1, D)).astype(np.float32)
    ck = rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    cv = rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    mha, jv = _jax_mha(jnp.asarray(x_t))
    anc = rng.integers(0, kb, size=(b, kb, t_max)).astype(np.int32) if with_ancestry else None
    onehot = None if anc is None else jax.nn.one_hot(jnp.asarray(anc), kb, dtype=jnp.float32)
    ref, ref_k, ref_v = mha.apply(jv, jnp.asarray(x_t), jnp.asarray(ck), jnp.asarray(cv), step,
                                  method="decode_self", ancestry_onehot=onehot)
    port = _load(pl.MultiHeadAttention(HEADS, D), jv)
    pk, pv = t(ck), t(cv)
    with torch.no_grad():
        out = port.decode_self(t(x_t), pk, pv, step, None if anc is None else t(anc))
    _close(out, ref)
    _close(pk, ref_k)  # slot `step` written in place
    _close(pv, ref_v)


def test_k2_decode_self_matches_jax_beyond_32_slots():
    """A cache of 60 slots (the character tokenizer's default length), more
    than the 32 lanes of K2's warp: the kernel holds two a lane; here the
    plain version, against JAX, at a step past the first 32."""
    rng = np.random.default_rng(16)
    b, kb, t_max, dk, step = 2, 3, 60, D // HEADS, 40
    n = b * kb
    x_t = rng.normal(size=(n, 1, D)).astype(np.float32)
    ck = rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    cv = rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    anc = rng.integers(0, kb, size=(b, kb, t_max)).astype(np.int32)
    mha, jv = _jax_mha(jnp.asarray(x_t))
    ref, _, _ = mha.apply(jv, jnp.asarray(x_t), jnp.asarray(ck), jnp.asarray(cv), step, method="decode_self",
                          ancestry_onehot=jax.nn.one_hot(jnp.asarray(anc), kb, dtype=jnp.float32))
    port = _load(pl.MultiHeadAttention(HEADS, D), jv)
    with torch.no_grad():
        out = port.decode_self(t(x_t), t(ck), t(cv), step, t(anc))
    _close(out, ref)
    assert t_max <= K2_MAX_SLOTS


def test_fused_qkv_built_once_and_rebuilt_after_weight_changes():
    """decode_self's concatenated q/k/v weight is cached across steps and
    follows a mask fold, a state_dict load and a dtype cast."""
    mha = pl.MultiHeadAttention(HEADS, D, mask_cfg=port_mask_cfg("supermask"), device="cpu")
    for m in (mha.q_proj, mha.k_proj, mha.v_proj):
        m.reset_parameters(torch.Generator().manual_seed(0))

    def expected():
        return torch.cat([mha.q_proj.weight, mha.k_proj.weight, mha.v_proj.weight]).detach()

    w, _ = mha._fused_qkv()
    assert torch.equal(w, expected()) and mha._fused_qkv()[0] is w  # no rebuild between steps
    mha.k_proj.fold_mask_(torch.randn(D, D, generator=torch.Generator().manual_seed(1)))
    assert torch.equal(mha._fused_qkv()[0], expected())
    state = {k: torch.randn_like(v) for k, v in mha.state_dict().items()}
    mha.load_state_dict(state)
    assert torch.equal(mha._fused_qkv()[0], expected())
    mha.to(torch.bfloat16)
    w, b = mha._fused_qkv()
    assert w.dtype == b.dtype == torch.bfloat16 and torch.equal(w, expected())


def test_k2_wrapper_checks_inputs():
    q = torch.zeros(6, HEADS, 8)
    cache = torch.zeros(6, HEADS, 5, 8)
    with pytest.raises(ValueError):
        ancestry_self_attention(q, cache, cache, None, 5)
    with pytest.raises(TypeError):
        ancestry_self_attention(q, cache, cache, torch.zeros(2, 3, 5, dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        ancestry_self_attention(q, cache, cache, torch.zeros(2, 2, 5, dtype=torch.int32), 1)


@pytest.mark.parametrize("rep,shared_v", [(1, False), (3, False), (3, True)])
def test_k3_decode_cross_matches_jax(rep, shared_v):
    """MultiHeadAttention.decode_cross (q proj + K3's plain version) vs JAX."""
    rng = np.random.default_rng(10 + rep)
    b, s, dk = 2, R, D // HEADS
    x_t = rng.normal(size=(b * rep, 1, D)).astype(np.float32)
    mk = rng.normal(size=(b, HEADS, s, dk)).astype(np.float32)
    mv = None if shared_v else rng.normal(size=(b, HEADS, s, dk)).astype(np.float32)
    amask = np.ones((b, s), np.float32)
    amask[1, -2:] = 0.0
    mha, jv = _jax_mha(jnp.asarray(x_t))
    ref = mha.apply(jv, jnp.asarray(x_t), jnp.asarray(mk), None if mv is None else jnp.asarray(mv),
                    jnp.asarray(amask)[:, None, None, :], method="decode_cross")
    port = _load(pl.MultiHeadAttention(HEADS, D), jv)
    with torch.no_grad():
        out = port.decode_cross(t(x_t), t(mk), None if mv is None else t(mv), t(amask) != 0)
    _close(out, ref)
    with pytest.raises(ValueError):
        grouped_cross_attention(torch.zeros(5, HEADS, dk), t(mk), None, t(amask) != 0)


@pytest.mark.parametrize("regions,rep,stages", [(36, 5, 2), (36, 40, 2), (64, 300, 1), (36, 800, 0)])
def test_k3_bf16_smem_bounds_regions_and_rows(regions, rep, stages):
    """K3's bf16 kernel stages the K and V rows (regions each) of 2 heads of
    an image, their rep x 2 q rows and a row of region flags, 144 bytes a
    row, two units deep where that fits, plus a zero row; the wrapper refuses
    what does not fit in a block's 232,448 bytes (chip_smoke.py checks the
    formula against the C function)."""
    want = (stages * ((2 * regions + rep) * 2 + 1) + 1) * 144 if stages else 0
    assert k3_bf16_smem(regions, rep) == want  # the paper's 36 regions, beam 5: 44,784 bytes
    assert want <= 232448
    if stages == 1:  # two stages would not fit
        assert (2 * ((2 * regions + rep) * 2 + 1) + 1) * 144 > 232448


def _jax_beam_topk(logits, k, prev, step, bad_ids, eos_id, unk_id, decoding_constraint, suppress_unk):
    """decoding/beam.py:163-175,192,209 on one step's logits."""
    vocab = logits.shape[1]
    logprobs = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    constrained = logprobs
    if decoding_constraint:
        pen = jax.nn.one_hot(jnp.asarray(prev), vocab) * JAX_NEG_BIG
        constrained = jnp.where(step > 0, constrained + pen, constrained)
    if bad_ids is not None:
        is_bad = jnp.isin(jnp.asarray(prev), jnp.asarray(bad_ids))
        eos_pen = jnp.where(is_bad[:, None] & (jnp.arange(vocab)[None, :] == eos_id), JAX_NEG_BIG, 0.0)
        constrained = jnp.where(step > 0, constrained + eos_pen, constrained)
    if suppress_unk:
        constrained = constrained.at[:, unk_id].add(-1000.0)
    row_lp, row_tok = _row_topk(constrained, k)
    return row_lp, row_tok, jnp.take_along_axis(logprobs, row_tok, axis=1)


@pytest.mark.parametrize("constraint,bad,unk,step", [
    (0, False, 0, 0), (1, False, 0, 2), (0, True, 0, 2), (0, False, 1, 0), (1, True, 1, 3), (1, True, 1, 0)])
def test_k4_beam_topk_matches_jax(constraint, bad, unk, step):
    """K4's plain version vs the JAX generator log_softmax + constraints + top-K,
    on logits with many exact ties (ties go to the lower index)."""
    rng = np.random.default_rng(20 + step)
    n, vocab, k, eos_id, unk_id = 10, 48, 5, 3, 1
    logits = np.round(rng.normal(size=(n, vocab)), 1).astype(np.float32)
    logits[:, eos_id] = logits.max(axis=1) + 0.5  # EOS would win unless banned
    prev = rng.integers(0, vocab, size=(n,)).astype(np.int32)
    prev[:3] = [7, 9, 3]
    bad_ids = [7, 9] if bad else None
    ref = _jax_beam_topk(logits, k, prev, step, bad_ids, eos_id, unk_id, constraint, unk)
    ban_token = t(prev) if (constraint and step > 0) else None
    ban_eos = torch.isin(t(prev), torch.tensor(bad_ids, dtype=torch.int32)) if (bad and step > 0) else None
    vals, idx, raw = beam_topk(t(logits), k, ban_token=ban_token, ban_eos=ban_eos, eos_id=eos_id,
                               unk_id=unk_id if unk else None)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[1]))
    _close(vals, ref[0])
    _close(raw, ref[2])
    assert NEG_BIG == JAX_NEG_BIG


@pytest.mark.parametrize("k", [10, 15, 40])
def test_k4_beam_topk_wide_matches_jax(k):
    """Beams wider than 8: K4's plain version vs ``lax.top_k`` on the same
    augmented scores (every constraint on), with many exact ties."""
    rng = np.random.default_rng(30 + k)
    n, vocab, eos_id, unk_id = 6, 64, 3, 1
    logits = np.round(rng.normal(size=(n, vocab)), 1).astype(np.float32)
    prev = rng.integers(0, vocab, size=(n,)).astype(np.int32)
    prev[:2] = [7, 9]
    ref = _jax_beam_topk(logits, k, prev, 1, [7, 9], eos_id, unk_id, 1, 1)
    vals, idx, raw = beam_topk(t(logits), k, ban_token=t(prev), ban_eos=torch.isin(t(prev), torch.tensor([7, 9])),
                               eos_id=eos_id, unk_id=unk_id)
    assert idx.shape == (n, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[1]))
    _close(vals, ref[0])
    _close(raw, ref[2])


def test_k4_wrapper_checks_inputs():
    logits = torch.zeros(4, 10)
    assert beam_topk(logits, 10)[1].shape == (4, 10)  # any k up to the vocabulary
    with pytest.raises(ValueError):
        beam_topk(logits, 11)
    with pytest.raises(ValueError):
        beam_topk(logits, 0)
    with pytest.raises(TypeError):
        beam_topk(logits, 2, ban_token=torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        beam_topk(logits[:, ::2], 2)


def test_kernel_table_names_sources():
    assert set(KERNELS) == {"box_attention", "box_attention_train", "box_attention_kv", "box_attention_train_kv",
                            "ancestry_self_attention", "ancestry_self_attention_kv", "grouped_cross_attention",
                            "grouped_cross_attention_kv", "box_attention_bwd_kv", "beam_topk", "supermask", "supermask_bwd", "add_ref_layernorm",
                            "add_ref_layernorm_bwd", "box_attention_bwd", "keyed_keep_mask", "keyed_dropout",
                            "sample_step", "cider_reward", "lstm_cell", "lstm_cell_bwd", "additive_attention",
                            "additive_attention_bwd", "vocab_log_softmax", "vocab_log_softmax_bwd",
                            "decoder_attention", "decoder_attention_bwd", "decoder_attention_kv",
                            "decoder_attention_bwd_kv", "magnitude_threshold", "supermask_keyed",
                            "ancestry_self_attention_bwd", "grouped_cross_attention_bwd"}
    from sparse_caption_tpu_torch.kernels._build import CSRC, SOURCES

    assert {k.library_name for k in KERNELS.values()} == set(SOURCES)

    for name in SOURCES:
        src = (CSRC / f"{name}.cu").read_text()
        assert "Replaces:" in src and "Bound on the H100" in src and "Design:" in src
        assert f"sct_{name}" in src
