"""Decode variants and the raw box geometry of the PyTorch port against the
JAX package on the CPU: the sampling methods (kernel K9's top-k, nucleus and
Gumbel modes through their plain versions, ``decoding/sample.py``
``modified_sample_logits`` / ``sample_next_word``), diverse beam search (K4's
diversity penalty, ``decoding/beam.py`` snapshots, ``decoding/api.py``
groups), and ``--no_box_trigonometric_embedding`` (the 4-wide geometry that
K1 and K7 take at dim_g 4).

JAX's random draws are replayed into the port: the Gumbel noise of
``jax.random.categorical`` (which is the argmax of the logits plus
``jax.random.gumbel`` of the same key) for ``random``, ``top<k>`` and
``top<p>``, and the uniforms u of the Gumbel method (``sample.py:81-84``),
per step in the decode's ``split`` sequence. The XE step of the raw-geometry
supermask ORT replays JAX's mask uniforms (``sample_mask`` patched) and its
dropout keep-masks (``bernoulli`` outside ``sample_mask``) call by call.

Tolerances: the sampling steps' tokens exactly and their log-probs within
1e-6 (f32, the same formula; the log-softmax and the softmax's sum in
another order); whole decodes' tokens exactly, log-probs within 1e-5 at
non-pad positions (sampling) and 1e-4 (beam, as the other beam tests); the
geometry bit for bit; the box attention's output within 1e-5 and its
gradients within 1e-5 of each gradient's scale; the XE step as
``test_torch_port_train.py`` holds it. Nucleus rows are built with cutoff
sums clear of p (the prefix sums of XLA and ``torch.cumsum`` round in their
own orders), and one crafted near-tie row is held by the rule the card's
checks use: the port's kept set must be valid under its own prefix sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_caption_tpu.config as jax_config
import sparse_caption_tpu.ops.masked as jax_masked
from _torch_port_common import HEADS, KW, R, F, T, V, D, make_inputs, t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.decoding import sample as jax_sample
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.pruning.engine import compute_sparsity_loss as jax_sparsity_loss
from sparse_caption_tpu_torch import config as port_config
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.decoding.sample import modified_sample_logits, sample_next_word
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import TrainState, make_xe_step
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.kernels.beam_topk import beam_topk
from sparse_caption_tpu_torch.kernels.sample_step import parse_sample_method, sample_step
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.models.layers import BoxMultiHeadAttention
from sparse_caption_tpu_torch.ops.attention import box_relational_embedding
from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedLinear, split_params
from sparse_caption_tpu_torch.ops.rng import TrainRandom
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables, to_jax_variables
from test_torch_port_train import CFG as TRAIN_CFG
from test_torch_port_train import SP_TARGET, SP_WEIGHT

KEY = jax.random.PRNGKey(0)
STEP_LP_TOL = 1e-6
SAMPLE_LP_TOL = 1e-5
BEAM_TOL = dict(rtol=1e-4, atol=1e-4)
FLAGS = dict(caption_model="relation_transformer", vocab_size=V, d_model=D, dim_feedforward=KW["dim_feedforward"],
             num_layers=KW["num_layers"], num_heads=HEADS, att_feat_size=F, max_seq_length=T - 1, pad_token_id=0,
             bos_token_id=2, eos_token_id=3)


def _logprobs(seed: int, rows: int = 6, vocab: int = 40, scale: float = 2.0) -> np.ndarray:
    """f32 log-probs of random logits (JAX's log_softmax)."""
    x = np.random.default_rng(seed).normal(size=(rows, vocab)).astype(np.float32) * scale
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _step(lp: np.ndarray, method: str, temperature: float, noise, ban=None):
    """K9's wrapper on CPU tensors (its plain version) for one step: (tokens, chosen log-probs)."""
    n = lp.shape[0]
    seq, seq_lp = torch.zeros(n, 3, dtype=torch.int32), torch.zeros(n, 3)
    prev = torch.zeros(n, dtype=torch.int32) if ban is None else t(ban).int()
    before = launch_counts()
    tok = sample_step(t(lp), prev, torch.ones(n, dtype=torch.bool), seq, seq_lp, 1, temperature=temperature,
                      ban_prev=ban is not None, noise=t(noise), sample_method=method)
    assert launch_counts() == before  # CPU tensors take the plain version
    assert torch.equal(seq[:, 1], tok)
    return tok.numpy(), seq_lp[:, 1].numpy()


# ------------------------------------------------------------- K9's filters
@pytest.mark.parametrize("temperature", [0.5, 1.3])
def test_k9_plain_top_k_keeps_ties_and_matches_jax(temperature):
    """top3: every value at or above the 3rd largest kept, ties at it included
    (row 0: four equal maxima; row 1: two maxima and three equal seconds);
    the filtered values, tokens and chosen (filtered) log-probs as JAX's."""
    x = np.random.default_rng(1).normal(size=(6, 40)).astype(np.float32)
    x[0, [3, 7, 9, 11]] = 4.0
    x[1, [2, 5]] = 5.0
    x[1, [8, 12, 20]] = 4.5
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    ref = np.asarray(jax_sample.modified_sample_logits(jnp.asarray(lp), "top3", temperature))
    got = modified_sample_logits(t(lp), "top3", temperature).numpy()
    np.testing.assert_array_equal(got > -1e29, ref > -1e29)
    assert (got[0] > -1e29).sum() == 4 and (got[1] > -1e29).sum() == 5 and ((got[2:] > -1e29).sum(1) == 3).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=STEP_LP_TOL)
    key = jax.random.PRNGKey(7)
    ref_tok, ref_lp = (np.asarray(a) for a in jax_sample.sample_next_word(jnp.asarray(lp), "top3", temperature, key))
    tok, chosen = _step(lp, "top3", temperature, np.asarray(jax.random.gumbel(key, lp.shape)))
    np.testing.assert_array_equal(tok, ref_tok)
    np.testing.assert_allclose(chosen, ref_lp, rtol=0, atol=STEP_LP_TOL)


@pytest.mark.parametrize("p", [0.3, 0.9])
def test_k9_plain_nucleus_matches_jax(p):
    """top<p>: the kept prefix, the renormalised log-probs, tokens and chosen
    (filtered) log-probs as JAX's, at temperature 0.7 with the previous
    token banned, on rows whose cutoff sums lie clear of p."""
    lp = _logprobs(2, rows=8, vocab=48, scale=0.7)
    ban = np.arange(8) + 4
    banned = lp.copy()
    banned[np.arange(8), ban] += np.float32(-1e30)
    method = f"top{p}"
    ref = np.asarray(jax_sample.modified_sample_logits(jnp.asarray(banned), method, 0.7))
    # the rows' cutoff sums, in f64 on JAX's probabilities: clear of p by far more than f32 rounding
    probs = np.asarray(jax.nn.softmax(jnp.asarray(banned) / np.float32(0.7), axis=-1)).astype(np.float64)
    csum = np.cumsum(-np.sort(-probs, axis=1), axis=1)
    assert (np.abs(csum - p).min(axis=1) > 1e-4).all()
    got = modified_sample_logits(t(banned), method, 0.7).numpy()
    np.testing.assert_array_equal(got > -1e29, ref > -1e29)
    assert 1 < (got > -1e29).sum(1).min() and (got > -1e29).sum(1).max() < 48
    np.testing.assert_allclose(got, ref, rtol=0, atol=STEP_LP_TOL)
    key = jax.random.PRNGKey(8)
    ref_tok, ref_lp = (np.asarray(a) for a in jax_sample.sample_next_word(jnp.asarray(banned), method, 0.7, key))
    tok, chosen = _step(lp, method, 0.7, np.asarray(jax.random.gumbel(key, lp.shape)), ban=ban)
    np.testing.assert_array_equal(tok, ref_tok)
    np.testing.assert_allclose(chosen, ref_lp, rtol=0, atol=STEP_LP_TOL)


def test_k9_plain_nucleus_near_tie_row_keeps_a_valid_prefix():
    """A row whose probabilities halve (1/2, 1/4, 1/8, ...) and p = 7/8: the
    cutoff sum lies within an ulp of p, where XLA's and ``torch.cumsum``'s
    rounding decide. Each side's kept set is a prefix of the stable
    descending order that is valid under its own prefix sums (the sum before
    its last kept entry below p, its own sum at least p), and the two differ
    by at most one entry."""
    probs = np.array([2.0 ** -(i + 1) for i in range(9)] + [2.0 ** -9], np.float64)
    lp = np.log(probs).astype(np.float32)[None]
    p = 0.875
    kept = {}
    for side, out in (("jax", np.asarray(jax_sample.modified_sample_logits(jnp.asarray(lp), f"top{p}", 1.0))),
                      ("port", modified_sample_logits(t(lp), f"top{p}", 1.0).numpy())):
        keep = out[0] > -1e29
        n_keep = int(keep.sum())
        assert keep[:n_keep].all()  # a prefix: the probabilities are already descending
        kept[side] = n_keep
    sorted_p, _ = torch.sort(torch.softmax(t(lp), dim=-1), dim=-1, descending=True, stable=True)
    csum = torch.cumsum(sorted_p, dim=-1)[0].numpy()
    n = kept["port"]
    assert (n == 1 or csum[n - 2] < p) and (n == lp.shape[1] or csum[n - 1] >= p)
    assert abs(kept["port"] - kept["jax"]) <= 1


def test_k9_plain_gumbel_replays_jax_uniforms():
    """The Gumbel method: argmax of the un-tempered log-probs plus
    -log(-log(u + 1e-20) + 1e-20) on JAX's uniforms; the temperature is not
    used and the chosen log-prob is the un-tempered one."""
    lp = _logprobs(3)
    key = jax.random.PRNGKey(9)
    ref_tok, ref_lp = (np.asarray(a) for a in jax_sample.sample_next_word(jnp.asarray(lp), "gumbel", 0.5, key))
    u = np.asarray(jax.random.uniform(key, lp.shape))
    tok, chosen = _step(lp, "gumbel", 0.5, u)
    np.testing.assert_array_equal(tok, ref_tok)
    np.testing.assert_allclose(chosen, ref_lp, rtol=0, atol=STEP_LP_TOL)
    it, lp2 = sample_next_word(t(lp), "gumbel", 1.0, t(u))
    np.testing.assert_array_equal(it.numpy(), ref_tok)
    np.testing.assert_array_equal(lp2.numpy(), lp[np.arange(lp.shape[0]), ref_tok])
    with pytest.raises(ValueError):
        parse_sample_method("top0")
    assert parse_sample_method("top5") == ("topk", 5.0) and parse_sample_method("top0.95") == ("nucleus", 0.95)


# ------------------------------------------------------------- sampling decode
def _ort(seed: int = 0, trig: bool = True, mask_cfg=None):
    """(JAX ORT, its variables, the port's model with them), both from ``from_config``."""
    flags = dict(FLAGS, no_box_trigonometric_embedding=not trig)
    inputs = make_inputs(seed=seed)
    jm = JaxORT.from_config(jax_config.Config(**flags), mask_cfg=mask_cfg[0] if mask_cfg else None)
    jv = to_numpy(jm.init({"params": KEY}, *(jnp.asarray(a) for a in (inputs[0], inputs[1], inputs[3], inputs[2]))))
    port = get_model("relation_transformer").from_config(port_config.Config(**flags), device="cpu",
                                                          mask_cfg=mask_cfg[1] if mask_cfg else None)
    return jm, jv, load_jax_variables(port, jv), inputs


@pytest.mark.parametrize("constraint", [0, 1])
@pytest.mark.parametrize("method", ["top3", "top0.9", "gumbel"])
def test_generate_sample_methods_match_jax(method, constraint):
    """``generate`` with 3 samples an image at temperature 0.7: JAX's draws
    replayed per step (its ``split`` sequence, sample.py:148-153); tokens
    identical, log-probs within 1e-5 at non-pad positions."""
    jm, jv, port, (att, amask, boxes, _) = _ort(seed=6)
    rows, length = 3, FLAGS["max_seq_length"]
    opt = {"num_random_sample": rows, "beam_size": 0, "temperature": 0.7, "sample_method": method,
           "decoding_constraint": constraint}
    memory = jm.apply(jv, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    key = jax.random.PRNGKey(31)
    ref_seq, ref_lp = (np.asarray(a) for a in jax_generate(jm, jv, memory, opt, rng=key))
    draw = jax.random.uniform if method == "gumbel" else jax.random.gumbel
    k, noise = key, []
    for _ in range(length):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(draw(sub, (2 * rows, V))))
    seq, lp = generate(port, port.encode(t(att), t(amask), t(boxes)), opt, noise=lambda step: t(noise[step]))
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    valid = ref_seq != 0
    np.testing.assert_allclose(lp.numpy()[valid], ref_lp[valid], rtol=0, atol=SAMPLE_LP_TOL)
    if constraint:
        s = seq.numpy()
        assert not (s[..., 1:] == s[..., :-1])[s[..., 1:] != 0].any()


# ------------------------------------------------------------- diverse beam
def test_k4_plain_diversity_penalty_matches_jax_bit_for_bit():
    """K4's plain version with the diverse-beam penalty (beam.py:176-184): 3
    images x 4 rows, 5 earlier-group tokens an image, some repeated (a word
    twice or three times), lambda 0.3, after the ban, bad-ending and UNK
    penalties: values and indices bit for bit as JAX's f32 top-k of the same
    log-probs penalised by beam.py's ops (the log-softmax itself is torch's
    on both sides: XLA's rounds apart in the last bit now and then), raw
    log-probs un-penalised. Subtracting lambda once per occurrence rounds
    differently (count x lambda is formed first)."""
    rng = np.random.default_rng(4)
    b, k, vocab, lam = 3, 4, 200, 0.3
    logits = rng.normal(size=(b * k, vocab)).astype(np.float32) * 3
    toks = rng.integers(4, vocab, size=(b, 5)).astype(np.int32)
    toks[:, 1] = toks[:, 0]  # repeated across earlier beams
    toks[0, 2] = toks[0, 0]
    lp = jnp.asarray(torch.log_softmax(t(logits), dim=-1).numpy())
    prev = rng.integers(4, vocab, size=b * k).astype(np.int32)
    bad = np.arange(b * k) % 3 == 0
    c = lp + jax.nn.one_hot(prev, vocab) * -1e18
    c = c + jnp.where(bad[:, None] & (jnp.arange(vocab)[None] == 3), -1e18, 0.0)
    c = c.at[:, 1].add(-1000.0)
    change = jnp.sum(jax.nn.one_hot(jnp.asarray(toks), vocab), axis=1)
    c = c - jnp.repeat(change, k, axis=0) * lam
    ref_vals, ref_idx = (np.asarray(a) for a in jax.lax.top_k(c, k))
    vals, idx, raw = beam_topk(t(logits), k, ban_token=t(prev), ban_eos=t(bad), eos_id=3, unk_id=1,
                               div_tokens=t(toks), div_lambda=lam)
    np.testing.assert_array_equal(vals.numpy(), ref_vals)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(raw.numpy(), np.take_along_axis(np.asarray(lp), ref_idx, axis=1))
    # the penalised rows' values at the repeated words: count-first, not lambda per occurrence
    once = np.asarray(lp)[0, toks[0, 0]] - np.float32(lam) - np.float32(lam) - np.float32(lam)
    first = np.asarray(lp)[0, toks[0, 0]] - np.float32(3 * np.float32(lam))
    assert once != first  # the two orders round apart at this entry
    c_port = torch.log_softmax(t(logits), -1)[0, int(toks[0, 0])] - torch.tensor(3.0) * lam
    assert float(c_port) == float(first)


@pytest.mark.parametrize("beam,group", [(4, 2), (6, 3)])
def test_diverse_generate_matches_jax(beam, group):
    """Diverse beam search (lambda 0.5): groups of beam / group beams run one
    after another, each penalised by the earlier groups' staggered live
    tokens. Tokens identical to the JAX package's, log-probs within 1e-5."""
    jm, jv, port, (att, amask, boxes, _) = _ort(seed=7)
    opt = {"beam_size": beam, "group_size": group, "diversity_lambda": 0.5}
    memory = jm.apply(jv, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, ref_lp = (np.asarray(a) for a in jax_generate(jm, jv, memory, opt))
    before = launch_counts()
    seq, lp = generate(port, port.encode(t(att), t(amask), t(boxes)), opt)
    assert launch_counts() == before
    assert seq.shape == (2, beam, FLAGS["max_seq_length"])
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=0, atol=1e-5)


# ------------------------------------------------------------- raw geometry
def test_raw_box_relational_embedding_matches_jax_bit_for_bit():
    """The four log-deltas in f32: their arguments are the same IEEE
    operations, so the values agree bit for bit but for the log's last bit
    (torch's and XLA's logs round apart now and then): at most one ulp, and
    exactly at the clamps (a box against itself and a twin box)."""
    _, _, boxes, _ = make_inputs(seed=8, batch=3)
    boxes[2, 1] = boxes[2, 0]  # a twin box: centre offsets 0, clamped at 1e-3
    ref = np.asarray(jl.box_relational_embedding(jnp.asarray(boxes), trigonometric=False))
    got = box_relational_embedding(t(boxes), trigonometric=False).numpy()
    assert got.shape == (3, R, R, 4)
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    assert (got == ref).mean() > 0.8
    clamp = np.float32(np.log(np.float32(1e-3)))
    assert got[0, 1, 1, 0] == ref[0, 1, 1, 0] and got[2, 1, 0, 0] == ref[2, 1, 0, 0]
    assert abs(got[2, 1, 0, 0] - clamp) <= abs(np.spacing(clamp))


def _bounded_raw_wg(rng, h):
    """A (4, h) raw-geometry kernel with |wg . geo| <= 0.85 on these boxes
    (|log-delta| <= 6.9 for x and y, <= 3 for w and h) and a bias of 1: w_g
    in [0.15, 1.85], away from the clamp's kink."""
    kernel = np.stack([rng.choice([-0.04, 0.04], h), rng.choice([-0.04, 0.04], h), rng.choice([-0.05, 0.05], h),
                       rng.choice([-0.05, 0.05], h)]).astype(np.float32)
    return kernel, np.ones(h, np.float32)


def test_raw_box_attention_layer_forward_and_gradients_match_jax():
    """``BoxMultiHeadAttention(trigonometric_embedding=False)`` against the JAX
    layer (dim_g 4, a (4 -> h) wg): the output and the gradients of x and of
    every weight, the (h, 4) wg included."""
    rng = np.random.default_rng(9)
    att, amask, boxes, _ = make_inputs(seed=9)
    x = rng.normal(size=(2, R, D)).astype(np.float32)
    go = rng.normal(size=(2, R, D)).astype(np.float32)
    jlayer = jl.BoxMultiHeadAttention(num_heads=HEADS, d_model=D, trigonometric_embedding=False, dropout_rate=0.0)
    jmask = jnp.asarray(amask)[:, None, None, :]
    params = to_numpy(jlayer.init(KEY, jnp.asarray(x), jnp.asarray(boxes), jmask))["params"]
    params["wg"]["kernel"], params["wg"]["bias"] = _bounded_raw_wg(rng, HEADS)
    assert params["wg"]["kernel"].shape == (4, HEADS)

    def jfn(p, x_):
        return jlayer.apply({"params": p}, x_, jnp.asarray(boxes), jmask)

    ref, vjp = jax.vjp(jfn, params, jnp.asarray(x))
    ref_gp, ref_gx = vjp(jnp.asarray(go))
    port = BoxMultiHeadAttention(HEADS, D, 0.0, trigonometric_embedding=False, device="cpu")
    assert port.wg.weight.shape == (HEADS, 4)
    with torch.no_grad():
        for name, leaf in params.items():
            getattr(port, name).weight.copy_(t(leaf["kernel"].T))
            getattr(port, name).bias.copy_(t(leaf["bias"]))
    px = t(x).requires_grad_()
    out = port(px, t(boxes), t(amask) != 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    out.backward(t(go))
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(ref_gp))
    scale = lambda g: 1e-5 * float(np.abs(g).max()) + 1e-6 * top  # noqa: E731  k_proj's bias: 0 but for rounding
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(ref_gx), rtol=1e-5, atol=scale(ref_gx))
    for name, leaf in ref_gp.items():
        lin = getattr(port, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(), np.asarray(leaf["kernel"]).T, rtol=1e-5,
                                   atol=scale(leaf["kernel"]), err_msg=name)
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(leaf["bias"]), rtol=1e-5,
                                   atol=scale(leaf["bias"]), err_msg=name)
    assert float(port.wg.weight.grad.abs().max()) > 1e-4  # the raw geometry's gradient is real


def test_raw_box_attention_bf16_log_bias_matches_jax():
    """bf16: the four f32 log-deltas enter wg rounded to bf16 (layers.py:427),
    the product rounded before the bias add, relu, clamp and log in bf16:
    K1's log-bias (its plain version) bit for bit against JAX's."""
    from sparse_caption_tpu_torch.kernels.box_attention import box_log_bias_plain, log_bias_from_geometry

    rng = np.random.default_rng(10)
    _, _, boxes, _ = make_inputs(seed=10)
    kernel, bias = _bounded_raw_wg(rng, HEADS)
    kernel[:, 0] *= 40  # one head past relu's kink: the clamp
    geo32 = jl.box_relational_embedding(jnp.asarray(boxes), trigonometric=False)
    wg = jl.MaskedDense(HEADS, dtype=jnp.bfloat16)
    w_g = jax.nn.relu(wg.apply({"params": {"kernel": jnp.asarray(kernel, jnp.bfloat16),
                                           "bias": jnp.asarray(bias, jnp.bfloat16)}}, geo32.astype(jnp.bfloat16)))
    ref = np.asarray(jnp.log(jnp.maximum(w_g, 1e-6)).transpose(0, 3, 1, 2).astype(jnp.float32))
    # JAX's f32 geometry through the port's cast points (the logs may differ in the last f32 bit, which can
    # move a bf16 rounding: test_raw_box_relational_embedding_matches_jax_bit_for_bit)
    got = log_bias_from_geometry(t(np.asarray(geo32)), t(kernel.T).to(torch.bfloat16), t(bias).to(torch.bfloat16),
                                 torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert (ref[:, 0] == np.float32(jnp.log(jnp.asarray(1e-6, jnp.bfloat16)))).any()
    plain = box_log_bias_plain(t(boxes), t(kernel.T).to(torch.bfloat16), t(bias).to(torch.bfloat16), torch.bfloat16)
    assert (plain == got).float().mean() > 0.99


def test_raw_ort_encode_and_beam5_match_jax():
    """A raw-geometry ORT built by both packages' ``from_config`` with
    ``no_box_trigonometric_embedding``: its (h, 4) wg, the encoded memory
    and beam-5 tokens identical to the JAX package's (log-probs 1e-4)."""
    jm, jv, port, (att, amask, boxes, _) = _ort(seed=11, trig=False)
    assert not port.box_trigonometric_embedding and jm.box_trigonometric_embedding is False
    assert port.box_encoder_layers[0].self_attn.wg.weight.shape == (HEADS, 4)
    memory = jm.apply(jv, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    enc = port.encode(t(att), t(amask), t(boxes))
    np.testing.assert_allclose(enc["memory"].numpy(), np.asarray(memory["memory"]), rtol=1e-5, atol=1e-5)
    ref_seq, ref_lp = (np.asarray(a) for a in jax_generate(jm, jv, memory, {"beam_size": 5}))
    seq, lp = generate(port, enc, {"beam_size": 5})
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, **BEAM_TOL)


class ReplayRandom(TrainRandom):
    """JAX's recorded mask uniforms (the (in, out) kernel layout, transposed
    for a Linear) and dropout keep-masks, each handed out in call order."""

    def __init__(self, uniforms, keeps):
        super().__init__(torch.Generator())
        self.uniforms, self.keeps = list(uniforms), list(keeps)

    def mask_uniform(self, layer, shape, device):
        u = self.uniforms.pop(0)
        u = np.ascontiguousarray(u.T if isinstance(layer, MaskedLinear) else u)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return t(u)

    def keep_mask(self, shape, keep_prob, device, site=None):
        m = self.keeps.pop(0)
        assert tuple(m.shape) == tuple(shape), (m.shape, shape)
        return torch.from_numpy(m.copy())


def test_raw_ort_supermask_xe_step_matches_jax(monkeypatch):
    """One f32 XE step of the raw-geometry supermask ORT (``from_config``,
    dropout 0.1 / 0.5, ``test_torch_port_train.py``'s noam, clip and
    sparsity target): JAX's 37 mask uniforms, the (4, h) wg masks among
    them, and its 22 dropout keep-masks replayed; loss within 1e-5 relative,
    every weight's and mask's gradient within 1e-5 of its tensor's largest
    entry plus 1e-7 of the largest gradient of all; the geometry weights
    bounded away from the kink (``_bounded_raw_wg``)."""
    mask_cfgs = (jax_masked.MaskConfig("supermask", 5.0), MaskConfig("supermask", 5.0, keep_masks=True))
    jm, jv, port, inputs = _ort(seed=12, trig=False, mask_cfg=mask_cfgs)
    att, amask, boxes, seqs = inputs
    rng = np.random.default_rng(12)
    for i in range(FLAGS["num_layers"]):
        wg = jv["params"][f"box_encoder_layers_{i}"]["self_attn"]["wg"]
        wg["kernel"], wg["bias"] = _bounded_raw_wg(rng, HEADS)
    jv["masks"] = jax.tree.map(lambda m: rng.normal(0.0, 2.0, size=m.shape).astype(np.float32), jv["masks"])
    load_jax_variables(port, jv)
    assert port.box_encoder_layers[1].self_attn.wg.mask.shape == (HEADS, 4)
    seq_masks = (seqs != 0).astype(np.float32)
    uniforms, keeps, inside = [], [], [False]
    real_sample, real_bernoulli = jax_masked.sample_mask, jax.random.bernoulli

    def recording_sample(mask, cfg, train, rng_key):
        if cfg.is_supermask and train:
            uniforms.append(np.asarray(jax.random.uniform(rng_key, mask.shape)))
        inside[0] = True
        try:
            return real_sample(mask, cfg, train, rng_key)
        finally:
            inside[0] = False

    def recording_bernoulli(*args, **kwargs):
        out = real_bernoulli(*args, **kwargs)
        if not inside[0]:
            keeps.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax_masked, "sample_mask", recording_sample)
    monkeypatch.setattr(jax.random, "bernoulli", recording_bernoulli)

    def loss_fn(params, masks):
        lp = jm.apply({"params": params, "masks": masks}, *(jnp.asarray(a) for a in (att, amask, seqs, boxes)),
                      train=True, rngs={"dropout": jax.random.PRNGKey(5), "mask": jax.random.PRNGKey(6)})
        cap = jax_losses.language_model_loss(lp, jnp.asarray(seqs)[:, 1:], jnp.asarray(seq_masks)[:, 1:])
        return cap + jax_sparsity_loss(masks, SP_TARGET, SP_WEIGHT, 0, TRAIN_CFG["max_train_step"], None)[0]

    loss, (gw, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1))(jv["params"], jv["masks"])
    assert len(uniforms) == 3 + 17 * FLAGS["num_layers"] and len(keeps) == 1 + 2 * 4 + 1 + 2 * 6
    ref_grads = convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False)
    cfg = TRAIN_CFG
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), cfg, port_optim.make_schedule(cfg))
    opt_m = port_optim.build_mask_optimizer(masks.values(), cfg, trainable=True)
    step = make_xe_step(port, opt_w, opt_m, cfg)
    batch = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes), seqs=t(seqs).long(), seq_masks=t(seq_masks))
    replay = ReplayRandom(uniforms, keeps)
    state, p_loss, aux = step(TrainState(), batch, replay)
    assert not replay.uniforms and not replay.keeps and state.step == 1
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(ref_grads) == set(named)
    top = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()) + 1e-7 * top, err_msg=name)


def test_raw_wg_bridge_round_trip():
    """The weight bridge with a (4, h) wg and its mask: JAX (4, h) kernels
    become (h, 4) Linear weights and go back unchanged."""
    mask_cfgs = (jax_masked.MaskConfig("supermask", 5.0), MaskConfig("supermask", 5.0, keep_masks=True))
    _, jv, port, _ = _ort(seed=13, trig=False, mask_cfg=mask_cfgs)
    assert jv["params"]["box_encoder_layers_0"]["self_attn"]["wg"]["kernel"].shape == (4, HEADS)
    state = convert_jax_variables(jv, fold_masks=False)
    assert state["box_encoder_layers.0.self_attn.wg.weight"].shape == (HEADS, 4)
    assert state["box_encoder_layers.0.self_attn.wg.mask"].shape == (HEADS, 4)
    back = to_jax_variables(port)
    flat_ref = jax.tree_util.tree_flatten_with_path(jv)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)
