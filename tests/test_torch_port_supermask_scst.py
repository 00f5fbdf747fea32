"""Supermask SCST slice of the PyTorch port against the JAX package on the
CPU: the keyed supermask draws (K5's keyed mode, plain version), the
backward of the decode step's self-attention (K2) and cross-attention (K3),
plain versions, and one whole SCST step of a supermask ORT and of a
supermask Up-Down against the JAX package's differentiable decode scan.

Random bits cannot be shared between the frameworks: the JAX side's mask
uniforms are recorded by patching ``sparse_caption_tpu.ops.masked.sample_mask``
while its jitted gradient runs the train-mode decode (each draw sent to the
host by ``jax.debug.callback``, which makes the scan's step keys concrete),
each under its layer's path and decode step (none in the encode and the
cross K/V projection), and handed to the port by a ``KeyedStream`` whose
``mask_draw`` looks them up by (layer, step).
The models run at dropout 0 there; the port-internal replay test holds the
gradient pass to the sampling decode with dropout on.

Tolerances: the K2 / K3 backward plain versions 1e-5 absolute against
``jax.vjp`` (f32, summation order only); the whole step as
``tests/test_torch_port_scst.py`` holds the mask_freeze ORT's: rewards rtol
1e-5 / atol 1e-6, loss 1e-5 relative, each gradient (weights and masks)
within 1e-5 of its tensor's largest entry plus 1e-6 of the largest gradient
of all, weights after the Adam update within 1e-7 + 1e-6 |p| (plus 2 lr
where the gradient is within its tolerance of 0). The gradient pass's
log-probs equal the sampling decode's exactly (the same plain functions on
the same inputs).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparse_caption_tpu.ops.masked as jax_masked
from _torch_port_common import KW, make_inputs, t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.engine import optim as jax_optim
from sparse_caption_tpu.models import up_down as jud
from sparse_caption_tpu.models.layers import MultiHeadAttention as JaxMHA
from sparse_caption_tpu.models.layers import scaled_dot_attention
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.scst import device_reward as devr
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine import training as port_training
from sparse_caption_tpu_torch.engine.training import TrainState, make_scst_step, scan_log_probs
from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
from sparse_caption_tpu_torch.kernels import supermask as k5
from sparse_caption_tpu_torch.kernels.keyed_dropout import philox4x32_10
from sparse_caption_tpu_torch.metrics.cider import build_df_pickle, load_df_pickle
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedLinear, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, decode_train_keys, site_id, slot_site
from sparse_caption_tpu_torch.scst import device_reward as port_devr
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

GRAD_TOL = 1e-5
BLEU = (0.0, 0.0, 0.0, 1.0)


# --------------------------------------------------------------- keyed draws
def test_keyed_uniform_plain_is_philox_words():
    """Element e draws word e % 4 of Philox4x32-10 (site, t, e // 4, 0) under
    the key; u is its top 24 bits x 2**-24 (Random123's known answer at the
    zero key and counter)."""
    key, site, tt, n = 0x0123456789ABCDEF, 0xCAFEF00D, 7, 23
    u = k5.keyed_uniform_plain(k5.KeyedDraw(key, site, tt), n, "cpu")
    e = torch.arange(n, dtype=torch.int64)
    words = torch.stack(philox4x32_10(torch.full_like(e, site), torch.full_like(e, tt), e // 4, torch.zeros_like(e),
                                      key), dim=-1)
    bits = words.gather(1, (e % 4)[:, None])[:, 0]
    assert u.dtype == torch.float32 and torch.equal(u, (bits >> 8).float() / 2 ** 24)
    zero = k5.keyed_uniform_plain(k5.KeyedDraw(0, 0, 0), 4, "cpu")
    want = [w >> 8 for w in (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)]
    assert zero.tolist() == [w / 2 ** 24 for w in want]
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_keyed_stream_mask_draws():
    """A layer's draw is a pure function of (key, its site at the slot, t):
    the same at the same step, another at another step or slot; the stream's
    ``mask_uniform`` is the draw's plain uniforms in the weight's layout."""
    layer = MaskedLinear(5, 3, mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    with pytest.raises(ValueError, match="mask_site"):
        KeyedStream(9).mask_draw(layer, (3, 5), "cpu")
    layer.mask_site = site_id("decoder_layers.0.feed_forward.w_1")
    stream = KeyedStream(9)
    d3 = stream.at(3).mask_draw(layer, (3, 5), "cpu")
    assert d3 == k5.KeyedDraw(9, layer.mask_site, 3) == stream.at(3).mask_draw(layer, (3, 5), "cpu")
    assert stream.mask_draw(layer, (3, 5), "cpu").t == 0
    assert stream.at(3).for_slot(2).mask_draw(layer, (3, 5), "cpu").site == slot_site(layer.mask_site, 2)
    u3, u4 = stream.at(3).mask_uniform(layer, (3, 5), "cpu"), stream.at(4).mask_uniform(layer, (3, 5), "cpu")
    assert u3.shape == (3, 5) and torch.equal(u3.flatten(), k5.keyed_uniform_plain(d3, 15, "cpu"))
    assert not torch.equal(u3, u4)


@pytest.mark.parametrize("bypass", [False, True])
def test_keyed_set_is_the_sample_mode_on_its_uniforms(bypass):
    """K5's keyed mode (plain version) equals the sample mode given the draws'
    uniforms: w_eff exact, gradients exact; a mixed or malformed draw raises."""
    g = torch.Generator().manual_seed(3)
    shapes = [(8, 64), (1, 512), (7, 13)]
    ws = [torch.randn(*s, generator=g, requires_grad=True) for s in shapes]
    ms = [(2 * torch.randn(*s, generator=g)).requires_grad_() for s in shapes]
    draws = [k5.KeyedDraw(2 ** 64 - 5, 11 + i, 4) for i in range(len(shapes))]
    keyed = k5.supermask_weights(ws, ms, draws, "keyed", bypass)
    sampled = k5.supermask_weights(ws, ms, [d.uniform(s, "cpu") for d, s in zip(draws, shapes)], "sample", bypass)
    gs = [torch.randn(*s, generator=g) for s in shapes]
    gk = torch.autograd.grad(keyed, ws + ms, gs)
    gp = torch.autograd.grad(sampled, ws + ms, gs)
    for a, b in zip(keyed + list(gk), sampled + list(gp)):
        assert torch.equal(a, b)
    assert 0.2 < float(torch.cat([k.flatten() != 0 for k in keyed]).float().mean()) < 0.8
    with pytest.raises(TypeError, match="KeyedDraw"):
        k5.supermask_weights(ws, ms, [torch.rand(*s) for s in shapes], "keyed")
    with pytest.raises(ValueError, match="out of range"):
        k5.supermask_weights(ws[:1], ms[:1], [k5.KeyedDraw(-1, 0, 0)], "keyed")


# ------------------------------------------------------ K2 / K3 backward
def _to_jax(x):
    return jnp.asarray(x.detach().numpy())


@pytest.mark.parametrize("step", [0, 3, 6])
def test_k2_backward_plain_matches_jax_vjp(step):
    """K2's backward plain version against ``jax.vjp`` of the attention of the
    JAX package's ``decode_self`` (``scaled_dot_attention`` over the cache,
    slots <= t valid): dq, and dK / dV of slots 0..t added into the cache
    gradient the later steps left, slot t's total as dk_t / dv_t, slot t of
    the buffer zeroed and the slots past t untouched. t = 0 attends one slot."""
    g = torch.Generator().manual_seed(step)
    n, h, t_max, dk = 6, 2, 7, 16
    q, ck, cv = (torch.randn(*s, generator=g) for s in ((n, h, dk), (n, h, t_max, dk), (n, h, t_max, dk)))
    dout = torch.randn(n, h, dk, generator=g)
    dck0, dcv0 = torch.randn(n, h, t_max, dk, generator=g), torch.randn(n, h, t_max, dk, generator=g)
    dck, dcv = dck0.clone(), dcv0.clone()
    dq, dk_t, dv_t = k2.ancestry_self_attention_backward(q, ck, cv, dout, dck, dcv, step)

    valid = (jnp.arange(t_max) <= step)[None, None, None, :]
    _, vjp = jax.vjp(lambda a, b, c: scaled_dot_attention(a[:, :, None], b, c, mask=valid)[:, :, 0],
                     _to_jax(q), _to_jax(ck), _to_jax(cv))
    jq, jk, jv = (torch.from_numpy(np.array(x)) for x in vjp(_to_jax(dout)))
    tol = dict(rtol=0, atol=1e-5)
    torch.testing.assert_close(dq, jq, **tol)
    torch.testing.assert_close(dk_t, dck0[:, :, step] + jk[:, :, step], **tol)
    torch.testing.assert_close(dv_t, dcv0[:, :, step] + jv[:, :, step], **tol)
    torch.testing.assert_close(dck[:, :, :step], dck0[:, :, :step] + jk[:, :, :step], **tol)
    torch.testing.assert_close(dcv[:, :, :step], dcv0[:, :, :step] + jv[:, :, :step], **tol)
    assert not dck[:, :, step].any() and not dcv[:, :, step].any()
    assert torch.equal(dck[:, :, step + 1:], dck0[:, :, step + 1:]) and torch.equal(dcv[:, :, step + 1:],
                                                                                     dcv0[:, :, step + 1:])
    assert float(jk[:, :, step + 1:].abs().max() if step + 1 < t_max else 0.0) == 0.0  # masked slots: no gradient


def test_decode_self_steps_chain_cache_gradients():
    """Steps 0..T-1 of ``decode_self_attention`` with gradients (the cache
    threaded through ``DecodeSelfStep``): each step's k_t, v_t and q get the
    gradient of the same computation written out of place (every step
    attends a fresh stack of the slots so far)."""
    g = torch.Generator().manual_seed(5)
    n, h, steps, dk = 3, 2, 5, 8
    qs, ks, vs = ([torch.randn(n, h, dk, generator=g, requires_grad=True) for _ in range(steps)] for _ in range(3))
    douts = [torch.randn(n, h, dk, generator=g) for _ in range(steps)]
    ck, cv = torch.zeros(n, h, steps + 2, dk), torch.zeros(n, h, steps + 2, dk)
    outs = [k2.decode_self_attention(qs[i], ks[i], vs[i], ck, cv, None, i) for i in range(steps)]
    got = torch.autograd.grad(outs, qs + ks + vs, douts)
    ref_outs = [k2.ancestry_self_attention_plain(qs[i], torch.stack(ks[: i + 1], 2), torch.stack(vs[: i + 1], 2),
                                                 None, i) for i in range(steps)]
    want = torch.autograd.grad(ref_outs, qs + ks + vs, douts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for i in range(steps):
        torch.testing.assert_close(outs[i], ref_outs[i], rtol=0, atol=1e-6)


def test_k3_backward_plain_matches_jax_vjp():
    """K3's backward plain version against ``jax.vjp`` of the JAX package's
    ``decode_cross`` (identity q / out projections, so its attention alone):
    dq of every row, dK / dV of each image summed over its 3 rows; padded
    regions get dK = 0, and image 2, which has no valid region, attends its
    regions uniformly: dV = dout's mean share, dK = 0."""
    g = torch.Generator().manual_seed(1)
    b, rep, h, s, dk = 3, 3, 2, 5, 8
    d = h * dk
    q = torch.randn(b * rep, h, dk, generator=g)
    mk, mv = torch.randn(b, h, s, dk, generator=g), torch.randn(b, h, s, dk, generator=g)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[1, 3:] = False
    mask[2] = False
    dout = torch.randn(b * rep, h, dk, generator=g)
    dq, dmk, dmv = k3.grouped_cross_attention_backward(q, mk, mv, mask, dout)

    mha = JaxMHA(num_heads=h, d_model=d, dropout_rate=0.0)
    eye = {"kernel": jnp.eye(d), "bias": jnp.zeros(d)}
    params = {"params": {name: eye for name in ("q_proj", "k_proj", "v_proj", "out_proj")}}
    jmask = jnp.asarray(mask.numpy())[:, None, None, :].astype(jnp.float32)
    _, vjp = jax.vjp(lambda x, a, c: mha.apply(params, x, a, c, jmask, method="decode_cross"),
                     _to_jax(q.reshape(b * rep, 1, d)), _to_jax(mk), _to_jax(mv))
    jq, jk, jv = (torch.from_numpy(np.array(x)) for x in vjp(_to_jax(dout.reshape(b * rep, 1, d))))
    tol = dict(rtol=0, atol=1e-5)
    torch.testing.assert_close(dq, jq.reshape(b * rep, h, dk), **tol)
    torch.testing.assert_close(dmk, jk, **tol)
    torch.testing.assert_close(dmv, jv, **tol)
    assert not dmk[1, :, 3:].any() and not dmk[2].any() and not dmv[1, :, 3:].any()
    torch.testing.assert_close(dmv[2], dout[2 * rep:].sum(0)[:, None, :].expand(h, s, dk) / s, **tol)
    q.requires_grad_()
    out = k3.grouped_cross_attention(q, mk, mv, mask)  # with gradients: K3's autograd Function
    assert out.grad_fn is not None and torch.equal(torch.autograd.grad(out, q, dout)[0], dq)


def test_unported_backwards_raise():
    """K2's and K3's backward in bf16 raise on every device (the JAX
    package's SCST step runs in f32); their kv modes (once refused) and K2's
    backward through the ancestry map give the autograd of the plain forward
    (the one cache or memory read as K and V gets both terms)."""
    q = torch.randn(4, 2, 8, requires_grad=True)
    cache = torch.zeros(4, 2, 5, 8)
    anc = torch.zeros(2, 2, 5, dtype=torch.int32)
    anc[:, :, 1] = torch.arange(2, dtype=torch.int32)  # step 1 reads slot 0 of beam 0, slot 1 of its own row
    k0 = torch.randn(4, 2, 8)
    ck, cv = cache.clone(), cache.clone()
    ck[:, :, 0], cv[:, :, 0] = k0, 2 * k0
    out = k2.decode_self_attention(q, q, q, ck, cv, anc, 1)
    (got,) = torch.autograd.grad(out.sum(), q)
    ref = k2.ancestry_self_attention_plain(q, torch.stack([k0, q], 2), torch.stack([2 * k0, q], 2),
                                           anc[:, :, :2].contiguous(), 1)
    (want,) = torch.autograd.grad(ref.sum(), q)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for m in (anc, None):  # the kv mode: slot 1 is q itself, read as K and V
        kv_cache = cache.clone()
        kv_cache[:, :, 0] = k0
        out = k2.decode_self_attention(q, q, None, kv_cache, None, m, 1)
        (got,) = torch.autograd.grad(out.sum(), q)
        stack = torch.stack([k0, q], 2)
        ref = k2.ancestry_self_attention_plain(q, stack, None, None if m is None else m[:, :, :2].contiguous(), 1)
        (want,) = torch.autograd.grad(ref.sum(), q)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    qb = q.detach().bfloat16().requires_grad_()
    with pytest.raises(NotImplementedError, match="f32"):
        k2.decode_self_attention(qb, qb, qb, cache.bfloat16(), cache.bfloat16(), None, 0)
    with pytest.raises(NotImplementedError, match="f32"):
        k2.decode_self_attention(qb, qb, None, cache.bfloat16(), None, None, 0)
    mem = torch.randn(2, 2, 3, 8, requires_grad=True)
    mask = torch.ones(2, 3, dtype=torch.bool)
    out = k3.grouped_cross_attention(q, mem, None, mask)
    got = torch.autograd.grad(out.sum(), (q, mem))
    want = torch.autograd.grad(k3.grouped_cross_attention_plain(q, mem, mem, mask).sum(), (q, mem))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="f32"):
        k3.grouped_cross_attention(qb, mem.bfloat16(), mem.bfloat16(), mask)
    with pytest.raises(NotImplementedError, match="f32"):
        k3.grouped_cross_attention(qb, mem.bfloat16(), None, mask)
    with torch.no_grad():  # without gradients the forward takes them all
        assert k3.grouped_cross_attention(qb, mem.bfloat16(), None, mask).shape == q.shape


# --------------------------------------------------- whole step against JAX
def _port_name(path) -> str:
    return ".".join(path).replace("_layers_", "_layers.").replace("logit_0", "logit.0")


class _Recorder:
    """Records the JAX side's supermask uniforms by (port layer name, decode
    step); the step is the decode loop's ``t`` (decoding/sample.py or beam.py), none
    outside it (the encode, the cross K/V projection of ``init_cache``).
    Inside the traced scan the keys and t are abstract, so each draw reaches
    the host by ``jax.debug.callback`` when the step runs."""

    def __init__(self, monkeypatch):
        self.uniforms = {}
        real = jax_masked.sample_mask
        loops = (os.path.join("decoding", "sample.py"), os.path.join("decoding", "beam.py"))

        def store(name, u, step=None):
            key = (name, None if step is None else int(step))
            u = np.asarray(u)
            assert key not in self.uniforms or np.array_equal(self.uniforms[key], u), key
            self.uniforms[key] = u

        def recording(mask, cfg, train, rng_key):
            if cfg.is_supermask and train:
                name = _port_name(sys._getframe(1).f_locals["self"].path)
                frame, step = sys._getframe(1), None
                while frame is not None:
                    if frame.f_code.co_name == "body" and frame.f_code.co_filename.endswith(loops):
                        step = frame.f_locals["t"]
                        break
                    frame = frame.f_back
                u = jax.random.uniform(rng_key, mask.shape)
                jax.debug.callback(lambda *a, name=name: store(name, *a), u, *(() if step is None else (step,)))
            return real(mask, cfg, train, rng_key)

        monkeypatch.setattr(jax_masked, "sample_mask", recording)


class _JaxUniformStream(KeyedStream):
    """A keyed stream whose mask draws are the JAX side's recorded uniforms,
    looked up by (layer name, step); dropout draws stay keyed."""

    def __init__(self, key, uniforms, names):
        super().__init__(key)
        self.uniforms, self.names, self.used = uniforms, names, set()

    def mask_draw(self, layer, shape, device):
        name = self.names[id(layer)]
        u = self.uniforms[(name, self.t)]
        u = u.T if isinstance(layer, MaskedLinear) else u  # Dense kernels are (in, out) in JAX
        assert tuple(u.shape) == tuple(shape), (name, u.shape, shape)
        self.used.add((name, self.t))
        return t(np.ascontiguousarray(u))


def _reward_setup(tmp_path, vocab_size):
    vocab = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(4, vocab_size)]
    tok2id = {w: i for i, w in enumerate(vocab)}
    rng = np.random.default_rng(0)

    def sent():
        return " ".join(rng.choice(vocab[4:], rng.integers(3, 8)))

    df_path = str(tmp_path / "df.p")
    build_df_pickle([[sent() for _ in range(5)] for _ in range(30)], df_path)
    df, ref_len = load_df_pickle(df_path)
    return df, ref_len, [[sent() for _ in range(5)] for _ in range(2)], tok2id


def _ort_setup():
    inputs = make_inputs(seed=4)
    jm = JaxORT(**KW, dropout_rate=0.0, drop_prob_src=0.0, mask_cfg=jax_masked.MaskConfig("supermask", 5.0))
    att, amask, boxes, seqs = inputs
    variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(att), jnp.asarray(amask),
                                 jnp.asarray(seqs), jnp.asarray(boxes)))
    rng = np.random.default_rng(11)
    variables["masks"] = jax.tree.map(lambda m: rng.normal(0.0, 1.5, size=m.shape).astype(np.float32),
                                      variables["masks"])
    port = get_model("relation_transformer_prune")(**KW, dropout_rate=0.0, drop_prob_src=0.0, device="cpu",
                                                   mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    enc = dict(att_feats=att, att_masks=amask, boxes=boxes)
    return jm, variables, load_jax_variables(port, variables), enc, KW["vocab_size"], KW["max_seq_length"]


UD_KW = dict(vocab_size=40, rnn_size=32, input_encoding_size=32, att_hid_size=16, fc_feat_size=12, att_feat_size=12,
             max_seq_length=6)


def _updown_setup():
    """A supermask Up-Down whose init weights are scaled by 3 and biases drawn
    N(0, 0.2), the EOS logit lowered by 2 (captions neither one token
    repeated nor ended at once), mask logits N(0, 1.5)."""
    rng = np.random.default_rng(0)
    att = rng.normal(size=(2, 5, 12)).astype(np.float32)
    fc = rng.normal(size=(2, 12)).astype(np.float32)
    amask = np.ones((2, 5), np.float32)
    amask[1, 3:] = 0.0
    jm = jud.UpDownModel(**UD_KW, drop_prob_lm=0.0, mask_cfg=jax_masked.MaskConfig("supermask", 5.0))
    variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(att), jnp.asarray(amask),
                                 jnp.full((2, 7), 4, jnp.int32), fc_feats=jnp.asarray(fc)))
    rng = np.random.default_rng(21)
    variables["masks"] = jax.tree.map(lambda m: rng.normal(0.0, 1.5, size=m.shape).astype(np.float32),
                                      variables["masks"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, p: (p + rng.normal(0, 0.2, size=p.shape) if path[-1].key == "bias" else 3 * p).astype(np.float32),
        variables["params"])
    variables["params"]["logit_0"]["bias"][3] -= 2.0
    port = get_model("up_down_lstm_prune")(**UD_KW, drop_prob_lm=0.0, device="cpu",
                                           mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    enc = dict(att_feats=att, att_masks=amask, fc_feats=fc)
    return jm, variables, load_jax_variables(port, variables), enc, UD_KW["vocab_size"], UD_KW["max_seq_length"]


SCAN_STEPS = 6  # decode steps of the whole-step test
CFG = dict(lr_scheduler="step", learning_rate=5e-5, optim="adam", grad_clip=0.1, scst_num_samples=3,
           scst_sample="random", scst_baseline="sample", scst_reward="device", seed=8)


@pytest.mark.parametrize("setup", [_ort_setup, _updown_setup], ids=["ort", "updown"])
def test_supermask_scst_step_matches_jax_differentiable_scan(setup, tmp_path, monkeypatch):
    """One SCST step of a supermask model (2 images x 3 samples,
    leave-one-out baseline, CIDEr-D + BLEU-4, step LR 5e-5, Adam, grad clip
    0.1, the mask Adam at lr 100, dropout 0) against the JAX package's
    gradient path for a supermask model: the train-mode encode and sampling
    decode re-run as a differentiable scan inside ``jax.value_and_grad``
    (``engine/training.py:693-703,769``), every layer's Bernoulli drawn under
    the step's key. Its tokens feed the port's ``grad_fn`` (the ORT's scan
    with K2's and K3's backward, Up-Down's unrolled replay), its uniforms
    the port's draws: rewards, loss, every weight's and mask's gradient, and
    every weight after the update."""
    jm, variables, port, enc, vocab, _ = setup()
    steps = SCAN_STEPS
    df, ref_len, gts, tok2id = _reward_setup(tmp_path, vocab)
    recorder = _Recorder(monkeypatch)
    params, masks = variables["params"], variables["masks"]
    opt = {"num_random_sample": 3, "beam_size": 0, "max_seq_length": steps, "decode_train": True,
           "differentiable": True}
    key = jax.random.PRNGKey(17)
    enc_j = {k: jnp.asarray(v) for k, v in enc.items()}
    table_j = devr.DfTable.build(df, ref_len, tok2id)
    pack_j = devr.ref_pack_device(devr.build_ref_pack(gts, df, ref_len, tok2id, vocab_size=vocab))
    score = devr.make_reward_device_fn(table_j, cider_weight=1.0, bleu_weight=BLEU)

    def loss_fn(params, masks):
        """The JAX step's loss on the tokens its own scan samples (the same
        tokens its sampling pass draws under the same key)."""
        v = {"params": params, "masks": masks}
        k_drop, k_mask, k_dec = jax.random.split(key, 3)
        memory = jm.apply(v, **enc_j, train=True, rngs={"dropout": k_drop, "mask": k_mask}, method="encode")
        seq, seq_lp = jax_generate(jm, v, memory, opt, rng=k_dec)
        flat = jax.lax.stop_gradient(seq).reshape(6, steps)
        sc = score(flat, jnp.repeat(jnp.arange(2), 3), table_j.device_arrays(), pack_j)
        rewards = jax.lax.stop_gradient(sc - devr.leave_one_out_baseline(sc, 3))
        loss = jax_losses.reward_loss(seq_lp.reshape(6, steps), (flat != 0).astype(jnp.float32), rewards)
        return loss, (flat, sc, rewards)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    (ref_loss, (flat, sc, rewards)), (gw, gm) = grad_fn(params, masks)
    jax.effects_barrier()
    flat = np.asarray(flat)
    assert (flat != 0).sum() > 12 and len(np.unique(flat)) > 5
    assert sum(step is not None for _, step in recorder.uniforms) > 0

    config = dict(CFG, max_seq_length=steps + 1)
    port_params, port_masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(port_params.values(), config, port_optim.make_schedule(config))
    opt_m = port_optim.build_mask_optimizer(port_masks.values(), config, trainable=True)
    table = port_devr.DfTable.build(df, ref_len, tok2id)
    step = make_scst_step(port, opt_w, opt_m, config, port_devr.make_reward_fn(table, bleu_weight=BLEU))
    names = {id(m): n for n, m in port.named_modules()}
    streams = []

    def jax_stream(k):
        streams.append(_JaxUniformStream(k, recorder.uniforms, names))
        return streams[-1]

    monkeypatch.setattr(port_training, "KeyedStream", jax_stream)
    batch = {k: t(v) for k, v in enc.items()}
    batch["ref_pack"] = port_devr.scst_ref_pack(gts, df, table, tok2id, vocab, "cpu")
    state, loss, aux = step.grad_fn(TrainState(), batch, {"sample": t(flat.reshape(2, 3, steps))})
    assert state.step == 1
    used = set().union(*(s.used for s in streams))
    assert used == set(recorder.uniforms), sorted(set(recorder.uniforms) ^ used)[:5]  # every JAX draw, once each

    np.testing.assert_allclose(float(aux["avg_sample"]), float(jnp.mean(sc)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["avg_reward"]), float(jnp.mean(rewards)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert abs(float(ref_loss)) > 1e-4
    opt_wj = jax_optim.build_weight_optimizer(config, jax_optim.make_schedule(config))
    uw, _ = opt_wj.update(gw, opt_wj.init(params), params)
    new_params = optax.apply_updates(params, uw)
    grads = convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False)
    after = convert_jax_variables(to_numpy({"params": new_params, "masks": masks}), fold_masks=False)
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    top = max(float(g.abs().max()) for g in grads.values())
    lr = config["learning_rate"]
    for name, g in grads.items():
        gtol = GRAD_TOL * float(g.abs().max()) + 1e-6 * top
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0, atol=gtol, err_msg=name)
        if not name.endswith(".mask"):
            noisy = (g.abs() <= gtol).numpy()
            err = np.abs(named[name].detach().numpy() - after[name].numpy())
            allowed = 1e-7 + 2 * lr * noisy + 1e-6 * np.abs(after[name].numpy())
            assert (err <= allowed).all(), f"{name}: worst err/allowed {(err / allowed).max():.3g}"
    mask_grads = [float(named[n].grad.abs().max()) for n in named if n.endswith(".mask")]
    assert min(mask_grads) > 0.0  # the gradient reaches every mask through the decode


# ------------------------------------------------------------ port replay
@pytest.mark.parametrize("family", ["ort", "updown"])
def test_gradient_pass_replays_the_sampling_decode(family, monkeypatch):
    """With dropout on: the gradient pass's log-probs at the sampled tokens
    equal the sampling decode's at every non-pad position, and the two passes
    draw the same keyed masks (key, site, step), every decode step its own."""
    if family == "ort":
        model = get_model("relation_transformer_prune")(**KW, dropout_rate=0.1, drop_prob_src=0.1, device="cpu",
                                                        mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
        att, amask, boxes, _ = make_inputs(seed=4)
        fields = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes))
    else:
        model = get_model("up_down_lstm_prune")(**UD_KW, drop_prob_lm=0.1, device="cpu",
                                                mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
        rng = np.random.default_rng(0)
        fields = dict(att_feats=t(rng.normal(size=(2, 5, 12)).astype(np.float32)), att_masks=torch.ones(2, 5),
                      fc_feats=t(rng.normal(size=(2, 12)).astype(np.float32)))
    _, masks = split_params(model)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in masks.values():
            m.copy_(1.5 * torch.randn(m.shape, generator=g))
    draws = []
    real = KeyedStream.mask_draw

    def logged(self, layer, shape, device):
        draws.append(real(self, layer, shape, device))
        return draws[-1]

    monkeypatch.setattr(KeyedStream, "mask_draw", logged)
    steps = 5
    opt = {"num_random_sample": 3, "beam_size": 0, "max_seq_length": steps, "decode_train": True}
    with torch.no_grad():
        memory = model.encode(**fields, train=True, rng=KeyedStream(11))
        seq, seq_lp = generate(model, memory, opt, rng=12)
    sampled, draws[:] = list(draws), []
    flat = seq.reshape(6, steps)
    memory = model.encode(**fields, train=True, rng=KeyedStream(11))
    if family == "ort":
        lp = scan_log_probs(model, memory, flat, 12)
    else:
        seqs_in = torch.cat([torch.full((6, 1), model.bos_id), flat.long()], 1)
        lp = model.decode_teacher_forced(memory, seqs_in, True, KeyedStream(decode_train_keys(12).dropout))
        lp = lp.gather(2, flat.long()[..., None])[..., 0]
    valid = flat != model.pad_id
    assert lp.requires_grad and int(valid.sum()) > 6
    assert torch.equal(lp.detach()[valid], seq_lp.reshape(6, steps)[valid])
    assert sorted(draws) == sorted(sampled)
    step_draws = [d for d in sampled if d.key == decode_train_keys(12).dropout]
    assert {d.t for d in step_draws} == set(range(steps))
    assert len({d.site for d in step_draws}) == len(step_draws) // steps  # each layer once a step
