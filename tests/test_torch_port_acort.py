"""ACORT in the PyTorch port against the JAX package on the CPU: the kv- and
qk-shared attention layouts (``share_att``), layer sharing (``share_layer``
plans: a model holds one layer per distinct index, each slot calls it), the
one-array decode caches, ``from_config``, the radix tokenizer, the weight
bridge, and an ACORT-shaped model's beam-5 decode and XE step.

The ACORT-shaped model here is a relation transformer of 3 slots over the
plan (0, 0, 1) on both sides at d 32, over a radix vocabulary of base 20 (23
ids: pad 0, digits 1..20, bos 21, eos 22) built from a synthetic word
vocabulary written by the test; ACORT-base itself (d512, 6 slots over 2
layers, base 768) is built from the recipe's flags and its shapes held
against JAX's ``eval_shape``. Weights come from the JAX ``init`` through
``utils/convert_jax.py``; dropout masks are recorded from JAX's
``bernoulli`` calls and replayed into the port in call order."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_caption_tpu.config as jax_config
from _torch_port_common import D, F, HEADS, R, make_inputs, t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.ops.masked import MaskConfig as JaxMaskConfig
from sparse_caption_tpu.tokenizers import get_tokenizer as jax_get_tokenizer
from sparse_caption_tpu_torch import config as port_config
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import TrainState, make_xe_step
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.kernels.ancestry_self_attention import ancestry_self_attention
from sparse_caption_tpu_torch.kernels.box_attention import box_attention
from sparse_caption_tpu_torch.kernels.box_attention_bwd import box_attention_train
from sparse_caption_tpu_torch.kernels.grouped_cross_attention import bf16_smem as k3_bf16_smem
from sparse_caption_tpu_torch.kernels.grouped_cross_attention import grouped_cross_attention
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.models import layers as pl
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, TrainRandom
from sparse_caption_tpu_torch.tokenizers import get_tokenizer
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables, to_jax_variables

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)  # f32, summation order only
BEAM_LP_TOL = 1e-4  # beam log-probs (as tests/test_torch_port_decode.py)
PLAN = (0, 0, 1)
SHARES = ("kv", "qk")
# the ACORT-shaped model's run config (resources/commands_acort.sh's flags at test size)
SMALL_FLAGS = dict(caption_model="relation_transformer", tokenizer="radix", radix_base=20, max_seq_length=10,
                   share_layer_encoder="(0, 0, 1)", share_layer_decoder="(0, 0, 1)", d_model=D, dim_feedforward=64,
                   num_layers=3, num_heads=HEADS, att_feat_size=F)
WORDS = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(56)]  # 57 word slots: 2 digits a word


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _load(layer, jax_vars):
    layer.load_state_dict(convert_jax_variables(to_numpy(jax_vars)))
    return layer


def _boxes(rng, b, r):
    xy = rng.uniform(0, 400, size=(b, r, 2))
    wh = rng.uniform(10, 200, size=(b, r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _configs(tmp_path, words=WORDS, **flags):
    """(JAX config, port config, JAX radix tokenizer, port radix tokenizer) over
    ``words`` written as the word tokenizer's artifact."""
    os.makedirs(tmp_path / "tokenizer", exist_ok=True)
    with open(tmp_path / "tokenizer" / "word.vocab.json", "w") as f:
        json.dump({"model_type": "word", "vocab": list(words)}, f)
    flags = dict(SMALL_FLAGS, **flags)
    jc = jax_config.Config(log_dir=str(tmp_path), **flags)
    pc = port_config.Config(log_dir=str(tmp_path), **flags)
    jt, pt = jax_get_tokenizer("radix")(jc), get_tokenizer("radix")(pc)
    return jc, pc, jt, pt


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("text", ["(0, 0, 0, 1, 1, 1)", "0,0,0,1,1,1", "[0, 1]", "", "()"])
def test_config_helpers_match_jax(text):
    assert port_config.list_of_ints(text) == jax_config.list_of_ints(text)
    for s in ("kv", "none", "Null", "", text):
        assert port_config.str_to_none(s) == jax_config.str_to_none(s)
    assert port_config.list_of_ints("(0, 0, 0, 1, 1, 1)") == [0, 0, 0, 1, 1, 1]


# ---------------------------------------------------------------- layers
def _jax_mha(share, x):
    mha = jl.MultiHeadAttention(num_heads=HEADS, d_model=D, share_att=share)
    return mha, mha.init(KEY, x, x, x)


@pytest.mark.parametrize("share", SHARES)
def test_mha_shared_forward_and_gradients_match_jax(share):
    """Full-sequence attention (K14 / K15's plain version, the one tensor as
    k and v under kv) with a causal and key mask: output and the gradients of
    the input and of every projection."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 6, D)).astype(np.float32)
    valid = np.ones((3, 6), bool)
    valid[1, 4:] = False
    g = rng.normal(size=(3, 6, D)).astype(np.float32)
    mha, jv = _jax_mha(share, jnp.asarray(x))
    assert set(jv["params"]) == set(pl.PROJECTIONS[share]) | {"out_proj"}
    jmask = jnp.asarray(valid)[:, None, None, :] & jnp.tril(jnp.ones((6, 6), bool))[None, None]

    def jfn(params, x_):
        return mha.apply({"params": params}, x_, x_, x_, jmask)

    ref, vjp = jax.vjp(jfn, jv["params"], jnp.asarray(x))
    ref_gp, ref_gx = vjp(jnp.asarray(g))
    port = _load(pl.MultiHeadAttention(HEADS, D, share_att=share), jv)
    px = t(x).requires_grad_()
    out = port(px, px, px, t(valid), causal=True)
    _close(out, ref)
    out.backward(t(g))
    _close(px.grad, ref_gx)
    grads = convert_jax_variables(to_numpy({"params": ref_gp}))
    for name, p in port.named_parameters():
        _close(p.grad, grads[name], rtol=1e-5, atol=1e-5 * float(grads[name].abs().max()))


@pytest.mark.parametrize("share", SHARES)
def test_mha_shared_decode_self_matches_jax(share):
    """decode_self with its layout's cache (one array under kv: K2's kv
    mode, read as K and V) and an ancestor map: output and the written slot."""
    rng = np.random.default_rng(2)
    b, kb, t_max, dk, step = 2, 3, 6, D // HEADS, 3
    n = b * kb
    x_t = rng.normal(size=(n, 1, D)).astype(np.float32)
    ck = rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    cv = None if share == "kv" else rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    anc = rng.integers(0, kb, size=(b, kb, t_max)).astype(np.int32)
    mha, jv = _jax_mha(share, jnp.asarray(x_t))
    ref, ref_k, ref_v = mha.apply(jv, jnp.asarray(x_t), jnp.asarray(ck), None if cv is None else jnp.asarray(cv), step,
                                  method="decode_self",
                                  ancestry_onehot=jax.nn.one_hot(jnp.asarray(anc), kb, dtype=jnp.float32))
    port = _load(pl.MultiHeadAttention(HEADS, D, share_att=share), jv)
    pk, pv = t(ck), None if cv is None else t(cv)
    with torch.no_grad():
        out = port.decode_self(t(x_t), pk, pv, step, t(anc))
        with pytest.raises(ValueError):  # the other layout's cache
            port.decode_self(t(x_t), pk, t(ck) if pv is None else None, step, t(anc))
    _close(out, ref)
    _close(pk, ref_k)
    assert (ref_v is None) == (pv is None)
    if pv is not None:
        _close(pv, ref_v)


@pytest.mark.parametrize("share", SHARES)
def test_mha_shared_decode_cross_matches_jax(share):
    """project_memory_kv ((k, None) under kv) and decode_cross (K3's kv mode
    with mem_v=None) for 3 rows an image."""
    rng = np.random.default_rng(3)
    b, rep = 2, 3
    x_t = rng.normal(size=(b * rep, 1, D)).astype(np.float32)
    memory = rng.normal(size=(b, R, D)).astype(np.float32)
    amask = np.ones((b, R), np.float32)
    amask[1, -2:] = 0
    mha, jv = _jax_mha(share, jnp.asarray(x_t))
    jk, jvv = mha.apply(jv, jnp.asarray(memory), method="project_memory_kv")
    mem_v = None if share == "kv" else jvv
    ref = mha.apply(jv, jnp.asarray(x_t), jk, mem_v, jnp.asarray(amask)[:, None, None, :], method="decode_cross")
    port = _load(pl.MultiHeadAttention(HEADS, D, share_att=share), jv)
    with torch.no_grad():
        pk, pv = port.project_memory_kv(t(memory))
        assert (pv is None) == (share == "kv")
        _close(pk, jk)
        if pv is not None:
            _close(pv, jvv)
        out = port.decode_cross(t(x_t), pk, pv, t(amask) != 0)
    _close(out, ref)


@pytest.mark.parametrize("share", SHARES)
def test_box_mha_shared_matches_jax(share):
    """BoxMultiHeadAttention under kv (K1 and K7's kv modes: V is the K
    tensor) and qk: the eval output, and with autograd (K1's train variant,
    no dropout) the gradients of the input and of every parameter."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, R, D)).astype(np.float32)
    boxes = _boxes(rng, 2, R)
    amask = np.ones((2, R), np.float32)
    amask[1, -1] = 0.0
    g = rng.normal(size=(2, R, D)).astype(np.float32)
    jlayer = jl.BoxMultiHeadAttention(num_heads=HEADS, d_model=D, share_att=share)
    jmask = jnp.asarray(amask)[:, None, None, :]
    jv = jlayer.init(KEY, jnp.asarray(x), jnp.asarray(boxes), jmask)

    def jfn(params, x_):
        return jlayer.apply({"params": params}, x_, jnp.asarray(boxes), jmask)

    ref, vjp = jax.vjp(jfn, jv["params"], jnp.asarray(x))
    ref_gp, ref_gx = vjp(jnp.asarray(g))
    port = _load(pl.BoxMultiHeadAttention(HEADS, D, share_att=share), jv)
    with torch.no_grad():
        _close(port(t(x), t(boxes), t(amask) != 0), ref)
    px = t(x).requires_grad_()
    out = port(px, t(boxes), t(amask) != 0)
    _close(out, ref)
    out.backward(t(g))
    _close(px.grad, ref_gx)
    grads = convert_jax_variables(to_numpy({"params": ref_gp}))
    for name, p in port.named_parameters():
        _close(p.grad, grads[name], rtol=1e-5, atol=1e-5 * float(grads[name].abs().max()))


@pytest.mark.parametrize("kernel", ["k1", "k1_train", "k2", "k3"])
def test_kv_wrappers_equal_the_tensor_passed_twice(kernel):
    """On the CPU a kv call (one tensor as K and V) runs the plain version,
    which equals the unshared call given the tensor twice, and launches
    nothing."""
    rng = np.random.default_rng(5)
    arr = lambda *shape: t(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    dk = D // HEADS
    before = launch_counts()
    if kernel in ("k1", "k1_train"):
        q, kv = arr(2, HEADS, R, dk), arr(2, HEADS, R, dk)
        boxes, wg_w, wg_b = t(_boxes(rng, 2, R)), arr(HEADS, 64), arr(HEADS)
        mask = torch.ones(2, R, dtype=torch.bool)
        mask[1, -1] = False
        fn = box_attention if kernel == "k1" else box_attention_train
        got, want = (fn(q, kv, v, boxes, wg_w, wg_b, mask) for v in (None, kv))
    elif kernel == "k2":
        q, cache = arr(6, HEADS, dk), arr(6, HEADS, 5, dk)
        anc = t(rng.integers(0, 3, size=(2, 3, 5)).astype(np.int32))
        got, want = (ancestry_self_attention(q, cache, v, anc, 3) for v in (None, cache))
    else:
        q, mem = arr(6, HEADS, dk), arr(2, HEADS, R, dk)
        mask = torch.ones(2, R, dtype=torch.bool)
        mask[0, :2] = False
        got, want = (grouped_cross_attention(q, mem, v, mask) for v in (None, mem))
    assert torch.equal(got, want) and launch_counts() == before


@pytest.mark.parametrize("regions,rep,kv_stages,stages", [(36, 5, 2, 2), (36, 15, 2, 2), (64, 300, 2, 1),
                                                            (64, 700, 1, 0)])
def test_k3_bf16_smem_kv_mode(regions, rep, kv_stages, stages):
    """K3's bf16 shared memory by hand: (stages x ((m x regions + rep) x 2 +
    1) + 1) rows of 144 bytes, m = 1 in the kv mode (the memory staged once:
    K rows only) and 2 unshared, two stages when they fit in 232,448 bytes,
    else one, else 0 (the call raises): the kv mode takes 700 rows an image
    at 64 regions, where the unshared layout fits none."""
    def by_hand(m, n_stages):
        return (n_stages * ((m * regions + rep) * 2 + 1) + 1) * 144 if n_stages else 0

    assert k3_bf16_smem(regions, rep, kv=True) == by_hand(1, kv_stages)
    assert k3_bf16_smem(regions, rep) == by_hand(2, stages)


# ------------------------------------------------------- model and cache
def _small_kw(share, plan=PLAN, vocab=23, **kw):
    return dict(vocab_size=vocab, d_model=D, dim_feedforward=64, num_layers=len(plan), num_heads=HEADS,
                att_feat_size=F, max_seq_length=10, share_att_encoder=share, share_att_decoder=share,
                share_layer_encoder=plan, share_layer_decoder=plan, **kw)


def _radix_inputs(seed, batch=2, vocab=23, bos=21, eos=22, length=8):
    att, amask, boxes, _ = make_inputs(seed=seed, batch=batch)
    rng = np.random.default_rng(seed)
    seqs = rng.integers(1, bos, size=(batch * 2, length)).astype(np.int32)  # 2 captions an image
    seqs[:, 0] = bos
    seqs[0, 5:] = [eos, 0, 0]
    seqs[3, 6:] = [eos, 0]
    return att, amask, boxes, seqs


@pytest.mark.parametrize("share,train", [("kv", False), ("kv", True), ("qk", False)])
def test_init_cache_layout_matches_jax(share, train):
    """init_cache: self_k (and self_v but under kv) per slot; cross_k (and
    cross_v but under kv) projected once per unique layer in eval, the
    slots of a layer holding one tensor, and once per slot in train; the
    values equal JAX's (1e-4: they come out of 3 encoder slots)."""
    inputs = _radix_inputs(7)
    att, amask, boxes, seqs = inputs
    kw = _small_kw(share, dropout_rate=0.0)  # dropout 0: the train-mode cache is compared with JAX's
    jm = JaxORT(**kw)
    jv = to_numpy(jm.init(KEY, *(jnp.asarray(a) for a in (att, amask, seqs, boxes))))
    mem = jm.apply(jv, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref = jm.apply(jv, mem, 9, 3, True, train, method="init_cache")
    port = load_jax_variables(get_model("relation_transformer")(**kw, device="cpu"), jv)
    with torch.no_grad():
        pmem = port.encode(t(att), t(amask), t(boxes))
        cache = port.init_cache(pmem, 9, 3, beam_ancestry=True, train=train,
                                rng=KeyedStream(1) if train else None)
    assert [sorted(e) for e in cache["layers"]] == [sorted(e) for e in ref["layers"]]
    assert [sorted(e) for e in cache["static"]["cross"]] == [sorted(e) for e in ref["static"]["cross"]]
    assert len(cache["layers"]) == len(PLAN)
    for got, want in zip(cache["static"]["cross"], ref["static"]["cross"]):
        for key in want:  # after 3 encoder slots: 1e-4, as the model tests' log-probs
            _close(got[key], want[key], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(cache["ancestry"].numpy(), np.asarray(ref["ancestry"]))
    cross = cache["static"]["cross"]
    assert (cross[0]["cross_k"] is cross[1]["cross_k"]) == (not train)  # slots 0 and 1 share layer 0
    assert cross[1]["cross_k"] is not cross[2]["cross_k"]


@pytest.mark.parametrize("share", SHARES)
def test_acort_beam5_generate_matches_jax(share, tmp_path):
    """An ACORT-shaped model built by ``from_config`` from a radix run config
    (3 slots over (0, 0, 1) on both sides): encode + beam-5 tokens identical
    to the JAX package's, log-probs within 1e-4, the radix ids (bos 21,
    eos 22, unk 1) from the tokenizer, the captions decoded to the same
    strings by both tokenizers."""
    jc, pc, jt, pt = _configs(tmp_path, share_att_encoder=share, share_att_decoder=share)
    jm = JaxORT.from_config(jc)
    port = get_model("relation_transformer").from_config(pc, device="cpu")
    assert (port.vocab_size, port.bos_id, port.eos_id, port.unk_id, port.pad_id) == (23, 21, 22, 1, 0)
    assert (jm.vocab_size, jm.bos_id, jm.eos_id) == (23, 21, 22)
    assert port.box_enc_plan == port.dec_plan == PLAN
    inputs = _radix_inputs(8)
    att, amask, boxes, seqs = inputs
    jv = to_numpy(jm.init(KEY, *(jnp.asarray(a) for a in (att, amask, seqs, boxes))))
    load_jax_variables(port, jv)
    assert len(port.box_encoder_layers) == len(port.decoder_layers) == 2
    opt = {"beam_size": 5}
    memory = jm.apply(jv, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, jv, memory, opt))
    seq, lp = generate(port, port.encode(t(att), t(amask), t(boxes)), opt)
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=BEAM_LP_TOL, atol=BEAM_LP_TOL)
    assert [pt.decode(s) for s in seq[:, 0].numpy()] == [jt.decode(s) for s in ref_seq[:, 0]]


def _record_bernoulli(monkeypatch):
    """Records every keep-mask the JAX side draws (flax ``Dropout`` and
    ``TimeDropout`` call ``jax.random.bernoulli``), in call order."""
    recorded = []
    real = jax.random.bernoulli

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        recorded.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    return recorded


class ReplayDropout(TrainRandom):
    """Hands each dropout site the next recorded JAX keep-mask."""

    def __init__(self, recorded):
        super().__init__(torch.Generator())
        self.recorded = list(recorded)

    def keep_mask(self, shape, keep_prob, device, site=None):
        m = self.recorded.pop(0)
        assert tuple(m.shape) == tuple(shape), (m.shape, shape)
        return torch.from_numpy(m.copy())

    def mask_uniform(self, layer, shape, device):
        raise AssertionError("the ACORT model is dense")


def test_acort_xe_step_matches_jax_with_dropout(tmp_path, monkeypatch):
    """One XE step of the ACORT-shaped model (kv on both sides, 3 slots over
    (0, 0, 1), dropout 0.1 and 0.5 as the recipe's defaults) through
    ``make_xe_step`` with noam: loss within 1e-5 relative, and every
    gradient (a shared layer's summed over its slots) within 1e-5 of its
    tensor's largest entry plus 1e-7 of the largest gradient anywhere. JAX's
    keep-masks are replayed call by call: each slot of a shared layer draws
    its own (32 draws here: the sites of 3 encoder and 3 decoder slots)."""
    jc, pc, _, _ = _configs(tmp_path, share_att_encoder="kv", share_att_decoder="kv")
    jm = JaxORT.from_config(jc)
    inputs = _radix_inputs(9)
    att, amask, boxes, seqs = inputs
    seq_masks = (seqs != 0).astype(np.float32)
    jv = to_numpy(jm.init(KEY, *(jnp.asarray(a) for a in (att, amask, seqs, boxes))))
    recorded = _record_bernoulli(monkeypatch)

    def loss_fn(params):
        lp = jm.apply({"params": params}, *(jnp.asarray(a) for a in (att, amask, seqs, boxes)), train=True,
                      rngs={"dropout": jax.random.PRNGKey(5)})
        return jax_losses.language_model_loss(lp, jnp.asarray(seqs)[:, 1:], jnp.asarray(seq_masks)[:, 1:])

    loss, grads = jax.value_and_grad(loss_fn)(jv["params"])
    draws = len(recorded)
    assert draws == 1 + 3 * 4 + 1 + 3 * 6  # src; per encoder slot 4; PE; per decoder slot 6
    ref_grads = convert_jax_variables(to_numpy({"params": grads}))

    port = load_jax_variables(get_model("relation_transformer").from_config(pc, device="cpu"), jv)
    cfg = dict(lr_scheduler="noam", d_model=D, noamopt_warmup=10000, grad_clip=0.1, optim="adam")
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), cfg, port_optim.make_schedule(cfg))
    opt_m = port_optim.build_mask_optimizer(masks.values(), cfg, trainable=False)
    step = make_xe_step(port, opt_w, opt_m, cfg)
    batch = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes), seqs=t(seqs).long(), seq_masks=t(seq_masks))
    rng = ReplayDropout(recorded)
    state, p_loss, _ = step(TrainState(), batch, rng)
    assert not rng.recorded and state.step == 1
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(ref_grads) == set(named)
    top = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        _close(named[name].grad, g, rtol=0, atol=1e-5 * float(g.abs().max()) + 1e-7 * top, err_msg=name)
    assert float(named["decoder_layers.0.self_attn.kv_proj.weight"].grad.abs().max()) > 0


def test_convert_round_trip_with_kv_proj_and_shared_layers():
    """The bridge maps ``kv_proj`` leaves and the unique layers' params
    (``decoder_layers_0/1``, ``box_encoder_layers_0/1``); ``to_jax_variables``
    gives the JAX tree back, every leaf equal."""
    inputs = _radix_inputs(10)
    att, amask, boxes, seqs = inputs
    kw = _small_kw("kv", plan=(0, 0, 0, 1, 1, 1))
    jm = JaxORT(**kw)
    jv = to_numpy(jm.init(KEY, *(jnp.asarray(a) for a in (att, amask, seqs, boxes))))
    assert {k for k in jv["params"] if "_layers_" in k} == {
        "box_encoder_layers_0", "box_encoder_layers_1", "decoder_layers_0", "decoder_layers_1"}
    port = load_jax_variables(get_model("relation_transformer")(**kw, device="cpu"), jv)
    assert "box_encoder_layers.1.self_attn.kv_proj.weight" in dict(port.named_parameters())
    back = to_jax_variables(port)
    flat_ref = jax.tree_util.tree_flatten_with_path(jv["params"])[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(flat_got) == len(flat_ref) and back["masks"] == {}
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_acort_base_builds_from_the_recipe_flags(tmp_path):
    """ACORT-base from ``resources/commands_acort.sh``'s flags over a 10,000
    word vocabulary: radix base 768 gives vocab 771 (bos 769, eos 770, 2
    digits a word); the model holds 2 unique layers a side with kv_proj
    projections, and its parameter shapes are the JAX model's
    (``jax.eval_shape``: nothing computed at full width)."""
    words = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(9996)]
    flags = dict(radix_base=768, max_seq_length=26, share_att_encoder="kv", share_att_decoder="kv",
                 share_layer_encoder="(0, 0, 0, 1, 1, 1)", share_layer_decoder="(0, 0, 0, 1, 1, 1)", d_model=512,
                 dim_feedforward=2048, num_layers=6, num_heads=8, att_feat_size=2048)
    jc, pc, jt, pt = _configs(tmp_path, words, **flags)
    assert (pc.vocab_size, pc.bos_token_id, pc.eos_token_id, pt.tokens_per_word) == (771, 769, 770, 2)
    port = get_model("relation_transformer").from_config(pc, device="meta")
    jm = JaxORT.from_config(jc)
    shapes = jax.eval_shape(lambda: jm.init(KEY, jnp.zeros((1, 36, 2048)), jnp.ones((1, 36)),
                                            jnp.zeros((1, 27), jnp.int32), jnp.zeros((1, 36, 4))))
    ref = {name: tuple(arr.shape) for name, arr in convert_jax_variables(to_numpy(jax.tree.map(
        lambda s: np.zeros((1,) * len(s.shape), np.float32), shapes))).items()}
    got = {name: tuple(p.shape) for name, p in port.named_parameters()}
    assert set(got) == set(ref)
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes["params"])[0])
    for path, s in flat.items():
        name = ".".join(k.key for k in path).replace("_layers_", "_layers.")
        leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(name.rsplit(".", 1)[1])
        name = name.rsplit(".", 1)[0] + "." + (leaf or name.rsplit(".", 1)[1])
        assert got[name] == (tuple(reversed(s.shape)) if path[-1].key == "kernel" else tuple(s.shape)), name
    assert (port.box_enc_plan, port.dec_plan, port.max_seq_length) == ((0, 0, 0, 1, 1, 1),) * 2 + (26,)
    assert len(port.decoder_layers) == len(port.box_encoder_layers) == 2 and port.vocab_size == 771


# ------------------------------------------------------- masks and sharing
def test_kept_masks_over_shared_layers_match_jax():
    """A train-mode forward with kept 0/1 masks (mask_freeze, the paper's
    sparse fine-tune: K5 "multiply" under autograd) over shared layers runs
    each unique layer's product once and its slots share it: the log-probs
    and the gradients of every weight and mask equal JAX's (dropout 0; the
    tolerances of the XE test)."""
    inputs = _radix_inputs(11)
    att, amask, boxes, seqs = inputs
    kw = _small_kw("kv", dropout_rate=0.0, drop_prob_src=0.0)
    jm = JaxORT(**kw, mask_cfg=JaxMaskConfig("mask_freeze"))
    jv = to_numpy(jm.init(KEY, *(jnp.asarray(a) for a in (att, amask, seqs, boxes))))
    rng = np.random.default_rng(12)
    jv["masks"] = jax.tree.map(lambda m: (rng.uniform(size=m.shape) < 0.7).astype(np.float32), jv["masks"])
    g = rng.normal(size=(seqs.shape[0], seqs.shape[1] - 1, 23)).astype(np.float32)

    def jfn(params, masks):
        return jm.apply({"params": params, "masks": masks}, *(jnp.asarray(a) for a in (att, amask, seqs, boxes)),
                        train=True, rngs={"dropout": KEY})

    ref, vjp = jax.vjp(jfn, jv["params"], jv["masks"])
    gp, gm = vjp(jnp.asarray(g))
    port = load_jax_variables(get_model("relation_transformer_prune")(
        **kw, mask_cfg=MaskConfig("mask_freeze", keep_masks=True), device="cpu"), jv)
    out = port(t(att), t(amask), t(seqs).long(), t(boxes), train=True, rng=TrainRandom(torch.Generator()))
    _close(out, ref)
    out.backward(t(g))
    ref_grads = convert_jax_variables(to_numpy({"params": gp, "masks": gm}), fold_masks=False)
    top = max(float(x.abs().max()) for x in ref_grads.values())
    named = dict(port.named_parameters())
    assert set(named) == set(ref_grads)
    for name, x in ref_grads.items():
        _close(named[name].grad, x, rtol=0, atol=1e-5 * float(x.abs().max()) + 1e-7 * top, err_msg=name)


def test_training_supermask_with_share_layer_raises():
    """A training supermask over shared layers (once refused) draws a fresh
    sample for each slot, as the JAX package's modules draw at every call:
    the XE forward asks a call-order source for one draw a call (the encoder
    and decoder layers of the plan (0, 0, 1) once per slot), the output is
    finite, and every mask logit tensor, shared ones included, gets a
    gradient. Keyed dropout (the SCST decode) over shared layers runs, a site
    for each slot (``tests/test_torch_port_acort_scst.py`` holds the sites);
    ``tests/test_torch_port_shared_width_scst.py`` holds the step against JAX."""
    att, amask, boxes, seqs = _radix_inputs(13)
    port = get_model("relation_transformer_prune")(**_small_kw("kv"), mask_cfg=MaskConfig("supermask", 5.0,
                                                                                        keep_masks=True),
                                                   device="cpu")
    drawn = []

    class Counting(TrainRandom):
        def mask_uniform(self, layer, shape, device):
            drawn.append(layer)
            return super().mask_uniform(layer, shape, device)

    out = port(t(att), t(amask), t(seqs).long(), t(boxes), train=True, rng=Counting(torch.Generator()))
    assert torch.isfinite(out).all()
    ffn = port.decoder_layers[0].feed_forward.w_1
    assert sum(m is ffn for m in drawn) == 2  # slots 0 and 1 of the plan (0, 0, 1)
    per_layer = sum(1 for m in port.modules() if hasattr(m, "mask_site"))
    assert len(drawn) > per_layer
    out.sum().backward()
    for name, p in port.named_parameters():
        if name.endswith(".mask"):
            assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
    dense = get_model("relation_transformer")(**_small_kw("kv"), device="cpu")
    with torch.no_grad():
        memory = dense.encode(t(att), t(amask), t(boxes), train=True, rng=KeyedStream(3))["memory"]
    assert torch.isfinite(memory).all()
    unshared = get_model("relation_transformer_prune")(**_small_kw("kv", plan=(0, 1, 2)),
                                                       mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True),
                                                       device="cpu")
    out = unshared(t(att), t(amask), t(seqs).long(), t(boxes), train=True, rng=TrainRandom(torch.Generator()))
    assert torch.isfinite(out).all()


# --------------------------------------------------------------- tokenizer
@pytest.mark.parametrize("caption,max_len", [("w0 w1 w2", 10), ("w55 zzz w3 w54", 10),
                                             ("w1 w2 w3 w4 w5 w6 w7 w8 w9", 10), ("w7 w8", 0)])
def test_radix_tokenizer_matches_jax(caption, max_len, tmp_path):
    """The port's radix tokenizer (a copy of the JAX package's) against it on
    the same synthetic word vocabulary: the layout (pad 0, digits 1..20, bos
    21, eos 22, unk on the last word slot), encode with the word budget and
    the radix cap, decode (unknown and short tails included), the config
    write-back."""
    jc, pc, jt, pt = _configs(tmp_path)
    assert len(pt) == len(jt) == 23 and pt.tokens_per_word == jt.tokens_per_word == 2
    for attr in ("vocab_size", "bos_token_id", "eos_token_id", "pad_token_id", "unk_token_id"):
        assert getattr(pc, attr) == getattr(jc, attr), attr
    ids = pt.encode(caption, max_seq_length=max_len)
    assert ids == jt.encode(caption, max_seq_length=max_len)
    assert pt.decode(ids) == jt.decode(ids) and pt.decode(ids[:-2]) == jt.decode(ids[:-2])
    np.testing.assert_array_equal(pt.encode_batch([caption, "w3"], 10), jt.encode_batch([caption, "w3"], 10))
    assert pt.token_to_id("w9") == jt.token_to_id("w9") and pt.id_to_token(21) == jt.id_to_token(21)
