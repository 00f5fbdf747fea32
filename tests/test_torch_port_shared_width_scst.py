"""Supermask and beam-sample SCST at ACORT's and ORT-xsmall's shapes in the
PyTorch port against the JAX package on the CPU:

* K2's backward (plain version) in the kv mode and at head widths 32 and 13,
  for the identity map and through a beam-ancestry map, against ``jax.vjp``
  of the JAX package's ``decode_self`` (``cache_v=None`` for kv);
* K3's backward (plain version) in the kv mode and at head widths 32 and 13
  against ``jax.vjp`` of ``decode_cross`` (``mem_v=None`` for kv);
* the kv self-cache threaded through the decode steps' ``DecodeSelfStep``
  against the same steps written out of place;
* the keyed supermask draws of a shared layer's slots: each slot its own
  sample, and the sampling pass and the gradient pass draw the same bits;
* an ACORT-shaped model (d 64 over 2 heads: dk 32, kv on both sides, the
  plans (0, 0, 1), the radix vocabulary layout of base 20: pad 0, digits
  1..20, bos 21, eos 22) under a training supermask: one XE step, one
  supermask SCST step and one beam-sample SCST step against the JAX
  package's; and the two SCST steps of an ORT-xsmall-shaped model (d 26
  over 2 heads: dk 13, unshared).

The JAX side's mask uniforms are recorded by patching
``sparse_caption_tpu.ops.masked.sample_mask`` (as
``tests/test_torch_port_supermask_scst.py`` does), here keyed by (layer,
decode step, call): a shared layer's module runs once per slot, and its
k-th call in the encode, in ``init_cache`` or at one decode step is the
port's slot k (``ops/rng.py mask_draws``); the XE step replays them in call
order. The SCST rewards score the token ids as words (the radix regroup
before the reward is held in ``tests/test_torch_port_acort_scst.py``);
dropout is 0 in the steps against JAX.

Tolerances: the K2 / K3 plain backward 1e-5 absolute (f32, summation order
only); the kv chain 1e-6; the XE step as ``tests/test_torch_port_train.py``
(loss 1e-5 relative, each gradient within 1e-5 of its tensor's largest entry
plus 1e-7 of the largest of all); the supermask SCST step as
``tests/test_torch_port_supermask_scst.py:17-25`` (rewards rtol 1e-5 / atol
1e-6, loss 1e-5 relative, each gradient within 1e-5 of its tensor's largest
entry plus 1e-6 of the largest of all); the beam-sample step as
``tests/test_torch_port_ss_beam_scst.py`` (its gradients element-wise within
1e-3 of their tensor's largest entry plus 1e-6 of the largest, and
norm-wise within 1e-2).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_caption_tpu.ops.masked as jax_masked
import test_torch_port_ss_beam_scst as sb
import test_torch_port_supermask_scst as sm
import test_torch_port_train as ttr
from _torch_port_common import F, KW, make_inputs, t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.models.layers import MultiHeadAttention as JaxMHA
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.pruning.engine import compute_sparsity_loss as jax_sparsity_loss
from sparse_caption_tpu.scst import device_reward as devr
from sparse_caption_tpu_torch.decoding import api as port_api
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine import training as port_training
from sparse_caption_tpu_torch.engine.training import TrainState, make_scst_step, make_xe_step, scan_log_probs
from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
from sparse_caption_tpu_torch.kernels.supermask import supermask_weight_plain
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedLinear, mask_set, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, slot_site
from sparse_caption_tpu_torch.scst import device_reward as port_devr
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

TOL = dict(rtol=0, atol=1e-5)
# (head width, kv): the new instances of the backward kernels, and kv at the paper's 64
WIDTHS = [(32, False), (32, True), (13, False), (13, True), (64, True)]
PLAN = (0, 0, 1)
BASE = 20
V, PAD, BOS, EOS = BASE + 3, 0, BASE + 1, BASE + 2  # the radix layout of base 20
ACORT_KW = dict(vocab_size=V, d_model=64, dim_feedforward=128, num_layers=len(PLAN), num_heads=2, att_feat_size=F,
                max_seq_length=7, pad_id=PAD, bos_id=BOS, eos_id=EOS, share_att_encoder="kv", share_att_decoder="kv",
                share_layer_encoder=PLAN, share_layer_decoder=PLAN)
XSMALL_KW = dict(KW, d_model=26, num_heads=2, dim_feedforward=52)  # 2 heads of 13
SHAPES = {"acort": ACORT_KW, "xsmall": XSMALL_KW}


def to_j(x):
    return jnp.asarray(x.detach().numpy())


def _eye_mha(h: int, dk: int, kv: bool):
    """The JAX package's attention layer with identity projections (its
    attention alone), unshared or kv."""
    d = h * dk
    eye = {"kernel": jnp.eye(d), "bias": jnp.zeros(d)}
    names = ("q_proj", "kv_proj", "out_proj") if kv else ("q_proj", "k_proj", "v_proj", "out_proj")
    return (JaxMHA(num_heads=h, d_model=d, dropout_rate=0.0, share_att="kv" if kv else None),
            {"params": {name: eye for name in names}})


# ------------------------------------------------------------ K2 backward
@pytest.mark.parametrize("kind", ["identity", "random"])
@pytest.mark.parametrize("dk,kv", WIDTHS)
def test_k2_backward_plain_matches_jax_vjp(dk, kv, kind):
    """K2's backward at dk 32 / 13 and in the kv mode (one cache, ``cache_v``
    and ``dcache_v`` None) against ``jax.vjp`` of ``decode_self`` with
    identity projections (so q = k_t (= v_t) = x_t): the input's gradient is
    dq + dk_t (+ dv_t), the cache's slots < t get JAX's cache gradient added
    (under kv its K and V uses summed; through the map every reader's
    share), slot t is zeroed and the later slots are untouched; 2 images x
    3 beams, 2 heads, step 4 of 7."""
    g = torch.Generator().manual_seed(dk + kv)
    b, k, h, t_max, step = 2, 3, 2, 7, 4
    n, d = b * k, h * dk
    anc = None if kind == "identity" else sb._map("random", b, k, t_max, step)
    x, dout = torch.randn(n, h, dk, generator=g), torch.randn(n, h, dk, generator=g)
    caches = [torch.randn(n, h, t_max, dk, generator=g) for _ in range(1 if kv else 2)]
    dcaches0 = [torch.randn(n, h, t_max, dk, generator=g) for _ in caches]
    written = [c.clone() for c in caches]
    for c in written:
        c[:, :, step] = x
    dcaches = [c.clone() for c in dcaches0]
    dq, dk_t, dv_t = k2.ancestry_self_attention_backward(
        x, written[0], None if kv else written[1], dout, dcaches[0], None if kv else dcaches[1], step,
        None if anc is None else t(anc))
    assert (dv_t is None) == kv

    mha, params = _eye_mha(h, dk, kv)
    onehot = None if anc is None else jax.nn.one_hot(jnp.asarray(anc), k, dtype=jnp.float32)

    def fn(xx, *cs):
        return mha.apply(params, xx, cs[0], None if kv else cs[1], step, False, onehot, method="decode_self")[0]

    _, vjp = jax.vjp(fn, to_j(x.reshape(n, 1, d)), *map(to_j, caches))
    jx, *jc = (torch.from_numpy(np.array(a)) for a in vjp(to_j(dout.reshape(n, 1, d))))
    own = dq + (dk_t - dcaches0[0][:, :, step])
    if not kv:
        own = own + (dv_t - dcaches0[1][:, :, step])
    torch.testing.assert_close(own, jx.reshape(n, h, dk), **TOL)
    for got, before, want in zip(dcaches, dcaches0, jc):
        torch.testing.assert_close(got[:, :, :step] - before[:, :, :step], want[:, :, :step], **TOL)
        assert not got[:, :, step].any() and torch.equal(got[:, :, step + 1:], before[:, :, step + 1:])
    assert float(jc[0][:, :, :step].abs().max()) > 0


@pytest.mark.parametrize("dk", [32, 13])
@pytest.mark.parametrize("maps", [False, True])
def test_kv_decode_self_steps_chain_cache_gradients(dk, maps):
    """Steps 0..4 of ``decode_self_attention`` with gradients in the kv mode
    (one cache threaded through ``DecodeSelfStep``; through maps that change
    every step, or the identity): each step's q and k_t get the gradient of
    the same steps written out of place (each attends a fresh stack of the
    slots so far, read as K and V)."""
    g = torch.Generator().manual_seed(dk + 2 * maps)
    b, k, h, steps = 2, 3, 2, 5
    n = b * k
    qs, ks = ([torch.randn(n, h, dk, generator=g, requires_grad=True) for _ in range(steps)] for _ in range(2))
    douts = [torch.randn(n, h, dk, generator=g) for _ in range(steps)]
    cache = torch.zeros(n, h, steps + 1, dk)
    anc = torch.arange(k, dtype=torch.int32)[None, :, None].repeat(b, 1, steps + 1)
    step_maps, outs = [], []
    for i in range(steps):
        anc = anc.clone()
        anc[:, :, i] = torch.arange(k, dtype=torch.int32)
        step_maps.append(anc if maps else None)
        outs.append(k2.decode_self_attention(qs[i], ks[i], None, cache, None, step_maps[-1], i))
        parents = torch.randint(0, k, (b, k), generator=g) if i else torch.zeros(b, k, dtype=torch.int64)
        anc = anc.gather(1, parents[..., None].expand(-1, -1, steps + 1))
    got = torch.autograd.grad(outs, qs + ks, douts)
    ref = [k2.ancestry_self_attention_plain(qs[i], torch.stack(ks[: i + 1], 2), None,
                                            None if m is None else m[:, :, : i + 1].contiguous(), i)
           for i, m in enumerate(step_maps)]
    want = torch.autograd.grad(ref, qs + ks, douts)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)
    for o, r in zip(outs, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-6)


# ------------------------------------------------------------ K3 backward
@pytest.mark.parametrize("dk,kv", WIDTHS)
def test_k3_backward_plain_matches_jax_vjp(dk, kv):
    """K3's backward at dk 32 / 13 and in the kv mode (``mem_v=None``: one
    memory, its gradient dK + dV) against ``jax.vjp`` of ``decode_cross``
    with identity projections: dq of every row, the memory's gradient of
    each image summed over its 3 rows; image 1 has padded regions, image 2
    none valid (it attends its regions uniformly)."""
    g = torch.Generator().manual_seed(dk + kv)
    b, rep, h, s = 3, 3, 2, 5
    d = h * dk
    q, dout = torch.randn(b * rep, h, dk, generator=g), torch.randn(b * rep, h, dk, generator=g)
    mems = [torch.randn(b, h, s, dk, generator=g) for _ in range(1 if kv else 2)]
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[1, 3:] = False
    mask[2] = False
    dq, dmk, dmv = k3.grouped_cross_attention_backward(q, mems[0], None if kv else mems[1], mask, dout)
    assert (dmv is None) == kv

    mha, params = _eye_mha(h, dk, kv)
    jmask = jnp.asarray(mask.numpy())[:, None, None, :].astype(jnp.float32)

    def fn(x, *ms):
        return mha.apply(params, x, ms[0], None if kv else ms[1], jmask, method="decode_cross")

    _, vjp = jax.vjp(fn, to_j(q.reshape(b * rep, 1, d)), *map(to_j, mems))
    jq, *jm = (torch.from_numpy(np.array(a)) for a in vjp(to_j(dout.reshape(b * rep, 1, d))))
    torch.testing.assert_close(dq, jq.reshape(b * rep, h, dk), **TOL)
    for got, want in zip((dmk, dmv), jm):
        torch.testing.assert_close(got, want, **TOL)
    if not kv:
        assert not dmk[1, :, 3:].any() and not dmk[2].any()
    mem = mems[0].clone().requires_grad_()
    qq = q.clone().requires_grad_()
    out = k3.grouped_cross_attention(qq, mem, None if kv else mems[1], mask)  # the autograd Function
    got = torch.autograd.grad(out, (qq, mem), dout)
    assert torch.equal(got[0], dq) and torch.equal(got[1], dmk)


# ------------------------------------------------------ shared-slot draws
def _acort_port(dropout=0.0):
    return get_model("relation_transformer_prune")(**ACORT_KW, dropout_rate=dropout, drop_prob_src=dropout,
                                                   mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True),
                                                   device="cpu")


def _randomize_masks(model, seed=2):
    _, masks = split_params(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in masks.values():
            m.copy_(1.5 * torch.randn(m.shape, generator=g))


def test_shared_slots_draw_fresh_keyed_samples(monkeypatch):
    """Under a keyed stream the k-th call of a layer in a K5 set draws under
    ``slot_site(site, k)``: a shared layer's two slots get different
    products, each the plain sample of its own draw. With dropout on, the
    ACORT-shaped model's sampling decode and its gradient pass (the decode
    again with gradients: K2's and K3's kv backward) draw the same keyed
    bits, each shared slot its own at every step, and give the same
    log-probs."""
    model = _acort_port(dropout=0.1)
    _randomize_masks(model)
    w1 = model.decoder_layers[0].feed_forward.w_1
    stream = KeyedStream(5).at(2)
    with mask_set([w1, w1], stream):
        a, b = w1.effective_weight(stream), w1.effective_weight(stream)
    for slot, got in enumerate((a, b)):
        u = KeyedStream(5).at(2).for_slot(slot).mask_uniform(w1, w1.weight.shape, "cpu")
        assert torch.equal(got, supermask_weight_plain(w1.weight, w1.mask, u, "sample"))
    assert not torch.equal(a, b)

    draws = []
    real = KeyedStream.mask_draw

    def logged(self, layer, shape, device):
        draws.append(real(self, layer, shape, device))
        return draws[-1]

    monkeypatch.setattr(KeyedStream, "mask_draw", logged)
    att, amask, boxes, _ = make_inputs(seed=4)
    fields = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes))
    steps = ACORT_KW["max_seq_length"]
    opt = {"num_random_sample": 3, "beam_size": 0, "max_seq_length": steps, "decode_train": True}
    with torch.no_grad():
        seq, seq_lp = generate(model, model.encode(**fields, train=True, rng=KeyedStream(11)), opt, rng=12)
    sampled, draws[:] = list(draws), []
    flat = seq.reshape(6, steps)
    lp = scan_log_probs(model, model.encode(**fields, train=True, rng=KeyedStream(11)), flat, 12)
    valid = flat != PAD
    assert lp.requires_grad and int(valid.sum()) > 6
    assert torch.equal(lp.detach()[valid], seq_lp.reshape(6, steps)[valid])
    assert sorted(draws) == sorted(sampled)
    site = w1.mask_site
    for step in range(steps):
        at_step = {d.site for d in sampled if d.t == step and d.site in (site, slot_site(site, 1))}
        assert at_step == {site, slot_site(site, 1)}, step  # decoder layer 0's two slots, each its own draw
    lp[valid].sum().backward()
    assert float(w1.mask.grad.abs().max()) > 0


# ---------------------------------------------------- whole steps vs JAX
class _SlotRecorder:
    """The JAX side's supermask uniforms keyed by (port layer name, decode
    step, call): the step is the decode loop's ``t`` (none outside it), the
    call the module's k-th call at that step (or in the encode / the cache's
    projections), counted while the step is traced."""

    def __init__(self, monkeypatch):
        self.uniforms = {}
        calls, alive = {}, []
        real = jax_masked.sample_mask
        loops = (os.path.join("decoding", "sample.py"), os.path.join("decoding", "beam.py"))

        def store(name, call, u, step=None):
            key = (name, None if step is None else int(step), call)
            u = np.asarray(u)
            assert key not in self.uniforms or np.array_equal(self.uniforms[key], u), key
            self.uniforms[key] = u

        def recording(mask, cfg, train, rng_key):
            if cfg.is_supermask and train:
                name = sm._port_name(sys._getframe(1).f_locals["self"].path)
                frame, step = sys._getframe(1), None
                while frame is not None:
                    if frame.f_code.co_name == "body" and frame.f_code.co_filename.endswith(loops):
                        step = frame.f_locals["t"]
                        break
                    frame = frame.f_back
                alive.append(step)  # the step's tracer stays alive: its id names one traced step
                call = calls.get((name, id(step)), 0)
                calls[(name, id(step))] = call + 1
                u = jax.random.uniform(rng_key, mask.shape)
                jax.debug.callback(lambda *a, name=name, call=call: store(name, call, *a), u,
                                   *(() if step is None else (step,)))
            return real(mask, cfg, train, rng_key)

        monkeypatch.setattr(jax_masked, "sample_mask", recording)


class _SlotUniformStream(sm._JaxUniformStream):
    """A keyed stream whose mask draws are the recorded JAX uniforms of
    (layer, step, the view's slot)."""

    def mask_draw(self, layer, shape, device):
        key = (self.names[id(layer)], self.t, self.slot)
        u = self.uniforms[key]
        u = u.T if isinstance(layer, MaskedLinear) else u  # Dense kernels are (in, out) in JAX
        assert tuple(u.shape) == tuple(shape), (key, u.shape, shape)
        self.used.add(key)
        return t(np.ascontiguousarray(u))


def _setup(shape: str):
    """The JAX model, its variables (mask logits N(0, 1.5); each head's
    geometry weights 4 entries of +-0.225 and a bias of 1, so that w_g lies
    in [0.1, 1.9], away from the clamp's kink, where the gradient of log(w_g)
    turns last-bit differences into large ones, as
    ``tests/test_torch_port_xsmall.py`` bounds them), the port model with
    them, the encoder inputs, the XE captions, the vocabulary size and the
    decode length, dropout 0."""
    kw = SHAPES[shape]
    att, amask, boxes, seqs = make_inputs(seed=4)
    if shape == "acort":
        seqs = np.random.default_rng(4).integers(1, BASE + 1, size=seqs.shape).astype(np.int32)
        seqs[:, 0] = BOS
        seqs[0, 5:] = [EOS, PAD]
        seqs[1, 4:] = [EOS, PAD, PAD]
    jm = JaxORT(**kw, dropout_rate=0.0, drop_prob_src=0.0, mask_cfg=jax_masked.MaskConfig("supermask", 5.0))
    variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, *(jnp.asarray(a) for a in (att, amask, seqs,
                                                                                               boxes))))
    rng = np.random.default_rng(11)
    variables["masks"] = jax.tree.map(lambda m: rng.normal(0.0, 1.5, size=m.shape).astype(np.float32),
                                      variables["masks"])
    for name, layer in variables["params"].items():  # w_g bounded away from the log's kink
        if name.startswith("box_encoder_layers_"):
            wg = layer["self_attn"]["wg"]
            kernel = np.zeros_like(wg["kernel"])
            for hh in range(kernel.shape[1]):
                kernel[rng.choice(kernel.shape[0], 4, replace=False), hh] = rng.choice([-0.225, 0.225], 4)
            wg["kernel"], wg["bias"] = kernel, np.ones_like(wg["bias"])
    port = get_model("relation_transformer_prune")(**kw, dropout_rate=0.0, drop_prob_src=0.0, device="cpu",
                                                   mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    enc = dict(att_feats=att, att_masks=amask, boxes=boxes)
    return jm, variables, load_jax_variables(port, variables), enc, seqs, kw["vocab_size"], kw["max_seq_length"]


def test_acort_supermask_xe_step_matches_jax(monkeypatch):
    """One supermask XE step (noam, Adam, clip 0.1, the sparsity loss, the
    mask Adam) of the ACORT-shaped model: JAX's uniforms replayed call by
    call (each slot of a shared layer its own draw), the loss, its sparsity
    terms and every gradient, the shared layers' summed over their slots."""
    jm, variables, port, enc, seqs, _, _ = _setup("acort")
    att, amask, boxes = (jnp.asarray(enc[k]) for k in ("att_feats", "att_masks", "boxes"))
    seq_masks = (seqs != PAD).astype(np.float32)
    recorded = []
    real = jax_masked.sample_mask

    def recording(mask, cfg, train, rng_key):
        if cfg.is_supermask and train:
            recorded.append(np.asarray(jax.random.uniform(rng_key, mask.shape)))
        return real(mask, cfg, train, rng_key)

    monkeypatch.setattr(jax_masked, "sample_mask", recording)
    cfg = dict(ttr.CFG, d_model=ACORT_KW["d_model"])

    def loss_fn(params, masks):
        lp = jm.apply({"params": params, "masks": masks}, att, amask, jnp.asarray(seqs), boxes, train=True,
                      rngs={"dropout": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(100)})
        cap = jax_losses.language_model_loss(lp, jnp.asarray(seqs)[:, 1:], jnp.asarray(seq_masks)[:, 1:])
        sp, _ = jax_sparsity_loss(masks, ttr.SP_TARGET, ttr.SP_WEIGHT, 0, cfg["max_train_step"], None)
        return cap + sp, cap

    (loss_j, cap_j), (gw, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(variables["params"],
                                                                                          variables["masks"])
    per_layer = len(jax.tree.leaves(variables["masks"]))
    assert len(recorded) > per_layer  # the shared layers drew once per slot
    grads = convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False)

    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), cfg, port_optim.make_schedule(cfg))
    opt_m = port_optim.build_mask_optimizer(masks.values(), cfg, trainable=True)
    step = make_xe_step(port, opt_w, opt_m, cfg)
    batch = {k: t(v) for k, v in enc.items()}
    batch.update(seqs=t(seqs).long(), seq_masks=t(seq_masks))
    replay = ttr.ReplayRandom(recorded)
    state, loss, aux = step(TrainState(), batch, replay)
    assert state.step == 1 and not replay.recorded  # every JAX draw consumed, in order
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux["caption_loss"]), float(cap_j), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    top = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()) + 1e-7 * top, err_msg=name)
    assert float(named["decoder_layers.0.feed_forward.w_1.mask"].grad.abs().max()) > 0


def _jax_sample_scst(jm, variables, enc, steps, reward):
    """The JAX supermask SCST step's loss and gradients: the train-mode encode
    and sampling decode re-run as a differentiable scan under the step's key
    (``engine/training.py:693-703,769``), as
    ``test_supermask_scst_step_matches_jax_differentiable_scan`` runs it."""
    df, ref_len, gts, tok2id, vocab = reward
    opt = {"num_random_sample": 3, "beam_size": 0, "max_seq_length": steps, "decode_train": True,
           "differentiable": True}
    key = jax.random.PRNGKey(17)
    enc_j = {k: jnp.asarray(v) for k, v in enc.items()}
    table_j = devr.DfTable.build(df, ref_len, tok2id)
    pack_j = devr.ref_pack_device(devr.build_ref_pack(gts, df, ref_len, tok2id, vocab_size=vocab))
    score = devr.make_reward_device_fn(table_j, cider_weight=1.0, bleu_weight=sm.BLEU)

    def loss_fn(params, masks):
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
    (loss, (flat, sc, rewards)), (gw, gm) = grad_fn(variables["params"], variables["masks"])
    jax.effects_barrier()
    grads = convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False)
    return float(loss), np.asarray(flat), np.asarray(sc), np.asarray(rewards), grads


@pytest.mark.parametrize("sample", ["random", "beam_search"])
@pytest.mark.parametrize("shape", ["acort", "xsmall"])
def test_supermask_scst_step_matches_jax(shape, sample, tmp_path, monkeypatch):
    """One supermask SCST step (2 images x 3 samples or beams, leave-one-out
    baseline, CIDEr-D + BLEU-4, step LR 5e-5, Adam, clip 0.1, the mask Adam,
    dropout 0) of the ACORT-shaped model (kv, shared layers, dk 32) and of
    the ORT-xsmall-shaped one (dk 13) against the JAX package's: random
    samples through the differentiable scan (the port's gradient pass on
    JAX's tokens: the decode again with gradients, K2's and K3's backward,
    kv under ACORT), beam search differentiated whole (the port's own
    train-mode search gives JAX's beams, then the search again on its
    decisions, K2's backward through the map). Each draw of a shared slot is
    JAX's draw of that call; every JAX draw is used once. Rewards, loss and
    every weight's and mask's gradient."""
    jm, variables, port, enc, _, vocab, steps = _setup(shape)
    df, ref_len, gts, tok2id = sm._reward_setup(tmp_path, vocab)
    reward = (df, ref_len, gts, tok2id, vocab)
    recorder = _SlotRecorder(monkeypatch)
    beams = sample == "beam_search"
    loss_j, flat, sc, rewards, grads = (sb._jax_beam_scst if beams else _jax_sample_scst)(jm, variables, enc, steps,
                                                                                          reward)
    assert (flat != 0).sum() > 12 and len(np.unique(flat)) > 5
    assert any(call > 0 for _, _, call in recorder.uniforms) == (shape == "acort")  # the shared slots' calls
    names = {id(m): n for n, m in port.named_modules()}
    streams = []

    def jax_stream(k):
        streams.append(_SlotUniformStream(k, recorder.uniforms, names))
        return streams[-1]

    monkeypatch.setattr(port_training, "KeyedStream", jax_stream)
    monkeypatch.setattr(port_api, "KeyedStream", jax_stream)
    config = dict(sb.SCST_CFG if beams else sm.CFG, max_seq_length=steps + 1)
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), config, port_optim.make_schedule(config))
    opt_m = port_optim.build_mask_optimizer(masks.values(), config, trainable=True)
    table = port_devr.DfTable.build(df, ref_len, tok2id)
    step = make_scst_step(port, opt_w, opt_m, config, port_devr.make_reward_fn(table, bleu_weight=sm.BLEU))
    batch = {k: t(v) for k, v in enc.items()}
    batch["ref_pack"] = port_devr.scst_ref_pack(gts, df, table, tok2id, vocab, "cpu")
    if beams:
        res = step.sample_fn(TrainState(), batch)
        np.testing.assert_array_equal(res["sample"].reshape(6, steps).numpy(), flat)
    else:
        res = {"sample": t(flat.reshape(2, 3, steps))}
    state, loss, aux = step.grad_fn(TrainState(), batch, res)
    assert state.step == 1
    used = set().union(*(s.used for s in streams))
    assert used == set(recorder.uniforms), sorted(set(recorder.uniforms) ^ used)[:5]

    np.testing.assert_allclose(float(aux["avg_sample"]), float(np.mean(sc)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["avg_reward"]), float(np.mean(rewards)), rtol=1e-5, atol=1e-6)
    assert float(np.abs(rewards).max()) > 1e-3
    # the leave-one-out rewards of an image sum to 0: the loss is held to 1e-5 of its terms' scale where it cancels
    assert abs(float(loss) - loss_j) <= 1e-5 * max(abs(loss_j), float(np.abs(rewards).mean()))
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    top = max(float(g.abs().max()) for g in grads.values())
    assert top > 1e-4
    for name, g in grads.items():
        if beams:
            gtol = sb.STEP_GRAD_TOL * float(g.abs().max()) + 1e-6 * top
            ratio = float((named[name].grad - g).norm()) / (1e-2 * float(g.norm()) + 1e-6 * top * g.numel() ** 0.5)
            assert ratio <= 1, name
        else:
            gtol = sm.GRAD_TOL * float(g.abs().max()) + 1e-6 * top
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0, atol=gtol, err_msg=name)
    assert min(float(named[n].grad.abs().max()) for n in named if n.endswith(".mask")) > 0.0
