"""Up-Down's scheduled sampling and extra logit layers, and beam-sample SCST
for the ORT and Up-Down, in the PyTorch port against the JAX package on the
CPU, at small widths:

* K9's ss mode (plain version) against ``jax.random.categorical`` on the same
  Gumbel noise and JAX's coins, f32 and bf16; its keyed draws;
* the Up-Down XE forward and one supermask XE step at ``ss_prob`` 0.5 and
  ``logit_layers`` 2 (rnn 16, vocab 30, 6 steps), the JAX side's mask
  uniforms, coins and noise replayed call by call (dropout 0);
* K2's backward through the beam-ancestry map (plain version) against
  ``jax.vjp`` of the JAX package's ``decode_self`` with ``ancestry_onehot``:
  the identity map, the map in which every beam descends from beam 0, and a
  random map;
* one beam-sample SCST step (2 images x 3 beams, leave-one-out baseline,
  CIDEr-D + BLEU-4, dropout 0) of a mask_freeze ORT, a supermask ORT (the
  JAX side's mask uniforms replayed) and a mask_freeze Up-Down against the
  JAX package's beam search differentiated whole; with dropout on, the
  gradient pass's forced search against the sampling pass's.

Tolerances: tokens exactly; log-probs and K2's gradients 1e-5 absolute (f32,
summation order only); the XE step's gradients within 1e-5 of their
tensor's largest entry plus 1e-7 of the largest of all; the beam SCST steps:
rewards rtol 1e-5 / atol 1e-6, loss 1e-5 relative (of the mean |reward|
where the loss cancels below it), each gradient norm-wise within 1e-2 (as
``chip_smoke.py``'s whole steps) and element-wise within 1e-3 of its
tensor's largest entry plus 1e-6 of the largest of all: the search's
reorders and the unrolled LSTM sum in other orders than XLA's, and the ORT's
geometry gradient divides by w_g near the log's kink (2.3e-4 of the largest
entry of an encoder layer's ``wg.bias`` on this data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_caption_tpu.ops.masked as jax_masked
import test_torch_port_supermask_scst as sm
import test_torch_port_updown as tud
import test_torch_port_updown_scst as tus
from _torch_port_common import KW, make_inputs, t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.models import up_down as jud
from sparse_caption_tpu.models.layers import MultiHeadAttention as JaxMHA
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.pruning.engine import compute_sparsity_loss as jax_sparsity_loss
from sparse_caption_tpu.scst import device_reward as devr
from sparse_caption_tpu_torch.decoding import api as port_api
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.decoding.beam import BeamDecisions, gather_beams
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine import training as port_training
from sparse_caption_tpu_torch.engine.training import TrainState, beam_log_probs, make_scst_step, make_xe_step
from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.kernels import sample_step as k9
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.models import up_down as pud
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, ScheduledSampling, TrainRandom
from sparse_caption_tpu_torch.scst import device_reward as port_devr
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables, to_jax_variables

GRAD_TOL = 1e-5
STEP_GRAD_TOL = 1e-3  # the beam steps' gradients, element-wise, of their tensor's largest entry
BLEU = (0.0, 0.0, 0.0, 1.0)


# -------------------------------------------------------------- K9 ss mode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_ss_plain_gives_jax_categorical_tokens(dtype):
    """The plain version on JAX's coins (``uniform(k1, (n,)) < ss_prob``) and
    JAX's Gumbel noise in the log-probs' dtype gives
    ``where(coin, categorical(k2, lp), teacher)`` exactly; in bf16 many
    sums tie and the first index wins. Rows 0-3 hold equal log-probs."""
    jdt = jnp.dtype(dtype)
    n, vocab, ss_prob = 64, 300, 0.5
    lp = jax.nn.log_softmax(3.0 * jax.random.normal(jax.random.PRNGKey(1), (n, vocab)), axis=-1)
    lp = lp.at[:4].set(-np.log(vocab)).astype(jdt)
    teacher = np.random.default_rng(0).integers(4, vocab, n).astype(np.int32)
    for i in range(4):
        k1, k2, _ = jax.random.split(jax.random.PRNGKey(10 + i), 3)
        coin_u = jax.random.uniform(k1, (n,))
        want = np.where(np.asarray(coin_u < ss_prob), np.asarray(jax.random.categorical(k2, lp, axis=-1)), teacher)
        noise = jax.random.gumbel(k2, lp.shape, jdt)
        tdt = getattr(torch, dtype)
        lp_t = t(np.asarray(lp.astype(jnp.float32))).to(tdt)
        draw = (t(np.asarray(coin_u)), t(np.asarray(noise.astype(jnp.float32))).to(tdt))
        before = launch_counts()
        got = k9.scheduled_sample(lp_t, t(teacher), ss_prob, draw)
        assert launch_counts() == before  # CPU tensors take the plain version
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < int((got.numpy() != teacher).sum()) < n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_ss_keyed_draws(dtype):
    """``SSDraw``'s keyed coins are uniforms on the 2^-24 grid in [0, 1) (a
    share near ss_prob comes up) and its noise is ``-log(-log(u))`` with u in
    (0, 1) at the dtype's precision (exact in bf16) and each log rounded to
    the dtype; the draw is a function of (key, t, row, column) alone; ss_prob
    0 and 1 give the teacher's and the sampled tokens."""
    n, vocab = 400, 50
    draw = k9.SSDraw(0x0123456789ABCDEF, 3)
    u = draw.coin_uniform(n, "cpu")
    assert u.dtype == torch.float32 and bool(((u >= 0) & (u < 1)).all())
    assert torch.equal(u * 2 ** 24, (u * 2 ** 24).round()) and 0.2 < float((u < 0.3).float().mean()) < 0.4
    noise = draw.noise(n, vocab, dtype, "cpu")
    assert noise.dtype == dtype and bool(torch.isfinite(noise).all())
    assert torch.equal(noise[:7], draw.noise(7, vocab, dtype, "cpu")) and torch.equal(noise, draw.noise(n, vocab, dtype,
                                                                                                         "cpu"))
    assert not torch.equal(noise, k9.SSDraw(draw.key, 4).noise(n, vocab, dtype, "cpu"))
    if dtype == torch.bfloat16:  # u = (2 m + 1) / 256 exactly, the logs rounded to bf16 one at a time
        g = -torch.log(-torch.log(torch.exp(-torch.exp(-noise.float())).bfloat16()))
        assert float((g.float() - noise.float()).abs().max()) <= 2 ** -6 * float(noise.float().abs().max())
    lp = torch.log_softmax(torch.randn(n, vocab, generator=torch.Generator().manual_seed(0)), -1).to(dtype)
    teacher = torch.full((n,), 7, dtype=torch.int64)
    assert torch.equal(k9.scheduled_sample(lp, teacher, 0.0, draw), teacher)
    sampled = k9.scheduled_sample(lp, teacher, 1.0, draw)
    assert torch.equal(sampled, torch.argmax(lp + noise, -1)) and len(sampled.unique()) > 10
    assert torch.equal(k9.scheduled_sample(lp, teacher, 0.3, draw), torch.where(u < 0.3, sampled, teacher))


# ------------------------------------------------ Up-Down XE with scheduled sampling
SS_KW = dict(tud.KW, logit_layers=2, ss_prob=0.5)
XE_CFG = dict(tud.CFG)


class _JaxSSRecorder:
    """The JAX Up-Down's scheduled-sampling draws, in call order: the coins'
    uniforms and the Gumbel noise of each ``jax.random.categorical`` (the
    module's ``jax`` is a proxy that records them; everything else as jax)."""

    def __init__(self, monkeypatch):
        self.coins, self.noise = [], []
        rec = self

        class Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            @staticmethod
            def uniform(key, shape=(), *args, **kw):
                u = jax.random.uniform(key, shape, *args, **kw)
                rec.coins.append(np.asarray(u))
                return u

            @staticmethod
            def categorical(key, logits, axis=-1):
                rec.noise.append(np.asarray(jax.random.gumbel(key, logits.shape, logits.dtype).astype(jnp.float32)))
                return jax.random.categorical(key, logits, axis=axis)

        class Jax:
            random = Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        monkeypatch.setattr(jud, "jax", Jax())


class _ReplaySS(tud.ReplayRandom):
    """``ReplayRandom`` whose scheduled-sampling stream hands in the JAX
    side's coins and noise step by step."""

    def __init__(self, recorded, coins, noise):
        super().__init__(recorded)
        self.coins, self.noise = list(coins), list(noise)

    def ss_stream(self):
        replay = self

        class Stream:
            def draw(self, t, n, vocab, dtype, device):
                noise = replay.noise.pop(0)
                assert noise.shape == (n, vocab)
                return t_(replay.coins.pop(0)), t_(noise).to(dtype)

        return Stream()


def t_(x):
    return t(np.ascontiguousarray(x))


def _ss_setup():
    jm = jud.UpDownModel(**SS_KW, drop_prob_lm=0.0, mask_cfg=jax_masked.MaskConfig("supermask", 5.0))
    att, amask, fc, seqs = tud.make_inputs(seed=8, spi=3)
    variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(att), jnp.asarray(amask),
                                 jnp.asarray(seqs), fc_feats=jnp.asarray(fc)))
    rng = np.random.default_rng(7)
    variables["masks"] = jax.tree.map(lambda m: rng.normal(0.0, 2.0, size=m.shape).astype(np.float32),
                                      variables["masks"])
    variables["params"] = jax.tree.map(lambda p: (3 * p).astype(np.float32), variables["params"])
    port = get_model("up_down_lstm_prune")(**SS_KW, drop_prob_lm=0.0, device="cpu",
                                           mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    return jm, variables, load_jax_variables(port, variables), (att, amask, fc, seqs)


def test_updown_logit_layers_bridge_and_call_order():
    """``logit_layers`` 2: hidden (rnn -> rnn) and output (rnn -> V) logit
    layers, both masked and in the step's K5 set after the language LSTM, in
    JAX's call order; the bridge carries ``logit_0`` / ``logit_1`` and their
    masks both ways; each hidden logit layer's dropout has a site of its own;
    the XE forward's scheduled sampling never runs in the decode."""
    jm, variables, port, _ = _ss_setup()
    assert [tuple(m.weight.shape) for m in port.logit] == [(16, 16), (30, 16)]
    assert port._step_masked[-2:] == [port.logit[0], port.logit[1]] and len(port._step_masked) == 9
    back = to_jax_variables(port)
    for kind in ("params", "masks"):
        for name in ("logit_0", "logit_1"):
            for leaf, v in variables[kind][name].items():
                np.testing.assert_array_equal(back[kind][name][leaf], v)
    assert len(set(pud.SITES.values())) == len(pud.SITES) and "logit.0" in pud.SITES
    two = get_model("up_down_lstm")(**dict(tud.KW, logit_layers=3), device="cpu")
    assert two._logit_sites == ["logit.0", "logit.1"] and len(two.logit) == 3
    with pytest.raises(ValueError):
        get_model("up_down_lstm")(**dict(tud.KW, logit_layers=0), device="cpu")
    calls = []
    real = pud.scheduled_sample
    pud.scheduled_sample = lambda *a: calls.append(a) or real(*a)
    try:
        att, amask, fc, _ = tud.make_inputs()
        memory = port.encode(t(att), t(amask), t(fc))
        generate(port, memory, {"beam_size": 2})
        generate(port, memory, {"num_random_sample": 2, "beam_size": 0, "decode_train": True}, rng=3)
    finally:
        pud.scheduled_sample = real
    assert calls == []


def _jax_ss_xe(jm, variables, inputs, monkeypatch, grad: bool):
    """The JAX step's log-probs (or loss and gradients) and its draws: mask
    uniforms, coins and noise in call order."""
    att, amask, fc, seqs = (jnp.asarray(a) for a in inputs)
    seq_masks = (seqs != 0).astype(jnp.float32)
    recorded = []
    real_sample = jax_masked.sample_mask

    def recording_sample(mask, cfg, train, rng_key):
        if cfg.is_supermask and train:
            recorded.append(np.asarray(jax.random.uniform(rng_key, mask.shape)))
        return real_sample(mask, cfg, train, rng_key)

    monkeypatch.setattr(jax_masked, "sample_mask", recording_sample)
    ss = _JaxSSRecorder(monkeypatch)
    rngs = {"dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(100), "ss": jax.random.PRNGKey(5)}

    def loss_fn(params, masks):
        lp = jm.apply({"params": params, "masks": masks}, att, amask, seqs, fc_feats=fc, train=True, rngs=rngs)
        cap = jax_losses.language_model_loss(lp, seqs[:, 1:], seq_masks[:, 1:])
        sp, aux = jax_sparsity_loss(masks, 0.991, 120.0, 0, XE_CFG["max_train_step"])
        return cap + sp, dict(aux, caption_loss=cap, lp=lp)

    if not grad:
        out = loss_fn(variables["params"], variables["masks"])[1]["lp"]
        return np.asarray(out), recorded, ss
    (loss, aux), (gw, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(variables["params"],
                                                                                     variables["masks"])
    grads = convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False)
    return (float(loss), float(aux["caption_loss"]), grads), recorded, ss


def test_updown_ss_forward_matches_jax(monkeypatch):
    """The train-mode XE forward (2 images x 3 captions, 6 steps, ss_prob 0.5,
    logit_layers 2, supermask, dropout 0): the inputs of steps 1-5 are the
    JAX side's (coins and categorical draws replayed), the log-probs within
    1e-5; ``decode_teacher_forced`` and an eval forward draw nothing."""
    jm, variables, port, inputs = _ss_setup()
    ref, recorded, ss = _jax_ss_xe(jm, variables, inputs, monkeypatch, grad=False)
    steps = tud.T - 1
    assert len(ss.coins) == len(ss.noise) == steps - 1 and len(recorded) == 3 + 9 * steps
    taken = []
    real = pud.scheduled_sample
    monkeypatch.setattr(pud, "scheduled_sample", lambda *a: taken.append(real(*a)) or taken[-1])
    att, amask, fc, seqs = inputs
    rng = _ReplaySS(recorded, ss.coins, ss.noise)
    lp = port(t(att), t(amask), t(seqs).long(), t(fc), train=True, rng=rng)
    assert not rng.recorded and not rng.coins and not rng.noise  # every JAX draw consumed, in order
    tud._close(lp, ref)
    teacher = t(seqs[:, 1:-1]).long()
    fed = torch.stack(taken, 1)
    assert (fed != teacher).any() and (fed == teacher).any()
    with torch.no_grad():
        eval_lp = port(t(att), t(amask), t(seqs).long(), t(fc))
    assert len(taken) == steps - 1
    assert not torch.allclose(eval_lp, lp)


def test_updown_ss_xe_step_matches_jax(monkeypatch):
    """One supermask XE step with scheduled sampling (ss_prob 0.5, logit
    layers 2, dropout 0; the Up-Down family's cosine LR 0.01, eps 0.01,
    target 0.991, weight 120) against the JAX package: loss 1e-5 relative,
    each gradient within 1e-5 of its tensor's largest entry plus 1e-7 of the
    largest of all; both logit layers' weights and masks get gradients."""
    jm, variables, port, inputs = _ss_setup()
    (loss_j, cap_j, grads), recorded, ss = _jax_ss_xe(jm, variables, inputs, monkeypatch, grad=True)
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), XE_CFG, port_optim.make_schedule(XE_CFG))
    opt_m = port_optim.build_mask_optimizer(masks.values(), XE_CFG, trainable=True)
    step = make_xe_step(port, opt_w, opt_m, XE_CFG)
    att, amask, fc, seqs = inputs
    batch = dict(att_feats=t(att), att_masks=t(amask), fc_feats=t(fc), seqs=t(seqs).long(),
                 seq_masks=t((seqs != 0).astype(np.float32)))
    state, loss, aux = step(TrainState(), batch, _ReplaySS(recorded, ss.coins, ss.noise))
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    np.testing.assert_allclose(float(aux["caption_loss"]), cap_j, rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    top = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        gtol = GRAD_TOL * float(g.abs().max()) + 1e-7 * top
        tud._close(named[name].grad, g, rtol=0, atol=gtol, err_msg=name)
    for name in ("logit.0.weight", "logit.0.mask", "logit.1.weight", "logit.1.mask"):
        assert float(named[name].grad.abs().max()) > 1e-6, name


def test_ss_stream_keys():
    """A ``TrainRandom``'s scheduled-sampling key comes from its generator
    (a new one a forward); a ``KeyedStream``'s is derived from its key."""
    a, b = TrainRandom(torch.Generator().manual_seed(4)), TrainRandom(torch.Generator().manual_seed(4))
    sa, sb = a.ss_stream(), b.ss_stream()
    assert isinstance(sa, ScheduledSampling) and sa.key == sb.key and a.ss_stream().key != sa.key
    assert sa.draw(3, 2, 5, torch.float32, "cpu") == k9.SSDraw(sa.key, 3)
    assert KeyedStream(9).ss_stream().key == KeyedStream(9).at(4).ss_stream().key != KeyedStream(10).ss_stream().key


# ------------------------------------------------ K2 backward, ancestry mode
def _map(kind: str, b: int, k: int, t_max: int, step: int):
    rng = np.random.default_rng(3)
    anc = {"identity": np.tile(np.arange(k)[None, :, None], (b, 1, t_max)),
           "from_beam_0": np.zeros((b, k, t_max), np.int64),
           "random": rng.integers(0, k, (b, k, t_max))}[kind].astype(np.int32)
    anc[:, :, step] = np.arange(k)  # slot t: each row wrote it itself (the decode step's map)
    return anc


@pytest.mark.parametrize("kind", ["identity", "from_beam_0", "random"])
@pytest.mark.parametrize("step", [3, 6])
def test_k2_backward_ancestry_plain_matches_jax_vjp(kind, step):
    """K2's backward through the map against ``jax.vjp`` of ``decode_self``
    with ``ancestry_onehot`` (identity projections, so q = k_t = v_t = x_t):
    the input's gradient is dq + dk_t + dv_t, the caches' slots < t get the
    JAX cache gradient added (every reader's share of a row summed), slot t
    is zeroed, later slots untouched; 2 images x 4 beams, 2 heads of 8."""
    g = torch.Generator().manual_seed(step)
    b, k, h, t_max, dk = 2, 4, 2, 7, 8
    n, d = b * k, h * dk
    anc = _map(kind, b, k, t_max, step)
    x = torch.randn(n, h, dk, generator=g)
    ck, cv = torch.randn(n, h, t_max, dk, generator=g), torch.randn(n, h, t_max, dk, generator=g)
    dout = torch.randn(n, h, dk, generator=g)
    dck0, dcv0 = torch.randn(n, h, t_max, dk, generator=g), torch.randn(n, h, t_max, dk, generator=g)
    ck_t, cv_t = ck.clone(), cv.clone()
    ck_t[:, :, step], cv_t[:, :, step] = x, x
    dck, dcv = dck0.clone(), dcv0.clone()
    dq, dk_t, dv_t = k2.ancestry_self_attention_backward(x, ck_t, cv_t, dout, dck, dcv, step, t(anc))

    mha = JaxMHA(num_heads=h, d_model=d, dropout_rate=0.0)
    eye = {"kernel": jnp.eye(d), "bias": jnp.zeros(d)}
    params = {"params": {name: eye for name in ("q_proj", "k_proj", "v_proj", "out_proj")}}
    onehot = jax.nn.one_hot(jnp.asarray(anc), k, dtype=jnp.float32)
    to_j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    _, vjp = jax.vjp(lambda xx, a, c: mha.apply(params, xx, a, c, step, False, onehot, method="decode_self")[0],
                     to_j(x.reshape(n, 1, d)), to_j(ck), to_j(cv))
    jx, jk, jv = (torch.from_numpy(np.array(a)) for a in vjp(to_j(dout.reshape(n, 1, d))))
    tol = dict(rtol=0, atol=1e-5)
    own = dq + (dk_t - dck0[:, :, step]) + (dv_t - dcv0[:, :, step])
    torch.testing.assert_close(own, jx.reshape(n, h, dk), **tol)
    torch.testing.assert_close(dck[:, :, :step] - dck0[:, :, :step], jk[:, :, :step], **tol)
    torch.testing.assert_close(dcv[:, :, :step] - dcv0[:, :, :step], jv[:, :, :step], **tol)
    assert not dck[:, :, step].any() and not dcv[:, :, step].any()
    assert torch.equal(dck[:, :, step + 1:], dck0[:, :, step + 1:])
    if kind == "from_beam_0":  # beam 0's early slots take every beam's share; the others' none
        assert float(jk[1:k, :, :step].abs().max()) == 0.0 and float(jk[0, :, :step].abs().max()) > 0


def test_decode_self_steps_through_changing_maps():
    """``decode_self_attention`` with gradients over 5 steps whose map changes
    every step (the search's parent choices gathered into it, slot t set to
    the identity), the cache threaded through ``DecodeSelfStep``: q, k_t and
    v_t get the gradient of the same steps written out of place with each
    step's own map; each step keeps a copy of its map."""
    g = torch.Generator().manual_seed(6)
    b, k, h, steps, dk = 2, 3, 2, 5, 8
    n = b * k
    qs, ks, vs = ([torch.randn(n, h, dk, generator=g, requires_grad=True) for _ in range(steps)] for _ in range(3))
    douts = [torch.randn(n, h, dk, generator=g) for _ in range(steps)]
    ck, cv = torch.zeros(n, h, steps, dk), torch.zeros(n, h, steps, dk)
    anc = torch.arange(k, dtype=torch.int32)[None, :, None].repeat(b, 1, steps)
    maps, outs = [], []
    for i in range(steps):
        anc = anc.clone()
        anc[:, :, i] = torch.arange(k, dtype=torch.int32)
        maps.append(anc)
        outs.append(k2.decode_self_attention(qs[i], ks[i], vs[i], ck, cv, anc, i))
        parents = torch.randint(0, k, (b, k), generator=g) if i else torch.zeros(b, k, dtype=torch.int64)
        anc = anc.gather(1, parents[..., None].expand(-1, -1, steps))  # the next step's map, a new tensor
    got = torch.autograd.grad(outs, qs + ks + vs, douts)
    ref = [k2.ancestry_self_attention_plain(qs[i], torch.stack(ks[: i + 1], 2), torch.stack(vs[: i + 1], 2),
                                            maps[i][:, :, : i + 1].contiguous(), i) for i in range(steps)]
    want = torch.autograd.grad(ref, qs + ks + vs, douts)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)


def test_beam_gather_backward_sums_each_source():
    """``gather_beams`` with gradients: the forward is the gather, the
    backward each source row's picks summed (a parent with three children
    gets their sum, an unpicked one 0)."""
    x = torch.randn(2, 4, 3, dtype=torch.float32, requires_grad=True)
    ix = torch.tensor([[0, 0, 0, 2], [3, 1, 1, 0]])
    y = gather_beams(x, ix)
    assert torch.equal(y, x.detach().gather(1, ix[..., None].expand(-1, -1, 3)))
    gy = torch.randn(2, 4, 3)
    (gx,) = torch.autograd.grad(y, x, gy)
    want = torch.zeros(2, 4, 3)
    for bb in range(2):
        for j in range(4):
            want[bb, ix[bb, j]] += gy[bb, j]
    torch.testing.assert_close(gx, want, rtol=0, atol=1e-6)
    assert not gx[0, 1].any() and not gx[0, 3].any()


# ------------------------------------------------ beam-sample SCST step
BEAMS = 3
SCST_CFG = dict(lr_scheduler="step", learning_rate=5e-5, optim="adam", grad_clip=0.1, scst_num_samples=BEAMS,
                scst_sample="beam_search", scst_baseline="sample", scst_reward="device", seed=8)


def _ort(mask_type: str):
    inputs = make_inputs(seed=4)
    att, amask, boxes, seqs = inputs
    init = 5.0 if mask_type == "supermask" else 1.0
    jm = JaxORT(**KW, dropout_rate=0.0, drop_prob_src=0.0, mask_cfg=jax_masked.MaskConfig(mask_type, init))
    variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(att), jnp.asarray(amask),
                                 jnp.asarray(seqs), jnp.asarray(boxes)))
    rng = np.random.default_rng(11)
    if mask_type == "supermask":
        draw = lambda m: rng.normal(0.0, 1.5, size=m.shape).astype(np.float32)  # noqa: E731
    else:
        draw = lambda m: (rng.uniform(size=m.shape) >= 0.3).astype(np.float32)  # noqa: E731
    variables["masks"] = jax.tree.map(draw, variables["masks"])
    port = get_model("relation_transformer_prune")(**KW, dropout_rate=0.0, drop_prob_src=0.0, device="cpu",
                                                   mask_cfg=MaskConfig(mask_type, init, keep_masks=True))
    enc = dict(att_feats=att, att_masks=amask, boxes=boxes)
    return jm, variables, load_jax_variables(port, variables), enc, KW["vocab_size"], KW["max_seq_length"]


def _updown():
    jm, variables, port = tus._mask_freeze(drop=0.0, sparsity=0.5)
    att, amask, fc = tus.make_inputs()
    return jm, variables, port, dict(att_feats=att, att_masks=amask, fc_feats=fc), tus.V, tus.L


def _jax_beam_scst(jm, variables, enc, steps, reward):
    """The JAX step's loss and gradients: the train-mode encode and beam
    search under the step's key, differentiated whole
    (``engine/training.py:467-468,768-770``)."""
    df, ref_len, gts, tok2id, vocab = reward
    opt = {"beam_size": BEAMS, "max_seq_length": steps, "decode_train": True}
    key = jax.random.PRNGKey(17)
    enc_j = {k: jnp.asarray(v) for k, v in enc.items()}
    table_j = devr.DfTable.build(df, ref_len, tok2id)
    pack_j = devr.ref_pack_device(devr.build_ref_pack(gts, df, ref_len, tok2id, vocab_size=vocab))
    score = devr.make_reward_device_fn(table_j, cider_weight=1.0, bleu_weight=BLEU)
    rows = 2 * BEAMS

    def loss_fn(params, masks):
        v = {"params": params, "masks": masks}
        k_drop, k_mask, k_dec = jax.random.split(key, 3)
        memory = jm.apply(v, **enc_j, train=True, rngs={"dropout": k_drop, "mask": k_mask}, method="encode")
        seq, seq_lp = jax_generate(jm, v, memory, opt, rng=k_dec)
        flat = jax.lax.stop_gradient(seq).reshape(rows, steps)
        sc = score(flat, jnp.repeat(jnp.arange(2), BEAMS), table_j.device_arrays(), pack_j)
        rewards = jax.lax.stop_gradient(sc - devr.leave_one_out_baseline(sc, BEAMS))
        loss = jax_losses.reward_loss(seq_lp.reshape(rows, steps), (flat != 0).astype(jnp.float32), rewards)
        return loss, (flat, sc, rewards)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    (loss, (flat, sc, rewards)), (gw, gm) = grad_fn(variables["params"], variables["masks"])
    jax.effects_barrier()
    grads = convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False)
    return float(loss), np.asarray(flat), np.asarray(sc), np.asarray(rewards), grads


@pytest.mark.parametrize("family", ["ort_mask_freeze", "ort_supermask", "updown"])
def test_beam_scst_step_matches_jax(family, tmp_path, monkeypatch):
    """One beam-sample SCST step (2 images x 3 beams, leave-one-out baseline,
    CIDEr-D + BLEU-4, dropout 0): the port's train-mode beam search gives the
    JAX search's beams (a supermask model drawing the JAX side's uniforms at
    each step), and its gradient pass, the search run again with gradients on
    the recorded decisions (the ORT through K2's backward in the ancestry
    mode, Up-Down through the states' reorders), gives JAX's rewards, loss
    and gradients."""
    setup = {"ort_mask_freeze": lambda: _ort("mask_freeze"), "ort_supermask": lambda: _ort("supermask"),
             "updown": _updown}[family]
    jm, variables, port, enc, vocab, steps = setup()
    df, ref_len, gts, tok2id = sm._reward_setup(tmp_path, vocab)
    supermask = family == "ort_supermask"
    recorder = sm._Recorder(monkeypatch) if supermask else None
    loss_j, flat_j, sc_j, rewards_j, grads = _jax_beam_scst(jm, variables, enc, steps,
                                                            (df, ref_len, gts, tok2id, vocab))
    assert (flat_j != 0).sum() > 12 and len(np.unique(flat_j)) > 5
    if supermask:
        assert sum(s is not None for _, s in recorder.uniforms) > 0
        names = {id(m): n for n, m in port.named_modules()}
        streams = []

        def jax_stream(k):
            streams.append(sm._JaxUniformStream(k, recorder.uniforms, names))
            return streams[-1]

        monkeypatch.setattr(port_training, "KeyedStream", jax_stream)
        monkeypatch.setattr(port_api, "KeyedStream", jax_stream)

    config = dict(SCST_CFG, max_seq_length=steps + 1)
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), config, port_optim.make_schedule(config))
    opt_m = port_optim.build_mask_optimizer(masks.values(), config, trainable=supermask)
    table = port_devr.DfTable.build(df, ref_len, tok2id)
    step = make_scst_step(port, opt_w, opt_m, config, port_devr.make_reward_fn(table, bleu_weight=BLEU))
    batch = {k: t(v) for k, v in enc.items()}
    batch["ref_pack"] = port_devr.scst_ref_pack(gts, df, table, tok2id, vocab, "cpu")
    res = step.sample_fn(TrainState(), batch)
    assert isinstance(res["decisions"], BeamDecisions) and res["decisions"].tokens.shape == (steps, 2, BEAMS)
    np.testing.assert_array_equal(res["sample"].reshape(2 * BEAMS, steps).numpy(), flat_j)
    state, loss, aux = step.grad_fn(TrainState(), batch, res)
    assert state.step == 1
    if supermask:
        used = set().union(*(s.used for s in streams))
        assert used == set(recorder.uniforms), sorted(set(recorder.uniforms) ^ used)[:5]
    np.testing.assert_allclose(float(aux["avg_sample"]), float(np.mean(sc_j)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["avg_reward"]), float(np.mean(rewards_j)), rtol=1e-5, atol=1e-6)
    # the leave-one-out rewards of an image sum to 0, so the loss cancels: it is held to 1e-5 of the scale
    # of its terms (the mean |reward| times a token's log-prob, ~1), or of itself where that is larger
    assert abs(float(loss) - loss_j) <= 1e-5 * max(abs(loss_j), float(np.abs(rewards_j).mean()))
    assert float(np.abs(rewards_j).max()) > 1e-3  # the beams' rewards differ: a gradient to hold
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    top = max(float(g.abs().max()) for g in grads.values())
    assert top > 1e-4
    for name, g in grads.items():
        gtol = STEP_GRAD_TOL * float(g.abs().max()) + 1e-6 * top
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0, atol=gtol, err_msg=name)
        ratio = float((named[name].grad - g).norm()) / (1e-2 * float(g.norm()) + 1e-6 * top * g.numel() ** 0.5)
        assert ratio <= 1, name


@pytest.mark.parametrize("family", ["ort", "updown"])
def test_beam_gradient_pass_replays_the_sampling_search(family):
    """With dropout 0.3: the forced search with gradients (``beam_log_probs``)
    gives the sampling search's beams and its chosen log-probs exactly (the
    same plain functions on the same draws), its log-probs carry gradients,
    and another decode seed's draws move them; a wrong decision fails the
    grad pass's check."""
    if family == "ort":
        model = get_model("relation_transformer_prune")(**KW, dropout_rate=0.3, drop_prob_src=0.3, device="cpu",
                                                        mask_cfg=MaskConfig("mask_freeze", keep_masks=True))
        att, amask, boxes, _ = make_inputs(seed=4)
        fields = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes))
        steps = KW["max_seq_length"]
    else:
        _, _, model = tus._mask_freeze(drop=0.3, sparsity=0.5)
        att, amask, fc = tus.make_inputs()
        fields = dict(att_feats=t(att), att_masks=t(amask), fc_feats=t(fc))
        steps = tus.L
    opt = {"beam_size": BEAMS, "max_seq_length": steps, "decode_train": True}
    with torch.no_grad():
        memory = model.encode(**fields, train=True, rng=KeyedStream(11))
        seq, seq_lp, decisions = generate(model, memory, opt, rng=12, return_decisions=True)
        eval_seq, _ = generate(model, model.encode(**fields), {"beam_size": BEAMS, "max_seq_length": steps})
    assert not torch.equal(seq, eval_seq)  # the train policy is really on
    memory = model.encode(**fields, train=True, rng=KeyedStream(11))
    seq2, lp2 = beam_log_probs(model, memory, decisions, 12)
    assert torch.equal(seq2, seq) and lp2.requires_grad
    valid = seq != model.pad_id
    assert int(valid.sum()) > 6
    assert torch.equal(lp2.detach()[valid], seq_lp[valid])
    (lp2[valid].sum()).backward()
    assert any(p.grad is not None and p.grad.abs().max() > 0 for p in model.parameters())
    _, lp3 = beam_log_probs(model, model.encode(**fields, train=True, rng=KeyedStream(11)), decisions, 13)
    assert (lp3.detach() - lp2.detach())[valid].abs().max() > 1e-4
