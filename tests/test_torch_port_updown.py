"""Up-Down LSTM of the PyTorch port against the JAX package on the CPU, at small
widths (rnn 16, att_hid 8, vocab 30, 5 regions with padding, 6 steps): the
plain versions behind kernels K11 (LSTM cell), K12 (additive attention) and
K13 (vocabulary log-softmax), the weight bridge, teacher-forced eval
log-probs, beam-5 decoding (identical tokens) and one whole supermask XE step
with the JAX side's mask uniforms replayed call by call (dropout 0).
Tolerances are f32 1e-5 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparse_caption_tpu.ops.masked as jax_masked
from _torch_port_common import t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.engine import optim as jax_optim
from sparse_caption_tpu.models import up_down as jud
from sparse_caption_tpu.pruning.engine import compute_sparsity_loss as jax_sparsity_loss
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import TrainState, make_xe_step, sparsity_loss_args
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.models import up_down as pud
from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedLinear, split_params
from sparse_caption_tpu_torch.ops.rng import TrainRandom
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

V, RNN, ENC, HID, FEAT, R, T = 30, 16, 16, 8, 12, 5, 7
KW = dict(vocab_size=V, rnn_size=RNN, input_encoding_size=ENC, att_hid_size=HID, fc_feat_size=FEAT,
          att_feat_size=FEAT, max_seq_length=T - 1)
TOL = dict(rtol=1e-5, atol=1e-5)
N_MASKED = 11  # embed, fc/att_embed, ctx2att, 2 x (ih, hh), h2att, alpha_net, logit_0


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **(tol or TOL))


def make_inputs(seed: int = 0, batch: int = 2, spi: int = 1):
    """att (B, R, F), att mask (B, R) with image 1's last two regions padded,
    fc (B, F), BOS-led seqs (B * spi, T) with pads."""
    rng = np.random.default_rng(seed)
    att = rng.normal(size=(batch, R, FEAT)).astype(np.float32)
    fc = rng.normal(size=(batch, FEAT)).astype(np.float32)
    amask = np.ones((batch, R), np.float32)
    amask[1, R - 2:] = 0.0
    seqs = rng.integers(4, V, size=(batch * spi, T)).astype(np.int32)
    seqs[:, 0] = 2
    seqs[0, 5:] = [3, 0]
    seqs[-1, 4:] = [3, 0, 0]
    return att, amask, fc, seqs


def jax_setup(mask_type=None, mask_seed=None, drop=0.5):
    """(JAX model, numpy variables, inputs); supermask logits ~ N(0, 2) with a mask seed."""
    cfg = jax_masked.MaskConfig(mask_type, 5.0) if mask_type else None
    jm = jud.UpDownModel(**KW, drop_prob_lm=drop, mask_cfg=cfg)
    inputs = make_inputs()
    att, amask, fc, seqs = (jnp.asarray(a) for a in inputs)
    variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, att, amask, seqs, fc_feats=fc))
    if mask_seed is not None:
        rng = np.random.default_rng(mask_seed)
        variables["masks"] = jax.tree.map(lambda m: rng.normal(0.0, 2.0, size=m.shape).astype(np.float32),
                                          variables["masks"])
    return jm, variables, inputs


def port_model(variables, mask_cfg=None, drop=0.5):
    model = get_model("up_down_lstm_prune")(**KW, drop_prob_lm=drop, mask_cfg=mask_cfg, device="cpu")
    return load_jax_variables(model, variables)


# ------------------------------------------------------------ K11 twin
def test_k11_lstm_cell_twin_matches_jax():
    """``MaskedLSTMCell`` (GEMMs + K11's plain version) vs the JAX cell: (h', c')
    and the gradients of x, h, c and both projections."""
    rng = np.random.default_rng(1)
    n, din, h = 4, 7, RNN
    x, hh, cc = (rng.normal(size=s).astype(np.float32) for s in ((n, din), (n, h), (n, h)))
    gh_out, gc_out = rng.normal(size=(2, n, h)).astype(np.float32)
    cell = jud.MaskedLSTMCell(h)
    params = to_numpy(cell.init(jax.random.PRNGKey(1), jnp.asarray(x), (jnp.asarray(hh), jnp.asarray(cc))))
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.1, size=a.shape).astype(np.float32), params)  # nonzero biases

    def jfn(params, x, h, c):
        return cell.apply(params, x, (h, c))

    ref, vjp = jax.vjp(jfn, params, jnp.asarray(x), jnp.asarray(hh), jnp.asarray(cc))
    port = pud.MaskedLSTMCell(din, h, device="cpu")
    port.load_state_dict(convert_jax_variables(params))
    px, ph, pc = (t(a).requires_grad_() for a in (x, hh, cc))
    out = port(px, ph, pc)
    _close(out[0], ref[0])
    _close(out[1], ref[1])
    grads = torch.autograd.grad(out, (px, ph, pc, port.ih.weight, port.ih.bias, port.hh.weight, port.hh.bias),
                                (t(gh_out), t(gc_out)))
    dparams, dx, dh, dc = vjp((jnp.asarray(gh_out), jnp.asarray(gc_out)))
    refs = [dx, dh, dc, dparams["params"]["ih"]["kernel"].T, dparams["params"]["ih"]["bias"],
            dparams["params"]["hh"]["kernel"].T, dparams["params"]["hh"]["bias"]]
    for g, r in zip(grads, refs):
        _close(g, r)


# ------------------------------------------------------------ K12 twin
@pytest.mark.parametrize("case", ["grouped rows", "all padded"])
def test_k12_additive_attention_twin_matches_jax(case):
    """``AdditiveAttention`` (h2att GEMM + K12's plain version, memory one row
    per image shared by 3 query rows) vs the JAX module on memory repeated per
    row: output and the gradients of h, att, p_att and both projections. An
    image whose regions are all padded gives zeros and zero gradients."""
    rng = np.random.default_rng(2)
    b, rows = 3, 3
    h = rng.normal(size=(b * rows, RNN)).astype(np.float32)
    att = rng.normal(size=(b, R, RNN)).astype(np.float32)
    p_att = rng.normal(size=(b, R, HID)).astype(np.float32)
    mask = np.ones((b, R), np.float32)
    mask[1, 1] = mask[2, 3:] = 0.0
    if case == "all padded":
        mask[0] = 0.0
    go = rng.normal(size=(b * rows, RNN)).astype(np.float32)
    module = jud.AdditiveAttention(HID)
    rep = lambda a: jnp.repeat(jnp.asarray(a), rows, axis=0)  # noqa: E731
    params = jax.tree.map(np.array, module.init(jax.random.PRNGKey(2), jnp.asarray(h), rep(att), rep(p_att),
                                                rep(mask)))
    params["params"]["alpha_net"]["bias"] += 0.3

    def jfn(params, h, att, p_att):
        return module.apply(params, h, jnp.repeat(att, rows, 0), jnp.repeat(p_att, rows, 0), rep(mask))

    ref, vjp = jax.vjp(jfn, params, jnp.asarray(h), jnp.asarray(att), jnp.asarray(p_att))
    port = pud.AdditiveAttention(RNN, HID, device="cpu")
    port.load_state_dict(convert_jax_variables(params))
    ph, patt, ppa = (t(a).requires_grad_() for a in (h, att, p_att))
    out = port(ph, patt, ppa, t(mask != 0))
    _close(out, ref)
    leaves = (ph, patt, ppa, port.h2att.weight, port.h2att.bias, port.alpha_net.weight, port.alpha_net.bias)
    grads = torch.autograd.grad(out, leaves, t(go))
    dparams, dh, datt, dpa = vjp(jnp.asarray(go))
    dp = dparams["params"]
    refs = [dh, datt, dpa, dp["h2att"]["kernel"].T, dp["h2att"]["bias"], dp["alpha_net"]["kernel"].T,
            dp["alpha_net"]["bias"]]
    for g, r in zip(grads, refs):
        _close(g, r)
    if case == "all padded":
        assert float(out.detach()[:rows].abs().max()) == 0.0 and float(grads[1][0].abs().max()) == 0.0
        assert float(grads[2][0].abs().max()) == 0.0
    assert float(grads[5].abs().max()) > 1e-3  # the alpha_net gradient is real


# ------------------------------------------------------------ K13 twin
def _ulp_bf16(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bfloat16_to_float32"])
def test_k13_vocab_log_softmax_twin_matches_jax(dtype):
    """Value and VJP of K13's plain version vs ``jax.nn.log_softmax``. In
    bf16 the value rounds where JAX's all-bf16 log_softmax does (Up-Down's
    site: the shift, the sum of the exponentials and its log), held bit for
    bit; the VJP is the f32 log-softmax's rounded to bf16, within one bf16
    ulp of JAX's f32 VJP rounded to bf16. The ORT generator's train site takes
    bf16 logits to f32 log-probs (``layers.py:465-472``): the value within
    1e-5 of JAX's ``log_softmax(x.astype(f32))`` and the VJP, back to bf16,
    within one bf16 ulp. The logits carry an offset of 20."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(6, 4, V)) * 3 + 20).astype(np.float32)
    g = np.zeros_like(x)  # the NLL's cotangent: -1/n at each row's target
    g[np.arange(6)[:, None], np.arange(4)[None, :], rng.integers(0, V, size=(6, 4))] = -1.0 / 24
    if dtype == "bfloat16_to_float32":
        xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        px = t(xb, torch.bfloat16).requires_grad_()
        out = vocab_log_softmax(px, torch.float32)
        (pg,) = torch.autograd.grad(out, px, t(g))
        assert out.dtype == torch.float32 and pg.dtype == torch.bfloat16
        ref, vjp = jax.vjp(lambda a: jax.nn.log_softmax(a.astype(jnp.float32), axis=-1), jnp.asarray(xb, jnp.bfloat16))
        _close(out, ref)
        ref_g = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
        assert (np.abs(pg.float().numpy() - ref_g) <= _ulp_bf16(ref_g)).all()
        return
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xb = np.asarray(jnp.asarray(x, jd).astype(jnp.float32))  # the inputs as the dtype holds them
    px = t(xb, td).requires_grad_()
    out = vocab_log_softmax(px)
    (pg,) = torch.autograd.grad(out, px, t(g, td))
    assert out.dtype == td and pg.dtype == td
    if dtype == "float32":
        ref, vjp = jax.vjp(lambda a: jax.nn.log_softmax(a, axis=-1), jnp.asarray(xb))
        _close(out, ref)
        _close(pg, vjp(jnp.asarray(g))[0], rtol=1e-5, atol=1e-7)
        return
    ref, vjp = jax.vjp(lambda a: jax.nn.log_softmax(a.astype(jnp.float32), axis=-1).astype(jnp.bfloat16),
                       jnp.asarray(xb, jd))
    ref_g = np.asarray(vjp(jnp.asarray(g, jd))[0].astype(jnp.float32))
    ref = np.asarray(ref.astype(jnp.float32))
    assert (np.abs(pg.float().numpy() - ref_g) <= _ulp_bf16(ref_g)).all()
    all_bf16 = np.asarray(jax.nn.log_softmax(jnp.asarray(xb, jd), axis=-1).astype(jnp.float32))
    np.testing.assert_array_equal(out.float().detach().numpy(), all_bf16)
    assert (out.float().detach().numpy() != ref).any()  # one rounding from f32 lies elsewhere


# ------------------------------------------------------- weight bridge
def test_convert_updown_folded_and_unfolded():
    """``up_down_lstm_prune``'s flax leaves load strictly: masks folded for
    serving, kept as ``<layer>.mask`` for training; ``logit_0`` is ``logit.0``."""
    _, variables, _ = jax_setup("supermask", mask_seed=4)
    state = convert_jax_variables(variables, fold_masks=False)
    masks = sorted(n for n in state if n.endswith(".mask"))
    assert len(masks) == N_MASKED and "logit.0.mask" in masks and "attention.alpha_net.mask" in masks
    np.testing.assert_array_equal(state["logit.0.mask"].numpy(), variables["masks"]["logit_0"]["mask"].T)
    np.testing.assert_array_equal(state["att_lstm.ih.weight"].numpy(),
                                  variables["params"]["att_lstm"]["ih"]["kernel"].T)
    kept = port_model(variables, MaskConfig("supermask", 5.0, keep_masks=True))
    assert len(split_params(kept)[1]) == N_MASKED
    folded = port_model(variables, MaskConfig("supermask"))
    w = variables["params"]["embed"]["embedding"]
    m = variables["masks"]["embed"]["mask"]
    np.testing.assert_array_equal(folded.embed.weight.detach().numpy(), w * (m > 0))


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("mask_type", [None, "supermask"])
def test_teacher_forced_eval_logprobs_match_jax(mask_type):
    jm, variables, inputs = jax_setup(mask_type, mask_seed=5 if mask_type else None)
    att, amask, fc, seqs = inputs
    ref = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(seqs), fc_feats=jnp.asarray(fc))
    port = port_model(variables, MaskConfig(mask_type) if mask_type else None)
    lp = port(t(att), t(amask), t(seqs).long(), fc_feats=t(fc))
    assert lp.shape == (2, T - 1, V) and not lp.requires_grad
    _close(lp, ref)


# -------------------------------------------------------------- decode
@pytest.mark.parametrize("masks", ["folded", "kept"])
def test_beam5_generate_matches_jax(masks):
    """Beam-5 tokens identical to the JAX package (exact f32 top-k on the CPU),
    sequence log-probs within 1e-4; the JAX side repeats the memory per beam,
    the port keeps one row per image."""
    jm, variables, inputs = jax_setup("supermask", mask_seed=6)
    att, amask, fc, _ = inputs
    opt = {"beam_size": 5, "max_seq_length": KW["max_seq_length"], "decoding_constraint": 1}
    memory = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(fc), method="encode")
    ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt))
    port = port_model(variables, MaskConfig("supermask", 5.0, keep_masks=masks == "kept"))
    before = launch_counts()
    seq, lp = generate(port, port.encode(t(att), t(amask), t(fc)), opt)
    assert launch_counts() == before  # CPU tensors take the plain versions
    assert seq.shape == (2, 5, KW["max_seq_length"])
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------- whole XE step
class ReplayRandom(TrainRandom):
    """Hands each masked layer the next recorded JAX uniforms (in the JAX
    package's (in, out) kernel layout, transposed for a Linear)."""

    def __init__(self, recorded):
        super().__init__(torch.Generator())
        self.recorded = list(recorded)

    def mask_uniform(self, layer, shape, device):
        u = self.recorded.pop(0)
        u = np.ascontiguousarray(u.T if isinstance(layer, MaskedLinear) else u)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return t(u)

    def keep_mask(self, shape, keep_prob, device, site=None):
        raise AssertionError("dropout is 0 in this test")


# the paper's Up-Down family (resources/commands_pruning.sh:19,23-25,52-58,98-113)
CFG = dict(lr_scheduler="cosine", learning_rate=0.01, optim_epsilon=0.01, optim="adam", grad_clip=0.1,
           max_train_step=10, prune_sparsity_target=0.991, prune_supermask_sparsity_weight=120,
           caption_model="up_down_lstm_prune")
MASK_LR, MASK_EPS = 100.0, 1e-2  # the mask optimizer's defaults
SPI, N_STEPS = 5, 2


def _jax_xe_steps(monkeypatch):
    jm, variables, _ = jax_setup("supermask", mask_seed=7, drop=0.0)
    att, amask, fc, seqs = make_inputs(seed=8, spi=SPI)
    att, amask, fc, seqs = (jnp.asarray(a) for a in (att, amask, fc, seqs))
    seq_masks = (seqs != 0).astype(jnp.float32)
    params, masks = variables["params"], variables["masks"]
    opt_w = jax_optim.build_weight_optimizer(CFG, jax_optim.make_schedule(CFG))
    opt_m = jax_optim.build_mask_optimizer(CFG, True)
    ow, om = opt_w.init(params), opt_m.init(masks)
    recorded = []
    real_sample = jax_masked.sample_mask

    def recording_sample(mask, cfg, train, rng_key):
        if cfg.is_supermask and train:
            recorded[-1].append(np.asarray(jax.random.uniform(rng_key, mask.shape)))
        return real_sample(mask, cfg, train, rng_key)

    monkeypatch.setattr(jax_masked, "sample_mask", recording_sample)
    steps = []
    for step in range(N_STEPS):
        recorded.append([])

        def loss_fn(params, masks):
            lp = jm.apply({"params": params, "masks": masks}, att, amask, seqs, fc_feats=fc, train=True,
                          rngs={"dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(100 + step)})
            cap = jax_losses.language_model_loss(lp, seqs[:, 1:], seq_masks[:, 1:])
            sp, aux = jax_sparsity_loss(masks, 0.991, 120.0, step, CFG["max_train_step"])
            return cap + sp, dict(aux, caption_loss=cap)

        (loss, aux), (gw, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(params, masks)
        uw, ow = opt_w.update(gw, ow, params)
        um, om = opt_m.update(gm, om, masks)
        params, masks = optax.apply_updates(params, uw), optax.apply_updates(masks, um)
        steps.append(dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                          grads=convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False),
                          state=convert_jax_variables(to_numpy({"params": params, "masks": masks}), fold_masks=False),
                          u=recorded[-1]))
    return variables, steps


def test_xe_step_matches_jax(monkeypatch):
    """Two supermask XE steps at 2 images x 5 captions (cosine, lr 0.01, eps
    0.01, target 0.991, weight 120, dropout 0): 11 masked tensors draw fresh
    uniforms on every call (3 in the encode, 8 per step), replayed from the
    JAX side in its call order. Loss and sparsity aux 1e-5 relative; a
    gradient within 1e-5 of its tensor's largest entry plus 1e-7 of the
    largest of all; params within 1e-6 + 1e-5 |p| plus lr / eps (= 1) times
    the gradient tolerance per update (Adam's slope in g is at most lr /
    eps); masks within 1e-5 |m| plus 1e4 times their gradient's tolerance
    per update (lr 100, eps 1e-2)."""
    variables, steps = _jax_xe_steps(monkeypatch)
    assert all(len(s["u"]) == 3 + 8 * (T - 1) for s in steps)
    model = port_model(variables, MaskConfig("supermask", 5.0, keep_masks=True), drop=0.0)
    assert sparsity_loss_args(model.mask_cfg, CFG) == (0.991, 120.0)
    params, masks = split_params(model)
    opt_w = port_optim.build_weight_optimizer(params.values(), CFG, port_optim.make_schedule(CFG))
    opt_m = port_optim.build_mask_optimizer(masks.values(), CFG, trainable=True)
    xe_step = make_xe_step(model, opt_w, opt_m, CFG)
    att, amask, fc, seqs = make_inputs(seed=8, spi=SPI)
    batch = dict(att_feats=t(att), att_masks=t(amask), fc_feats=t(fc), seqs=t(seqs).long(),
                 seq_masks=t((seqs != 0).astype(np.float32)))
    state = TrainState()
    named = dict(model.named_parameters())
    lr_eps = CFG["learning_rate"] / CFG["optim_epsilon"]
    acc_tol = {}
    for ref in steps:
        rng = ReplayRandom(ref["u"])
        state, loss, aux = xe_step(state, batch, rng)
        assert not rng.recorded  # every JAX draw consumed, in order
        np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
        for k, v in ref["aux"].items():
            np.testing.assert_allclose(float(aux[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert set(ref["grads"]) == set(named)
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        for name, g in ref["grads"].items():
            gtol = 1e-5 * float(g.abs().max()) + 1e-7 * top
            _close(named[name].grad, g, rtol=0, atol=gtol, err_msg=name)
            acc_tol[name] = acc_tol.get(name, 0.0) + (MASK_LR / MASK_EPS if name in masks else lr_eps) * gtol
        for name, p in ref["state"].items():
            err = np.abs(named[name].detach().numpy() - p.numpy())
            allowed = 1e-6 + acc_tol[name] + 1e-5 * np.abs(p.numpy())
            assert (err <= allowed).all(), f"{name}: worst err/allowed {(err / allowed).max():.3g}"
    assert state.step == N_STEPS and ref["aux"]["anneal_rate"] < 1  # the sparsity term acted in step 2


# ------------------------------------------------------ Up-Down options
def test_unported_updown_options_raise():
    """The options once refused: ``logit_layers`` 2 (a hidden rnn -> rnn
    layer with ReLU and dropout before the output layer) and ``ss_prob`` 0.25
    (scheduled sampling, train-mode XE only) build, and their eval
    teacher-forced log-probs and beam-5 tokens match the JAX package's;
    encode still needs ``fc_feats``."""
    for kw in (dict(ss_prob=0.25), dict(logit_layers=2)):
        jm = jud.UpDownModel(**KW, **kw, drop_prob_lm=0.5)
        att, amask, fc, seqs = make_inputs()
        variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(att), jnp.asarray(amask),
                                     jnp.asarray(seqs), fc_feats=jnp.asarray(fc)))
        port = load_jax_variables(get_model("up_down_lstm")(**KW, **kw, device="cpu"), variables)
        assert len(port.logit) == kw.get("logit_layers", 1) and port.ss_prob == kw.get("ss_prob", 0.0)
        ref = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(seqs), fc_feats=jnp.asarray(fc))
        _close(port(t(att), t(amask), t(seqs).long(), fc_feats=t(fc)), ref)
        opt = {"beam_size": 5, "max_seq_length": KW["max_seq_length"]}
        memory = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), fc_feats=jnp.asarray(fc), method="encode")
        ref_seq, _ = jax_generate(jm, variables, memory, opt)
        seq, _ = generate(port, port.encode(t(att), t(amask), t(fc)), opt)
        np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
    with pytest.raises(ValueError, match="fc_feats"):
        port.encode(t(att), t(amask))
