"""ORT-xsmall (the ACORT recipe's smallest ORT baseline, d_model 104 over 8
heads: head width 13) in the PyTorch port against the JAX package on the
CPU, and K14 / K15's kv mode on its plain path.

The ORT-xsmall here is the recipe's width (d104, ff416, 8 heads) at 2 + 2
layers over the tiny vocabulary of ``_torch_port_common``, built by both
packages' ``from_config``; weights come from the JAX ``init`` through
``utils/convert_jax.py``, and the XE step's dropout masks are recorded from
JAX's ``bernoulli`` calls and replayed into the port in call order. The
kernels' dk 13 instances run only on the card (``chip_smoke.py
check_xsmall_kernels``); here their wrappers take their plain versions, and
the shared-memory helpers that bound the bf16 kernels are counted by hand at
the padded width (16: rows of 2 x (16 + 8) = 48 bytes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_caption_tpu.config as jax_config
from _torch_port_common import F, T, V, make_inputs, t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu_torch import config as port_config
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import TrainState, make_xe_step
from sparse_caption_tpu_torch.kernels import _checks
from sparse_caption_tpu_torch.kernels.decoder_attention import (
    bf16_backward_smem,
    bf16_forward_smem,
    decoder_attention,
    row_pitch,
)
from sparse_caption_tpu_torch.kernels.grouped_cross_attention import bf16_smem as k3_bf16_smem
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops.attention import score_divisor
from sparse_caption_tpu_torch.ops.masked import split_params
from sparse_caption_tpu_torch.ops.rng import TrainRandom
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)  # f32, summation order only
DEEP_TOL = dict(rtol=1e-4, atol=1e-4)  # after 2 encoder layers, and beam log-probs (as the other model tests)
FLAGS = dict(caption_model="relation_transformer", vocab_size=V, d_model=104, dim_feedforward=416, num_layers=2,
             num_heads=8, att_feat_size=F, max_seq_length=T - 1, pad_token_id=0, bos_token_id=2, eos_token_id=3)
DK = FLAGS["d_model"] // FLAGS["num_heads"]


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _models(inputs, bounded_wg: bool = False):
    """(JAX model, its variables, the port's model with them), both from
    ``from_config`` of FLAGS. ``bounded_wg``: each head's geometry weights 4
    entries of +-0.225 and a bias of 1, so that w_g = relu(geo . wg + 1) lies
    in [0.1, 1.9], away from the clamp's kink, where the gradient of log(w_g)
    (1 / w_g) turns last-bit differences into large ones (as
    ``tests/test_torch_port_train.py`` holds the layer)."""
    att, amask, boxes, seqs = inputs
    jm = JaxORT.from_config(jax_config.Config(**FLAGS))
    jv = to_numpy(jm.init(KEY, *(jnp.asarray(a) for a in (att, amask, seqs, boxes))))
    if bounded_wg:
        rng = np.random.default_rng(11)
        for i in range(FLAGS["num_layers"]):
            wg = jv["params"][f"box_encoder_layers_{i}"]["self_attn"]["wg"]
            kernel = np.zeros_like(wg["kernel"])
            for hh in range(kernel.shape[1]):
                kernel[rng.choice(kernel.shape[0], 4, replace=False), hh] = rng.choice([-0.225, 0.225], 4)
            wg["kernel"], wg["bias"] = kernel, np.ones_like(wg["bias"])
    port = get_model("relation_transformer").from_config(port_config.Config(**FLAGS), device="cpu")
    return jm, jv, load_jax_variables(port, jv)


def test_ort_xsmall_is_head_width_13():
    """ORT-xsmall's d104 over the default 8 heads is head width 13, which the
    attention wrappers now take (the kernels' padded instance)."""
    _, _, port = _models(make_inputs(seed=1))
    assert port.d_model // port.num_heads == DK == 13
    _checks.check_head_width(DK, "decoder_attention")
    assert _checks.padded_width(DK) == 16


def test_ort_xsmall_encode_matches_jax():
    inputs = make_inputs(seed=2)
    att, amask, boxes, _ = inputs
    jm, jv, port = _models(inputs)
    ref = jm.apply(jv, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    with torch.no_grad():
        got = port.encode(t(att), t(amask), t(boxes))
    _close(got["memory"], ref["memory"], **DEEP_TOL)


def test_ort_xsmall_beam5_generate_matches_jax():
    """encode + beam-5 generate: tokens identical to the JAX package's,
    log-probs within 1e-4."""
    inputs = make_inputs(seed=3)
    att, amask, boxes, _ = inputs
    jm, jv, port = _models(inputs)
    opt = {"beam_size": 5}
    memory = jm.apply(jv, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, jv, memory, opt))
    seq, lp = generate(port, port.encode(t(att), t(amask), t(boxes)), opt)
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, **DEEP_TOL)


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
        raise AssertionError("ORT-xsmall is dense")


def test_ort_xsmall_xe_step_matches_jax(monkeypatch):
    """One f32 XE step through ``make_xe_step`` with the ORT's noam (at d104)
    and clip 0.1, dropout 0.1 and 0.5 as the recipe's defaults: loss within
    1e-5 relative and every gradient within 1e-5 of its tensor's largest
    entry plus 1e-7 of the largest gradient anywhere; JAX's 22 keep-masks
    (the source's, 4 an encoder layer, the positional encoding's, 6 a
    decoder layer) replayed call by call; the geometry weights bounded
    (``_models``)."""
    inputs = make_inputs(seed=4)
    att, amask, boxes, seqs = inputs
    seq_masks = (seqs != 0).astype(np.float32)
    jm, jv, port = _models(inputs, bounded_wg=True)
    recorded = []
    real = jax.random.bernoulli

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        recorded.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)

    def loss_fn(params):
        lp = jm.apply({"params": params}, *(jnp.asarray(a) for a in (att, amask, seqs, boxes)), train=True,
                      rngs={"dropout": jax.random.PRNGKey(5)})
        return jax_losses.language_model_loss(lp, jnp.asarray(seqs)[:, 1:], jnp.asarray(seq_masks)[:, 1:])

    loss, grads = jax.value_and_grad(loss_fn)(jv["params"])
    assert len(recorded) == 1 + 2 * 4 + 1 + 2 * 6
    ref_grads = convert_jax_variables(to_numpy({"params": grads}))
    cfg = dict(lr_scheduler="noam", d_model=FLAGS["d_model"], noamopt_warmup=10000, grad_clip=0.1, optim="adam")
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


# ------------------------------------------------------------ K14 / K15 kv mode
@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("dk", [13, 32, 64])
def test_decoder_attention_kv_plain_matches_jax(kind, dk):
    """``decoder_attention(q, kv, None, ...)`` (an ACORT kv-shared layer: V is
    the K tensor) on its plain path against JAX's ``scaled_dot_attention``
    with v = k (K/V repeated to the query rows): the output, and the
    gradients of q and of the shared tensor (its two uses summed), within
    1e-5; equal to the wrapper given the tensor twice."""
    rng = np.random.default_rng(dk + (kind == "cross"))
    h, tq = 4, 6
    b, g, tk = (3, 1, tq) if kind == "self" else (2, 3, 5)
    n = b * g
    q = rng.normal(size=(n, h, tq, dk)).astype(np.float32)
    kv = rng.normal(size=(b, h, tk, dk)).astype(np.float32)
    dout = rng.normal(size=(n, h, tq, dk)).astype(np.float32)
    valid = np.ones((b, tk), bool)
    valid[1, tk - 2:] = False
    causal = kind == "self"
    mask = np.repeat(valid, g, 0)[:, None, None, :] & (np.tril(np.ones((tq, tk), bool)) if causal else True)

    def jfn(q_, kv_):
        kr = jnp.repeat(kv_, g, axis=0)
        return jl.scaled_dot_attention(q_, kr, kr, jnp.asarray(mask))

    ref, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(kv))
    ref_dq, ref_dkv = vjp(jnp.asarray(dout))
    pq, pkv = t(q).requires_grad_(), t(kv).requires_grad_()
    out = decoder_attention(pq, pkv, None, t(valid), causal)
    out.backward(t(dout))
    _close(out, ref)
    _close(pq.grad, ref_dq)
    _close(pkv.grad, ref_dkv)
    twice = decoder_attention(pq, pkv, pkv, t(valid), causal)
    dq2, dkv2 = torch.autograd.grad(twice, (pq, pkv), t(dout))
    assert torch.equal(out, twice) and torch.equal(pq.grad, dq2) and torch.equal(pkv.grad, dkv2)


def test_score_divisor_rounds_sqrt_dk_to_the_dtype():
    """The scores' divisor as JAX's weak typing gives it: sqrt(dk) rounded to
    the scores' dtype (bf16(sqrt(13)) = 3.609375; sqrt(64) = 8 exactly)."""
    assert score_divisor(13, torch.bfloat16) == 3.609375
    assert score_divisor(13, torch.float32) == float(np.float32(np.sqrt(13.0)))
    assert score_divisor(32, torch.bfloat16) == 5.65625
    assert score_divisor(64, torch.bfloat16) == score_divisor(64, torch.float32) == 8.0
    x = jnp.asarray(np.random.default_rng(0).normal(size=4096).astype(np.float32) * 40).astype(jnp.bfloat16)
    want = np.asarray((x / float(np.sqrt(13.0))).astype(jnp.float32))  # a Python float: weakly typed
    got = (t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
           / torch.full((), score_divisor(13, torch.bfloat16), dtype=torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ dk 13 shared memory
def test_dk13_shared_memory_counted_by_hand():
    """The bf16 kernels' shared memory at dk 13, staged at 16: rows of 2 x (16
    + 8) = 48 bytes; ORT-xsmall's serving (36 regions, beam 5), XE (17
    positions: self over 17 keys, cross over 36 regions, 5 captions an image)
    and the kv modes at ACORT's 26 positions."""
    assert row_pitch(13) == 24 and row_pitch(32) == 40 and row_pitch(64) == 72
    # K3: one stage of ((2 or 1) x regions + rep) x 2 heads + 1 flag row, a zero row, and 2 raw stages: the
    # 16-byte envelopes of the K (and V) span, 2 x 36 x 13 x 2 = 1,872 bytes + 16, of each beam's q span, 2 x
    # 13 x 2 = 52 bytes -> 64 + 16, and the 36 region flags -> 48
    assert k3_bf16_smem(36, 5, dk=13) == ((2 * 36 + 5) * 2 + 2) * 48 + 2 * (2 * 1_888 + 5 * 80 + 48) == 15_936
    assert k3_bf16_smem(36, 5, kv=True, dk=13) == ((36 + 5) * 2 + 2) * 48 + 2 * (1_888 + 5 * 80 + 48)
    # K14: 2 stages of (K, V, the group's q rows) and each member's keep flags, + a zero row
    kp = lambda tq, tk: 16 * -(-(tq * tk + 15) // 16)  # noqa: E731
    assert bf16_forward_smem(17, 17, 1, True, dk=13) == 2 * (2 * (2 * 17 + 17) * 24 + kp(17, 17)) + 48
    assert bf16_forward_smem(17, 36, 5, True, dk=13) == 2 * (2 * (2 * 36 + 5 * 17) * 24 + 5 * kp(17, 36)) + 48
    assert bf16_forward_smem(26, 36, 5, True, dk=13, kv=True) == 2 * (2 * (36 + 5 * 26) * 24 + 5 * kp(26, 36)) + 48
    # K15: 2 stages of (K, V, q and dO rows), a zero row, dS and P~ (positions padded to 16 x keys padded to 16, + 8)
    assert bf16_backward_smem(17, 17, 1, dk=13) == 2 * (2 * (2 * 17 + 2 * 17) * 24 + 24 + 2 * 32 * 40)
    assert bf16_backward_smem(17, 36, 5, dk=13) == 2 * (2 * (2 * 36 + 2 * 5 * 17) * 24 + 24 + 2 * 5 * 32 * 56)
    assert bf16_backward_smem(26, 36, 5, dk=13, kv=True) == 2 * (2 * (36 + 2 * 5 * 26) * 24 + 24 + 2 * 5 * 32 * 56)


@pytest.mark.parametrize("dk,pitch", [(64, 72), (32, 40), (13, 24)])
def test_kv_mode_shared_memory_stages_k_once(dk, pitch):
    """K14 / K15's kv modes stage the shared tensor's Tk rows once a stage: at
    ACORT's XE shapes (26 positions; self over 26 keys, cross over 36
    regions with 5 captions an image) both keep two stages, Tk rows of
    ``pitch`` elements fewer each."""
    for tk, group in ((26, 1), (36, 5)):
        fwd = bf16_forward_smem(26, tk, group, True, dk=dk) - bf16_forward_smem(26, tk, group, True, dk=dk, kv=True)
        bwd = bf16_backward_smem(26, tk, group, dk=dk) - bf16_backward_smem(26, tk, group, dk=dk, kv=True)
        assert fwd == bwd == 2 * 2 * tk * pitch
