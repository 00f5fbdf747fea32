"""K5's set entry (``kernels/supermask.py supermask_weights``) on the CPU,
where it runs the plain version per tensor, and the masked layers' sets:

* a mixed small set (the shapes of the ORT's wg and Up-Down's alpha_net, a
  size that is not a multiple of 8, a square) in f32 and bf16, every mode,
  bypass on and off: w_eff and the gradients equal the per-tensor plain
  results and the JAX package's ``_masked`` (its ``sample_mask`` times the
  kernel, cast back), the uniforms drawn as ``jax.random.bernoulli`` draws
  them;
* a small ORT's and a small Up-Down's train forward: the set draws each
  layer's mask uniforms in the order and shapes in which the layers use
  their products (the order of the per-layer draws before sets), in one set
  for the ORT's forward (two past 128 tensors) and one for Up-Down's encode
  plus one per unrolled step.

Tolerances: w_eff and dw exact (a product with 0 or 1); dm 1e-6 relative
(sigmoid' taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import KW as ORT_KW
from _torch_port_common import make_inputs as ort_inputs
from sparse_caption_tpu.ops import masked as jax_masked
from sparse_caption_tpu_torch.kernels import supermask as k5
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops import masked as port_masked
from sparse_caption_tpu_torch.ops.masked import MaskConfig, _Prunable
from sparse_caption_tpu_torch.ops.rng import TrainRandom

SHAPES = [(8, 64), (1, 512), (7, 13), (24, 24)]
JAX_MASK_TYPE = {"sample": "supermask", "round": "supermask", "multiply": "mask_freeze"}


def _jax_masked(kernel, mask, mode, bypass, key, g):
    """The JAX package's ``_masked`` product and its gradients (dkernel, dmask)."""
    cfg = jax_masked.MaskConfig(JAX_MASK_TYPE[mode], 5.0, bypass_sigmoid_grad=bypass)

    def f(k, m):
        out = (k * jax_masked.sample_mask(m, cfg, mode == "sample", key)).astype(k.dtype)
        return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(kernel, mask)
    return out, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sample", "round", "multiply"])
@pytest.mark.parametrize("bypass", [False, True])
def test_set_plain_matches_per_tensor_and_jax(dtype, mode, bypass):
    rng = np.random.default_rng(5)
    keys = jax.random.split(jax.random.PRNGKey(7), len(SHAPES))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ws, ms, us, gs, refs = [], [], [], [], []
    for sh, key in zip(SHAPES, keys):
        w = jnp.asarray(rng.normal(size=sh), jdt)
        m = jnp.asarray(rng.normal(size=sh) * 2.0, jnp.float32)
        if mode == "multiply":
            m = (m > 0).astype(jnp.float32)
        g = jnp.asarray(rng.normal(size=sh), jdt)
        refs.append(_jax_masked(w, m, mode, bypass, key, g))
        ws.append(torch.from_numpy(np.array(w.astype(jnp.float32))).to(tdt).requires_grad_())
        ms.append(torch.from_numpy(np.array(m)).requires_grad_())
        us.append(torch.from_numpy(np.array(jax.random.uniform(key, sh))))
        gs.append(torch.from_numpy(np.array(g.astype(jnp.float32))).to(tdt))
    u_arg = us if mode == "sample" else None
    outs = k5.supermask_weights(ws, ms, u_arg, mode, bypass)
    grads = torch.autograd.grad(outs, ws + ms, gs)
    for i, (out, (ref_out, (ref_dw, ref_dm))) in enumerate(zip(outs, refs)):
        w, m = (x.detach().requires_grad_() for x in (ws[i], ms[i]))
        one = k5.supermask_weight_plain(w, m, None if u_arg is None else us[i], mode, bypass)
        one_dw, one_dm = torch.autograd.grad(one, (w, m), gs[i])
        assert out.dtype == tdt
        assert torch.equal(out, one) and torch.equal(grads[i], one_dw) and torch.equal(grads[len(ws) + i], one_dm)
        np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref_out.astype(jnp.float32)))
        np.testing.assert_array_equal(grads[i].float().numpy(), np.asarray(ref_dw.astype(jnp.float32)))
        np.testing.assert_allclose(grads[len(ws) + i].numpy(), np.asarray(ref_dm), rtol=1e-6, atol=1e-7)


def test_set_checks_inputs():
    w, m, u = torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(4, 8)
    assert len(k5.supermask_weights([w, w], [m, m], [u, u])) == 2
    with pytest.raises(ValueError, match="uniforms"):
        k5.supermask_weights([w], [m])
    with pytest.raises(ValueError, match="no uniforms"):
        k5.supermask_weights([w], [m], [u], "round")
    with pytest.raises(TypeError, match="one dtype"):
        k5.supermask_weights([w, w.bfloat16()], [m, m], [u, u])
    with pytest.raises(ValueError, match="one mask per weight"):
        k5.supermask_weights([w, w], [m], [u, u])
    with pytest.raises(ValueError):
        k5.supermask_weights([w], [torch.zeros(8, 4)], [u])
    assert k5.unit_offsets([512, 91, 8]) == [0, 64, 76, 77]


class _Recording(TrainRandom):
    """Draws as TrainRandom does and records (layer, shape) of each mask draw."""

    def __init__(self):
        super().__init__(torch.Generator().manual_seed(3))
        self.draws = []

    def mask_uniform(self, layer, shape, device):
        self.draws.append((layer, tuple(shape)))
        return super().mask_uniform(layer, shape, device)


def _ort_forward(model, rng):
    att, amask, boxes, seqs = (torch.from_numpy(a) for a in ort_inputs())
    return model(att, amask, seqs.long(), boxes, train=True, rng=rng)


def _updown_forward(model, rng):
    g = np.random.default_rng(8)
    att = torch.from_numpy(g.normal(size=(2, 5, 12)).astype(np.float32))
    fc = torch.from_numpy(g.normal(size=(2, 12)).astype(np.float32))
    seqs = torch.from_numpy(g.integers(4, 30, size=(2, 7))).long()
    seqs[:, 0] = 2
    return model(att, torch.ones(2, 5), seqs, fc, train=True, rng=rng)


UD_KW = dict(vocab_size=30, rnn_size=16, input_encoding_size=16, att_hid_size=8, fc_feat_size=12, att_feat_size=12,
             max_seq_length=6)


@pytest.mark.parametrize("name,kw,forward,sets", [
    ("relation_transformer_prune", ORT_KW, _ort_forward, 1),  # one set for the whole forward
    # 3 + 17 x 8 = 139 masked layers: past a set's 128 tensors, a second launch
    ("relation_transformer_prune", dict(ORT_KW, num_layers=8), _ort_forward, 2),
    ("up_down_lstm_prune", UD_KW, _updown_forward, 1 + 6),  # the encode's, then one a step
])
def test_train_forward_draws_in_call_order(name, kw, forward, sets, monkeypatch):
    model = get_model(name)(**kw, mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    used, launched = [], []
    real_effective, real_set = _Prunable.effective_weight, port_masked.supermask_weights

    def recording_effective(self, rng=None):
        used.append((self, tuple(self.weight.shape)))
        return real_effective(self, rng)

    def recording_set(ws, ms, us=None, mode="sample", bypass=False):
        launched.append(len(ws))
        return real_set(ws, ms, us, mode, bypass)

    monkeypatch.setattr(_Prunable, "effective_weight", recording_effective)
    monkeypatch.setattr(port_masked, "supermask_weights", recording_set)
    rng = _Recording()
    lp = forward(model, rng)
    assert torch.isfinite(lp).all()
    # each product drawn once, in the order the layers use them, in the weights' shapes
    assert [(id(m), s) for m, s in rng.draws] == [(id(m), s) for m, s in used]
    assert len(launched) == sets and sum(launched) == len(used)
    if name.startswith("relation"):
        assert len(used) == len({id(m) for m in model.modules() if isinstance(m, _Prunable)})
    else:  # every call draws afresh: the encode's 3, then 8 a step
        assert launched == [3] + [8] * 6
