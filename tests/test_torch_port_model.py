"""Whole-model parity of the PyTorch port against the JAX package on the CPU:
ORT and Transformer XE log-probs (dense and supermask/magnitude-folded, 1e-4),
the encoded memory, and the port's cached decode against its own teacher
forcing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    KW, T, jax_mask_cfg, jax_variables, make_inputs, port_mask_cfg, port_model, t)
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.models.transformer import Transformer as JaxTransformer
from sparse_caption_tpu.models.transformer import _unique_layer_plan as jax_plan
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.models.transformer import _unique_layer_plan
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables

LP_TOL = dict(rtol=1e-4, atol=1e-4)
JAX_CLASSES = {"relation_transformer": JaxORT, "transformer": JaxTransformer}


def _jax_setup(name, mask_type=None, mask_seed=None):
    inputs = make_inputs()
    jm = JAX_CLASSES[name](**KW, mask_cfg=jax_mask_cfg(mask_type) if mask_type else None)
    variables = jax_variables(jm, inputs, mask_seed=mask_seed, mask_type=mask_type or "supermask")
    return jm, variables, inputs


def _port_args(inputs):
    att, amask, boxes, seqs = inputs
    return t(att), t(amask), t(seqs).long(), t(boxes)


@pytest.mark.parametrize("name,mask_type", [
    ("relation_transformer", None),
    ("relation_transformer", "supermask"),
    ("relation_transformer", "mag_blind"),
    ("transformer", None),
])
def test_xe_logprobs_match_jax(name, mask_type):
    jm, variables, inputs = _jax_setup(name, mask_type, mask_seed=7 if mask_type else None)
    att, amask, boxes, seqs = inputs
    ref = np.asarray(jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(seqs),
                              jnp.asarray(boxes)))
    port = port_model(name + ("_prune" if mask_type else ""), variables,
                      port_mask_cfg(mask_type) if mask_type else None)
    a, m, s, b = _port_args(inputs)
    out = port(a, m, s, b).numpy()
    assert out.shape == (2, T - 1, KW["vocab_size"])
    np.testing.assert_allclose(out, ref, **LP_TOL)
    if mask_type:
        # the fold really pruned: some weights are exactly zero
        assert (port.decoder_layers[0].self_attn.q_proj.weight == 0).float().mean() > 0.2


def test_encode_memory_matches_jax():
    jm, variables, inputs = _jax_setup("relation_transformer")
    att, amask, boxes, _ = inputs
    ref = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    port = port_model("relation_transformer", variables)
    a, m, _, b = _port_args(inputs)
    enc = port.encode(a, m, b)
    np.testing.assert_allclose(enc["memory"].numpy(), np.asarray(ref["memory"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(enc["mask"].numpy(), amask)


@pytest.mark.parametrize("beam_ancestry", [False, True])
def test_decode_step_unrolled_matches_teacher_forcing(beam_ancestry):
    """Inside the port: cached decode_step over seqs == XE forward at every step."""
    _, variables, inputs = _jax_setup("relation_transformer")
    port = port_model("relation_transformer", variables)
    a, m, s, b = _port_args(inputs)
    full = port(a, m, s, b)
    enc = port.encode(a, m, b)
    cache = port.init_cache(enc, T - 1, rows_per_image=1, beam_ancestry=beam_ancestry)
    for step in range(4):  # steps before any pad token
        lp, cache = port.decode_step(s[:, step], cache, step, enc)
        np.testing.assert_allclose(lp.numpy(), full[:, step].numpy(), rtol=1e-5, atol=1e-5)
    if beam_ancestry:
        np.testing.assert_array_equal(cache["ancestry"].numpy(), 0)


def test_init_cache_layout():
    _, variables, inputs = _jax_setup("relation_transformer")
    port = port_model("relation_transformer", variables)
    a, m, _, b = _port_args(inputs)
    cache = port.init_cache(port.encode(a, m, b), 6, rows_per_image=5, beam_ancestry=True)
    dk = KW["d_model"] // KW["num_heads"]
    assert len(cache["layers"]) == KW["num_layers"]
    assert cache["layers"][0]["self_k"].shape == (10, KW["num_heads"], 6, dk)
    assert cache["static"]["cross"][0]["cross_k"].shape == (2, KW["num_heads"], 5, dk)
    assert cache["ancestry"].dtype == torch.int32
    np.testing.assert_array_equal(cache["ancestry"][1, :, 3].numpy(), np.arange(5))


def test_layer_plan_registry_and_unported_options():
    for share in (None, (0, 0, 1, 1)):
        assert _unique_layer_plan(4, share) == jax_plan(4, share)
    assert get_model("relation_transformer_prune") is get_model("relation_transformer")
    assert get_model("transformer_prune") is get_model("transformer")
    cls = get_model("relation_transformer")
    # ACORT's options build (tests/test_torch_port_acort.py holds them against JAX); a plan holds one layer an index
    shared = cls(**KW, share_att_encoder="kv", share_att_decoder="qk", share_layer_decoder=(0, 0), device="cpu")
    assert len(shared.decoder_layers) == 1 and shared.dec_plan == (0, 0) and len(shared.box_encoder_layers) == 2
    with pytest.raises(ValueError):  # no such layout
        cls(**KW, share_att_encoder="vk", device="cpu")
    raw = cls.from_config(dict(KW, no_box_trigonometric_embedding=True), device="cpu")  # the 4-wide raw geometry
    assert not raw.box_trigonometric_embedding and raw.box_encoder_layers[0].self_attn.wg.weight.shape[1] == 4
    port = cls(**KW, device="cpu")
    a, m, s, b = _port_args(make_inputs())
    with pytest.raises(ValueError, match="rng"):  # a train-mode decode needs its random source
        port.init_cache(port.encode(a, m, b), 6, train=True)
    with pytest.raises(ValueError, match="rng"):
        port.encode(a, m, b, train=True)
    with pytest.raises(ValueError):
        port.encode(a, m)


def test_convert_rejects_masks_without_config():
    _, variables, _ = _jax_setup("relation_transformer", "supermask", mask_seed=1)
    with pytest.raises(ValueError, match="MaskConfig"):
        convert_jax_variables(variables)


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("relation_transformer")(**KW)
