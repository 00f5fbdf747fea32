"""Beam-5 decoding of the PyTorch port against the JAX package on the CPU: the
JAX side uses its exact f32 top-k there (``decoding/beam.py:61-63``), so the
token sequences must be identical and the sequence log-probs within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import KW, jax_mask_cfg, jax_variables, make_inputs, port_mask_cfg, port_model, t
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu_torch.decoding import beam_search, generate
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops.masked import MaskConfig
from sparse_caption_tpu_torch.utils.convert_jax import load_jax_variables

OPTS = {
    "plain": {},
    "constrained": {"decoding_constraint": 1, "suppress_UNK": 1, "bad_ending_ids": [5, 9, 12]},
    "wu_penalty": {"length_penalty": "wu_0.7"},
}


@pytest.mark.parametrize("mask_type", [None, "supermask"])
@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_beam5_generate_matches_jax(opt_name, mask_type):
    inputs = make_inputs(seed=3)
    att, amask, boxes, _ = inputs
    jm = JaxORT(**KW, mask_cfg=jax_mask_cfg(mask_type) if mask_type else None)
    variables = jax_variables(jm, inputs, mask_seed=11 if mask_type else None)
    opt = {"beam_size": 5, "max_seq_length": KW["max_seq_length"], **OPTS[opt_name]}
    memory = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt))

    port = port_model("relation_transformer", variables, port_mask_cfg(mask_type) if mask_type else None)
    before = launch_counts()
    seq, lp = generate(port, port.encode(t(att), t(amask), t(boxes)), opt)
    assert launch_counts() == before  # CPU tensors take the plain versions
    assert seq.shape == (2, 5, KW["max_seq_length"])
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-4, atol=1e-4)
    if opt_name == "constrained":
        s = seq.numpy()
        assert not (s[..., 1:] == s[..., :-1])[s[..., 1:] != 0].any()  # no immediate repeats


def test_beam10_generate_matches_jax():
    """A beam wider than 8 (the JAX package takes any width): beam-10 tokens
    identical to the JAX package's, log-probs within 1e-4."""
    inputs = make_inputs(seed=4)
    att, amask, boxes, _ = inputs
    jm = JaxORT(**KW)
    variables = jax_variables(jm, inputs)
    opt = {"beam_size": 10, "max_seq_length": KW["max_seq_length"]}
    memory = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt))
    port = port_model("relation_transformer", variables)
    seq, lp = generate(port, port.encode(t(att), t(amask), t(boxes)), opt)
    assert seq.shape == (2, 10, KW["max_seq_length"])
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-4, atol=1e-4)


def test_beam_search_reorders_only_the_ancestry():
    """The K/V cache tensors the step function sees are the ones init_cache
    built. A cache without the ancestor map has its (B*K, ...) rows reordered
    by parent beam instead (the JAX package's other mode): the same captions."""
    port = port_model("relation_transformer", jax_variables(JaxORT(**KW), make_inputs()))
    att, amask, boxes, _ = make_inputs()
    memory = port.encode(t(att), t(amask), t(boxes))
    cache = port.init_cache(memory, 6, rows_per_image=3, beam_ancestry=True)
    kv = [c["self_k"] for c in cache["layers"]]
    seen = []

    def step_fn(it, cache, step):
        seen.append(all(a is b for a, b in zip(kv, (c["self_k"] for c in cache["layers"]))))
        return port.decode_step_logits(it, cache, step, memory)

    seq, lp = beam_search(step_fn, cache, 2, 3, 6, bos_id=2, eos_id=3)
    assert all(seen) and len(seen) == 6
    assert seq.shape == (2, 3, 6)
    moved = []

    def reorder_step(it, cache, step):
        moved.append(not all(a is b for a, b in zip(kv, (c["self_k"] for c in cache["layers"]))))
        return port.decode_step_logits(it, cache, step, memory)

    seq_r, lp_r = beam_search(reorder_step, port.init_cache(memory, 6, 3), 2, 3, 6, bos_id=2, eos_id=3)
    assert all(moved[1:])
    assert torch.equal(seq_r, seq)
    torch.testing.assert_close(lp_r, lp)


@pytest.mark.parametrize("opt", [{"beam_size": 3, "decode_train": True}])
def test_unported_decode_modes_raise(opt):
    """Beam search under the train policy (beam-sample SCST's sampling pass),
    once refused, against the JAX package's at dropout 0 (the train-mode
    cache and steps, f32 log-probs): identical tokens, log-probs within 1e-4;
    its decisions give the same beams when replayed."""
    from sparse_caption_tpu_torch.engine.training import beam_log_probs

    inputs = make_inputs()
    att, amask, boxes, _ = inputs
    jm = JaxORT(**KW, dropout_rate=0.0, drop_prob_src=0.0)
    variables = jax_variables(jm, inputs)
    opt = dict(opt, max_seq_length=KW["max_seq_length"])
    memory = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt, rng=jax.random.PRNGKey(4)))
    port = load_jax_variables(get_model("relation_transformer")(**KW, dropout_rate=0.0, drop_prob_src=0.0,
                                                                device="cpu"), variables)
    mem = port.encode(t(att), t(amask), t(boxes))
    seq, lp, decisions = generate(port, mem, opt, rng=4, return_decisions=True)
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        seq2, lp2 = beam_log_probs(port, mem, decisions, 4)
    assert torch.equal(seq2, seq) and torch.equal(lp2, lp)
    with pytest.raises(ValueError, match="decode_train needs an rng"):
        generate(port, mem, opt)


def test_beam5_generate_with_kept_masks_matches_jax():
    """A supermask model built with ``keep_masks=True`` (masks as parameters,
    logits of mixed sign) decodes like the JAX package and like the same
    weights with the masks folded: the decode's fused q/k/v projection must
    apply the kept mask (it used the raw weights once)."""
    inputs = make_inputs(seed=5)
    att, amask, boxes, _ = inputs
    jm = JaxORT(**KW, mask_cfg=jax_mask_cfg("supermask"))
    variables = jax_variables(jm, inputs, mask_seed=13)
    opt = {"beam_size": 5, "max_seq_length": KW["max_seq_length"]}
    memory = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt))

    kept = get_model("relation_transformer_prune")(**KW, mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True),
                                                   device="cpu")
    load_jax_variables(kept, variables)
    assert kept.decoder_layers[0].self_attn.q_proj.mask is not None
    seq, lp = generate(kept, kept.encode(t(att), t(amask), t(boxes)), opt)
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=1e-4, atol=1e-4)
    folded = port_model("relation_transformer", variables, port_mask_cfg("supermask"))
    seq_f, _ = generate(folded, folded.encode(t(att), t(amask), t(boxes)), opt)
    np.testing.assert_array_equal(seq.numpy(), seq_f.numpy())
