"""The port's checkpoints (``sparse_caption_tpu_torch/engine/checkpoints.py``)
and the prune-training hooks that read and write them
(``engine/prune_training.py``) against the JAX package on the CPU.

JAX-written flax msgpack files (``model_init``, a binarized-mask
checkpoint, a chunked array, a bf16 leaf) load into the port without flax;
the port's own ``model_<tag>.pt`` round-trips with its update count; a
lenient restore logs missing and extra keys to ``restore_log.txt`` and does
not fail; a lottery rewind restores the snapshot's weights and keeps the
new masks; the pruned exports carry the JAX package's names and layouts.
Everything is compared exactly (the same bits are copied, not computed).
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port_common import KW, jax_variables, make_inputs, to_numpy
from sparse_caption_tpu.engine.checkpoints import save_pytree
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.ops.masked import MaskConfig as JaxMaskConfig
from sparse_caption_tpu.pruning import engine as jpe
from sparse_caption_tpu_torch.engine import checkpoints as ckpt
from sparse_caption_tpu_torch.engine import prune_training as ppt
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.pruning import engine as ppe
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables


def _jax(mask_type, seed=0, mask_seed=None):
    jm = JaxORT(**KW, mask_cfg=JaxMaskConfig(mask_type, 5.0 if mask_type == "supermask" else 1.0))
    inputs = make_inputs(seed=seed)
    variables = jax_variables(jm, inputs, mask_seed=mask_seed, mask_type=mask_type)
    if seed:  # other weights than init's own: shift every param
        variables["params"] = jax.tree.map(lambda p: (p + np.float32(0.01 * seed)).astype(np.float32),
                                           variables["params"])
    return variables


def _port(mask_type, **kw):
    return get_model("relation_transformer_prune")(**dict(KW, **kw), device="cpu",
                                                   mask_cfg=MaskConfig(mask_type, keep_masks=True))


def _state(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _assert_state(model, ref):
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].detach().numpy(), ref[k].numpy(), err_msg=k)


def test_flax_msgpack_model_init_loads(tmp_path):
    """A ``model_init.msgpack`` written by the JAX package reads as flax reads
    it and loads into the port's model."""
    variables = _jax("mag_uniform")
    path = save_pytree(str(tmp_path / "model_init.msgpack"), variables)
    tree = ckpt.read_flax_msgpack(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(jax.tree_util.tree_leaves(tree))
    for kp, leaf in flat:
        node = tree
        for k in kp:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    model = _port("mag_uniform")
    step, missing, unexpected = ckpt.restore_lenient(model, path)
    assert (step, missing, unexpected) == (0, [], [])
    _assert_state(model, convert_jax_variables(to_numpy(variables), fold_masks=False))


def test_flax_msgpack_chunked_and_bf16_leaves(tmp_path, monkeypatch):
    """flax's chunked layout (arrays above its chunk size, shrunk here) and a
    bf16 leaf (widened to f32 exactly)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(50, dtype=np.float32).reshape(5, 10)
    half = jax.numpy.asarray(np.linspace(-3, 3, 7, dtype=np.float32), jax.numpy.bfloat16)
    path = tmp_path / "x.msgpack"
    path.write_bytes(serialization.to_bytes({"a": {"big": big, "half": half, "s": np.float32(2.5)}}))
    tree = ckpt.read_flax_msgpack(str(path))
    np.testing.assert_array_equal(tree["a"]["big"], big)
    assert tree["a"]["half"].dtype == np.float32
    np.testing.assert_array_equal(tree["a"]["half"], np.asarray(half, np.float32))
    assert tree["a"]["s"] == np.float32(2.5)


def test_pt_round_trip_find_ckpt_and_lenient_log(tmp_path):
    """``model_<tag>.pt`` keeps params, masks and the update count;
    ``find_ckpt`` picks the newer of ``.pt`` and ``.msgpack``; a restore into
    a deeper model logs the missing and the extra keys and loads the rest."""
    model = _port("mag_blind")
    ppe.update_masks_once(model, "mag_blind", 0.5)
    path = ckpt.save_checkpoint(str(tmp_path / "model_last.pt"), model, step=7)
    other = _port("mag_blind")
    assert ckpt.restore_lenient(other, path) == (7, [], [])
    _assert_state(other, _state(model))
    assert ckpt.find_ckpt(str(tmp_path), "model_last") == path
    assert ckpt.find_ckpt(str(tmp_path), "model_best") == str(tmp_path / "model_best.pt")
    msg = save_pytree(str(tmp_path / "model_last.msgpack"), _jax("mag_blind"))
    os.utime(path, (1, 1))
    assert ckpt.find_ckpt(str(tmp_path), "model_last") == msg
    deeper = _port("mag_blind", num_layers=3)
    log = str(tmp_path / "restore_log.txt")
    _, missing, unexpected = ckpt.restore_lenient(deeper, path, log)
    assert missing and all(k.startswith(("decoder_layers.2", "box_encoder_layers.2")) for k in missing)
    assert unexpected == []
    text = open(log).read()
    assert f"Checkpoint `{path}` is missing parameters:" in text and missing[0] in text
    shallow = _port("mag_blind", num_layers=1)
    _, missing, unexpected = ckpt.restore_lenient(shallow, path, log)
    assert missing == [] and unexpected and "contains extra parameters" in open(log).read()
    np.testing.assert_array_equal(shallow.generator.proj.mask.detach().numpy(),
                                  model.generator.proj.mask.detach().numpy())
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_checkpoint(str(tmp_path / "model_best.orbax"))


@pytest.mark.parametrize("with_start_from", [True, False])
def test_lottery_rewind_keeps_new_masks(tmp_path, with_start_from):
    """``post_restore_hook`` for ``lottery_mag_uniform``: masks pruned from the
    trained weights (as the JAX package's host prune), then every weight back
    to the init snapshot: the JAX package's ``model_init.msgpack`` under
    ``start_from``, or this run's own ``model_init.pt``."""
    init = _jax("lottery_mag_uniform")
    trained = _jax("lottery_mag_uniform", seed=3)
    model = load_jax_variables(_port("lottery_mag_uniform"), trained)
    log_dir = tmp_path / "run"
    cfg = dict(prune_sparsity_target=0.7, log_dir=str(log_dir))
    if with_start_from:
        dense = tmp_path / "dense"
        save_pytree(str(dense / "model_init.msgpack"), init)
        cfg["start_from"] = str(dense)
    else:
        ckpt.save_checkpoint(str(log_dir / "model_init.pt"), load_jax_variables(_port("lottery_mag_uniform"), init))
    ppt.post_restore_hook(model, cfg)
    masks = jpe.update_masks_once(trained["params"], trained["masks"], "lottery_mag_uniform", 0.7)
    _assert_state(model, convert_jax_variables(to_numpy({"params": init["params"], "masks": masks}),
                                               fold_masks=False))
    with pytest.raises(FileNotFoundError, match="init snapshot"):
        ppt.post_restore_hook(model, dict(cfg, start_from=str(tmp_path)))


def test_mask_freeze_starts_from_binarized_masks(tmp_path):
    """A supermask run's binarized-mask checkpoint (the JAX package's
    ``model_best_bin_mask.msgpack``) starts a mask_freeze model."""
    sup = _jax("supermask", mask_seed=3)
    path = save_pytree(str(tmp_path / "model_best_bin_mask.msgpack"),
                       {"params": sup["params"], "masks": jpe.binarize_masks(sup["masks"])})
    model = _port("mask_freeze")
    assert ckpt.restore_lenient(model, path)[1:] == ([], [])
    ppt.post_restore_hook(model, dict(start_from=str(tmp_path)))
    _, masks = split_params(model)
    assert all(set(m.unique().tolist()) <= {0.0, 1.0} for m in masks.values())
    np.testing.assert_array_equal(model.generator.proj.mask.detach().numpy(),
                                  np.asarray(jpe.binarize_masks(sup["masks"])["generator"]["proj"]["mask"]).T)


@pytest.mark.parametrize("mask_type", ["supermask", "mag_uniform"])
def test_export_pruned_best(tmp_path, mask_type):
    """``export_pruned_best`` loads ``model_best`` and writes the pruned
    checkpoint, the binarized masks (supermask), the sparse npz with the JAX
    package's keys and values, and ``sparsities.csv`` by flax path."""
    best = _jax(mask_type, seed=2, mask_seed=5)
    cfg = dict(log_dir=str(tmp_path))
    assert not ppt.export_pruned_best(_port(mask_type), cfg)
    ckpt.save_checkpoint(str(tmp_path / "model_best.pt"), load_jax_variables(_port(mask_type), best))
    model = _port(mask_type)
    assert ppt.export_pruned_best(model, cfg)
    pruned = ckpt.load_checkpoint(str(tmp_path / "model_best_pruned.pt"))
    ref = convert_jax_variables(to_numpy({"params": jpe.prune_weights(best["params"], best["masks"], mask_type)}))
    assert set(pruned["params"]) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(pruned["params"][k].numpy(), ref[k].numpy(), err_msg=k)
    assert os.path.exists(tmp_path / "model_best_bin_mask.pt") == (mask_type == "supermask")
    npz = np.load(tmp_path / "model_best_pruned_sparse.npz")
    ref_sparse = jpe.sparse_export(best["params"], best["masks"], mask_type)
    assert set(npz.files) == set(ref_sparse)
    for k in ref_sparse:
        np.testing.assert_array_equal(npz[k], np.asarray(ref_sparse[k]), err_msg=k)
    rows = open(tmp_path / "sparsities.csv").read().splitlines()
    _, _, per = jpe.mask_sparsity(best["masks"], mask_type)
    assert rows == ["tensor,sparsity"] + [f"{k},{float(v):.6f}" for k, v in sorted(per.items())]
