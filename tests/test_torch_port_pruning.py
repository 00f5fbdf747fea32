"""The port's pruning engine and prune-training hooks against the JAX package
on the CPU (``sparse_caption_tpu_torch/pruning/engine.py``,
``engine/prune_training.py``, and K16's plain version
``kernels/magnitude_threshold.py``).

A small ORT (2 + 2 layers, d 32) with kept 0/1 masks: the same numpy-seeded
weights go through ``sparse_caption_tpu.pruning.engine`` and the port (via
``utils/convert_jax.py``). The weights hold ties on purpose (a block of exact
zeros, as a pruned checkpoint has, and magnitudes rounded to a coarse grid),
which the stable argsort of the host path breaks by position: the port must
walk each Dense kernel in its JAX (in, out) layout to pick the same elements.

Tolerances: masks are compared exactly, except the device path's dist
family, whose per-tensor mean and std are reductions in another order than
XLA's (at most 4 elements may change sides, the JAX package's own allowance
between its host and device paths, ``tests/test_pruning.py``); SNIP's mask
gradients within 1e-5 (f32, summation order only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_port_common import KW, jax_variables, make_inputs, t, to_numpy
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.ops.masked import MaskConfig as JaxMaskConfig
from sparse_caption_tpu.pruning import engine as jpe
from sparse_caption_tpu_torch.engine import prune_training as ppt
from sparse_caption_tpu_torch.kernels import magnitude_threshold as k16
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.pruning import engine as ppe
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables, to_jax_variables

PAPER_POOL = 55_331_840  # the paper-width ORT's masked weights
HOST_TYPES = ("mag_blind", "mag_uniform", "mag_dist", "mag_grad_blind", "mag_grad_uniform", "lottery_mag_blind",
              "lottery_mag_uniform", "lottery_mag_dist")
DEVICE_TYPES = ("mag_blind", "mag_uniform", "mag_dist", "mag_grad_blind", "mag_grad_uniform", "lottery_mag_dist")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _with_ties(variables):
    """Exact zeros in one kernel (a pruned checkpoint), and two kernels'
    magnitudes on a grid of 1/64 (many equal |w|, of both signs)."""
    fp = _flat(variables["params"])
    zeros = ("decoder_layers_0", "feed_forward", "w_1", "kernel")
    grid = [("decoder_layers_1", "self_attn", "q_proj", "kernel"), ("tgt_embed", "lut", "embedding")]
    for path in [zeros] + grid:
        node = variables["params"]
        for k in path[:-1]:
            node = node[k]
        w = np.array(fp[path])
        if path == zeros:
            w[:, : w.shape[1] // 3] = 0.0
        else:
            w = np.round(w * 64) / 64
        node[path[-1]] = w.astype(np.float32)
    return variables


def _models(mask_type, dropout=0.0):
    """(JAX model, its variables with ties, the port model holding the same
    weights with its masks kept)."""
    inputs = make_inputs(seed=3)
    jm = JaxORT(**KW, dropout_rate=dropout, drop_prob_src=dropout, mask_cfg=JaxMaskConfig(mask_type, 1.0))
    variables = _with_ties(jax_variables(jm, inputs))
    port = get_model("relation_transformer_prune")(**KW, dropout_rate=dropout, drop_prob_src=dropout, device="cpu",
                                                   mask_cfg=MaskConfig(mask_type, keep_masks=True))
    return jm, variables, load_jax_variables(port, variables), inputs


def _assert_masks(port, jax_masks, max_diff=0):
    got, ref = _flat(to_jax_variables(port)["masks"]), _flat(jax_masks)
    assert set(got) == set(ref)
    diff = sum(int((got[p] != ref[p]).sum()) for p in ref)
    assert diff <= max_diff, diff
    return diff


# ----------------------------------------------------------- host one-shot
@pytest.mark.parametrize("mask_type", HOST_TYPES + ("snip",))
def test_update_masks_once_matches_jax(mask_type):
    """Every family's host one-shot masks (and SNIP's from a given saliency)
    equal the JAX package's, ties included, with and without a freeze scope."""
    _, variables, port, _ = _models(mask_type)
    saliency_j = saliency_p = None
    if mask_type == "snip":
        rng = np.random.default_rng(5)
        saliency_j = jax.tree.map(lambda m: (np.round(rng.normal(size=m.shape) * 8) / 8).astype(np.float32),
                                  variables["masks"])
        saliency_p = {mw.name: mw.from_jax(_flat(saliency_j)[mw.path]) for mw in ppe.mask_weight_pairs(port)}
    masks = variables["masks"]
    for scope, target in ((None, 0.8), (["decoder_layers_0", "box_encoder_layers_1/self_attn"], 0.55)):
        masks = jpe.update_masks_once(variables["params"], masks, mask_type, target, scope, snip_saliency=saliency_j)
        ppe.update_masks_once(port, mask_type, target, scope, snip_saliency=saliency_p)
        _assert_masks(port, masks)


def test_layout_decides_ties():
    """Half of the zeroed kernel's tied zeros are pruned: the first ones in
    its (in, out) layout, as the JAX package picks them; walking the port's
    (out, in) weight would pick others."""
    _, variables, port, _ = _models("mag_blind")
    path = ("decoder_layers_0", "feed_forward", "w_1", "mask")
    zero = _flat(variables["params"])[path[:-1] + ("kernel",)] == 0
    total = sum(m.size for m in _flat(variables["masks"]).values())
    target = 0.5 * zero.sum() / total
    ref = _flat(jpe.update_masks_once(variables["params"], variables["masks"], "mag_blind", target))
    ppe.update_masks_once(port, "mag_blind", target)
    assert 0 < int((zero & (ref[path] == 1)).sum()) < int(zero.sum())
    np.testing.assert_array_equal(port.decoder_layers[0].feed_forward.w_1.mask.detach().numpy().T, ref[path])
    pruned_port_order = np.zeros(zero.size, bool)
    pruned_port_order[np.flatnonzero(zero.T)[: int(target * total)]] = True
    assert not np.array_equal(pruned_port_order.reshape(zero.T.shape).T, ref[path] == 0)


# -------------------------------------------------------- device threshold
def _lax_index(n, q):
    """jax's ``_quantile`` index arithmetic, lax op for lax op (f32)."""
    q = jnp.asarray(q, jnp.float32)
    nf = lax.convert_element_type(n, jnp.float32)
    pos = lax.mul(q, nf - 1)
    low, high = lax.floor(pos), lax.ceil(pos)
    hw = lax.sub(pos, low)
    lw = lax.sub(jnp.float32(1), hw)
    low = lax.clamp(jnp.float32(0), low, nf - 1)
    high = lax.clamp(jnp.float32(0), high, nf - 1)
    return int(low), int(high), np.float32(lw), np.float32(hw)


@pytest.mark.parametrize("n", [1, 2, 7, 512, 262_144, 5_120_000, 16_777_220, PAPER_POOL])
def test_quantile_index_is_jax_f32_arithmetic(n):
    """``quantile_index`` against the same lax f32 arithmetic, at the targets
    of the paper's gradual schedule; at the paper's pool f64 would put the
    low index one element off (44,265,471 against f32's 44,265,472)."""
    targets = [0.0, 0.8, 0.5, 0.999] + [ppe.gradual_sparsity_target(0.8, s, 2, 3, prune_frequency=2)
                                         for s in (4, 6)]
    for q in targets:
        lo, hi, lw, hw = k16.quantile_index(n, q)
        assert (lo, hi) == _lax_index(n, q)[:2], q
        assert (lw.tobytes(), hw.tobytes()) == tuple(x.tobytes() for x in _lax_index(n, q)[2:]), q
    if n == PAPER_POOL:
        assert k16.quantile_index(n, 0.8)[0] == 44_265_472 != int(np.floor(0.8 * (n - 1)))


def _jnp_quantile(x, q):
    """``jnp.quantile`` of |x| evaluated op by op (each lax op rounds its
    result). Under ``jit`` XLA:CPU fuses the high product into the add
    (``fma(v_hi, hw, v_lo lw)``), which moves the threshold by an ulp in
    about one pool of six here; the jaxpr's arithmetic, the one K16
    follows, has no fused multiply-add."""
    with jax.disable_jit():
        return np.float32(jnp.quantile(jnp.abs(jnp.asarray(x)), q))


def test_plain_threshold_equals_jnp_quantile_above_2_24():
    """K16's plain version on one pool of 2^24 + 4 distinct magnitudes (more
    than ``torch.quantile`` takes): its threshold equals ``jnp.quantile``'s
    bit for bit, and it prunes the count that threshold implies; there the
    f32 index lies one element above the f64 one."""
    n = 2 ** 24 + 4
    w = (np.arange(n, dtype=np.uint32)[::-1] + np.uint32(0x3C000000)).view(np.float32)  # distinct, from 2^-7 on
    q = 0.8
    masks, th, _ = k16.magnitude_masks([torch.from_numpy(w)], [0], q)
    ref = _jnp_quantile(w, q)
    assert th.numpy()[0].tobytes() == ref.tobytes()
    assert n - int(masks[0].sum()) == int((w <= ref).sum())
    assert k16.quantile_index(n, q)[0] == int(np.floor(q * (n - 1))) + 1


def test_plain_thresholds_equal_jnp_quantile():
    """Pools of a few sizes at many targets, ties among them: the
    interpolation is two f32 products and one add."""
    rng = np.random.default_rng(1)
    for n in (1, 2, 6, 83, 288):
        for trial in range(40):
            w = (rng.normal(size=n) * (rng.integers(0, 2) * 0.98 + 0.01)).astype(np.float32)
            if trial % 3 == 0:
                w = np.round(w * 16) / 16  # ties
            q = float(rng.uniform())
            _, th, _ = k16.magnitude_masks([torch.from_numpy(w)], [0], q)
            assert th.numpy()[0].tobytes() == _jnp_quantile(w, q).tobytes(), (n, q)


@pytest.mark.parametrize("mask_type", DEVICE_TYPES)
def test_update_masks_once_device_matches_jax(mask_type):
    """The device path's plain version against JAX's jitted
    ``update_masks_once_device``: equal masks for the |w| families, at most 4
    elements apart for dist; the schedule's first update (sparsity 0) still
    prunes each pool's minimum and its ties."""
    _, variables, port, _ = _models(mask_type)
    fn = jax.jit(functools.partial(jpe.update_masks_once_device, mask_type=mask_type))
    for target in (0.0, ppe.gradual_sparsity_target(0.8, 4, 2, 3, prune_frequency=2), 0.8):
        ref = fn(variables["params"], variables["masks"], sparsity_target=target)
        th = ppe.update_masks_once_device(port, mask_type, target)
        assert th.shape == ((37,) if "uniform" in mask_type else (1,))
        _assert_masks(port, ref, max_diff=4 if "dist" in mask_type else 0)
    w_1 = port.decoder_layers[0].feed_forward.w_1
    assert not bool(w_1.mask[w_1.weight == 0].any())  # the zeroed block's ties all fall at the first update


def test_update_masks_once_device_respects_freeze_scope():
    _, variables, port, _ = _models("mag_grad_blind")
    scope = ["decoder_layers_0", "box_encoder_layers_1/self_attn"]
    ref = jpe.update_masks_once_device(variables["params"], variables["masks"], "mag_grad_blind", 0.7, scope)
    ppe.update_masks_once_device(port, "mag_grad_blind", 0.7, scope)
    _assert_masks(port, ref)
    assert bool((port.decoder_layers[0].self_attn.q_proj.mask == 1).all())


def test_magnitude_masks_dist_stats_and_given_stats():
    """The plain version's dist stats are (mean, biased std); given other
    stats it uses them (how the card's check holds K16's selection exactly)."""
    rng = np.random.default_rng(2)
    ws = [torch.from_numpy(rng.normal(0.1, 2, size=s).astype(np.float32)) for s in ((7, 5), (300,))]
    masks, th, stats = k16.magnitude_masks(ws, [0, 0], 0.6, dist=True)
    for w, st in zip(ws, stats):
        np.testing.assert_allclose(st.numpy(), [w.numpy().mean(), w.numpy().std()], rtol=1e-6)
    shifted = stats.clone()
    shifted[:, 0] += 1.0
    masks2, _, _ = k16.magnitude_masks_plain(ws, [0, 0], 0.6, dist=True, stats=shifted)
    assert any(not torch.equal(a, b) for a, b in zip(masks, masks2))
    with pytest.raises(ValueError, match="pool ids"):
        k16.magnitude_masks(ws, [0, 2], 0.5)


def test_magnitude_masks_write_out_for_any_tensor_count():
    """More tensors than one kernel table holds (139, the 8-layer ORT's
    count; the card runs them as groups of 128): per-tensor pools and one
    pool give jnp.quantile's thresholds, and the masks land in the given
    tensors, whose version counters move (caches keyed on them rebuild)."""
    rng = np.random.default_rng(3)
    ws = [torch.from_numpy(rng.normal(size=(int(rng.integers(1, 40)),)).astype(np.float32)) for _ in range(139)]
    assert len(ws) > k16.MAX_TENSORS
    for pools in (list(range(len(ws))), [0] * len(ws)):
        out = [torch.full_like(w, 7.0) for w in ws]
        versions = [o._version for o in out]
        masks, th, _ = k16.magnitude_masks(ws, pools, 0.6, out=out)
        assert all(m is o for m, o in zip(masks, out))
        assert all(o._version > v for o, v in zip(out, versions))
        for p in range(max(pools) + 1):
            members = [w.numpy() for w, pp in zip(ws, pools) if pp == p]
            assert th.numpy()[p].tobytes() == _jnp_quantile(np.concatenate(members), 0.6).tobytes()
        for w, m, p in zip(ws, out, pools):
            assert torch.equal(m, (w.abs() > th[p]).float())
    with pytest.raises(ValueError, match="out"):
        k16.magnitude_masks(ws, [0] * len(ws), 0.5, out=out[:-1])


# ----------------------------------------------------------------- schedule
def test_gradual_sparsity_target_matches_jax():
    for step in range(0, 40):
        for args in ((0.8, 4, 3, 0.0, 6), (0.9875, 10, 5, 0.1, 2)):
            target, start, n, init, freq = args
            assert ppe.gradual_sparsity_target(target, step, start, n, init, freq) == \
                jpe.gradual_sparsity_target(target, step, start, n, init, freq)


def test_gradual_prune_hook_schedule():
    """``gradual_prune``: updates at steps 2, 4, 6, 8 of 16 (2 steps an epoch,
    every 2 steps to half of training), sparsity rising to the target."""
    _, _, port, _ = _models("mag_grad_uniform")
    cfg = dict(prune_sparsity_target=0.8, prune_gradual_frequency=2)
    fired = {s: ppt.gradual_prune(port, cfg, s, 2, 16) for s in range(1, 17)}
    assert [s for s, v in fired.items() if v is not None] == [2, 4, 6, 8]
    _, masks = split_params(port)
    assert abs(float(ppe.mask_sparsity(masks, "mag_grad_uniform")[0]) - 0.8) < 0.01
    assert ppt.allow_best_checkpoint(port, cfg)
    assert not ppt.allow_best_checkpoint(port, dict(cfg, prune_sparsity_target=0.9))


# ----------------------------------------------------- sparsity and export
@pytest.mark.parametrize("mask_type", ["supermask", "mag_uniform"])
def test_sparsity_prune_and_export_match_jax(mask_type):
    """``mask_sparsity``, ``weight_sparsity``, ``mask_avg``,
    ``binarize_masks``, ``prune_weights`` and ``sparse_export`` against the
    JAX package on masks of both kinds; ``sparse_import`` of the port's
    export restores the pruned weights into a model."""
    inputs = make_inputs(seed=3)
    jm = JaxORT(**KW, mask_cfg=JaxMaskConfig(mask_type, 1.0))
    variables = jax_variables(jm, inputs, mask_seed=4, mask_type=mask_type)
    port = load_jax_variables(get_model("relation_transformer_prune")(
        **KW, device="cpu", mask_cfg=MaskConfig(mask_type, keep_masks=True)), variables)
    params, masks = split_params(port)
    scope = ["decoder_layers_1"]
    s, nnz, per = ppe.mask_sparsity(masks, mask_type, scope)
    js, jnnz, jper = jpe.mask_sparsity(variables["masks"], mask_type, scope)
    assert float(nnz) == float(jnnz) and abs(float(s) - float(js)) < 1e-7
    assert set(per) == set(jper) and all(abs(float(per[k]) - float(jper[k])) < 1e-7 for k in per)
    np.testing.assert_allclose(float(ppe.mask_avg(masks, scope)), float(jpe.mask_avg(variables["masks"], scope)),
                               rtol=1e-6)
    ws, wnnz = ppe.weight_sparsity(port)
    jws, jwnnz = jpe.weight_sparsity(variables["params"], variables["masks"])
    assert int(wnnz) == int(jwnnz) and abs(float(ws) - float(jws)) < 1e-7
    bins = ppe.binarize_masks(masks)
    ref_bins = _flat(jpe.binarize_masks(variables["masks"]))
    for mw in ppe.mask_weight_pairs(port):
        np.testing.assert_array_equal(mw.jax_numpy(bins[mw.name]), ref_bins[mw.path])
    pruned = ppe.prune_weights(port, mask_type)
    ref_pruned = convert_jax_variables(to_numpy({"params": jpe.prune_weights(variables["params"], variables["masks"],
                                                                             mask_type)}))
    assert set(pruned) == set(params) == set(ref_pruned)
    for name in pruned:
        np.testing.assert_array_equal(pruned[name].numpy(), ref_pruned[name].numpy(), err_msg=name)
    exp, ref_exp = ppe.sparse_export(port, mask_type), jpe.sparse_export(variables["params"], variables["masks"],
                                                                          mask_type)
    assert set(exp) == set(ref_exp)
    for k in exp:
        np.testing.assert_array_equal(exp[k], np.asarray(ref_exp[k]), err_msg=k)
    back = get_model("relation_transformer_prune")(**KW, device="cpu", mask_cfg=MaskConfig(mask_type))
    load_jax_variables(back, {"params": ppe.sparse_import(exp)})
    for name, p in back.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), pruned[name].numpy(), err_msg=name)


# ----------------------------------------------------------------- SNIP
def test_snip_saliency_matches_jax():
    """The mask gradients summed over 2 batches, as ``_snip_prune`` takes
    them (the XE loss, train mode, dropout 0), within 1e-5; then
    ``post_restore_hook`` prunes by them as the host SNIP prune does."""
    jm, variables, port, _ = _models("snip")
    batches = []
    for seed in (6, 7):
        att, amask, boxes, seqs = make_inputs(seed=seed)
        batches.append(dict(att_feats=att, att_masks=amask, boxes=boxes, seqs=seqs,
                            seq_masks=(seqs != 0).astype(np.float32)))

    def loss_fn(m, b):
        lp = jm.apply({"params": variables["params"], "masks": m}, jnp.asarray(b["att_feats"]),
                      jnp.asarray(b["att_masks"]), jnp.asarray(b["seqs"]), jnp.asarray(b["boxes"]), train=True,
                      rngs={"dropout": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(0)})
        return jax_losses.language_model_loss(lp, jnp.asarray(b["seqs"])[:, 1:], jnp.asarray(b["seq_masks"])[:, 1:])

    ref = None
    for b in batches:
        g = jax.grad(loss_fn)(variables["masks"], b)
        ref = g if ref is None else jax.tree.map(jnp.add, ref, g)
    port_batches = [{k: t(v) for k, v in b.items()} for b in batches]
    cfg = dict(prune_sparsity_target=0.6, prune_snip_grad_accum=2, seed=0)
    sal = ppt.snip_saliency(port, port_batches, cfg)
    flat_ref = _flat(ref)
    pairs = ppe.mask_weight_pairs(port)
    assert len(pairs) == len(flat_ref) == 37
    for mw in pairs:
        np.testing.assert_allclose(mw.jax_numpy(sal[mw.name]), flat_ref[mw.path], rtol=1e-5, atol=1e-5,
                                   err_msg=mw.name)
    ppt.post_restore_hook(port, cfg, port_batches)
    _, masks = split_params(port)
    assert abs(float(ppe.mask_sparsity(masks, "snip")[0]) - 0.6) < 1e-3
