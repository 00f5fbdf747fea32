"""The prune-training hooks (port of the hooks of ``PruneTrainingModule``,
``sparse_caption_tpu/engine/prune_training.py``) as functions over a model
built with ``MaskConfig(<prune type>, keep_masks=True)``.

``config`` is the run's flat dict: ``prune_sparsity_target`` (0.8),
``prune_mask_freeze_scope`` (comma-separated flax path prefixes),
``prune_snip_grad_accum`` (1), ``prune_gradual_frequency`` (1000),
``start_from`` and ``log_dir``. A training loop calls

* ``post_restore_hook`` once, after the model's weights are restored:
  SNIP's saliency prune, a one-shot magnitude or lottery prune, and the
  lottery rewind to an init snapshot with the new masks kept;
* ``gradual_prune`` after every update (the update count after it): the Zhu
  & Gupta schedule of the gradual magnitude types, from the second epoch
  to half of training, on the model's device (kernel K16);
* ``allow_best_checkpoint`` before it saves a best checkpoint;
* ``export_pruned_best`` at the end.

Masks are updated in place.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from sparse_caption_tpu_torch.engine import checkpoints as ckpt
from sparse_caption_tpu_torch.engine.losses import language_model_loss
from sparse_caption_tpu_torch.ops.masked import split_params
from sparse_caption_tpu_torch.ops.rng import TrainRandom, derive_key
from sparse_caption_tpu_torch.pruning import LOTTERY, LOTTERY_MASK_FREEZE, MAG_ANNEAL, MAG_HARD, MASK_FREEZE, SNIP
from sparse_caption_tpu_torch.pruning import SUPER_MASKS
from sparse_caption_tpu_torch.pruning import engine as prune_engine
from sparse_caption_tpu_torch.utils.misc import csv_append_row

logger = logging.getLogger(__name__)


def sparsity_target(config) -> float:
    return float(config.get("prune_sparsity_target", 0.8))


def freeze_scope(config) -> list:
    return [s for s in str(config.get("prune_mask_freeze_scope", "")).split(",") if s]


def post_restore_hook(model: nn.Module, config, snip_batches: Optional[Iterable[Mapping]] = None) -> None:
    """One-shot pruning at the start of a run: SNIP from ``snip_batches``;
    ``MAG_HARD`` and the lottery types by magnitude (host); then a lottery
    rewinds every weight to the init snapshot, ``<start_from>/model_init``
    (``.pt`` or the JAX package's ``.msgpack``), or without ``start_from``
    this run's own ``<log_dir>/model_init``, keeping the new masks."""
    pt = model.mask_cfg.mask_type
    if pt == SNIP:
        snip_prune(model, config, snip_batches)
    elif pt in MAG_HARD or (pt in LOTTERY and pt != LOTTERY_MASK_FREEZE):
        prune_engine.update_masks_once(model, pt, sparsity_target(config), freeze_scope(config))
        logger.info("one-shot pruned to %.4f", sparsity_target(config))
    if pt in LOTTERY:
        start_from = config.get("start_from")
        if start_from and os.path.isdir(start_from):
            init_path = ckpt.find_ckpt(start_from, "model_init")
            if not os.path.exists(init_path):
                raise FileNotFoundError(f"lottery pruning needs the dense run's init snapshot: {init_path}")
        else:
            logger.warning("lottery without --start_from: rewinding to this run's own random init "
                           "(untrained dense model)")
            init_path = ckpt.find_ckpt(config["log_dir"], "model_init")
        lottery_rewind(model, init_path)
        logger.info("lottery: weights reset to init snapshot %s", init_path)
    if pt in (MASK_FREEZE, LOTTERY_MASK_FREEZE):
        assert config.get("start_from"), f"{pt} requires --start_from with existing masks"


@torch.no_grad()
def lottery_rewind(model: nn.Module, init_path: str) -> None:
    """Every parameter but the masks back to the snapshot at ``init_path``."""
    saved = ckpt.load_checkpoint(init_path)["params"]
    params, _ = split_params(model)
    missing = sorted(set(params) - set(saved))
    if missing:
        raise KeyError(f"{init_path} lacks {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    for name, p in params.items():
        p.copy_(saved[name])


def snip_saliency(model: nn.Module, batches: Iterable[Mapping], config) -> Dict[str, torch.Tensor]:
    """The mask gradients of the XE loss (``language_model_loss``, the model
    in train mode), summed over ``batches``: {mask name: gradient}. A batch
    holds the model's ``COLLATE_FIELDS``, ``seqs`` and ``seq_masks`` (as
    ``make_xe_step``'s). On the card the gradients come from K5's
    ``multiply`` backward."""
    _, masks = split_params(model)
    names = list(masks)
    extra = [k for k in model.COLLATE_FIELDS if k not in ("att_feats", "att_masks")]
    device = masks[names[0]].device
    seed = int(config.get("seed", 8888))
    saliency: Optional[Dict[str, torch.Tensor]] = None
    for i, batch in enumerate(batches):
        rng = TrainRandom(torch.Generator(device=device).manual_seed(derive_key(seed, i)))
        lp = model(batch["att_feats"], batch["att_masks"], batch["seqs"], **{k: batch[k] for k in extra},
                   train=True, rng=rng)
        loss = language_model_loss(lp, batch["seqs"][:, 1:], batch["seq_masks"][:, 1:])
        grads = torch.autograd.grad(loss, [masks[n] for n in names])
        if saliency is None:
            saliency = dict(zip(names, grads))
        else:
            saliency = {n: saliency[n] + g for n, g in zip(names, grads)}
    if saliency is None:
        raise ValueError("SNIP needs at least one batch")
    return saliency


def snip_prune(model: nn.Module, config, batches: Iterable[Mapping]) -> None:
    """SNIP: the saliency over the first ``prune_snip_grad_accum`` of
    ``batches``, then one host prune to the sparsity target."""
    accum = int(config.get("prune_snip_grad_accum", 1))
    it = iter(batches)
    saliency = snip_saliency(model, (next(it) for _ in range(accum)), config)
    prune_engine.update_masks_once(model, SNIP, sparsity_target(config), freeze_scope(config),
                                   snip_saliency=saliency)
    logger.info("SNIP pruned to %.4f over %d accum batches", sparsity_target(config), accum)


def gradual_prune(model: nn.Module, config, global_step: int, steps_per_epoch: int,
                  max_train_step: int) -> Optional[float]:
    """The gradual magnitude types' update after step ``global_step``: from
    ``steps_per_epoch`` (the second epoch) every ``prune_gradual_frequency``
    steps to half of ``max_train_step``, the masks pruned on the model's
    device to the schedule's sparsity. Returns that sparsity, or None where
    the schedule does not prune."""
    pt = model.mask_cfg.mask_type
    if pt not in MAG_ANNEAL:
        return None
    start = steps_per_epoch
    freq = int(config.get("prune_gradual_frequency", 1000))
    n = max(int((0.5 * max_train_step - start) / freq), 1)
    st = prune_engine.gradual_sparsity_target(sparsity_target(config), global_step, start, n, prune_frequency=freq)
    if st is not None:
        prune_engine.update_masks_once_device(model, pt, st, freeze_scope(config))
        logger.info("gradual prune @ step %d -> %.4f", global_step, st)
    return st


def allow_best_checkpoint(model: nn.Module, config) -> bool:
    """A best checkpoint only once the active masks' nonzero share is within
    5% of the target's."""
    _, masks = split_params(model)
    s, _, _ = prune_engine.mask_sparsity(masks, model.mask_cfg.mask_type, freeze_scope(config))
    reached = 1.0 - float(s) <= (1.0 - sparsity_target(config)) * 1.05
    if not reached:
        logger.info("sparsity %.4f below target %.4f; best ckpt gated", float(s), sparsity_target(config))
    return reached


def export_pruned_best(model: nn.Module, config) -> bool:
    """Load ``<log_dir>/model_best`` into ``model`` (its last state is
    replaced) and write the pruned exports beside it:
    ``model_best_pruned.pt`` (masks folded into the weights, masks kept),
    for supermasks ``model_best_bin_mask.pt`` (the masks binarized),
    ``model_best_pruned_sparse.npz`` (``sparse_export``, flax path keys) and
    ``sparsities.csv`` (one row per mask, by flax path). False when there is
    no best checkpoint."""
    log_dir = config["log_dir"]
    best = ckpt.find_ckpt(log_dir, "model_best")
    if not os.path.exists(best):
        logger.warning("no best checkpoint found; skipping pruned export")
        return False
    ckpt.restore_lenient(model, best)
    pt = model.mask_cfg.mask_type
    params, masks = split_params(model)
    ckpt.save_variables(os.path.join(log_dir, "model_best_pruned.pt"), prune_engine.prune_weights(model, pt), masks)
    if pt in SUPER_MASKS:
        ckpt.save_variables(os.path.join(log_dir, "model_best_bin_mask.pt"), params,
                            prune_engine.binarize_masks(masks))
    np.savez_compressed(os.path.join(log_dir, "model_best_pruned_sparse.npz"),
                        **prune_engine.sparse_export(model, pt))
    _, _, per = prune_engine.mask_sparsity(masks, pt)
    csv_path = os.path.join(log_dir, "sparsities.csv")
    for name, s in sorted(per.items()):
        csv_append_row(csv_path, ["tensor", "sparsity"], [name, f"{float(s):.6f}"])
    logger.info("pruned exports written to %s", log_dir)
    return True
