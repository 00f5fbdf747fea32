"""The supermask XE train step (port of ``sparse_caption_tpu/engine/training.py``
``make_xe_step`` 489-570, ``_grad_update`` 445-455, ``_loss_criterion``
428-432 and ``_sparsity_loss_args`` 434-443) as plain functions.

    params, masks = split_params(model)
    opt_w = build_weight_optimizer(params.values(), config, make_schedule(config))
    opt_m = build_mask_optimizer(masks.values(), config, trainable=True)
    step = make_xe_step(model, opt_w, opt_m, config)
    state, loss, aux = step(TrainState(), batch)

``batch`` holds ``att_feats`` (B, R, F), ``att_masks`` (B, R), ``boxes`` (B, R, 4),
``seqs`` (B * seq_per_img, T) and ``seq_masks`` (B * seq_per_img, T). The model
is updated in place; ``TrainState`` carries the update count (the schedule's
and the sparsity anneal's step); after a step each parameter's ``.grad``
holds that step's raw gradient. With ``train_precision`` bf16 the master
params stay f32 and the forward runs on a differentiable bf16 cast of them
(masks and boxes stay f32, the log-softmax runs in f32).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sparse_caption_tpu_torch.engine import losses as losses_mod
from sparse_caption_tpu_torch.engine.optim import Optimizer
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.ops.rng import TrainRandom
from sparse_caption_tpu_torch.pruning.engine import compute_sparsity_loss


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int = 0  # updates done so far


def loss_criterion(config):
    ls = float(config.get("label_smoothing", 0.0))
    if ls > 0:
        return functools.partial(losses_mod.label_smoothing_loss, smoothing=ls)
    return losses_mod.language_model_loss


def sparsity_loss_args(mask_cfg: Optional[MaskConfig], config) -> Optional[Tuple[float, float]]:
    """(target, weight) of the supermask sparsity loss, or None without supermasks."""
    if mask_cfg is None or not mask_cfg.is_supermask:
        return None
    target = float(config.get("prune_sparsity_target", 0.8))
    weight = float(config.get("prune_supermask_sparsity_weight", -1.0))
    if weight <= 0:
        # reference default: max(5, C / (1 - s))
        c = 0.5 if "lstm" in str(config.get("caption_model", "")) else 1.5
        weight = max(5.0, c / (1.0 - target))
    return target, weight


def grad_update(state: TrainState, opt_w: Optimizer, opt_m: Optimizer) -> TrainState:
    """One optimizer update of weights and masks from their ``.grad``, then the step bump."""
    opt_w.step(state.step)
    opt_m.step(state.step)
    return TrainState(state.step + 1)


def make_xe_step(model: nn.Module, opt_w: Optimizer, opt_m: Optimizer, config):
    """-> ``xe_step(state, batch, rng=None) -> (state, loss, aux)``; ``rng`` (a
    ``TrainRandom``) defaults to one seeded from ``config["seed"] + 1``."""
    criterion = loss_criterion(config)
    sp_args = sparsity_loss_args(model.mask_cfg, config)
    freeze_scope = [s for s in str(config.get("prune_mask_freeze_scope", "")).split(",") if s]
    max_step = int(config.get("max_train_step", 1))
    bf16 = str(config.get("train_precision", "fp32")) == "bf16"
    params, masks = split_params(model)
    device = next(iter(params.values())).device
    default_rng = TrainRandom(torch.Generator(device=device).manual_seed(int(config.get("seed", 8888)) + 1))

    def forward(inputs: Dict, rng: TrainRandom):
        args = (inputs["att_feats"], inputs["att_masks"], inputs["seqs"], inputs.get("boxes"))
        if not bf16:
            return model(*args, train=True, rng=rng)
        # differentiable cast of the f32 master params; masks stay f32
        cast = {n: p.to(torch.bfloat16) for n, p in params.items() if p.is_floating_point()}
        return torch.func.functional_call(model, cast, args, dict(train=True, rng=rng))

    def xe_step(state: TrainState, batch: Dict, rng: Optional[TrainRandom] = None):
        rng = rng or default_rng
        opt_w.zero_grad()
        opt_m.zero_grad()
        inputs = dict(batch)
        if bf16:
            # boxes stay f32: the geometry's x100-scaled trig arguments need it
            for k in ("att_feats", "att_masks"):
                inputs[k] = inputs[k].to(torch.bfloat16)
        lp = forward(inputs, rng)
        seqs = inputs["seqs"]
        loss = criterion(lp, seqs[:, 1:], inputs["seq_masks"][:, 1:])
        aux = {"caption_loss": loss.detach()}
        if sp_args is not None:
            sp, sp_aux = compute_sparsity_loss(masks, sp_args[0], sp_args[1], state.step, max_step, freeze_scope)
            loss = loss + sp
            aux.update({k: v.detach() for k, v in sp_aux.items()})
        loss.backward()
        return grad_update(state, opt_w, opt_m), loss.detach(), aux

    return xe_step
