"""Optimizers and LR schedules (port of ``sparse_caption_tpu/engine/optim.py``,
on ``torch.optim``).

Semantics kept from the optax version:
* a schedule is evaluated at the number of updates done BEFORE this one:
  update k (from 0) uses ``schedule(k)``, and noam's own ``step + 1`` makes
  its first value the s = 1 one
* weight path: gradient clip by VALUE (``optax.clip``, default 0.1), then
  coupled L2 weight decay (``g + wd * w`` into the optimizer; torch's
  ``weight_decay``, not AdamW), then the optimizer with the scheduled LR
* under noam the optimizer is forced to Adam(0.9, 0.98, 1e-9) without decay
* mask path: constant-LR Adam (lr 100, eps 1e-2) for trainable mask types; a
  mask type whose masks are not trained gets no update (``set_to_zero``)

``rmsprop`` and ``adagrad`` are not ported: optax puts their eps inside the
square root and starts adagrad's accumulator at 0.1, torch's do neither.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

ALL_SCHEDULERS = ("noam", "step", "cosine")
ALL_OPTIMIZERS = ("rmsprop", "adagrad", "sgd", "sgdm", "sgdmom", "adam")


def make_schedule(config, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """step (updates done so far) -> learning rate, in f32 like the JAX schedule."""
    name = str(config.get("lr_scheduler", "noam")).lower()
    f32 = np.float32
    if name == "noam":
        d_model = int(config.get("d_model", 512))
        factor = float(config.get("noamopt_factor", 1.0))
        warmup = int(config.get("noamopt_warmup", 10000))

        def sched(step: int) -> float:
            s = f32(max(step + 1, 1))
            return float(f32(factor * d_model ** -0.5) * min(s ** f32(-0.5), s * f32(warmup ** -1.5)))

        return sched
    if name == "step":
        lr0 = float(config.get("learning_rate", 5e-4))
        decay_start = int(config.get("learning_rate_decay_start", -1))
        decay_every = int(config.get("learning_rate_decay_every", 3))
        decay_rate = float(config.get("learning_rate_decay_rate", 0.8))
        assert decay_every > 0, f"learning_rate_decay_every must be > 0, got {decay_every}"
        assert 0.0 < decay_rate <= 1.0, f"learning_rate_decay_rate must be in (0, 1], got {decay_rate}"

        def sched(step: int) -> float:
            epoch = step // max(steps_per_epoch, 1)
            if decay_start >= 0 and epoch > decay_start:
                return float(f32(lr0 * decay_rate ** ((epoch - decay_start) // decay_every)))
            return lr0

        return sched
    if name == "cosine":
        lr0 = float(config.get("learning_rate", 0.01))
        lr_min = float(config.get("learning_rate_min", 1e-5))
        max_step = int(config.get("max_train_step", 100000))

        def sched(step: int) -> float:
            frac = min(step / max_step, 1.0)
            return float(f32((lr0 - lr_min) * ((1.0 + math.cos(frac * math.pi)) / 2.0) + lr_min))

        return sched
    raise ValueError(f"bad lr_scheduler `{name}`; options: {ALL_SCHEDULERS}")


class Optimizer:
    """A ``torch.optim`` optimizer with an optional value clip of the gradients
    and a schedule that sets the LR from the update count before each step."""

    def __init__(self, opt: Optional[torch.optim.Optimizer], schedule: Optional[Callable[[int], float]] = None,
                 grad_clip: float = 0.0, frozen: Iterable[torch.Tensor] = ()):
        """``opt=None``: no update (``frozen``: the params whose gradients
        ``zero_grad`` still clears)."""
        self.opt, self.schedule, self.grad_clip = opt, schedule, grad_clip
        self.frozen = list(frozen)

    def step(self, count: int) -> None:
        """Apply update number ``count`` (0 for the first) from the params'
        ``.grad``; the clip acts on the update only, ``.grad`` keeps the raw
        gradients."""
        if self.opt is None:
            return
        params = [p for g in self.opt.param_groups for p in g["params"] if p.grad is not None]
        raw = [p.grad for p in params]
        if self.grad_clip > 0:
            for p in params:
                p.grad = p.grad.clamp(-self.grad_clip, self.grad_clip)
        if self.schedule is not None:
            for group in self.opt.param_groups:
                group["lr"] = self.schedule(count)
        self.opt.step()
        for p, g in zip(params, raw):
            p.grad = g

    def zero_grad(self) -> None:
        if self.opt is not None:
            self.opt.zero_grad(set_to_none=True)
        for p in self.frozen:
            p.grad = None


def build_weight_optimizer(params: Iterable[torch.Tensor], config, schedule: Callable[[int], float]) -> Optimizer:
    params = list(params)
    name = str(config.get("optim", "adam")).lower()
    grad_clip = float(config.get("grad_clip", 0.1))
    wd = float(config.get("weight_decay", 0.0))
    alpha = float(config.get("optim_alpha", 0.9))
    beta = float(config.get("optim_beta", 0.999))
    eps = float(config.get("optim_epsilon", 1e-8))
    if str(config.get("lr_scheduler", "noam")).lower() == "noam":
        # the reference hard-codes Adam(0.9, 0.98, 1e-9) with no weight decay under noam
        alpha, beta, eps, name, wd = 0.9, 0.98, 1e-9, "adam", 0.0
    lr0 = schedule(0)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr0, betas=(alpha, beta), eps=eps, weight_decay=wd)
    elif name in ("sgd", "sgdm", "sgdmom"):
        momentum = 0.0 if name == "sgd" else alpha
        opt = torch.optim.SGD(params, lr=lr0, momentum=momentum, nesterov=name == "sgdmom", weight_decay=wd)
    elif name in ALL_OPTIMIZERS:
        raise NotImplementedError(f"optim `{name}` is not ported (optax's eps placement differs from torch's)")
    else:
        raise ValueError(f"bad optim `{name}`; options: {ALL_OPTIMIZERS}")
    return Optimizer(opt, schedule, grad_clip if grad_clip > 0 else 0.0)


def build_mask_optimizer(masks: Iterable[torch.Tensor], config, trainable: bool) -> Optimizer:
    """Constant-LR Adam for supermask / SNIP logits; no update otherwise."""
    masks = list(masks)
    if not trainable or not masks:
        return Optimizer(None, frozen=masks)
    lr = float(config.get("prune_supermask_lr", 100.0))
    eps = float(config.get("prune_mask_adam_eps", 1e-2))
    return Optimizer(torch.optim.Adam(masks, lr=lr, betas=(0.9, 0.999), eps=eps))
