"""Supermask sparsity loss over the kept masks (port of the parts of
``sparse_caption_tpu/pruning/engine.py`` the XE step runs: ``flat_masks``,
``path_str``, ``active_paths``, ``compute_sparsity_loss``).

Masks are the port's mask parameters by name (``ops.masked.split_params``):
``decoder_layers.0.self_attn.q_proj.mask`` where the JAX package has the flax
path ``("decoder_layers_0", "self_attn", "q_proj", "mask")``. Paths here are
those flax paths (``utils.convert_jax.flax_path``), so ``freeze_scope``
prefixes match the strings the JAX package matches
(``decoder_layers_0/self_attn``), and paths sort in its order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from sparse_caption_tpu_torch.ops.ste import rounding_sigmoid
from sparse_caption_tpu_torch.utils.convert_jax import flax_path


def flat_masks(masks: Mapping[str, torch.Tensor]) -> Dict[Tuple[str, ...], torch.Tensor]:
    """{flax path tuple: mask} from {port parameter name: mask}."""
    return {flax_path(name): m for name, m in masks.items()}


def path_str(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def active_paths(masks: Mapping[str, torch.Tensor],
                 freeze_scope: Optional[Sequence[str]] = None) -> List[Tuple[str, ...]]:
    """Flax mask paths, sorted, not excluded by ``freeze_scope`` prefixes of their path strings."""
    scopes = [s for s in (freeze_scope or []) if s]
    paths = sorted(flat_masks(masks))
    return [p for p in paths if not any(path_str(p).startswith(s) for s in scopes)]


def compute_sparsity_loss(masks: Mapping[str, torch.Tensor], sparsity_target: float, weight: float, current_step: int,
                          max_step: int, freeze_scope: Optional[Sequence[str]] = None):
    """``|target - sparsity(round(sigmoid(m)))| * weight * (1 - anneal)``, with
    the reversed-cosine anneal over ``max_step``, differentiable through the
    rounding straight-through estimator. Returns (scaled loss, aux dict)."""
    fm = flat_masks(masks)
    act = active_paths(masks, freeze_scope)
    if not act:
        return torch.zeros(()), {}
    nnz = sum(torch.sum(rounding_sigmoid(fm[p])) for p in act)
    total = sum(fm[p].numel() for p in act)
    sparsity = 1.0 - nnz / total
    loss = torch.abs(sparsity_target - sparsity)
    frac = min(float(current_step) / max_step, 1.0)
    anneal_rate = torch.tensor((1.0 + math.cos(frac * math.pi)) / 2.0, dtype=torch.float32, device=loss.device)
    scaled = loss * weight * (1.0 - anneal_rate)
    return scaled, {"sparsity_loss": loss, "anneal_rate": anneal_rate, "mask_sparsity": sparsity}
