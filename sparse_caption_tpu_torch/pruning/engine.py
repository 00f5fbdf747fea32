"""Pruning over a model's kept masks (port of ``sparse_caption_tpu/pruning/engine.py``).

Masks are the port's mask parameters by name (``ops.masked.split_params``):
``decoder_layers.0.self_attn.q_proj.mask`` where the JAX package has the flax
path ``("decoder_layers_0", "self_attn", "q_proj", "mask")``. Paths here are
those flax paths (``utils.convert_jax.flax_path``), so ``freeze_scope``
prefixes match the strings the JAX package matches
(``decoder_layers_0/self_attn``), and paths sort in its order.

* supermask sparsity loss (``compute_sparsity_loss``), sparsity read-outs
  (``mask_sparsity``, ``weight_sparsity``, ``mask_avg``)
* one-shot magnitude / lottery / SNIP masks on the host
  (``update_masks_once``): numpy, the JAX package's arithmetic and tie order
  (a stable argsort over the criteria in sorted flax path order, each tensor
  flattened in its JAX layout: a Dense kernel's (in, out), the transpose of
  the port's weight)
* the magnitude threshold on the model's device (``update_masks_once_device``,
  kernel K16), for the gradual schedule (``gradual_sparsity_target``)
* folding and export (``binarize_masks``, ``prune_weights``,
  ``sparse_export``, ``sparse_import``), keyed by flax path strings and in
  the JAX layouts, so that exports pass between the two packages

The mask updates write the model's mask parameters in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sparse_caption_tpu_torch.kernels.magnitude_threshold import magnitude_masks
from sparse_caption_tpu_torch.ops.masked import _Prunable
from sparse_caption_tpu_torch.ops.ste import rounding_sigmoid
from sparse_caption_tpu_torch.pruning import (
    LOTTERY_MAG_BLIND,
    LOTTERY_MAG_DIST,
    LOTTERY_MAG_UNIFORM,
    MAG_BLIND,
    MAG_DIST,
    MAG_GRAD_BLIND,
    MAG_GRAD_DIST,
    MAG_GRAD_UNIFORM,
    MAG_PRUNE_MASKS,
    MAG_UNIFORM,
    SNIP,
    SUPER_MASKS,
)
from sparse_caption_tpu_torch.utils.convert_jax import (
    flatten_tree,
    flax_path,
    from_jax_layout,
    jax_leaf,
    to_jax_layout,
    to_jax_variables,
)

UNIFORM_TYPES = (MAG_UNIFORM, MAG_GRAD_UNIFORM, LOTTERY_MAG_UNIFORM)
BLIND_TYPES = (MAG_BLIND, MAG_GRAD_BLIND, LOTTERY_MAG_BLIND)
DIST_TYPES = (MAG_DIST, MAG_GRAD_DIST, LOTTERY_MAG_DIST)


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


# ---------------------------------------------------------------- structure
@dataclasses.dataclass(frozen=True)
class MaskedWeight:
    """A kept mask and the weight it masks. ``path``: the mask's flax path;
    ``name``: its port parameter name; ``transposed``: a Dense kernel, whose
    JAX layout (in, out) is the transpose of the port's weight."""

    path: Tuple[str, ...]
    name: str
    weight: torch.Tensor
    mask: torch.Tensor
    transposed: bool

    def jax_numpy(self, t: torch.Tensor) -> np.ndarray:
        """``t`` (the weight's layout) as a C-ordered numpy array in the JAX layout."""
        return to_jax_layout(t, self.transposed)

    def from_jax(self, arr: np.ndarray) -> torch.Tensor:
        """A JAX-layout array (any shape of its size) as a tensor in the weight's layout, on its device."""
        shape = self.mask.T.shape if self.transposed else self.mask.shape
        return from_jax_layout(np.reshape(arr, shape), self.transposed).to(self.mask.device)


def mask_weight_pairs(model: nn.Module) -> List[MaskedWeight]:
    """Every kept mask of ``model`` with its weight, in sorted flax path order."""
    out = []
    for mod_name, module in model.named_modules():
        if isinstance(module, _Prunable) and module.mask is not None:
            name = ".".join(filter(None, (mod_name, "mask")))
            out.append(MaskedWeight(flax_path(name), name, module.weight, module.mask,
                                    jax_leaf(module, "mask")[1]))
    return sorted(out, key=lambda mw: mw.path)


def _active(model: nn.Module, freeze_scope: Optional[Sequence[str]]) -> List[MaskedWeight]:
    pairs = mask_weight_pairs(model)
    act = set(active_paths({mw.name: mw.mask for mw in pairs}, freeze_scope))
    return [mw for mw in pairs if mw.path in act]


# ----------------------------------------------------------------- sparsity
def sampled_mask_values(masks: Mapping[str, torch.Tensor], mask_type: str) -> Dict[Tuple[str, ...], torch.Tensor]:
    """{flax path: the 0/1 sample of the mask}: round(sigmoid(m)) for supermasks, m itself otherwise."""
    fm = flat_masks(masks)
    if mask_type in SUPER_MASKS:
        return {k: rounding_sigmoid(v.detach()) for k, v in fm.items()}
    return {k: v.detach() for k, v in fm.items()}


def mask_sparsity(masks: Mapping[str, torch.Tensor], mask_type: str, freeze_scope: Optional[Sequence[str]] = None):
    """(total sparsity, total nnz, {flax path string: sparsity}) over the active masks."""
    sampled = sampled_mask_values(masks, mask_type)
    act = active_paths(masks, freeze_scope)
    nnz = {p: torch.sum(sampled[p]) for p in act}
    total_nnz = sum(nnz.values())
    total = sum(sampled[p].numel() for p in act)
    per_tensor = {path_str(p): 1.0 - nnz[p] / sampled[p].numel() for p in act}
    return 1.0 - total_nnz / total, total_nnz, per_tensor


def weight_sparsity(model: nn.Module):
    """(sparsity, nnz) of the masked weight tensors themselves (their nonzero count)."""
    pairs = mask_weight_pairs(model)
    nnz = sum(torch.sum(mw.weight.detach() != 0) for mw in pairs)
    total = sum(mw.weight.numel() for mw in pairs)
    return 1.0 - nnz / total, nnz


def mask_avg(masks: Mapping[str, torch.Tensor], freeze_scope: Optional[Sequence[str]] = None):
    fm = flat_masks(masks)
    return torch.cat([fm[p].detach().reshape(-1) for p in active_paths(masks, freeze_scope)]).mean()


# ------------------------------------------------------------- one-shot prune
def _compute_mask(criterion: np.ndarray, sparsity_target: float) -> np.ndarray:
    """Ones with the bottom-k by criterion zeroed (stable argsort: ties go to the lower index)."""
    assert 0.0 <= sparsity_target < 1.0
    flat = np.asarray(criterion).reshape(-1)
    mask = np.ones_like(flat, dtype=np.float32)
    k = int(sparsity_target * flat.size)
    if k > 0:
        idx = np.argsort(flat, kind="stable")[:k]
        mask[idx] = 0.0
    return mask


@torch.no_grad()
def update_masks_once(model: nn.Module, mask_type: str, sparsity_target: float,
                      freeze_scope: Optional[Sequence[str]] = None,
                      snip_saliency: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """One-shot pruning of the active masks, in place: the bottom
    ``sparsity_target`` share by criterion zeroed, per tensor (``*_uniform``)
    or over one pool (blind, dist, SNIP). Host numpy, the JAX package's
    arithmetic on its layouts. ``snip_saliency``: {mask name: summed mask
    gradient} (SNIP only; the signed gradient normalised by its sum)."""
    assert mask_type in MAG_PRUNE_MASKS, f"invalid mask_type {mask_type}"
    pairs = _active(model, freeze_scope)
    weights = [mw.jax_numpy(mw.weight) for mw in pairs]
    if mask_type == SNIP:
        assert snip_saliency is not None, "SNIP requires accumulated mask gradients"
        sal_vec = np.concatenate([mw.jax_numpy(snip_saliency[mw.name]).reshape(-1) for mw in pairs])
        criteria = [sal_vec / sal_vec.sum()]
    elif mask_type in DIST_TYPES:
        crits = []
        for w in weights:
            std = np.std(w.reshape(-1))  # biased, as the reference (unbiased=False)
            crits.append(np.abs((w - w.mean()) / std))
        criteria = [np.concatenate([c.reshape(-1) for c in crits])]
    elif mask_type in UNIFORM_TYPES:
        criteria = [np.abs(w) for w in weights]
    elif mask_type in BLIND_TYPES:
        criteria = [np.concatenate([np.abs(w).reshape(-1) for w in weights])]
    else:
        raise ValueError(f"unknown mask_type {mask_type}")
    new = [_compute_mask(c, sparsity_target) for c in criteria]
    if len(new) == 1:
        new = np.split(new[0], np.cumsum([w.size for w in weights])[:-1])
    for mw, m in zip(pairs, new):
        mw.mask.copy_(mw.from_jax(m))


@torch.no_grad()
def update_masks_once_device(model: nn.Module, mask_type: str, sparsity_target: float,
                             freeze_scope: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The magnitude families' mask update on the model's device, in place:
    ``mask = criterion > quantile(pool, sparsity_target)`` with the JAX
    package's ``jnp.quantile`` arithmetic (f32), per tensor (``*_uniform``)
    or over one pool (blind, dist), through kernel K16 on a CUDA model and
    its plain version on a CPU one. Masks outside ``freeze_scope`` are left
    as they are. Returns the pools' thresholds."""
    assert mask_type in MAG_PRUNE_MASKS and mask_type != SNIP, (
        f"device mask update supports magnitude families only, got {mask_type}")
    pairs = _active(model, freeze_scope)
    pools = list(range(len(pairs))) if mask_type in UNIFORM_TYPES else [0] * len(pairs)
    _, th, _ = magnitude_masks([mw.weight.detach() for mw in pairs], pools, sparsity_target,
                               dist=mask_type in DIST_TYPES, out=[mw.mask for mw in pairs])
    return th


# --------------------------------------------------------------- gradual
def gradual_sparsity_target(sparsity_target: float, current_step: int, start_step: int, prune_steps: int,
                            initial_sparsity: float = 0.0, prune_frequency: int = 1000) -> Optional[float]:
    """Zhu & Gupta schedule: the sparsity to prune to if ``current_step`` is a
    pruning step (``start_step`` + k ``prune_frequency``, k = 0..``prune_steps``), else None."""
    t, t0, dt = current_step, start_step, prune_frequency
    tn = start_step + prune_frequency * prune_steps
    assert dt > 0 and prune_steps > 0
    if not (t0 <= t <= tn and (t - t0) % dt == 0):
        return None
    p = min(1.0, max(0.0, (t - t0) / (tn - t0)))
    return sparsity_target + (initial_sparsity - sparsity_target) * ((1.0 - p) ** 3)


# ----------------------------------------------------------------- export
def binarize_masks(masks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """round(sigmoid(mask)) of every mask."""
    return {name: torch.round(torch.sigmoid(m.detach())) for name, m in masks.items()}


def prune_weights(model: nn.Module, mask_type: str) -> Dict[str, torch.Tensor]:
    """The model's parameters but its masks (``state_dict`` names), each
    masked weight folded: ``w * sample(mask)``."""
    folded = {}
    for mw in mask_weight_pairs(model):
        m = rounding_sigmoid(mw.mask.detach()) if mask_type in SUPER_MASKS else mw.mask.detach()
        folded[mw.name[: -len("mask")] + "weight"] = mw.weight.detach() * m
    return {name: folded.get(name, p.detach()) for name, p in model.named_parameters()
            if not name.endswith(".mask") and name != "mask"}


def sparse_export(model: nn.Module, mask_type: str) -> Dict[str, np.ndarray]:
    """COO export of the pruned (folded) masked weights and every other
    parameter dense, as an npz-able dict keyed by flax path strings in the
    JAX layouts (``<path>__sparse_indices`` / ``__sparse_values`` /
    ``__sparse_shape`` for a masked weight): the JAX package's
    ``sparse_export`` of the same model."""
    variables = to_jax_variables(model)
    fm = flatten_tree(variables["masks"])
    out: Dict[str, np.ndarray] = {}
    for path, arr in flatten_tree(variables["params"]).items():
        key = path_str(path)
        mask = fm.get(path[:-1] + ("mask",))
        if mask is not None and path[-1] in ("kernel", "embedding"):
            m = np.asarray(rounding_sigmoid(torch.from_numpy(mask))) if mask_type in SUPER_MASKS else mask
            arr = arr * m
            idx = np.nonzero(arr)
            out[f"{key}__sparse_indices"] = np.stack(idx, 1).astype(np.int32)
            out[f"{key}__sparse_values"] = arr[idx]
            out[f"{key}__sparse_shape"] = np.asarray(arr.shape, dtype=np.int64)
        else:
            out[key] = arr
    return out


def sparse_import(data: Mapping[str, np.ndarray]) -> Dict:
    """A ``sparse_export`` dict densified into a nested flax params tree of
    numpy arrays (``utils.convert_jax`` loads it into a model)."""
    tree: Dict = {}
    for key in sorted(data):
        if key.endswith("__sparse_values") or key.endswith("__sparse_shape"):
            continue
        if key.endswith("__sparse_indices"):
            base = key[: -len("__sparse_indices")]
            idx, vals = data[key], data[base + "__sparse_values"]
            dense = np.zeros(tuple(data[base + "__sparse_shape"]), dtype=vals.dtype)
            dense[tuple(idx[:, i] for i in range(idx.shape[1]))] = vals
        else:
            base, dense = key, np.asarray(data[key])
        *parents, leaf = base.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = dense
    return tree
