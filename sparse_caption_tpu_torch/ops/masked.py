"""Masked (prunable) layers, eval semantics.

Port of ``sparse_caption_tpu/ops/masked.py``. The eval forward of a masked
layer is an exact product with a 0/1 tensor:

* supermask: ``w * round(sigmoid(m))``
* every other mask type: ``w * m``

so the port folds the mask into the weight ONCE, at load
(``fold_mask`` / ``fold_mask_``), and the layers then run as plain Linear /
Embedding. The straight-through train-mode sampling (``ops/ste.py``) comes
with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_caption_tpu_torch import check_eval
from sparse_caption_tpu_torch.pruning import SUPER_MASKS, VALID_MASKS


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Per-model pruning configuration threaded into prunable layers. Eval
    folds masks that were trained elsewhere, so only the mask type matters;
    the mask's init value and gradient options come with the training slice."""

    mask_type: str

    def __post_init__(self):
        if self.mask_type not in VALID_MASKS:
            raise ValueError(f"mask_type must be one of {VALID_MASKS}, got `{self.mask_type}`")

    @property
    def is_supermask(self) -> bool:
        return self.mask_type in SUPER_MASKS


def mask_sample(mask: torch.Tensor, cfg: MaskConfig) -> torch.Tensor:
    """Eval-mode multiplicative 0/1 sample of a mask tensor (f32)."""
    mask = mask.float()
    return torch.round(torch.sigmoid(mask)) if cfg.is_supermask else mask


def fold_mask(weight: torch.Tensor, mask: torch.Tensor, cfg: MaskConfig) -> torch.Tensor:
    """``weight * sample(mask)`` in the weight's dtype (exact: a 0/1 product)."""
    return (weight.float() * mask_sample(mask.to(weight.device), cfg)).to(weight.dtype)


def xavier_uniform_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot-uniform init of a 2-D tensor (the JAX package's ``xavier_uniform``;
    symmetric in fan-in/fan-out, so the (out, in) layout gives the same bound)."""
    bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


class _Prunable(nn.Module):
    mask_cfg: Optional[MaskConfig]

    @torch.no_grad()
    def fold_mask_(self, mask: torch.Tensor) -> None:
        """Fold a mask (in the weight's layout) into the weight, in place."""
        if self.mask_cfg is None:
            raise ValueError("layer has no mask config")
        if mask.shape != self.weight.shape:
            raise ValueError(f"mask shape {tuple(mask.shape)} != weight shape {tuple(self.weight.shape)}")
        self.weight.copy_(fold_mask(self.weight, mask, self.mask_cfg))


class MaskedLinear(_Prunable):
    """Dense layer; ``weight`` is (out, in). With a mask config the mask is
    folded into ``weight`` at load (see module docstring)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 mask_cfg: Optional[MaskConfig] = None, device=None, dtype=None):
        super().__init__()
        self.mask_cfg = mask_cfg
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype)) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        xavier_uniform_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        check_eval(train)
        return F.linear(x, self.weight, self.bias)


class MaskedEmbedding(_Prunable):
    """Embedding table (num_embeddings, features) with a foldable mask."""

    def __init__(self, num_embeddings: int, features: int, mask_cfg: Optional[MaskConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        self.mask_cfg = mask_cfg
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, device=device, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        xavier_uniform_(self.weight, generator)

    def forward(self, ids: torch.Tensor, train: bool = False) -> torch.Tensor:
        check_eval(train)
        return F.embedding(ids, self.weight)
