"""Random draws of a training forward (the JAX package's ``"mask"`` and
``"dropout"`` rng streams).

A ``TrainRandom`` is handed to a train-mode forward; ``None`` in its place
means eval. Both streams draw from one ``torch.Generator``:

* ``mask_uniform``: the uniforms ``u`` of a supermask sample ``[u < sigmoid(m)]``
  (one tensor per masked layer per forward, in the layer's call order)
* ``keep_mask``: a dropout keep-mask ``u < keep_prob``

Tests subclass it to replay the JAX side's uniforms in the same call order.
"""

from __future__ import annotations

import torch
from torch import nn


class TrainRandom:
    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _uniform(self, shape, device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)
        return u.to(device)

    def mask_uniform(self, layer: nn.Module, shape, device) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ``layer``'s mask (the weight's layout)."""
        return self._uniform(shape, device)

    def keep_mask(self, shape, keep_prob: float, device) -> torch.Tensor:
        return self._uniform(shape, device) < keep_prob


def dropout(x: torch.Tensor, rate: float, rng) -> torch.Tensor:
    """Standard-mode dropout (``TimeDropout`` with ``t=None``): ``x / keep`` where
    kept, 0 elsewhere; the identity in eval (``rng=None``) or at rate 0."""
    if rng is None or rate == 0.0:
        return x
    keep = rng.keep_mask(x.shape, 1.0 - rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def keep_mask(shape, rate: float, rng, device):
    """The keep-mask a fused kernel applies itself, or None (eval, rate 0)."""
    if rng is None or rate == 0.0:
        return None
    return rng.keep_mask(shape, 1.0 - rate, device)
