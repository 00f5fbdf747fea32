"""Dropout's scaling of kept values, as the JAX package computes it.

The JAX package writes ``jnp.where(mask, x / keep, 0)`` with ``keep`` a
Python float: weak typing rounds it to x's dtype first, so a bf16 run
divides by bf16(0.9) = 0.8984375, and the division is a true division. The
plain versions here do the same on every device (the divisor is a 0-dim
tensor on x's device: PyTorch's CUDA ``x / python_float`` multiplies by the
reciprocal instead), and the kernels take ``keep_divisor`` and divide by it.
The keep-mask itself is still drawn against the unrounded probability.
"""

from __future__ import annotations

import torch


def keep_divisor(keep_prob: float, dtype: torch.dtype) -> float:
    """The keep probability rounded to ``dtype`` (a no-op for f32 kernels,
    which take it as a C float)."""
    return float(torch.tensor(keep_prob, dtype=dtype))


def apply_keep(x: torch.Tensor, keep: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """``x / keep_prob`` where ``keep``, 0 elsewhere, ``keep_prob`` rounded to x's dtype."""
    divisor = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / divisor, torch.zeros_like(x))
