"""Straight-through estimators for supermask sampling (port of
``sparse_caption_tpu/ops/ste.py``).

* ``bernoulli_sample_sigmoid(logits, u)``: forward ``[u < sigmoid(logits)]``,
  i.e. a Bernoulli(sigmoid(logits)) draw from the uniform ``u`` in [0, 1)
  (``jax.random.bernoulli`` computes ``uniform < p`` the same way, so the same
  ``u`` gives the same sample); backward passes the gradient through
  ``sigmoid'`` by default, or to the logits unchanged with
  ``bypass_sigmoid_grad``
* ``rounding_sigmoid(logits)``: forward ``round(sigmoid(logits))``, the same
  two backward flavours

Both return the sample in the logits' dtype. The supermask weight product
of the masked layers runs these in kernel K5 (``kernels/supermask.py``);
these plain functions serve the sparsity loss and the tests.
"""

from __future__ import annotations

from typing import Optional

import torch


class _SigmoidSTE(torch.autograd.Function):
    """Forward: ``[u < sigmoid(m)]`` (``u=None``: ``round(sigmoid(m))``);
    backward: ``g * sigmoid'(m)``, or ``g`` under ``bypass``."""

    @staticmethod
    def forward(ctx, logits, u: Optional[torch.Tensor], bypass: bool):
        p = torch.sigmoid(logits)
        sample = torch.round(p) if u is None else (u < p)
        ctx.bypass = bypass
        ctx.save_for_backward(p)
        return sample.to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return (g if ctx.bypass else g * (p * (1.0 - p))), None, None


def bernoulli_sample_sigmoid(logits, u, bypass_sigmoid_grad: bool = False):
    """Stochastic mask sample from raw logits and uniforms ``u`` (same shape)."""
    if u.shape != logits.shape:
        raise ValueError(f"u shape {tuple(u.shape)} != logits shape {tuple(logits.shape)}")
    return _SigmoidSTE.apply(logits, u, bypass_sigmoid_grad)


def rounding_sigmoid(logits, bypass_sigmoid_grad: bool = False):
    """Deterministic mask binarization from raw logits."""
    return _SigmoidSTE.apply(logits, None, bypass_sigmoid_grad)
