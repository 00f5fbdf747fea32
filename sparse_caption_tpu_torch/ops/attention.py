"""Plain attention math shared by the layers and the kernels' plain versions.

Port of ``sparse_caption_tpu/models/layers.py:158-172`` (scaled dot
attention) and ``:338-365`` (ORT box geometry).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sparse_caption_tpu_torch.ops.keep import apply_keep

NEG_INF = -1e9


def score_divisor(dk: int, dtype: torch.dtype) -> float:
    """sqrt(dk) rounded to ``dtype``: what the attention scores are divided by.
    The JAX package writes ``scores / math.sqrt(dk)``, and weak typing rounds
    the Python float to the scores' dtype first (bf16(sqrt(13)) = 3.609375);
    the division is a true one. The plain versions divide by it as a 0-dim
    tensor on the scores' device (``divide_scores``: PyTorch's CUDA ``x /
    python_float`` multiplies by the reciprocal instead, which differs from
    the quotient unless sqrt(dk) is a power of 2), and the kernels take it and
    divide by it."""
    return float(torch.tensor(math.sqrt(dk), dtype=dtype))


def divide_scores(scores: torch.Tensor, dk: int) -> torch.Tensor:
    """``scores / sqrt(dk)`` as ``score_divisor`` describes it."""
    return scores / torch.full((), math.sqrt(dk), dtype=scores.dtype, device=scores.device)


def scaled_dot_attention(q, k, v, key_valid: Optional[torch.Tensor] = None, causal: bool = False,
                         bias: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
                         keep_prob: float = 1.0):
    """q: (N, h, Tq, dk); k/v: (N / g, h, Tk, dk), each row shared by g
    consecutive query rows (repeated here); key_valid: (N / g, Tk) bool,
    False = masked key, or None; causal: query i attends keys <= i.

    ``masked_fill`` keeps the scores' dtype (a bf16 run stays bf16), and the
    bias (ORT geometry) is added AFTER the -1e9 fill. ``keep`` (bool, the
    probabilities' shape) is the training dropout on the probabilities
    (``ops/keep.py``)."""
    group = q.shape[0] // k.shape[0]
    if group > 1:
        k, v = k.repeat_interleave(group, dim=0), v.repeat_interleave(group, dim=0)
        key_valid = None if key_valid is None else key_valid.repeat_interleave(group, dim=0)
    scores = divide_scores(torch.matmul(q, k.transpose(-1, -2)), q.shape[-1])
    if key_valid is not None or causal:
        valid = torch.ones(scores.shape[-2:], dtype=torch.bool, device=q.device)
        if causal:
            valid = torch.tril(valid)
        if key_valid is not None:
            valid = key_valid[:, None, None, :] & valid
        scores = scores.masked_fill(~valid, NEG_INF)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = apply_keep(probs, keep, keep_prob)
    return torch.matmul(probs, v)


WAVE_LEN = 1000.0  # the trig features' longest wavelength (reference default)


def geometry_frequencies(dim_g: int = 64, device=None) -> torch.Tensor:
    """(dim_g // 8,) f32 trig frequencies ``1 / WAVE_LEN**(f / n_freq)``."""
    n_freq = dim_g // 8
    return 1.0 / (WAVE_LEN ** (torch.arange(n_freq, dtype=torch.float32, device=device) / n_freq))


def box_relational_embedding(boxes: torch.Tensor, dim_g: int = 64, trigonometric: bool = True) -> torch.Tensor:
    """Pairwise log-delta (cx, cy, w, h) box geometry expanded to sin/cos
    features at x100 scaling. boxes: (B, R, 4) as (x_min, y_min, x_max,
    y_max). Returns (B, R, R, dim_g), or with ``trigonometric=False`` the
    four raw log-deltas (B, R, R, 4) (``--no_box_trigonometric_embedding``)."""
    x_min, y_min, x_max, y_max = boxes.split(1, dim=-1)  # (B, R, 1)
    cx = (x_min + x_max) * 0.5
    cy = (y_min + y_max) * 0.5
    w = (x_max - x_min) + 1.0
    h = (y_max - y_min) + 1.0

    delta_x = torch.log(torch.clamp(torch.abs((cx - cx.transpose(1, 2)) / w), min=1e-3))
    delta_y = torch.log(torch.clamp(torch.abs((cy - cy.transpose(1, 2)) / h), min=1e-3))
    delta_w = torch.log(w / w.transpose(1, 2))
    delta_h = torch.log(h / h.transpose(1, 2))
    position_mat = torch.stack([delta_x, delta_y, delta_w, delta_h], dim=-1)  # (B, R, R, 4)
    if not trigonometric:
        return position_mat
    dim_mat = geometry_frequencies(dim_g, boxes.device)
    mul = 100.0 * position_mat[..., None] * dim_mat  # (B, R, R, 4, n_freq)
    b, r = boxes.shape[0], boxes.shape[1]
    mul = mul.reshape(b, r, r, 4 * (dim_g // 8))
    return torch.cat([torch.sin(mul), torch.cos(mul)], dim=-1)
