"""Beam length penalties (parity: reference utils/model_utils.py:121-146)."""

from __future__ import annotations

from typing import Callable


def penalty_fn(penalty_config: str) -> Callable:
    """'' -> identity; 'wu_0.7' -> GNMT penalty; 'avg_1.0' -> mean logprob."""
    if not penalty_config:
        return lambda length, logprobs: logprobs
    pen_type, alpha = penalty_config.split("_")
    alpha = float(alpha)
    if pen_type == "wu":
        return lambda length, logprobs: logprobs / (((5.0 + length) ** alpha) / ((5.0 + 1.0) ** alpha))
    if pen_type == "avg":
        return lambda length, logprobs: logprobs / length
    raise ValueError(f"unknown length penalty `{penalty_config}`")
