"""Training criteria (port of ``sparse_caption_tpu/engine/losses.py``).

All take log-probabilities and normalize by the mask sum, as the reference
does (label smoothing keeps torch KLDivLoss's constant term).
"""

from __future__ import annotations

import torch


def language_model_loss(logprobs, targets, masks):
    """Masked NLL. logprobs (N, T, V); targets/masks (N, T') with T' >= T
    (truncated to T)."""
    t = logprobs.shape[1]
    targets = targets[:, :t].long()
    masks = masks[:, :t].to(logprobs.dtype)
    nll = -torch.gather(logprobs, 2, targets[..., None])[..., 0]
    return torch.sum(nll * masks) / torch.clamp(torch.sum(masks), min=1.0)


def label_smoothing_loss(logprobs, targets, masks, smoothing: float = 0.1):
    """Masked KL(true_dist || p) with fill smoothing / (V - 1)."""
    t = logprobs.shape[1]
    v = logprobs.shape[-1]
    targets = targets[:, :t].long()
    masks = masks[:, :t].to(logprobs.dtype)
    one_hot = torch.full_like(logprobs, smoothing / (v - 1)).scatter(2, targets[..., None], 1.0 - smoothing)
    # torch KLDivLoss: sum_v t * (log t - logp); 0 * log 0 := 0
    log_t = torch.where(one_hot > 0, torch.log(torch.clamp(one_hot, min=1e-30)), torch.zeros_like(one_hot))
    kl = torch.sum(one_hot * (log_t - logprobs), dim=-1)
    return torch.sum(kl * masks) / torch.clamp(torch.sum(masks), min=1.0)


def reward_loss(sample_logprobs, masks, rewards):
    """REINFORCE: mean over the mask of -logp * reward. sample_logprobs (N, T)
    chosen-token log-probs; rewards (N,) broadcast over time."""
    masks = masks.to(sample_logprobs.dtype)
    out = -sample_logprobs * (masks * rewards[:, None])
    return torch.sum(out) / torch.clamp(torch.sum(masks), min=1.0)
