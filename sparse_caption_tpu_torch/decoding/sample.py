"""Greedy / sampling decode (port of ``sparse_caption_tpu/decoding/sample.py``).

* feed BOS; ``max_len`` steps; the ``unfinished`` latch records the EOS
  itself and feeds pad after it; each step records the chosen token's
  log-prob (loss masking handles the tail)
* ``decoding_constraint``: forbid repeating the previous token (t > 0)
* ``sample_method``: ``random`` samples ``softmax(log_probs / temperature)``
  and records the un-tempered log-prob; ``top<k>`` / ``top<p>`` sample the
  top-k or nucleus filter of the tempered log-probs and record the filtered
  value (``modified_sample_logits``); ``gumbel`` takes the argmax of the
  un-tempered log-probs plus Gumbel noise formed with eps and records the
  un-tempered log-prob (``sample_next_word``)
* the noise is keyed by (key, site, t, row, column)

Every step runs kernel K9 on the step's logits (its modes are the sample
methods; ``modified_sample_logits`` and ``sample_next_word`` are its plain
version). The loop always runs all ``max_len`` steps with no host sync; the
JAX package's while-loop stops once every row has finished, which gives the
same tokens (pad after EOS) and differs only in the log-probs recorded at
pad positions.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sparse_caption_tpu_torch.kernels.sample_step import parse_sample_method, sample_step

NEG_INF = -1e30


def divide_by_temperature(logprobs: torch.Tensor, temperature: float) -> torch.Tensor:
    """``logprobs / temperature`` as a true division by the temperature rounded
    to the log-probs' dtype (a 0-dim tensor: PyTorch's CUDA ``x / float``
    multiplies by the reciprocal, which rounds differently)."""
    return logprobs / torch.full((), temperature, dtype=logprobs.dtype, device=logprobs.device)


def modified_sample_logits(logprobs: torch.Tensor, sample_method: str, temperature: float) -> torch.Tensor:
    """The JAX package's ``modified_sample_logits``: the tempered log-probs,
    then (``top<p>``, 0 < p < 1) the nucleus filter: softmax, one stable
    descending sort (equal probabilities by the lower index), ``torch.cumsum``,
    the smallest prefix whose mass before the entry stays below p (the first
    entry always kept: ``csum[:-1] < p``), the kept probabilities
    renormalised by their sum and written back as log-probs; or (``top<k>``)
    the top-k filter, every value at or above the k-th largest kept (ties
    included). Filtered entries are -1e30."""
    scaled = divide_by_temperature(logprobs, temperature)
    mode, top = parse_sample_method(sample_method)
    if mode not in ("random", "topk", "nucleus"):
        raise ValueError(f"no modified logits for sample_method `{sample_method}`")
    if mode == "nucleus":
        unnormalized = torch.exp(scaled - scaled.max(dim=-1, keepdim=True).values)
        probs = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
        sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        csum = torch.cumsum(sorted_probs, dim=-1)
        keep_sorted = torch.cat([torch.ones_like(csum[:, :1], dtype=torch.bool), csum[:, :-1] < top], dim=-1)
        n_keep = keep_sorted.sum(dim=-1, keepdim=True)
        ranks = torch.empty_like(order).scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                                                 .expand_as(order).contiguous())
        keep = ranks < n_keep
        denom = torch.where(keep, probs, 0.0).sum(dim=-1, keepdim=True)
        return torch.where(keep, torch.log(probs / denom), NEG_INF)
    if mode == "topk":
        kth = torch.topk(scaled, int(top), dim=-1).values[:, -1:]
        return torch.where(scaled >= kth, scaled, NEG_INF)
    return scaled


def sample_next_word(logprobs: torch.Tensor, sample_method: str, temperature: float,
                     noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``sample_next_word``: (tokens (N,) int64, their
    log-probs (N,)). ``noise`` (N, V): the Gumbel noise of the categorical
    draw (``jax.random.categorical`` is the argmax of logits + Gumbel noise),
    or, for ``gumbel``, the uniforms u of ``-log(-log(u + 1e-20) + 1e-20)``;
    unused by ``greedy``."""
    if sample_method == "greedy":
        it = torch.argmax(logprobs, dim=-1)
        return it, logprobs.gather(1, it[:, None])[:, 0]
    if sample_method == "gumbel":
        eps = 1e-20
        g = -torch.log(-torch.log(noise + eps) + eps)
        it = torch.argmax(logprobs + g, dim=-1)
        return it, logprobs.gather(1, it[:, None])[:, 0]
    modified = modified_sample_logits(logprobs, sample_method, temperature)
    it = torch.argmax(modified + noise, dim=-1)
    return it, modified.gather(1, it[:, None])[:, 0]


def sample_decode(step_fn: Callable, cache, batch_size: int, max_len: int, *, bos_id: int, eos_id: int,
                  pad_id: int = 0, greedy: bool = True, temperature: float = 1.0, sample_method: str = "random",
                  decoding_constraint: int = 0, key: int = 0, site: int = 0, device=None,
                  noise: Optional[Callable[[int], torch.Tensor]] = None):
    """Run the decode loop.

    step_fn(it, cache, t) -> (logits (N, V), cache); ``key``/``site``: the
    sampling stream; ``noise(t)``: explicit (N, V) noise per step (the Gumbel
    noise, or ``gumbel``'s uniforms), taken only by the CPU plain version
    (tests replay another framework's draws with it). Returns (seq (N,
    max_len) int32, seq_logprobs (N, max_len) f32)."""
    it = torch.full((batch_size,), bos_id, dtype=torch.int32, device=device)
    unfinished = torch.ones((batch_size,), dtype=torch.bool, device=device)
    seq = torch.full((batch_size, max_len), pad_id, dtype=torch.int32, device=device)
    seq_lp = torch.zeros((batch_size, max_len), dtype=torch.float32, device=device)
    for t in range(max_len):
        logits, cache = step_fn(it, cache, t)
        it = sample_step(logits, it, unfinished, seq, seq_lp, t, key, site, greedy, temperature,
                         bool(decoding_constraint) and t > 0, eos_id, pad_id,
                         None if noise is None else noise(t), sample_method)
    return seq, seq_lp
