"""Greedy / temperature sampling decode (port of
``sparse_caption_tpu/decoding/sample.py:93-174``, the greedy and ``random``
modes).

* feed BOS; ``max_len`` steps; the ``unfinished`` latch records the EOS
  itself and feeds pad after it; each step records the chosen token's
  log-prob from the un-tempered log-probs (loss masking handles the tail)
* ``decoding_constraint``: forbid repeating the previous token (t > 0)
* random mode samples ``softmax(log_probs / temperature)`` by Gumbel-max
  with noise keyed by (key, site, t, row, column)

Every step runs kernel K9 on the step's logits. The loop always runs all
``max_len`` steps with no host sync; the JAX package's while-loop stops once
every row has finished, which gives the same tokens (pad after EOS) and
differs only in the log-probs recorded at pad positions.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sparse_caption_tpu_torch.kernels.sample_step import sample_step


def sample_decode(step_fn: Callable, cache, batch_size: int, max_len: int, *, bos_id: int, eos_id: int,
                  pad_id: int = 0, greedy: bool = True, temperature: float = 1.0, decoding_constraint: int = 0,
                  key: int = 0, site: int = 0, device=None,
                  noise: Optional[Callable[[int], torch.Tensor]] = None):
    """Run the decode loop.

    step_fn(it, cache, t) -> (logits (N, V), cache); ``key``/``site``: the
    sampling stream; ``noise(t)``: explicit (N, V) Gumbel noise per step,
    taken only by the CPU plain version (tests replay another framework's
    draws with it). Returns (seq (N, max_len) int32, seq_logprobs (N, max_len) f32)."""
    it = torch.full((batch_size,), bos_id, dtype=torch.int32, device=device)
    unfinished = torch.ones((batch_size,), dtype=torch.bool, device=device)
    seq = torch.full((batch_size, max_len), pad_id, dtype=torch.int32, device=device)
    seq_lp = torch.zeros((batch_size, max_len), dtype=torch.float32, device=device)
    for t in range(max_len):
        logits, cache = step_fn(it, cache, t)
        it = sample_step(logits, it, unfinished, seq, seq_lp, t, key, site, greedy, temperature,
                         bool(decoding_constraint) and t > 0, eos_id, pad_id,
                         None if noise is None else noise(t))
    return seq, seq_lp
