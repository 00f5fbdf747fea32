"""Generation entry point (port of ``sparse_caption_tpu/decoding/api.py``).

This slice ports beam search (``beam_size > 1``, ``group_size == 1``, eval).
Greedy decoding, random sampling, diverse beam search and train-mode
decoding raise ``NotImplementedError`` until their slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sparse_caption_tpu_torch.decoding.beam import beam_search


@torch.no_grad()
def generate(model, memory: Dict[str, Any], opt: Optional[Dict[str, Any]] = None):
    """Beam-search captions from an encoded memory dict (``model.encode``).

    Runs on the memory's device. Returns (seq (B, K, max_len), seq_logprobs
    (B, K, max_len)), best beam first."""
    opt = opt or {}
    beam_size = int(opt.get("beam_size", 1))
    if int(opt.get("num_random_sample", 0)) > 0:
        raise NotImplementedError("random sampling lands in a later slice")
    if bool(opt.get("decode_train", False)):
        raise NotImplementedError("train-mode decoding lands in a later slice")
    if beam_size <= 1:
        raise NotImplementedError("greedy decoding lands in a later slice")
    if int(opt.get("group_size", 1)) > 1:
        raise NotImplementedError("diverse beam search lands in a later slice")

    max_len = int(opt.get("max_seq_length", model.max_seq_length))
    b = memory["memory"].shape[0]
    cache = model.init_cache(memory, max_len, beam_size, beam_ancestry=True)

    def step_fn(it, cache, t):
        return model.decode_step_logits(it, cache, t, memory)

    return beam_search(
        step_fn, cache, b, beam_size, max_len,
        bos_id=model.bos_id, eos_id=model.eos_id, pad_id=model.pad_id, unk_id=model.unk_id,
        length_penalty=str(opt.get("length_penalty", "")),
        decoding_constraint=int(opt.get("decoding_constraint", 0)),
        suppress_unk=int(opt.get("suppress_UNK", 0)),
        bad_ending_ids=opt.get("bad_ending_ids"),
    )
