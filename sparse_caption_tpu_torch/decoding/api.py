"""Generation entry point (port of ``sparse_caption_tpu/decoding/api.py``).

Dispatch on the opt dict as the JAX package does:

* ``num_random_sample > 0`` (requires ``beam_size < 1``): sampling by
  ``sample_method`` (``random``, ``gumbel``, ``top<k>``, ``top<p>``; kernel
  K9's modes), ``num_random_sample`` rows per image sharing its cross K/V
* ``beam_size > 1``: batched beam search (eval only); ``group_size > 1``:
  diverse beam search, the groups one after another, each penalised by the
  earlier groups' tokens (kernel K4's prologue)
* else: greedy

``decode_train=True`` decodes under the train policy (the SCST sampling
phase; beam search too, for beam-sample SCST): dropout keyed per step from
the ``rng`` seed's streams (``ops.rng.decode_train_keys``), masks applied as
in training (the cross K/V projection's drawn once under the cache stream),
f32 logits. ``generate(..., return_decisions=True)`` also returns a beam
search's decisions (``decoding.beam.BeamDecisions``), which the SCST
gradient pass replays. Memory stays one row per image for every model: the
beam or sample rows of an image read its row.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sparse_caption_tpu_torch.decoding.beam import beam_search
from sparse_caption_tpu_torch.decoding.sample import sample_decode
from sparse_caption_tpu_torch.ops.rng import SAMPLE_SITE, KeyedStream, decode_train_keys


def staggered_tokens(snap: torch.Tensor, off: int) -> torch.Tensor:
    """(B, K, T): an earlier group's live beams' token at each position t as
    its search saw them after step min(t + off, T - 1); ``snap`` (T, B, K, T)
    its snapshots (``beam_search(..., return_seq_snapshots=True)``)."""
    t_total = snap.shape[0]
    steps = torch.arange(t_total, device=snap.device)
    rows = snap[torch.clamp(steps + off, max=t_total - 1)]  # (T, B, K, T)
    return rows[steps, :, :, steps].permute(1, 2, 0)


@torch.no_grad()
def generate(model, memory: Dict[str, Any], opt: Optional[Dict[str, Any]] = None, rng: Optional[int] = None,
             noise=None, return_decisions: bool = False):
    """Captions from an encoded memory dict (``model.encode``), on the
    memory's device. ``rng``: the seed of the decode's random streams
    (required with ``decode_train``; sampling otherwise defaults to 0);
    ``noise``: explicit per-step noise for the CPU plain version
    (``decoding.sample.sample_decode``). Returns (seq (B, K, max_len),
    seq_logprobs (B, K, max_len)); beam search puts the best beam first (of
    each group, the groups in order), and with ``return_decisions`` (one
    group only) also returns its ``BeamDecisions``."""
    opt = opt or {}
    num_random_sample = int(opt.get("num_random_sample", 0))
    beam_size = int(opt.get("beam_size", 1))
    decode_train = bool(opt.get("decode_train", False))
    max_len = int(opt.get("max_seq_length", model.max_seq_length))
    decoding_constraint = int(opt.get("decoding_constraint", 0))
    b = memory["mask"].shape[0]  # every model's memory carries its (B, R) region mask
    cache_rng = step_rng = None
    if decode_train:
        if rng is None:
            raise ValueError("decode_train needs an rng seed")
        keys = decode_train_keys(int(rng))
        step_rng, cache_rng = KeyedStream(keys.dropout), KeyedStream(keys.cache)

    if beam_size > 1 and num_random_sample <= 0:
        common = dict(bos_id=model.bos_id, eos_id=model.eos_id, pad_id=model.pad_id, unk_id=model.unk_id,
                      length_penalty=str(opt.get("length_penalty", "")), decoding_constraint=decoding_constraint,
                      suppress_unk=int(opt.get("suppress_UNK", 0)), bad_ending_ids=opt.get("bad_ending_ids"))
        step = lambda it, cache, t: model.decode_step_logits(it, cache, t, memory, decode_train, step_rng)  # noqa: E731
        group_size = int(opt.get("group_size", 1))
        if group_size <= 1:
            cache = model.init_cache(memory, max_len, beam_size, beam_ancestry=True, train=decode_train,
                                     rng=cache_rng)
            return beam_search(step, cache, b, beam_size, max_len, return_decisions=return_decisions, **common)
        if return_decisions:
            raise ValueError("diverse beam search returns no decisions")
        # diverse beam search: the groups as sequential searches; group g at
        # local time t reads earlier group p's live beams' token at t as of
        # p's step t + (g - p) (its snapshots)
        if beam_size % group_size:
            raise ValueError(f"beam_size {beam_size} must divide by group_size {group_size}")
        bdash, lam = beam_size // group_size, float(opt.get("diversity_lambda", 0.5))
        seqs, lps, snaps = [], [], []
        for divm in range(group_size):
            prev = torch.cat([staggered_tokens(snaps[p], divm - p) for p in range(divm)], dim=1) if divm else None
            cache = model.init_cache(memory, max_len, bdash, beam_ancestry=True, train=decode_train, rng=cache_rng)
            seq_g, lp_g, snap_g = beam_search(step, cache, b, bdash, max_len, diversity_penalty_tokens=prev,
                                              diversity_lambda=lam, return_seq_snapshots=True, **common)
            seqs.append(seq_g)
            lps.append(lp_g)
            snaps.append(snap_g)
        return torch.cat(seqs, dim=1), torch.cat(lps, dim=1)

    rows, method = 1, "random"
    if num_random_sample > 0:
        if beam_size >= 1:
            raise ValueError(f"beam_size must be < 1 for random sampling, got {beam_size}")
        method = str(opt.get("sample_method", "random"))
        rows = num_random_sample
    if return_decisions:
        raise ValueError("only beam search returns decisions")
    sample_key = keys.sample if decode_train else (0 if rng is None else int(rng))
    cache = model.init_cache(memory, max_len, rows, train=decode_train, rng=cache_rng)

    def step_fn(it, cache, t):
        return model.decode_step_logits(it, cache, t, memory, decode_train, step_rng)

    seq, seq_lp = sample_decode(
        step_fn, cache, b * rows, max_len, bos_id=model.bos_id, eos_id=model.eos_id, pad_id=model.pad_id,
        greedy=num_random_sample <= 0, temperature=float(opt.get("temperature", 1.0)), sample_method=method,
        decoding_constraint=decoding_constraint, key=sample_key, site=SAMPLE_SITE,
        device=memory["mask"].device, noise=noise)
    return seq.reshape(b, rows, max_len), seq_lp.reshape(b, rows, max_len)
