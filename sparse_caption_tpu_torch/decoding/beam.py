"""Batched beam search with beam-ancestry caches (port of
``sparse_caption_tpu/decoding/beam.py``, eval).

Semantics kept from the reference:
* candidates = beam score + log-prob, as a two-level top-K: the per-beam
  top-K over the vocabulary (kernel K4, which also applies the constraints)
  and then the top-K of the (K, K) candidate grid per image; the first step
  is restricted to beam 0 by -1e18 initial scores
* a beam that emits EOS at step t (or reaches the last step) is merged into
  the fixed-size done set with score ``penalty(t + 1, sum_lp)``; its live
  score then drops by 1000
* constraints: ``decoding_constraint`` (no immediate repeat), ``suppress_UNK``
  (-1000 on the unk id), bad endings (no EOS right after a bad-ending word,
  on the real EOS id)
* per-step chosen-token log-probs are recorded per beam (B, K, T)
* beams reorder by parent beam in one of the JAX package's two modes: a
  cache with an ``"ancestry"`` map (B, K, T) gathers only that map (the K/V
  cache rows never move); any other cache gathers every (B*K, ...) tensor
  by parent row (an exact gather; Up-Down's LSTM states), except the
  top-level ``"static"`` subtree, whose rows an image's beams share
* every top-K breaks ties to the lower index, as ``lax.top_k``
* diverse groups (``decoding/api.py``): a group's search subtracts
  ``diversity_lambda`` x the count of the tokens earlier groups chose at its
  local time (``diversity_penalty_tokens``, kernel K4's prologue) and returns
  its live beams' sequences after every step (``return_seq_snapshots``),
  from which later groups read their staggered view
* beam-sample SCST: the search returns its decisions (``BeamDecisions``:
  each step's parent beams, chosen tokens and finished-merge picks) and takes
  them back in a forced mode, which applies them in place of K4's top-K and
  the score merges but keeps every gather, so that ``done_seq_lp`` is a
  differentiable function of the steps' log-probs (kernel K13, f32). The
  JAX package differentiates its search itself; the port's gradient pass
  runs other code (autograd Functions), whose last bits may differ, and a
  re-decided search could turn at one near-tie. With gradients, the gathers
  of the log-probs and of a reordered cache (Up-Down's LSTM states) sum each
  source's picks in their backward by a one-hot product in f64 (the JAX
  package's one-hot einsum; deterministic, no atomics), not through
  ``gather`` / ``index_select``'s CUDA backward
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sparse_caption_tpu_torch.decoding.penalties import penalty_fn
from sparse_caption_tpu_torch.kernels.beam_topk import NEG_BIG, beam_topk, topk_lower_index
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax


class BeamDecisions(NamedTuple):
    """What a search decided at each step, (max_len, B, K) int64 each."""

    beam_ix: torch.Tensor  # the parent beam of each new live beam
    tokens: torch.Tensor  # the token each new live beam appended
    best_ix: torch.Tensor  # the finished-merge picks: of [done set, live beams], the K kept

    def to(self, device) -> "BeamDecisions":
        return BeamDecisions(*(x.to(device) for x in self))


def _pick(grid, beam_ix, rank_ix):
    """grid (B, K, K) -> grid[b, beam_ix[b, j], rank_ix[b, j]] as (B, K)."""
    by_beam = grid.gather(1, beam_ix[..., None].expand(-1, -1, grid.shape[2]))
    return by_beam.gather(2, rank_ix[..., None])[..., 0]


def _gather_beams(x, beam_ix):
    """x (B, M, ...) -> (B, K, ...): x[b, beam_ix[b, j]] for the (B, K) indices."""
    idx = beam_ix.reshape(*beam_ix.shape, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(*beam_ix.shape, *x.shape[2:]))


class _BeamGather(torch.autograd.Function):
    """``_gather_beams`` whose backward sums each source row's picks by a
    one-hot product in f64 (exact to well below an f32 ulp whatever the
    order, deterministic: no atomics)."""

    @staticmethod
    def forward(ctx, x, beam_ix):
        ctx.save_for_backward(beam_ix)
        ctx.sources = x.shape[1]
        return _gather_beams(x, beam_ix)

    @staticmethod
    def backward(ctx, grad):
        (beam_ix,) = ctx.saved_tensors
        b, k = beam_ix.shape
        onehot = F.one_hot(beam_ix, ctx.sources).to(torch.float64)  # (B, K, M)
        dx = torch.bmm(onehot.transpose(1, 2), grad.reshape(b, k, -1).to(torch.float64))
        return dx.to(grad.dtype).reshape(b, ctx.sources, *grad.shape[2:]), None


def gather_beams(x, beam_ix):
    """x (B, M, ...) -> (B, K, ...): x[b, beam_ix[b, j]]; with gradients
    through ``_BeamGather``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _BeamGather.apply(x, beam_ix)
    return _gather_beams(x, beam_ix)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)


def _reorder_rows(tree, beam_ix, rows):
    """Every tensor of ``tree`` (B*K, ...) gathered along its first axis by
    parent beam: ``rows`` the flat parent rows; with gradients by
    ``gather_beams`` on the (B, K, ...) view."""
    if isinstance(tree, torch.Tensor):
        if torch.is_grad_enabled() and tree.requires_grad:
            b, k = beam_ix.shape
            return gather_beams(tree.reshape(b, k, *tree.shape[1:]), beam_ix).reshape(tree.shape)
        return tree.index_select(0, rows)
    if isinstance(tree, dict):
        return {k: _reorder_rows(v, beam_ix, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reorder_rows(v, beam_ix, rows) for v in tree)
    return tree


def _reorder_cache(cache, beam_ix):
    """The cache after the step's beam choice (B, K) of parent beams."""
    if "ancestry" in cache:
        return dict(cache, ancestry=_gather_beams(cache["ancestry"], beam_ix))
    b, k = beam_ix.shape
    rows = (beam_ix + torch.arange(b, device=beam_ix.device)[:, None] * k).reshape(-1)
    return {key: v if key == "static" else _reorder_rows(v, beam_ix, rows) for key, v in cache.items()}


def beam_search(
    step_fn: Callable,
    init_cache,
    batch_size: int,
    beam_size: int,
    max_len: int,
    *,
    bos_id: int,
    eos_id: int,
    pad_id: int = 0,
    unk_id: int = 1,
    length_penalty: str = "",
    decoding_constraint: int = 0,
    suppress_unk: int = 0,
    bad_ending_ids: Optional[Sequence[int]] = None,
    diversity_penalty_tokens: Optional[torch.Tensor] = None,
    diversity_lambda: float = 0.5,
    return_seq_snapshots: bool = False,
    return_decisions: bool = False,
    forced: Optional[BeamDecisions] = None,
) -> Tuple[torch.Tensor, ...]:
    """Beam search over ``step_fn(it, cache, t) -> (logits (B*K, V), cache)``.

    ``init_cache`` is a dict, with a beam-ancestry map (B, K, T) int32 or
    with (B*K, ...) tensors to reorder (see the module notes); rows are
    interleaved (image i owns rows i*K..(i+1)*K-1). Returns (seq (B, K,
    max_len) int64, seq_logprobs (B, K, max_len) f32), sorted by penalized
    score per image, descending; with ``return_seq_snapshots`` also the live
    beams' sequences after each step (max_len, B, K, max_len).
    ``diversity_penalty_tokens``: (B, P, max_len), the tokens that earlier
    groups' P beams chose at each local time (diverse beam search), each
    lowering that word by ``diversity_lambda`` a time in every beam of its
    image. ``return_decisions``: also the search's ``BeamDecisions`` (last).
    ``forced``: the decisions of an earlier search, applied in place of the
    top-K and the merges (the constraints and the length penalty then play no
    part); each step's log-probs come from K13 over its logits, with
    gradients where the step's logits carry them."""
    if forced is not None:
        return _forced_search(step_fn, init_cache, batch_size, beam_size, max_len, bos_id, pad_id, forced)
    k = beam_size
    b = batch_size
    dev = next(_leaves(init_cache)).device
    penalty = penalty_fn(length_penalty)
    bad_ids = torch.tensor(list(bad_ending_ids), dtype=torch.int32, device=dev) if bad_ending_ids else None

    cache = init_cache
    tokens = torch.full((b * k,), bos_id, dtype=torch.int32, device=dev)
    sum_lp = torch.where(torch.arange(k, device=dev)[None, :] == 0, 0.0, NEG_BIG).expand(b, k).float()
    seq = torch.full((b, k, max_len), pad_id, dtype=torch.long, device=dev)
    seq_lp = torch.zeros((b, k, max_len), device=dev)
    done_score = torch.full((b, k), NEG_BIG, device=dev)
    done_seq = seq.clone()
    done_seq_lp = seq_lp.clone()
    div = None if diversity_penalty_tokens is None else diversity_penalty_tokens.to(torch.int32)
    snapshots, decided = [], []

    for t in range(max_len):
        logits, cache = step_fn(tokens, cache, t)  # (B*K, V)
        ban_token = tokens if (decoding_constraint and t > 0) else None
        ban_eos = torch.isin(tokens, bad_ids) if (bad_ids is not None and t > 0) else None
        row_lp, row_tok, row_raw = beam_topk(logits, k, ban_token=ban_token, ban_eos=ban_eos, eos_id=eos_id,
                                             unk_id=unk_id if suppress_unk else None,
                                             div_tokens=None if div is None else div[:, :, t].contiguous(),
                                             div_lambda=diversity_lambda)  # (B*K, K) each
        cand = sum_lp[..., None] + row_lp.reshape(b, k, k)
        top_scores, flat_ix = topk_lower_index(cand.reshape(b, k * k), k)  # (B, K)
        beam_ix = flat_ix // k  # parent beam
        rank_ix = flat_ix % k  # which of the parent's top-K tokens
        tok_ix = _pick(row_tok.reshape(b, k, k), beam_ix, rank_ix).long()
        chosen_lp = _pick(row_raw.reshape(b, k, k), beam_ix, rank_ix)

        seq = _gather_beams(seq, beam_ix)
        seq_lp = _gather_beams(seq_lp, beam_ix)
        cache = _reorder_cache(cache, beam_ix)
        seq[:, :, t] = tok_ix
        seq_lp[:, :, t] = chosen_lp
        sum_lp = top_scores
        if return_seq_snapshots:
            snapshots.append(seq)

        is_end = (tok_ix == eos_id) | (t == max_len - 1)
        fin_score = torch.where(is_end, penalty(t + 1.0, sum_lp), NEG_BIG)
        merged_score = torch.cat([done_score, fin_score], dim=1)  # (B, 2K)
        done_score, best_ix = topk_lower_index(merged_score, k)
        done_seq = _gather_beams(torch.cat([done_seq, seq], dim=1), best_ix)
        done_seq_lp = _gather_beams(torch.cat([done_seq_lp, seq_lp], dim=1), best_ix)

        sum_lp = torch.where(is_end, sum_lp - 1000.0, sum_lp)
        tokens = tok_ix.reshape(-1).int()
        if return_decisions:
            decided.append((beam_ix, tok_ix, best_ix))
    out = (done_seq, done_seq_lp)
    if return_seq_snapshots:
        out += (torch.stack(snapshots),)
    if return_decisions:
        out += (BeamDecisions(*(torch.stack(x) for x in zip(*decided))),)
    return out


def _forced_search(step_fn, cache, b: int, k: int, max_len: int, bos_id: int, pad_id: int,
                   forced: BeamDecisions):
    """``beam_search`` replaying ``forced``: the same reorders and merges, the
    chosen log-probs gathered from each step's K13 log-softmax (f32)."""
    if tuple(forced.tokens.shape) != (max_len, b, k):
        raise ValueError(f"forced decisions of shape {tuple(forced.tokens.shape)} for ({max_len}, {b}, {k})")
    dev = next(_leaves(cache)).device
    tokens = torch.full((b * k,), bos_id, dtype=torch.int32, device=dev)
    seq = torch.full((b, k, max_len), pad_id, dtype=torch.long, device=dev)
    seq_lp = torch.zeros((b, k, max_len), device=dev)
    done_seq, done_seq_lp = seq.clone(), seq_lp.clone()
    column = torch.arange(max_len, device=dev)
    for t in range(max_len):
        logits, cache = step_fn(tokens, cache, t)  # (B*K, V)
        lp = vocab_log_softmax(logits, torch.float32)
        vocab = lp.shape[1]
        beam_ix, tok_ix, best_ix = forced.beam_ix[t], forced.tokens[t], forced.best_ix[t]
        # (parent, token) pairs are distinct within an image: the gather's backward has no collisions
        chosen_lp = lp.reshape(b, k * vocab).gather(1, beam_ix * vocab + tok_ix)
        seq = _gather_beams(seq, beam_ix)
        seq_lp = gather_beams(seq_lp, beam_ix)
        cache = _reorder_cache(cache, beam_ix)
        at_t = column == t
        seq = torch.where(at_t, tok_ix[..., None], seq)
        seq_lp = torch.where(at_t, chosen_lp[..., None], seq_lp)
        done_seq = _gather_beams(torch.cat([done_seq, seq], dim=1), best_ix)
        done_seq_lp = gather_beams(torch.cat([done_seq_lp, seq_lp], dim=1), best_ix)
        tokens = tok_ix.reshape(-1).int()
    return done_seq, done_seq_lp
