"""K4: log_softmax + beam constraints + per-row top-K (``csrc/beam_topk.cu``).

``beam_topk`` launches the kernel for CUDA tensors and runs
``beam_topk_plain`` for CPU tensors; nothing else falls back. Diverse beam
search's penalty (``div_tokens``, the tokens earlier groups chose) runs in
the kernel's prologue.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor

ARGS = [
    _build.I, _build.P, _build.I, _build.I, _build.I, _build.P, _build.P, _build.I, _build.I,
    _build.P, _build.I, _build.I, _build.F32, _build.P, _build.P, _build.P, _build.P,
]
KERNEL = _build.CudaKernel("beam_topk", "sct_beam_topk", ARGS)
# with the diverse-beam penalty: the same entry point, counted apart
KERNEL_DIVERSE = _build.CudaKernel("beam_topk", "sct_beam_topk", ARGS)
NEG_BIG = -1e18
REGISTER_K = 32  # larger k takes the kernel's radix-select variant
SELECT_SMEM_LIMIT = 232448 - 4096  # bytes of dynamic shared memory that variant may take
MAX_DIVERSITY = 256  # earlier-group tokens an image may carry (csrc/beam_topk.cu kMaxDiversity)


def topk_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties to the lower index (as ``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def diversity_counts(div_tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) f32: how many of each image's P earlier-group tokens (B, P) are
    each word (``sum(one_hot(prev_t, V), axis=1)`` of ``beam.py:181-183``)."""
    counts = torch.zeros(div_tokens.shape[0], vocab, dtype=torch.float32, device=div_tokens.device)
    return counts.scatter_add_(1, div_tokens.long(), torch.ones(div_tokens.shape, device=div_tokens.device))


def constrained_logprobs(logits, ban_token: Optional[torch.Tensor] = None, ban_eos: Optional[torch.Tensor] = None,
                         eos_id: int = 3, unk_id: Optional[int] = None, div_tokens: Optional[torch.Tensor] = None,
                         div_lambda: float = 0.5):
    """(f32 log-probs rounded through the logits' dtype, f32 constrained log-probs), each (N, V).
    The diverse-beam penalty, last: count x lambda in f32, count first, for
    the N / B rows of each image of ``div_tokens`` (B, P)."""
    lp = torch.log_softmax(logits, dim=-1).float()
    c = lp.clone()
    if ban_token is not None:
        c[torch.arange(c.shape[0], device=c.device), ban_token.long()] += NEG_BIG
    if ban_eos is not None:
        c[:, eos_id] += torch.where(ban_eos, NEG_BIG, 0.0)
    if unk_id is not None:
        c[:, unk_id] += -1000.0
    if div_tokens is not None:
        counts = diversity_counts(div_tokens, c.shape[1]).repeat_interleave(c.shape[0] // div_tokens.shape[0], 0)
        c = c - counts * div_lambda
    return lp, c


def beam_topk_plain(logits, k: int, ban_token: Optional[torch.Tensor] = None,
                    ban_eos: Optional[torch.Tensor] = None, eos_id: int = 3, unk_id: Optional[int] = None,
                    div_tokens: Optional[torch.Tensor] = None, div_lambda: float = 0.5):
    lp, c = constrained_logprobs(logits, ban_token, ban_eos, eos_id, unk_id, div_tokens, div_lambda)
    vals, idx = topk_lower_index(c, k)
    return vals, idx.int(), lp.gather(1, idx)


def beam_topk(logits, k: int, ban_token: Optional[torch.Tensor] = None, ban_eos: Optional[torch.Tensor] = None,
              eos_id: int = 3, unk_id: Optional[int] = None, div_tokens: Optional[torch.Tensor] = None,
              div_lambda: float = 0.5):
    """Constrained top-k of ``log_softmax(logits)`` per row.

    logits: (N, V) f32 or bf16; the log-probs are rounded to that dtype.
    ban_token: (N,) int32, a token to knock down by -1e18 per row
    (``decoding_constraint``); ban_eos: (N,) bool, rows whose EOS is knocked
    down by -1e18 (bad endings); unk_id: column knocked down by 1000
    (``suppress_UNK``); div_tokens: (N / k, P) int32 (diverse beam search,
    P <= 256), the tokens earlier groups chose at this step for each image,
    whose k rows each lower word v by count(v) x div_lambda. The penalties
    add in f32, in that order.
    Returns (values (N, k) f32, indices (N, k) int32, raw log-probs at the
    indices (N, k) f32, no penalty in them); ties go to the lower index. Any
    1 <= k <= V; on the card a k above 32 holds the row and the k winners in shared memory
    (4 V + 8 * pow2ceil(k) bytes, which V = 10000 allows for every k)."""
    check_float(logits, "logits")
    n, vocab = logits.shape
    if not 1 <= k <= vocab:
        raise ValueError(f"k={k} outside 1..{vocab}")
    if ban_token is not None:
        check_tensor(ban_token, "ban_token", (n,), torch.int32)
    if ban_eos is not None:
        check_tensor(ban_eos, "ban_eos", (n,), torch.bool)
    if div_tokens is not None:
        if div_tokens.dim() != 2 or div_tokens.shape[0] * k != n or not 1 <= div_tokens.shape[1] <= MAX_DIVERSITY:
            raise ValueError(f"div_tokens: expected ({n // k}, P) with 1 <= P <= {MAX_DIVERSITY}, got "
                             f"{tuple(div_tokens.shape)}")
        check_tensor(div_tokens, "div_tokens", div_tokens.shape, torch.int32)
    check_same_device(logits, ban_token, ban_eos, div_tokens)
    if logits.device.type == "cpu":
        return beam_topk_plain(logits, k, ban_token, ban_eos, eos_id, unk_id, div_tokens, div_lambda)
    if k > REGISTER_K and 4 * vocab + 8 * (1 << (k - 1).bit_length()) > SELECT_SMEM_LIMIT:
        raise ValueError(f"k={k} over V={vocab} needs more shared memory than a block has")
    dev = logits.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    raw = torch.empty((n, k), dtype=torch.float32, device=dev)
    div_p = 0 if div_tokens is None else div_tokens.shape[1]
    kernel = KERNEL if div_tokens is None else KERNEL_DIVERSE
    kernel.launch(_build.dtype_code(logits), logits.data_ptr(), n, vocab, k, _build.ptr(ban_token),
                  _build.ptr(ban_eos), eos_id, -1 if unk_id is None else unk_id, _build.ptr(div_tokens), div_p, k,
                  div_lambda, vals.data_ptr(), idx.data_ptr(), raw.data_ptr(), _build.stream_handle(logits))
    return vals, idx, raw
