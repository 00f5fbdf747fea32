"""K4: log_softmax + beam constraints + per-row top-K (``csrc/beam_topk.cu``).

``beam_topk`` launches the kernel for CUDA tensors and runs
``beam_topk_plain`` for CPU tensors; nothing else falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor

KERNEL = _build.CudaKernel("beam_topk", "sct_beam_topk", [
    _build.I, _build.P, _build.I, _build.I, _build.I, _build.P, _build.P, _build.I, _build.I,
    _build.P, _build.P, _build.P, _build.P,
])
NEG_BIG = -1e18
REGISTER_K = 32  # larger k takes the kernel's radix-select variant
SELECT_SMEM_LIMIT = 232448 - 4096  # bytes of dynamic shared memory that variant may take


def topk_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties to the lower index (as ``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def constrained_logprobs(logits, ban_token: Optional[torch.Tensor] = None, ban_eos: Optional[torch.Tensor] = None,
                         eos_id: int = 3, unk_id: Optional[int] = None):
    """(f32 log-probs rounded through the logits' dtype, f32 constrained log-probs), each (N, V)."""
    lp = torch.log_softmax(logits, dim=-1).float()
    c = lp.clone()
    if ban_token is not None:
        c[torch.arange(c.shape[0], device=c.device), ban_token.long()] += NEG_BIG
    if ban_eos is not None:
        c[:, eos_id] += torch.where(ban_eos, NEG_BIG, 0.0)
    if unk_id is not None:
        c[:, unk_id] += -1000.0
    return lp, c


def beam_topk_plain(logits, k: int, ban_token: Optional[torch.Tensor] = None,
                    ban_eos: Optional[torch.Tensor] = None, eos_id: int = 3, unk_id: Optional[int] = None):
    lp, c = constrained_logprobs(logits, ban_token, ban_eos, eos_id, unk_id)
    vals, idx = topk_lower_index(c, k)
    return vals, idx.int(), lp.gather(1, idx)


def beam_topk(logits, k: int, ban_token: Optional[torch.Tensor] = None, ban_eos: Optional[torch.Tensor] = None,
              eos_id: int = 3, unk_id: Optional[int] = None):
    """Constrained top-k of ``log_softmax(logits)`` per row.

    logits: (N, V) f32 or bf16; the log-probs are rounded to that dtype.
    ban_token: (N,) int32, a token to knock down by -1e18 per row
    (``decoding_constraint``); ban_eos: (N,) bool, rows whose EOS is knocked
    down by -1e18 (bad endings); unk_id: column knocked down by 1000
    (``suppress_UNK``). The penalties add in f32.
    Returns (values (N, k) f32, indices (N, k) int32, raw log-probs at the
    indices (N, k) f32); ties go to the lower index. Any 1 <= k <= V; on the
    card a k above 32 holds the row and the k winners in shared memory
    (4 V + 8 * pow2ceil(k) bytes, which V = 10000 allows for every k)."""
    check_float(logits, "logits")
    n, vocab = logits.shape
    if not 1 <= k <= vocab:
        raise ValueError(f"k={k} outside 1..{vocab}")
    if ban_token is not None:
        check_tensor(ban_token, "ban_token", (n,), torch.int32)
    if ban_eos is not None:
        check_tensor(ban_eos, "ban_eos", (n,), torch.bool)
    check_same_device(logits, ban_token, ban_eos)
    if logits.device.type == "cpu":
        return beam_topk_plain(logits, k, ban_token, ban_eos, eos_id, unk_id)
    if k > REGISTER_K and 4 * vocab + 8 * (1 << (k - 1).bit_length()) > SELECT_SMEM_LIMIT:
        raise ValueError(f"k={k} over V={vocab} needs more shared memory than a block has")
    dev = logits.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    raw = torch.empty((n, k), dtype=torch.float32, device=dev)
    KERNEL.launch(_build.dtype_code(logits), logits.data_ptr(), n, vocab, k, _build.ptr(ban_token),
                  _build.ptr(ban_eos), eos_id, -1 if unk_id is None else unk_id, vals.data_ptr(),
                  idx.data_ptr(), raw.data_ptr(), _build.stream_handle(logits))
    return vals, idx, raw
