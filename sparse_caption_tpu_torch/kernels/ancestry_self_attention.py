"""K2: decode-step self-attention through the beam-ancestry map
(``csrc/ancestry_self_attention.cu``).

``ancestry_self_attention`` launches the kernel for CUDA tensors and runs
``ancestry_self_attention_plain`` for CPU tensors; nothing else falls back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor

KERNEL = _build.CudaKernel("ancestry_self_attention", "sct_ancestry_self_attention", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# cache slots the kernel takes: the rows PyTorch's warp softmax takes, whose
# layout the kernel follows (csrc: 32 lanes, at most 32 slots each)
MAX_SLOTS = 1024


def ancestry_self_attention_plain(q, cache_k, cache_v, ancestry: Optional[torch.Tensor], t: int):
    """Attention of row n = b*K + k against the cached slots t' <= t of row
    b*K + ancestry[b, k, t'] (row n itself without a map).

    The reference scores every slot and masks t' > t with -1e9; those
    softmax weights are exactly 0, so reading slots 0..t only is the same.
    In bf16 the score, the scaled score and the softmax weights round to
    bf16, the points the kernel rounds at."""
    n, h, dk = q.shape
    keys, vals = cache_k[:, :, : t + 1], cache_v[:, :, : t + 1]  # (N, h, t+1, dk)
    if ancestry is not None:
        b, kb, _ = ancestry.shape
        base = torch.arange(b, device=q.device)[:, None, None] * kb
        rows = (ancestry[:, :, : t + 1].long() + base).reshape(n, t + 1)  # (N, t+1)
        slots = torch.arange(t + 1, device=q.device)
        keys = cache_k.transpose(1, 2)[rows, slots].transpose(1, 2)  # (N, h, t+1, dk)
        vals = cache_v.transpose(1, 2)[rows, slots].transpose(1, 2)
    scores = torch.einsum("nhd,nhtd->nht", q, keys) / math.sqrt(dk)
    return torch.einsum("nht,nhtd->nhd", torch.softmax(scores, dim=-1), vals)


def ancestry_self_attention(q, cache_k, cache_v, ancestry: Optional[torch.Tensor], t: int):
    """q: (N, h, dk); cache_k/v: (N, h, T_max, dk) with slot t already written;
    ancestry: (B, K, T_max) int32 with N = B*K, or None for the identity map;
    0 <= t < T_max. Returns (N, h, dk) in q's dtype."""
    check_float(q, "q")
    n, h, dk = q.shape
    t_max = cache_k.shape[2]
    for name, c in (("cache_k", cache_k), ("cache_v", cache_v)):
        check_tensor(c, name, (n, h, t_max, dk), q.dtype)
    kb = 1
    if ancestry is not None:
        if ancestry.dim() != 3 or ancestry.shape[0] * ancestry.shape[1] != n:
            raise ValueError(f"ancestry: expected (B, K, {t_max}) with B*K == {n}, got {tuple(ancestry.shape)}")
        kb = ancestry.shape[1]
        check_tensor(ancestry, "ancestry", (n // kb, kb, t_max), torch.int32)
    if not 0 <= t < t_max:
        raise ValueError(f"t={t} outside the cache of {t_max} slots")
    check_same_device(q, cache_k, cache_v, ancestry)
    if q.device.type == "cpu":
        return ancestry_self_attention_plain(q, cache_k, cache_v, ancestry, t)
    if dk != 64 or h > 32 or t_max > MAX_SLOTS:
        raise ValueError(f"ancestry_self_attention kernel takes dk == 64, h <= 32, T_max <= {MAX_SLOTS}; "
                         f"got dk={dk} h={h} T_max={t_max}")
    out = torch.empty_like(q)
    KERNEL.launch(_build.dtype_code(q), q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                  _build.ptr(ancestry), out.data_ptr(), n, h, t_max, kb, t, 1.0 / math.sqrt(dk),
                  _build.stream_handle(q))
    return out
