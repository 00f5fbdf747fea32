"""K2: decode-step self-attention through the beam-ancestry map
(``csrc/ancestry_self_attention.cu``).

``ancestry_self_attention`` launches the kernel for CUDA tensors and runs
``ancestry_self_attention_plain`` for CPU tensors; nothing else falls back.
With ``cache_v=None`` (a kv-shared layer, ACORT: one cache array read as K
and V) it launches the kernel's kv mode, which reads each cached slot once
for both the scores and the output.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_head_width, check_same_device, check_tensor
from sparse_caption_tpu_torch.ops.attention import divide_scores, score_divisor

KERNEL = _build.CudaKernel("ancestry_self_attention", "sct_ancestry_self_attention", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the kv mode: one cache array, read as K and V
KERNEL_KV = _build.CudaKernel("ancestry_self_attention", "sct_ancestry_self_attention_kv", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# cache slots the kernel takes: the rows PyTorch's warp softmax takes, whose
# layout the kernel follows (csrc: 32 lanes, at most 32 slots each)
MAX_SLOTS = 1024


def ancestry_self_attention_plain(q, cache_k, cache_v: Optional[torch.Tensor], ancestry: Optional[torch.Tensor],
                                  t: int):
    """Attention of row n = b*K + k against the cached slots t' <= t of row
    b*K + ancestry[b, k, t'] (row n itself without a map); cache_v=None reads
    the K cache as V.

    The reference scores every slot and masks t' > t with -1e9; those
    softmax weights are exactly 0, so reading slots 0..t only is the same.
    In bf16 the score, its quotient by sqrt(dk) (``divide_scores``) and the
    softmax weights round to bf16, the points the kernel rounds at."""
    if cache_v is None:
        cache_v = cache_k
    n, h, dk = q.shape
    keys, vals = cache_k[:, :, : t + 1], cache_v[:, :, : t + 1]  # (N, h, t+1, dk)
    if ancestry is not None:
        b, kb, _ = ancestry.shape
        base = torch.arange(b, device=q.device)[:, None, None] * kb
        rows = (ancestry[:, :, : t + 1].long() + base).reshape(n, t + 1)  # (N, t+1)
        slots = torch.arange(t + 1, device=q.device)
        keys = cache_k.transpose(1, 2)[rows, slots].transpose(1, 2)  # (N, h, t+1, dk)
        vals = cache_v.transpose(1, 2)[rows, slots].transpose(1, 2)
    scores = divide_scores(torch.einsum("nhd,nhtd->nht", q, keys), dk)
    return torch.einsum("nht,nhtd->nhd", torch.softmax(scores, dim=-1), vals)


def ancestry_self_attention(q, cache_k, cache_v: Optional[torch.Tensor], ancestry: Optional[torch.Tensor], t: int):
    """q: (N, h, dk); cache_k/v: (N, h, T_max, dk) with slot t already written,
    cache_v=None when the layer shares K and V (the kv mode);
    ancestry: (B, K, T_max) int32 with N = B*K, or None for the identity map;
    0 <= t < T_max. Returns (N, h, dk) in q's dtype."""
    check_float(q, "q")
    n, h, dk = q.shape
    t_max = cache_k.shape[2]
    for name, c in (("cache_k", cache_k), ("cache_v", cache_v)):
        if c is not None:
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
    check_head_width(dk, "ancestry_self_attention")
    if h > 32 or t_max > MAX_SLOTS:
        raise ValueError(f"ancestry_self_attention kernel takes h <= 32, T_max <= {MAX_SLOTS}; got h={h} "
                         f"T_max={t_max}")
    out = torch.empty_like(q)
    if cache_v is None:
        KERNEL_KV.launch(_build.dtype_code(q), dk, q.data_ptr(), cache_k.data_ptr(), _build.ptr(ancestry),
                         out.data_ptr(), n, h, t_max, kb, t, score_divisor(dk, q.dtype), _build.stream_handle(q))
        return out
    KERNEL.launch(_build.dtype_code(q), dk, q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                  _build.ptr(ancestry), out.data_ptr(), n, h, t_max, kb, t, score_divisor(dk, q.dtype),
                  _build.stream_handle(q))
    return out
