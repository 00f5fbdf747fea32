"""K3: decode-step cross-attention with one memory K/V row per image shared by
its beam rows (``csrc/grouped_cross_attention.cu``).

``grouped_cross_attention`` launches the kernel for CUDA tensors and runs
``grouped_cross_attention_plain`` for CPU tensors; nothing else falls back.
With ``mem_v=None`` (a kv-shared layer, ACORT) it launches the kernel's kv
mode, which stages each memory row once and reads it for both products.
In bf16 the kernel holds the K, V (K alone in the kv mode) and q rows of
(image, 2 heads) units in shared memory (two units when they fit), which
bounds regions and rows an image (``bf16_smem``).
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import (
    check_float,
    check_head_width,
    check_same_device,
    check_tensor,
    padded_width,
)
from sparse_caption_tpu_torch.ops.attention import NEG_INF, divide_scores, score_divisor

KERNEL = _build.CudaKernel("grouped_cross_attention", "sct_grouped_cross_attention", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the kv mode: one memory array, read as K and V
KERNEL_KV = _build.CudaKernel("grouped_cross_attention", "sct_grouped_cross_attention_kv", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
UNIT_HEADS = 2  # heads of an image one unit of the bf16 kernel takes (csrc kXHeads)


def bf16_smem(regions: int, rep: int, kv: bool = False, dk: int = 64) -> int:
    """Shared memory of the bf16 kernel (``cross_smem_bytes``): two stages of
    a unit's rows if they fit, else one (K and V of its 2 heads, regions rows
    each, K alone in the kv mode, its rep x 2 q rows and a row of region
    flags), and a zero row, each row 2 (padded_width(dk) + 8) bytes (144 at
    dk 64, 80 at 32, 48 at 13). 0 when even one stage does not fit."""
    for stages in (2, 1):
        nbytes = (stages * (((1 if kv else 2) * regions + rep) * UNIT_HEADS + 1) + 1) * 2 * (padded_width(dk) + 8)
        if nbytes <= _build.BLOCK_SMEM_LIMIT:
            return nbytes
    return 0


def grouped_cross_attention_plain(q, mem_k, mem_v: Optional[torch.Tensor], mask):
    """Each group of N/B query rows attends its image's memory by broadcast."""
    if mem_v is None:
        mem_v = mem_k
    n, h, dk = q.shape
    b = mem_k.shape[0]
    qg = q.reshape(b, n // b, h, dk)
    scores = divide_scores(torch.einsum("bkhd,bhsd->bkhs", qg, mem_k), dk)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    out = torch.einsum("bkhs,bhsd->bkhd", torch.softmax(scores, dim=-1), mem_v)
    return out.reshape(n, h, dk)


def grouped_cross_attention(q, mem_k, mem_v: Optional[torch.Tensor], mask):
    """q: (N, h, dk) with N a multiple of B (image i owns rows i*rep..(i+1)*rep-1);
    mem_k/mem_v: (B, h, S, dk), mem_v=None when V shares K's storage;
    mask: (B, S) bool, False = padded region. Returns (N, h, dk)."""
    check_float(q, "q")
    n, h, dk = q.shape
    b, s = mem_k.shape[0], mem_k.shape[2]
    if b < 1 or n % b != 0:
        raise ValueError(f"{n} query rows do not split over {b} images")
    check_tensor(mem_k, "mem_k", (b, h, s, dk), q.dtype)
    if mem_v is not None:
        check_tensor(mem_v, "mem_v", (b, h, s, dk), q.dtype)
    check_tensor(mask, "mask", (b, s), torch.bool)
    check_same_device(q, mem_k, mem_v, mask)
    if q.device.type == "cpu":
        return grouped_cross_attention_plain(q, mem_k, mem_v, mask)
    check_head_width(dk, "grouped_cross_attention")
    if s > 64:
        raise ValueError(f"grouped_cross_attention kernel takes S <= 64; got S={s}")
    if q.dtype == torch.bfloat16 and bf16_smem(s, n // b, mem_v is None, dk) == 0:
        raise ValueError(f"grouped_cross_attention's bf16 kernel holds 2 heads' K, V and q rows in shared memory; "
                         f"{s} regions and {n // b} rows an image do not fit")
    q, mem_k = _build.aligned16(q), _build.aligned16(mem_k)
    out = torch.empty_like(q)
    if mem_v is None:
        KERNEL_KV.launch(_build.dtype_code(q), dk, q.data_ptr(), mem_k.data_ptr(), mask.data_ptr(), out.data_ptr(),
                         b, h, s, n // b, score_divisor(dk, q.dtype), _build.stream_handle(q))
        return out
    mem_v = _build.aligned16(mem_v)
    KERNEL.launch(_build.dtype_code(q), dk, q.data_ptr(), mem_k.data_ptr(), mem_v.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), b, h, s, n // b, score_divisor(dk, q.dtype), _build.stream_handle(q))
    return out
