"""K3: decode-step cross-attention with one memory K/V row per image shared by
its beam rows (``csrc/grouped_cross_attention.cu``).

``grouped_cross_attention`` launches the kernel for CUDA tensors and runs
``grouped_cross_attention_plain`` for CPU tensors; nothing else falls back.
With ``mem_v=None`` (a kv-shared layer, ACORT) it launches the kernel's kv
mode, which stages each memory row once and reads it for both products.
In bf16 the kernel holds the K, V (K alone in the kv mode) and q rows of
(image, 2 heads) units in shared memory (two units when they fit), which
bounds regions and rows an image (``bf16_smem``).

Where gradients are asked for (supermask SCST's gradient pass, which runs
the decode step by step) the call is an autograd Function whose backward is
kernel K3's backward (``csrc/grouped_cross_attention_bwd.cu``;
``grouped_cross_attention_backward``, plain version
``grouped_cross_attention_backward_plain``, the autograd of the plain
forward): dq for every row, and each image's dK, dV summed over its ``rep``
rows in a fixed order. Ported in f32 at head widths 64, 32 and 13, for
unshared K and V and in the kv mode (one memory array, staged once; its
gradient dK + dV, its own entry point and launch count); bf16 raises
``NotImplementedError`` on every device (the JAX package's SCST step runs
in f32). ``bwd_smem`` bounds regions and rows an image. The steps' dK / dV
of the one cross K/V are summed by autograd.
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
    envelope_cap,
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
# the backward: dq, and dK / dV of each image summed over its rows
KERNEL_BWD = _build.CudaKernel("grouped_cross_attention_bwd", "sct_grouped_cross_attention_bwd", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the kv mode: one memory array and its one gradient, dK + dV
KERNEL_BWD_KV = _build.CudaKernel("grouped_cross_attention_bwd", "sct_grouped_cross_attention_bwd_kv", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
BWD_HEAD_WIDTHS = (64, 32, 13)  # the backward kernel's instances (f32)
UNIT_HEADS = 2  # heads of an image one unit of the bf16 kernel takes (csrc kXHeads)


def raw_stage_bytes(regions: int, rep: int, kv: bool = False, dk: int = 13) -> int:
    """A raw stage of the bf16 kernel at head width 13 (``cross_raw_bytes``):
    the envelopes of a unit's K span (its 2 heads' regions rows), V span (not
    in the kv mode) and a q span a beam (2 rows), then the region flags."""
    return ((1 if kv else 2) * envelope_cap(UNIT_HEADS * regions * dk * 2) + rep * envelope_cap(UNIT_HEADS * dk * 2)
            + (regions + 15) // 16 * 16)


def bf16_smem(regions: int, rep: int, kv: bool = False, dk: int = 64) -> int:
    """Shared memory of the bf16 kernel (``cross_smem_bytes``): two stages of
    a unit's rows if they fit, else one (K and V of its 2 heads, regions rows
    each, K alone in the kv mode, its rep x 2 q rows and a row of region
    flags), and a zero row, each row 2 (padded_width(dk) + 8) bytes (144 at
    dk 64, 80 at 32, 48 at 13). At head width 13 the stages are raw
    (``raw_stage_bytes``, copied whole) and repacked into one stage of rows.
    0 when even one stage does not fit."""
    row, rows = 2 * (padded_width(dk) + 8), ((1 if kv else 2) * regions + rep) * UNIT_HEADS + 1
    for stages in (2, 1):
        if dk % 8:
            nbytes = (rows + 1) * row + stages * raw_stage_bytes(regions, rep, kv, dk)
        else:
            nbytes = (stages * rows + 1) * row
        if nbytes <= _build.BLOCK_SMEM_LIMIT:
            return nbytes
    return 0


def bwd_smem(dk: int, regions: int, rep: int, kv: bool = False) -> int:
    """Shared memory of the backward kernel (``cross_bwd_smem_bytes``): K and
    V of one (image, head) (K alone in the kv mode) at row pitch
    padded_width(dk) + 4, every row's q and dout (padded_width(dk) each), at
    dk 13 the raw stage (each memory span's 16-byte envelope, 16 floats a q
    and a dout row), probabilities and score gradients (a region each), f32,
    and the region flags."""
    p, arrays = padded_width(dk), 1 if kv else 2
    raw = 0 if dk % 4 == 0 else arrays * bwd_raw_floats(regions * dk) + 2 * rep * 16
    return (arrays * regions * (p + 4) + 2 * rep * p + raw + 2 * rep * regions) * 4 + regions


def bwd_raw_floats(n: int) -> int:
    """Floats of the backward's raw stage for the 16-byte envelope of n f32
    elements (``cross_bwd_raw``: an offset of at most 12 bytes)."""
    return (4 * n + 12 + 15) // 16 * 4


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
    mask: (B, S) bool, False = padded region. Returns (N, h, dk); with
    gradients through K3's backward where they are asked for."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (q, mem_k, mem_v)):
        check_backward_supported(q)
        return GroupedCrossStep.apply(q, mem_k, mem_v, mask)
    return _forward(q, mem_k, mem_v, mask)


def _forward(q, mem_k, mem_v: Optional[torch.Tensor], mask):
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


# ------------------------------------------------------------------ backward
def check_backward_supported(q) -> None:
    """What the backward does not take, on every device: bf16 (the JAX
    package's SCST step runs in f32)."""
    if q.dtype != torch.float32:
        raise NotImplementedError(f"K3's backward is ported in f32 (the JAX package's SCST step runs in f32); "
                                  f"got {q.dtype}")


def grouped_cross_attention_backward_plain(q, mem_k, mem_v: Optional[torch.Tensor], mask, dout):
    """The plain version: the autograd of ``grouped_cross_attention_plain``.
    Returns (dq (N, h, dk), dK, dV (B, h, S, dk)); under kv (``mem_v=None``)
    (dq, dmem, None), dmem the one memory's gradient, dK + dV."""
    with torch.enable_grad():
        mems = (mem_k,) if mem_v is None else (mem_k, mem_v)
        qq, *mm = (x.detach().requires_grad_() for x in (q, *mems))
        out = grouped_cross_attention_plain(qq, mm[0], None if mem_v is None else mm[1], mask)
        grads = torch.autograd.grad(out, (qq, *mm), dout)
    return grads if mem_v is not None else (*grads, None)


def grouped_cross_attention_backward(q, mem_k, mem_v: Optional[torch.Tensor], mask, dout):
    """The backward of one decode step's K3 (f32): q, dout (N, h, dk); mem_k,
    mem_v (B, h, S, dk), mem_v=None in the kv mode; mask (B, S) bool.
    Returns (dq, dK, dV), dK and dV each image's sum over its N / B rows;
    regions the mask drops get dK = 0 (their scores were filled), and dV = p
    dout as every region (an image with no valid region attends all S
    uniformly). Under kv (dq, dmem, None), dmem = dK + dV."""
    check_backward_supported(q)
    kv = mem_v is None
    n, h, dk = q.shape
    b, s = mem_k.shape[0], mem_k.shape[2]
    if b < 1 or n % b != 0:
        raise ValueError(f"{n} query rows do not split over {b} images")
    check_tensor(dout, "dout", (n, h, dk), q.dtype)
    check_tensor(mem_k, "mem_k", (b, h, s, dk), q.dtype)
    if not kv:
        check_tensor(mem_v, "mem_v", (b, h, s, dk), q.dtype)
    check_tensor(mask, "mask", (b, s), torch.bool)
    check_same_device(q, mem_k, mem_v, mask, dout)
    if q.device.type == "cpu":
        return grouped_cross_attention_backward_plain(q, mem_k, mem_v, mask, dout)
    if dk not in BWD_HEAD_WIDTHS:
        raise ValueError(f"K3's backward kernel takes head widths {BWD_HEAD_WIDTHS}; got dk={dk}")
    if s > 64 or bwd_smem(dk, s, n // b, kv) > _build.BLOCK_SMEM_LIMIT:
        raise ValueError(f"K3's backward kernel holds an (image, head)'s memory and its {n // b} rows in shared "
                         f"memory and takes S <= 64; {s} regions do not fit")
    q, dout, mem_k = _build.aligned16(q), _build.aligned16(dout), _build.aligned16(mem_k)
    dq, dmk = torch.empty_like(q), torch.empty_like(mem_k)
    sqrt_dk, stream = score_divisor(dk, q.dtype), _build.stream_handle(q)
    if kv:
        KERNEL_BWD_KV.launch(dk, q.data_ptr(), mem_k.data_ptr(), mask.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                             dmk.data_ptr(), b, h, s, n // b, sqrt_dk, stream)
        return dq, dmk, None
    mem_v = _build.aligned16(mem_v)
    dmv = torch.empty_like(mem_v)
    KERNEL_BWD.launch(dk, q.data_ptr(), mem_k.data_ptr(), mem_v.data_ptr(), mask.data_ptr(), dout.data_ptr(),
                      dq.data_ptr(), dmk.data_ptr(), dmv.data_ptr(), b, h, s, n // b, sqrt_dk, stream)
    return dq, dmk, dmv


class GroupedCrossStep(torch.autograd.Function):
    """One decode step's cross-attention with gradients: K3 forward, K3's
    backward. Saves q and the memory (no probabilities: the backward
    recomputes them); under kv (mem_v=None) one memory and one gradient."""

    @staticmethod
    def forward(ctx, q, mem_k, mem_v, mask):
        ctx.kv = mem_v is None
        ctx.save_for_backward(q, mem_k, mask, *(() if ctx.kv else (mem_v,)))
        return _forward(q, mem_k, mem_v, mask)

    @staticmethod
    def backward(ctx, dout):
        q, mem_k, mask, *mem_v = ctx.saved_tensors
        dq, dmk, dmv = grouped_cross_attention_backward(q, mem_k, None if ctx.kv else mem_v[0], mask,
                                                        dout.contiguous())
        return dq, dmk, dmv, None
