"""K14 / K15: the decoder's full-sequence attention, forward and backward
(``csrc/decoder_attention.cu``, ``csrc/decoder_attention_bwd.cu``).

``decoder_attention(q, k, v, key_valid, causal, keep, keep_prob)`` computes
``softmax(fill(q k^T / sqrt(dk))) v`` with the masked scores filled with -1e9
in their dtype. The mask is a key-validity vector (one row per K/V row) and a
causal flag instead of a dense tensor; a K/V row may serve a group of g
consecutive query rows (the captions or samples of one image in
cross-attention), so the memory is projected and read once per image.
``keep`` is the training dropout on the probabilities. CUDA tensors launch
K14, inside an autograd Function whose backward is K15 (dK and dV summed over
each group in a fixed order). In bf16 both run on the tensor cores with the
whole group's query rows in shared memory at once, which bounds the group
(``bf16_forward_smem``, ``bf16_backward_smem``); they share the score and
softmax code, so K15 recomputes the probabilities K14 used, bit for bit.
CPU tensors run ``decoder_attention_plain`` (``ops/attention.py
scaled_dot_attention``). Nothing else falls back. With ``v=None`` (an
ACORT kv-shared layer: V is the K tensor) both launch their kv modes: K14
stages each shared row once, and K15 writes one gradient for it, dK and dV
each rounded to the compute dtype and then added there, as the plain
version's autograd adds the two uses of the tensor.
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
from sparse_caption_tpu_torch.ops.attention import scaled_dot_attention, score_divisor
from sparse_caption_tpu_torch.ops.keep import keep_divisor

KERNEL = _build.CudaKernel("decoder_attention", "sct_decoder_attention", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.F32, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
KERNEL_BWD = _build.CudaKernel("decoder_attention_bwd", "sct_decoder_attention_bwd", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.F32,
    _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the kv modes (V is K): no v in, one gradient dkv out
KERNEL_KV = _build.CudaKernel("decoder_attention", "sct_decoder_attention_kv", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.F32, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
KERNEL_BWD_KV = _build.CudaKernel("decoder_attention_bwd", "sct_decoder_attention_bwd_kv", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.F32,
    _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
MAX_LEN = 64  # the kernels' limit on keys and query positions


def row_pitch(dk: int) -> int:
    """The staged bf16 rows of K14 and K15 in elements (csrc/decoder_attention.cuh
    kLd): the padded width + 8, so 72 at dk 64, 40 at 32, 24 at 13."""
    return padded_width(dk) + 8


def bf16_forward_smem(tq: int, tk: int, group: int, keep: bool, dk: int = 64, kv: bool = False) -> int:
    """Shared memory of K14's bf16 kernel (``fwd_smem_bytes``) for a K/V row
    whose group of ``group`` query rows has ``tq`` positions each: two stages
    of (K, V (not in the kv mode), the group's q rows in rows of 2
    ``row_pitch(dk)`` bytes and, with a keep-mask, each member's tq x tk
    flags in a region rounded up to 16 bytes with 15 to spare) if they fit,
    else one, plus a zero row. 0 when even one stage does not fit."""
    pitch = row_pitch(dk)
    keep_pitch = 16 * -(-(tq * tk + 15) // 16)
    stage = 2 * ((1 if kv else 2) * tk + group * tq) * pitch + (group * keep_pitch if keep else 0)
    for stages in (2, 1):
        if stages * stage + 2 * pitch <= _build.BLOCK_SMEM_LIMIT:
            return stages * stage + 2 * pitch
    return 0


def bf16_backward_smem(tq: int, tk: int, group: int, dk: int = 64, kv: bool = False) -> int:
    """Shared memory of K15's bf16 kernel (``mma_smem_bytes``) for a K/V row
    whose group of ``group`` query rows has ``tq`` positions each: two stages
    of (K, V (not in the kv mode), the group's q and dO rows) if they fit,
    else one, plus a zero row and dS, P~ (each member's positions padded to
    16 x the keys padded to 16, + 8). 0 when even one stage does not fit."""
    pitch = row_pitch(dk)
    kp, qp = 16 * -(-tk // 16), 16 * -(-tq // 16)
    for stages in (2, 1):
        elems = stages * ((1 if kv else 2) * tk + 2 * group * tq) * pitch + pitch + 2 * group * qp * (kp + 8)
        if 2 * elems <= _build.BLOCK_SMEM_LIMIT:
            return 2 * elems
    return 0


def decoder_attention_plain(q, k, v, key_valid=None, causal: bool = False, keep=None, keep_prob: float = 1.0):
    """The plain version (the JAX package's ``scaled_dot_attention`` with K/V
    repeated to the query rows); v=None reads k as V (autograd then adds k's
    two gradients)."""
    return scaled_dot_attention(q, k, k if v is None else v, key_valid, causal, keep=keep, keep_prob=keep_prob)


class _DecoderAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, keep, causal: bool, keep_prob: float):
        n, h, tq, dk = q.shape
        nk, tk = k.shape[0], k.shape[2]
        q, k = _build.aligned16(q), _build.aligned16(k)
        out = torch.empty_like(q)
        tail = (_build.ptr(key_valid), _build.ptr(keep), keep_prob, out.data_ptr(), nk, h, tq, tk, n // nk,
                int(causal), score_divisor(dk, q.dtype), _build.stream_handle(q))
        if v is None:
            KERNEL_KV.launch(_build.dtype_code(q), dk, q.data_ptr(), k.data_ptr(), *tail)
        else:
            v = _build.aligned16(v)
            KERNEL.launch(_build.dtype_code(q), dk, q.data_ptr(), k.data_ptr(), v.data_ptr(), *tail)
        ctx.causal, ctx.keep_prob = causal, keep_prob
        ctx.save_for_backward(q, k, v, key_valid, keep)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, keep = ctx.saved_tensors
        n, h, tq, dk = q.shape
        nk, tk = k.shape[0], k.shape[2]
        q, k, dout = (_build.aligned16(t) for t in (q, k, dout.contiguous()))
        dq, dk_ = torch.empty_like(q), torch.empty_like(k)
        flags = (_build.ptr(key_valid), _build.ptr(keep), ctx.keep_prob, dq.data_ptr(), dk_.data_ptr())
        tail = (nk, h, tq, tk, n // nk, int(ctx.causal), score_divisor(dk, q.dtype), _build.stream_handle(q))
        if v is None:  # dk_ is d(k as K) + d(k as V)
            KERNEL_BWD_KV.launch(_build.dtype_code(q), dk, q.data_ptr(), k.data_ptr(), dout.data_ptr(), *flags, *tail)
            return dq, dk_, None, None, None, None, None
        v = _build.aligned16(v)
        dv = torch.empty_like(v)
        KERNEL_BWD.launch(_build.dtype_code(q), dk, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), *flags,
                          dv.data_ptr(), *tail)
        return dq, dk_, dv, None, None, None, None


def decoder_attention(q, k, v: Optional[torch.Tensor], key_valid: Optional[torch.Tensor] = None, causal: bool = False,
                      keep: Optional[torch.Tensor] = None, keep_prob: float = 1.0):
    """q: (N, h, Tq, dk); k, v: (Nk, h, Tk, dk) with Nk dividing N (K/V row b
    serves query rows b*g .. b*g + g - 1, g = N / Nk), v=None when V is k
    (the kv mode); key_valid: (Nk, Tk)
    bool, False = masked key, or None (every key valid); causal: query
    position i attends keys j <= i (needs Tq == Tk); keep: (N, h, Tq, Tk) bool,
    kept probabilities divided by ``keep_prob`` rounded to q's dtype, or None
    (no dropout). One dtype, f32 or bf16. Returns (N, h, Tq, dk), with
    gradients for q, k and v (for k alone, its two uses summed, when
    v=None)."""
    check_float(q, "q")
    n, h, tq, dk = q.shape
    nk, tk = k.shape[0], k.shape[2]
    if nk < 1 or n % nk != 0:
        raise ValueError(f"{n} query rows do not split over {nk} key rows")
    check_tensor(k, "k", (nk, h, tk, dk), q.dtype)
    if v is not None:
        check_tensor(v, "v", (nk, h, tk, dk), q.dtype)
    if key_valid is not None:
        check_tensor(key_valid, "key_valid", (nk, tk), torch.bool)
    if keep is not None:
        check_tensor(keep, "keep", (n, h, tq, tk), torch.bool)
    if causal and tq != tk:
        raise ValueError(f"causal attention needs as many keys as query positions; got Tq={tq} Tk={tk}")
    check_same_device(q, k, v, key_valid, keep)
    if q.device.type == "cpu":
        return decoder_attention_plain(q, k, v, key_valid, causal, keep, keep_prob)
    check_head_width(dk, "decoder_attention")
    if tq > MAX_LEN or tk > MAX_LEN:
        raise ValueError(f"decoder_attention kernels take Tq and Tk <= {MAX_LEN}; got Tq={tq} Tk={tk}")
    kv = v is None
    if q.dtype == torch.bfloat16 and bf16_forward_smem(tq, tk, n // nk, keep is not None, dk, kv) == 0:
        raise ValueError(f"decoder_attention's bf16 forward holds a K/V row's {n // nk} x {tq} query rows in shared "
                         f"memory; they do not fit with Tk={tk}")
    needs_grad = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v))
    if q.dtype == torch.bfloat16 and needs_grad and bf16_backward_smem(tq, tk, n // nk, dk, kv) == 0:
        raise ValueError(f"decoder_attention's bf16 backward holds a K/V row's {n // nk} x {tq} query rows in shared "
                         f"memory; they do not fit with Tk={tk}")
    return _DecoderAttentionFn.apply(q, k, v, key_valid, keep, causal, keep_divisor(keep_prob, q.dtype))
