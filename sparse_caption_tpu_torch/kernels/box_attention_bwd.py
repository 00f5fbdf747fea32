"""K7: backward of the ORT box-relation self-attention (``csrc/box_attention_bwd.cu``),
bound with K1's train variant into one autograd Function.

``box_attention_train`` is the training form of ``box_attention``: for CUDA
tensors its forward launches K1's train variant (dropout keep-mask on the
probabilities) and its backward launches K7, which recomputes the
probabilities with K1's arithmetic and
which returns dq, dk, dv and the gradients of the ``wg`` projection; for
CPU tensors it runs ``box_attention_plain``, whose autograd gives the same
gradients. Nothing else falls back. With ``v=None`` (a kv-shared layer,
ACORT) both launch their kv modes: V is the K tensor, and K7 returns one
gradient for it, dK and dV each rounded to the compute dtype and then added
there, as the plain version's autograd adds the two uses of k.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels.box_attention import (
    DIM_G,
    RAW_DIM_G,
    box_attention_plain,
    check_args,
    forward_kernel,
)
from sparse_caption_tpu_torch.ops.attention import geometry_frequencies, score_divisor
from sparse_caption_tpu_torch.ops.keep import keep_divisor

HEAD_GROUP = 4  # heads per block of the kernel (csrc/box_attention_bwd.cu kGroupHeads)
KERNEL = _build.CudaKernel("box_attention_bwd", "sct_box_attention_bwd", [
    _build.I, _build.I, _build.I, *[_build.P] * 10, _build.F32, *[_build.P] * 6,
    _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the kv mode: no v in, one gradient dkv out
KERNEL_KV = _build.CudaKernel("box_attention_bwd", "sct_box_attention_bwd_kv", [
    _build.I, _build.I, _build.I, *[_build.P] * 9, _build.F32, *[_build.P] * 5,
    _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the raw geometry (dim_g 4): the same entry points, each counted apart
KERNEL_RAW = _build.CudaKernel("box_attention_bwd", "sct_box_attention_bwd", KERNEL.argtypes)
KERNEL_KV_RAW = _build.CudaKernel("box_attention_bwd", "sct_box_attention_bwd_kv", KERNEL_KV.argtypes)


class _BoxAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, boxes, wg_weight, wg_bias, mask, keep, keep_prob: float):
        b, h, r, dk = q.shape
        out = torch.empty_like(q)
        freq = geometry_frequencies(DIM_G, device=q.device)
        tail = (boxes.data_ptr(), wg_weight.data_ptr(), wg_bias.data_ptr(), freq.data_ptr(), mask.data_ptr(),
                _build.ptr(keep), keep_prob, out.data_ptr(), b, h, r, score_divisor(dk, q.dtype),
                _build.stream_handle(q))
        dg = wg_weight.shape[1]
        forward_kernel(True, v is None, dg).launch(_build.dtype_code(q), dk, dg, q.data_ptr(), k.data_ptr(),
                                                   *(() if v is None else (v.data_ptr(),)), *tail)
        ctx.keep_prob = keep_prob
        ctx.save_for_backward(q, k, v, boxes, wg_weight, wg_bias, mask, keep, freq)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, boxes, wg_weight, wg_bias, mask, keep, freq = ctx.saved_tensors
        b, h, r, dk = q.shape
        dout = dout.contiguous()
        dq, dk_ = torch.empty_like(q), torch.empty_like(k)
        dwg_w, dwg_b = torch.empty_like(wg_weight), torch.empty_like(wg_bias)
        # per-(image, head group) d wg partials, summed by the kernel's second pass in a fixed order (a row
        # holds the 64 trig columns, or the 4 raw ones first, then the bias)
        partial = torch.empty(b, -(-h // HEAD_GROUP), h, DIM_G + 1, device=q.device, dtype=torch.float32)
        dg = wg_weight.shape[1]
        inputs = (dout.data_ptr(), boxes.data_ptr(), wg_weight.data_ptr(), wg_bias.data_ptr(), freq.data_ptr(),
                  mask.data_ptr(), _build.ptr(keep), ctx.keep_prob, dq.data_ptr(), dk_.data_ptr())
        tail = (dwg_w.data_ptr(), dwg_b.data_ptr(), partial.data_ptr(), b, h, r, score_divisor(dk, q.dtype),
                _build.stream_handle(q))
        raw = dg == RAW_DIM_G
        if v is None:  # dk_ is d(k as K) + d(k as V)
            (KERNEL_KV_RAW if raw else KERNEL_KV).launch(_build.dtype_code(q), dk, dg, q.data_ptr(), k.data_ptr(),
                                                         *inputs, *tail)
            return dq, dk_, None, None, dwg_w, dwg_b, None, None, None
        dv = torch.empty_like(v)
        (KERNEL_RAW if raw else KERNEL).launch(_build.dtype_code(q), dk, dg, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               *inputs, dv.data_ptr(), *tail)
        return dq, dk_, dv, None, dwg_w, dwg_b, None, None, None


def box_attention_train(q, k, v, boxes, wg_weight, wg_bias, mask, keep: Optional[torch.Tensor] = None,
                        keep_prob: float = 1.0):
    """``box_attention`` with gradients for q, k, v (v=None: V is k, the kv
    mode), wg_weight and wg_bias, and
    the training dropout: keep (B, h, R, R) bool, kept probabilities scaled
    by 1 / keep_prob (None: no dropout)."""
    check_args(q, k, v, boxes, wg_weight, wg_bias, mask, keep)
    if q.device.type == "cpu":
        return box_attention_plain(q, k, v, boxes, wg_weight, wg_bias, mask, keep, keep_prob)
    return _BoxAttentionFn.apply(q, k, v, boxes, wg_weight, wg_bias, mask, keep, keep_divisor(keep_prob, q.dtype))
