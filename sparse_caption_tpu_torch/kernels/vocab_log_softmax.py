"""K13: row-wise log-softmax over the vocabulary, forward and backward
(``csrc/vocab_log_softmax.cu``).

``vocab_log_softmax(x, out_dtype)`` computes ``log_softmax(x)`` over the last
axis in f32 and writes it in ``out_dtype`` (x's dtype by default): f32 for
the ORT generator in training, the compute dtype for Up-Down and for eval.
CUDA tensors launch the kernel in both directions (an autograd Function
whose backward recomputes the softmax from x and two f32 stats per row);
CPU tensors run ``vocab_log_softmax_plain``. Nothing else falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float

KERNEL = _build.CudaKernel("vocab_log_softmax", "sct_vocab_log_softmax", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.I, _build.I, _build.P,
])
KERNEL_BWD = _build.CudaKernel("vocab_log_softmax", "sct_vocab_log_softmax_bwd", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.P,
])


def vocab_log_softmax_plain(x, out_dtype: Optional[torch.dtype] = None):
    """``log_softmax`` in f32, rounded to ``out_dtype`` (x's dtype by default)."""
    return torch.log_softmax(x.float(), dim=-1).to(out_dtype or x.dtype)


class _LogSoftmaxFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_dtype):
        vocab = x.shape[-1]
        rows = x.numel() // vocab
        y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        stats = torch.empty(rows, 2, dtype=torch.float32, device=x.device)
        KERNEL.launch(_build.dtype_code(x), _build.dtype_code(y), x.data_ptr(), y.data_ptr(), stats.data_ptr(), rows,
                      vocab, _build.stream_handle(x))
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stats = ctx.saved_tensors
        dy = dy.contiguous()
        vocab = x.shape[-1]
        dx = torch.empty_like(x)
        KERNEL_BWD.launch(_build.dtype_code(x), _build.dtype_code(dy), dy.data_ptr(), x.data_ptr(), stats.data_ptr(),
                          dx.data_ptr(), x.numel() // vocab, vocab, _build.stream_handle(x))
        return dx, None


def vocab_log_softmax(x, out_dtype: Optional[torch.dtype] = None):
    """x: (..., V) f32 or bf16, contiguous. Returns the log-softmax over the
    last axis in ``out_dtype`` (f32 or bf16; x's dtype by default)."""
    check_float(x, "x")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype: expected float32 or bfloat16, got {out_dtype}")
    if x.device.type == "cpu":
        return vocab_log_softmax_plain(x, out_dtype)
    return _LogSoftmaxFn.apply(x, out_dtype)
