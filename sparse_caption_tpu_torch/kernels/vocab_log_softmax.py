"""K13: row-wise log-softmax over the vocabulary, forward and backward
(``csrc/vocab_log_softmax.cu``).

``vocab_log_softmax(x, out_dtype)`` computes ``log_softmax(x)`` over the last
axis in f32 and writes it in ``out_dtype`` (x's dtype by default): f32 for
the ORT generator in training, the compute dtype for Up-Down and for eval.
A bf16 -> bf16 row rounds where the JAX package's bf16 log-softmax does
(``rounded_log_softmax``, the plain rule that K4 and K9 share).
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


def rounded_log_softmax(x, out_dtype: Optional[torch.dtype] = None):
    """The log-softmax over the last axis in ``out_dtype`` (x's dtype by
    default), rounded where ``jax.nn.log_softmax`` rounds a bf16 row
    (``sparse_caption_tpu/models/layers.py:472``, ``models/up_down.py:124``)
    when x and the output are both bf16: m = max x (exact); sh = bf16(x - m);
    s = sum exp(sh) in f32, rounded to bf16; lse = bf16(log s); the output
    bf16(sh - lse). Otherwise the f32 log-softmax rounded once to
    ``out_dtype``: in f32 every rounding is the identity, and bf16 logits
    with f32 log-probs are the Generator's train site, where the JAX package
    casts the logits to f32 first (``layers.py:467-471``). The plain rule of
    K13, K4 and K9 (``csrc/common.cuh`` ``lsm_*``); no gradient."""
    out_dtype = out_dtype or x.dtype
    if not x.dtype == out_dtype == torch.bfloat16:
        return torch.log_softmax(x.float(), dim=-1).to(out_dtype)

    def r(v):
        return v.to(torch.bfloat16).float()

    xf = x.detach().float()
    sh = r(xf - xf.amax(dim=-1, keepdim=True))
    lse = r(torch.log(r(torch.exp(sh).sum(dim=-1, keepdim=True))))
    return (sh - lse).to(out_dtype)


def vocab_log_softmax_plain(x, out_dtype: Optional[torch.dtype] = None):
    """``rounded_log_softmax``'s values; the gradient is the f32
    log-softmax's, rounded to x's dtype (K13's backward)."""
    out_dtype = out_dtype or x.dtype
    y = torch.log_softmax(x.float(), dim=-1)
    if x.dtype == out_dtype == torch.bfloat16:
        y = y + (rounded_log_softmax(x).float() - y).detach()
    return y.to(out_dtype)


def _forward(x, out_dtype, with_stats: bool):
    """K13's forward: (y, stats (rows, 2) f32 or None). Without stats (no
    backward follows) a bf16 -> bf16 row sums its exps once."""
    vocab = x.shape[-1]
    rows = x.numel() // vocab
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stats = torch.empty(rows, 2, dtype=torch.float32, device=x.device) if with_stats else None
    KERNEL.launch(_build.dtype_code(x), _build.dtype_code(y), x.data_ptr(), y.data_ptr(), _build.ptr(stats), rows,
                  vocab, _build.stream_handle(x))
    return y, stats


class _LogSoftmaxFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_dtype):
        y, stats = _forward(x, out_dtype, True)
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
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _forward(x, out_dtype, False)[0]
    return _LogSoftmaxFn.apply(x, out_dtype)
