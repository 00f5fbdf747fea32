"""K6: residual add (with dropout) + RefLayerNorm, forward and backward
(``csrc/add_ref_layernorm.cu``).

``add_ref_layernorm(x, y, weight, bias, keep, keep_prob)`` returns
``(s, n)``: the sum ``s = x + dropout(y)`` and ``n = RefLayerNorm(s)``;
with ``y=None`` it is a plain RefLayerNorm and returns ``n`` alone. CUDA
tensors launch the kernel in both directions (an autograd Function); CPU
tensors run ``add_ref_layernorm_plain``. Nothing else falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor
from sparse_caption_tpu_torch.ops.keep import apply_keep, keep_divisor

KERNEL = _build.CudaKernel("add_ref_layernorm", "sct_add_ref_layernorm", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.F32, _build.F32, _build.P,
])
KERNEL_BWD = _build.CudaKernel("add_ref_layernorm", "sct_add_ref_layernorm_bwd", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P, _build.I, _build.I, _build.F32, _build.F32, _build.P,
])
MAX_D = 1024
EPS = 1e-6


def ref_layer_norm_plain(x, weight, bias, eps: float = EPS):
    """``a * (x - mean) / (std + eps) + b``, Bessel-corrected std, stats in f32,
    result in x's dtype (``models/layers.py`` RefLayerNorm of the JAX package)."""
    d = x.shape[-1]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).sum(dim=-1, keepdim=True) / max(d - 1, 1)
    out = weight.float() * (xf - mean) / (torch.sqrt(var) + eps) + bias.float()
    return out.to(x.dtype)


def add_ref_layernorm_plain(x, y, weight, bias, keep: Optional[torch.Tensor] = None, keep_prob: float = 1.0,
                            eps: float = EPS):
    if y is None:
        return ref_layer_norm_plain(x, weight, bias, eps)
    if keep is not None:
        y = apply_keep(y, keep, keep_prob)
    s = x + y
    return s, ref_layer_norm_plain(s, weight, bias, eps)


def _bwd_blocks(rows: int) -> int:
    fn = _build.library("add_ref_layernorm").sct_add_ref_layernorm_bwd_blocks
    fn.argtypes, fn.restype = [_build.I], _build.I
    return fn(rows)


class _AddNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, weight, bias, keep, keep_prob: float, eps: float):
        d = x.shape[-1]
        rows = x.numel() // d
        n = torch.empty_like(x)
        s = None if y is None else torch.empty_like(x)
        stats = torch.empty(rows, 2, device=x.device, dtype=torch.float32)
        KERNEL.launch(_build.dtype_code(x), x.data_ptr(), _build.ptr(y), _build.ptr(keep), weight.data_ptr(),
                      bias.data_ptr(), _build.ptr(s), n.data_ptr(), stats.data_ptr(), rows, d, keep_prob, eps,
                      _build.stream_handle(x))
        ctx.has_y, ctx.keep_prob, ctx.eps = y is not None, keep_prob, eps
        ctx.save_for_backward(x if s is None else s, weight, keep, stats)
        ctx.set_materialize_grads(False)
        return n if s is None else (s, n)

    @staticmethod
    def backward(ctx, *grads):
        s, weight, keep, stats = ctx.saved_tensors
        gs, gn = grads if ctx.has_y else (None, grads[0])
        if gn is None:
            gn = torch.zeros_like(s)
        gn = gn.contiguous()
        gs = None if gs is None else gs.contiguous()
        d = s.shape[-1]
        rows = s.numel() // d
        dx = torch.empty_like(s)
        dy = torch.empty_like(s) if ctx.has_y else None
        da, db = torch.empty_like(weight), torch.empty_like(weight)
        partial = torch.empty(_bwd_blocks(rows), 2, d, device=s.device, dtype=torch.float32)
        KERNEL_BWD.launch(_build.dtype_code(s), gn.data_ptr(), _build.ptr(gs), s.data_ptr(), _build.ptr(keep),
                          weight.data_ptr(), stats.data_ptr(), dx.data_ptr(), _build.ptr(dy), da.data_ptr(),
                          db.data_ptr(), partial.data_ptr(), rows, d, ctx.keep_prob, ctx.eps, _build.stream_handle(s))
        return dx, dy, da, db, None, None, None


def add_ref_layernorm(x, y, weight, bias, keep: Optional[torch.Tensor] = None, keep_prob: float = 1.0,
                      eps: float = EPS):
    """x, y: (..., d) f32 or bf16 (y may be None); weight, bias: (d,) in x's
    dtype; keep: bool, y's shape, the dropout keep-mask on y (None: no dropout).
    Returns (s, n), or n alone when y is None."""
    check_float(x, "x")
    d = x.shape[-1]
    if y is not None:
        check_tensor(y, "y", x.shape, x.dtype)
    elif keep is not None:
        raise ValueError("keep needs y")
    if keep is not None:
        check_tensor(keep, "keep", x.shape, torch.bool)
    check_tensor(weight, "weight", (d,), x.dtype)
    check_tensor(bias, "bias", (d,), x.dtype)
    check_same_device(x, y, weight, bias, keep)
    if x.device.type == "cpu":
        return add_ref_layernorm_plain(x, y, weight, bias, keep, keep_prob, eps)
    if d > MAX_D:
        raise ValueError(f"add_ref_layernorm kernel takes d <= {MAX_D}; got d={d}")
    return _AddNormFn.apply(x, y, weight, bias, keep, keep_divisor(keep_prob, x.dtype), float(eps))
