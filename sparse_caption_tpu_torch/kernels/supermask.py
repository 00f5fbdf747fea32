"""K5: supermask weight sample and straight-through backward (``csrc/supermask.cu``).

``supermask_weight(w, m, u, mode, bypass)`` returns ``w * s`` in w's dtype
with ``s`` the 0/1 sample of the mask logits ``m`` (``MODES``). For CUDA
tensors forward and backward each launch the kernel (an autograd
Function); for CPU tensors ``supermask_weight_plain`` runs, whose autograd
gives the same gradients. Nothing else falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor
from sparse_caption_tpu_torch.ops.ste import bernoulli_sample_sigmoid, rounding_sigmoid

KERNEL = _build.CudaKernel("supermask", "sct_supermask", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.I64, _build.I, _build.P,
])
KERNEL_BWD = _build.CudaKernel("supermask", "sct_supermask_bwd", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I64, _build.I, _build.I, _build.P,
])
# sample: [u < sigmoid(m)] (training); round: round(sigmoid(m)) (eval);
# multiply: m itself (the 0/1 masks of the magnitude / lottery / SNIP types)
MODES = {"sample": 0, "round": 1, "multiply": 2}


def supermask_weight_plain(w, m, u: Optional[torch.Tensor] = None, mode: str = "sample", bypass: bool = False):
    """``(w * sample(m)).to(w.dtype)`` through the straight-through estimators
    of ``ops/ste.py`` (the JAX package's ``_masked``)."""
    if mode == "sample":
        s = bernoulli_sample_sigmoid(m, u, bypass)
    elif mode == "round":
        s = rounding_sigmoid(m, bypass)
    else:
        s = m
    return (w * s).to(w.dtype)


def launch_forward(w, m, u, mode: int):
    """One forward launch on CUDA tensors (checked by the caller): w_eff."""
    out = torch.empty_like(w)
    KERNEL.launch(_build.dtype_code(w), w.data_ptr(), m.data_ptr(), _build.ptr(u), out.data_ptr(), w.numel(), mode,
                  _build.stream_handle(w))
    return out


def launch_backward(g, w, m, u, mode: int, bypass: bool):
    """One backward launch on CUDA tensors: (dw, dm)."""
    g = g.contiguous()
    dw, dm = torch.empty_like(w), torch.empty_like(m)
    KERNEL_BWD.launch(_build.dtype_code(w), g.data_ptr(), w.data_ptr(), m.data_ptr(), _build.ptr(u), dw.data_ptr(),
                      dm.data_ptr(), w.numel(), mode, int(bypass), _build.stream_handle(w))
    return dw, dm


class _SupermaskFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, m, u, mode: int, bypass: bool):
        ctx.mode, ctx.bypass = mode, bypass
        ctx.save_for_backward(w, m, u)
        return launch_forward(w, m, u, mode)

    @staticmethod
    def backward(ctx, g):
        w, m, u = ctx.saved_tensors
        return (*launch_backward(g, w, m, u, ctx.mode, ctx.bypass), None, None, None)


def supermask_weight(w, m, u: Optional[torch.Tensor] = None, mode: str = "sample", bypass: bool = False):
    """w: weight (any shape) f32 or bf16; m: mask logits (or a 0/1 mask for
    ``mode="multiply"``), f32, w's shape; u: uniforms in [0, 1), f32, w's shape
    (``mode="sample"`` only). Returns w_eff in w's dtype."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    check_float(w, "w")
    check_tensor(m, "m", w.shape, torch.float32)
    if mode == "sample":
        if u is None:
            raise ValueError("mode 'sample' needs the uniforms u")
        check_tensor(u, "u", w.shape, torch.float32)
    elif u is not None:
        raise ValueError(f"mode {mode!r} takes no uniforms")
    check_same_device(w, m, u)
    if w.device.type == "cpu":
        return supermask_weight_plain(w, m, u, mode, bypass)
    return _SupermaskFn.apply(w, m, u, MODES[mode], bypass)
