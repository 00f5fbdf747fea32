"""K1: fused ORT box-relation self-attention (``csrc/box_attention.cu``).

``box_attention`` launches the kernel for CUDA tensors and runs
``box_attention_plain`` for CPU tensors; nothing else falls back. With
``v=None`` (a kv-shared layer, ACORT: V is the K tensor) it launches the
kernel's kv mode, which stages q and k and reads the k tile for both
products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_head_width, check_same_device, check_tensor
from sparse_caption_tpu_torch.ops.attention import (
    box_relational_embedding,
    geometry_frequencies,
    scaled_dot_attention,
    score_divisor,
)

KERNEL = _build.CudaKernel("box_attention", "sct_box_attention", [
    _build.I, _build.I, _build.I, *[_build.P] * 10, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the train variant: dropout keep-mask on the probabilities
KERNEL_TRAIN = _build.CudaKernel("box_attention", "sct_box_attention_train", [
    _build.I, _build.I, _build.I, *[_build.P] * 9, _build.F32, _build.P, _build.I, _build.I, _build.I, _build.F32,
    _build.P,
])
# the kv modes (V is K): the same entry points without a v
KERNEL_KV = _build.CudaKernel("box_attention", "sct_box_attention_kv", [
    _build.I, _build.I, _build.I, *[_build.P] * 9, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
KERNEL_TRAIN_KV = _build.CudaKernel("box_attention", "sct_box_attention_train_kv", [
    _build.I, _build.I, _build.I, *[_build.P] * 8, _build.F32, _build.P, _build.I, _build.I, _build.I, _build.F32,
    _build.P,
])
# the raw geometry (dim_g 4): the same entry points, each counted apart
KERNEL_RAW = _build.CudaKernel("box_attention", "sct_box_attention", KERNEL.argtypes)
KERNEL_TRAIN_RAW = _build.CudaKernel("box_attention", "sct_box_attention_train", KERNEL_TRAIN.argtypes)
KERNEL_KV_RAW = _build.CudaKernel("box_attention", "sct_box_attention_kv", KERNEL_KV.argtypes)
KERNEL_TRAIN_KV_RAW = _build.CudaKernel("box_attention", "sct_box_attention_train_kv", KERNEL_TRAIN_KV.argtypes)
DIM_G, RAW_DIM_G = 64, 4  # the geometry's widths: trig features, the raw log-deltas


def geometry_width(trigonometric: bool) -> int:
    """dim_g of the geometry (``BoxMultiHeadAttention.dim_g`` of the JAX package)."""
    return DIM_G if trigonometric else RAW_DIM_G


def forward_kernel(train: bool, kv: bool, dim_g: int) -> _build.CudaKernel:
    """The entry point (and launch count) of a K1 call."""
    raw = dim_g == RAW_DIM_G
    if train:
        return (KERNEL_TRAIN_KV_RAW if raw else KERNEL_TRAIN_KV) if kv else (KERNEL_TRAIN_RAW if raw else KERNEL_TRAIN)
    return (KERNEL_KV_RAW if raw else KERNEL_KV) if kv else (KERNEL_RAW if raw else KERNEL)


def log_bias_from_geometry(geo, wg_weight, wg_bias, dtype):
    """The (B, h, R, R) log-bias ``log(max(relu(geo . wg + wg_b), 1e-6))`` of
    the f32 geometry (B, R, R, dim_g) in ``dtype``, with the JAX layer's cast
    points: the geometry cast to ``dtype``, the product rounded before the
    bias is added (``MaskedDense`` adds it after the dot), relu, the clamp and
    the log in ``dtype``."""
    w_g = torch.relu(F.linear(geo.to(dtype), wg_weight) + wg_bias)  # (B, R, R, h)
    return torch.log(torch.clamp(w_g, min=1e-6)).permute(0, 3, 1, 2).to(dtype)


def box_log_bias_plain(boxes, wg_weight, wg_bias, dtype):
    """K1's log-bias: ``log_bias_from_geometry`` of the boxes' f32 geometry,
    the trig features or (a (h, 4) ``wg_weight``) the raw log-deltas."""
    dim_g = wg_weight.shape[1]
    geo = box_relational_embedding(boxes.float(), dim_g=dim_g, trigonometric=dim_g != RAW_DIM_G)
    return log_bias_from_geometry(geo, wg_weight, wg_bias, dtype)


def box_attention_plain(q, k, v, boxes, wg_weight, wg_bias, mask, keep=None, keep_prob: float = 1.0):
    """Reference math of ``BoxMultiHeadAttention`` after the q/k/v projections:
    the log-bias of ``box_log_bias_plain`` added after the -1e9 fill of padded
    keys; ``keep`` is the training dropout on the probabilities; v=None reads
    k as V (autograd then adds k's two gradients)."""
    log_wg = box_log_bias_plain(boxes, wg_weight, wg_bias, q.dtype)
    return scaled_dot_attention(q, k, k if v is None else v, mask, bias=log_wg, keep=keep, keep_prob=keep_prob)


def check_args(q, k, v, boxes, wg_weight, wg_bias, mask, keep=None):
    """Shapes, dtypes and devices of a box-attention call (v=None: the kv
    mode); returns (B, h, R, dk)."""
    check_float(q, "q")
    b, h, r, dk = q.shape
    for name, t in (("k", k), ("v", v)):
        if t is not None or name == "k":
            check_tensor(t, name, (b, h, r, dk), q.dtype)
    check_tensor(boxes, "boxes", (b, r, 4), torch.float32)
    if wg_weight.dim() != 2 or wg_weight.shape[1] not in (DIM_G, RAW_DIM_G):
        raise ValueError(f"wg_weight: expected (h, {DIM_G}) or (h, {RAW_DIM_G}), got {tuple(wg_weight.shape)}")
    check_tensor(wg_weight, "wg_weight", (h, wg_weight.shape[1]), q.dtype)
    check_tensor(wg_bias, "wg_bias", (h,), q.dtype)
    check_tensor(mask, "mask", (b, r), torch.bool)
    if keep is not None:
        check_tensor(keep, "keep", (b, h, r, r), torch.bool)
    check_same_device(q, k, v, boxes, wg_weight, wg_bias, mask, keep)
    if q.device.type == "cuda":
        check_head_width(dk, "box_attention")
        if r > 64 or h > 16:
            raise ValueError(f"box_attention kernels take R <= 64, h <= 16; got R={r} h={h}")
    return b, h, r, dk


def box_attention(q, k, v, boxes, wg_weight, wg_bias, mask, bias_out=None):
    """q, k, v: (B, h, R, dk) f32 or bf16, v=None for V = K; boxes: (B, R, 4) f32; wg_weight: (h, 64)
    (the Linear layout of the (64, h) projection of the trig features) or (h,
    4) (the raw log-deltas, ``--no_box_trigonometric_embedding``) and wg_bias: (h,) in the
    compute dtype; mask: (B, R) bool, False = padded region. Returns (B, h, R, dk).
    ``bias_out``, a (B, h, R, R) tensor in the compute dtype or None (the main
    path), receives the log-bias the call added: the check of K1's geometry
    rounding. Eval only: the result carries no gradient (training uses
    ``box_attention_bwd.box_attention_train``)."""
    b, h, r, dk = check_args(q, k, v, boxes, wg_weight, wg_bias, mask)
    if bias_out is not None:
        check_tensor(bias_out, "bias_out", (b, h, r, r), q.dtype)
        check_same_device(q, bias_out)
    if q.device.type == "cpu":
        if bias_out is not None:
            bias_out.copy_(box_log_bias_plain(boxes, wg_weight, wg_bias, q.dtype))
        return box_attention_plain(q, k, v, boxes, wg_weight, wg_bias, mask)
    out = torch.empty_like(q)
    freq = geometry_frequencies(DIM_G, device=q.device)
    tail = (boxes.data_ptr(), wg_weight.data_ptr(), wg_bias.data_ptr(), freq.data_ptr(), mask.data_ptr(),
            out.data_ptr(), _build.ptr(bias_out), b, h, r, score_divisor(dk, q.dtype), _build.stream_handle(q))
    dg = wg_weight.shape[1]
    kernel = forward_kernel(False, v is None, dg)
    kernel.launch(_build.dtype_code(q), dk, dg, q.data_ptr(), k.data_ptr(), *(() if v is None else (v.data_ptr(),)),
                  *tail)
    return out
