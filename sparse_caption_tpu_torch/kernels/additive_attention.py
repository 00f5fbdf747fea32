"""K12: Up-Down's additive attention with masked renormalisation, forward and
backward (``csrc/additive_attention.cu``).

``additive_attention(p_att, att_h, w, b, mask, att)`` is
``AdditiveAttention`` of the JAX package after its ``h2att`` dot: scores
``w . tanh(p_att + att_h) + b``, a softmax over every region, the region
mask applied and the weights renormalised by ``max(sum, 1e-9)``, then the
weighted sum of ``att``. Memory is one row per image; the B * rows query
rows of ``att_h`` (image i owns rows i * rows .. (i + 1) * rows - 1) share
their image's ``p_att`` and ``att``, which the JAX package repeats per row
instead (the same numbers). An image's rows run in chunks of at most 16
per block (SCST's 60 samples in 4), their backward partials summed in chunk
order. CUDA tensors launch the kernel in both directions (an autograd
Function) when a gradient may follow; serving (under ``torch.no_grad()``, or
no input requiring a gradient) launches the forward alone, which then writes
no probabilities or weights for a backward. CPU tensors run
``additive_attention_plain``. Nothing else falls back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor

KERNEL = _build.CudaKernel("additive_attention", "sct_additive_attention", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.P,
])
KERNEL_BWD = _build.CudaKernel("additive_attention", "sct_additive_attention_bwd", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.I, _build.I,
    _build.I, _build.P,
])
MAX_REGIONS, CHUNK_ROWS = 64, 16  # regions per image; query rows per block
RENORM_FLOOR = 1e-9


def additive_attention_plain(p_att, att_h, w, b, mask, att):
    """The JAX package's math on memory repeated to the query rows."""
    rows = att_h.shape[0] // p_att.shape[0]
    p_att, mask, att = (x.repeat_interleave(rows, dim=0) for x in (p_att, mask, att))
    dot = torch.tanh(p_att + att_h[:, None, :])  # (N, R, A)
    weight = torch.softmax(F.linear(dot, w[None, :], b)[..., 0], dim=1)  # (N, R): over every region
    weight = weight * mask.to(weight.dtype)
    weight = weight / torch.clamp(weight.sum(dim=1, keepdim=True), min=RENORM_FLOOR)
    return torch.einsum("nr,nrd->nd", weight, att)


def _forward(p_att, att_h, w, b, mask, att, saved: bool):
    """The forward kernel's output; with `saved`, also the f32 probabilities
    and weights (N, R) the backward reads (else the kernel writes neither)."""
    bsz, r, a = p_att.shape
    n, d = att_h.shape[0], att.shape[2]
    out = torch.empty((n, d), dtype=att.dtype, device=att.device)
    prob = torch.empty((n, r), dtype=torch.float32, device=att.device) if saved else None
    weight = torch.empty_like(prob) if saved else None
    KERNEL.launch(_build.dtype_code(att), p_att.data_ptr(), att_h.data_ptr(), w.data_ptr(), b.data_ptr(),
                  mask.data_ptr(), att.data_ptr(), out.data_ptr(), _build.ptr(prob), _build.ptr(weight), bsz,
                  n // bsz, r, a, d, _build.stream_handle(att))
    return out, prob, weight


class _AdditiveAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p_att, att_h, w, b, mask, att):
        out, prob, weight = _forward(p_att, att_h, w, b, mask, att, saved=True)
        ctx.save_for_backward(p_att, att_h, w, mask, att, prob, weight)
        return out

    @staticmethod
    def backward(ctx, dout):
        p_att, att_h, w, mask, att, prob, weight = ctx.saved_tensors
        bsz, r, a = p_att.shape
        n, d = att_h.shape[0], att.shape[2]
        dout = dout.contiguous()
        d_p_att, d_att_h, d_att = torch.empty_like(p_att), torch.empty_like(att_h), torch.empty_like(att)
        dw, db = torch.empty_like(w), torch.empty(1, dtype=w.dtype, device=w.device)
        chunks = -(-(n // bsz) // CHUNK_ROWS)
        scratch = lambda *shape: torch.empty(shape, dtype=torch.float32, device=w.device)  # noqa: E731
        partial_w, partial_b = scratch(bsz * chunks, a), scratch(bsz * chunks)
        part_p_att = scratch(bsz * chunks, r, a) if chunks > 1 else None
        part_att = scratch(bsz * chunks, r, d) if chunks > 1 else None
        KERNEL_BWD.launch(_build.dtype_code(att), p_att.data_ptr(), att_h.data_ptr(), w.data_ptr(), mask.data_ptr(),
                          att.data_ptr(), prob.data_ptr(), weight.data_ptr(), dout.data_ptr(), d_p_att.data_ptr(),
                          d_att_h.data_ptr(), d_att.data_ptr(), dw.data_ptr(), db.data_ptr(), partial_w.data_ptr(),
                          partial_b.data_ptr(), _build.ptr(part_p_att), _build.ptr(part_att), bsz, n // bsz, r, a, d,
                          _build.stream_handle(att))
        return d_p_att, d_att_h, dw, db, None, d_att


def additive_attention(p_att, att_h, w, b, mask, att):
    """p_att: (B, R, A); att_h: (B * rows, A); w: (A,) the effective
    ``alpha_net`` weight and b: (1,) its bias; mask: (B, R) bool, False =
    padded region; att: (B, R, D). One float dtype. Returns (B * rows, D)."""
    check_float(p_att, "p_att")
    bsz, r, a = p_att.shape
    n = att_h.shape[0]
    if n % bsz:
        raise ValueError(f"att_h has {n} rows, not a multiple of the {bsz} images")
    check_tensor(att_h, "att_h", (n, a), p_att.dtype)
    check_tensor(w, "w", (a,), p_att.dtype)
    check_tensor(b, "b", (1,), p_att.dtype)
    check_tensor(mask, "mask", (bsz, r), torch.bool)
    check_float(att, "att")
    check_tensor(att, "att", (bsz, r, att.shape[2]), p_att.dtype)
    check_same_device(p_att, att_h, w, b, mask, att)
    if p_att.device.type == "cpu":
        return additive_attention_plain(p_att, att_h, w, b, mask, att)
    if r > MAX_REGIONS:
        raise ValueError(f"additive_attention kernel takes R <= {MAX_REGIONS}; got R={r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (p_att, att_h, w, b, att)):
        return _AdditiveAttentionFn.apply(p_att, att_h, w, b, mask, att)
    return _forward(p_att, att_h, w, b, mask, att, saved=False)[0]
