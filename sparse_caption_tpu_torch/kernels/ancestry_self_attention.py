"""K2: decode-step self-attention through the beam-ancestry map
(``csrc/ancestry_self_attention.cu``).

``ancestry_self_attention`` launches the kernel for CUDA tensors and runs
``ancestry_self_attention_plain`` for CPU tensors; nothing else falls back.
With ``cache_v=None`` (a kv-shared layer, ACORT: one cache array read as K
and V) it launches the kernel's kv mode, which reads each cached slot once
for both the scores and the output.

The backward (supermask SCST: the gradient pass runs the decode itself,
step by step, with gradients) is ``decode_self_attention``: the step's
write of slot t and K2, as one autograd Function (``DecodeSelfStep``)
whose backward is kernel K2's backward (``csrc/ancestry_self_attention_bwd.cu``;
``ancestry_self_attention_backward``, plain version
``ancestry_self_attention_backward_plain``, the autograd of the plain
forward). It is ported for the identity map, unshared K and V, f32; the
ancestry map (beam-sample SCST), the kv mode and bf16 raise
``NotImplementedError`` on every device, and the kernel takes head width
64 only.

The cache is written in place at every step, and autograd would give no
order in which the steps' backwards run if each of them added to one
gradient buffer of the cache. So the order is made explicit by threading
the cache through each step's Function as an input and an output
(``mark_dirty``): step t's output cache is step t + 1's input, so step t's
backward runs after every later step's and receives the cache's gradient
(``dcache``, one (N, h, T_max, dk) buffer a layer) with their
contributions already added. It adds its own for slots 0..t-1 into that
buffer, returns slot t's total (the buffer's slot t plus its own) as the
gradient of k_t and v_t, zeroes slot t (the input cache's slot t was
overwritten) and hands the buffer on to step t - 1. A design that restacked
the cache from the per-step k_t, v_t at every step would need no order,
but copies O(T^2) bytes and keeps every step's stacked copy for the
backward: at 64 x 15 samples, 17 steps and 6 layers about 3.6 GB of f32,
against one buffer a layer here. The step saves its q and aliases of the
two caches; later steps write slots > t only, so slots 0..t are still the
step's when its backward reads them.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_head_width, check_same_device, check_tensor
from sparse_caption_tpu_torch.ops.attention import divide_scores, score_divisor

KERNEL = _build.CudaKernel("ancestry_self_attention", "sct_ancestry_self_attention", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the kv mode: one cache array, read as K and V
KERNEL_KV = _build.CudaKernel("ancestry_self_attention", "sct_ancestry_self_attention_kv", [
    _build.I, _build.I, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the backward: dq, and dK / dV of slots 0..t added into the cache's gradient
KERNEL_BWD = _build.CudaKernel("ancestry_self_attention_bwd", "sct_ancestry_self_attention_bwd", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
BWD_HEAD_WIDTHS = (64,)  # the backward kernel's instances (f32)
# cache slots the kernel takes: the rows PyTorch's warp softmax takes, whose
# layout the kernel follows (csrc: 32 lanes, at most 32 slots each)
MAX_SLOTS = 1024


def ancestry_self_attention_plain(q, cache_k, cache_v: Optional[torch.Tensor], ancestry: Optional[torch.Tensor],
                                  t: int):
    """Attention of row n = b*K + k against the cached slots t' <= t of row
    b*K + ancestry[b, k, t'] (row n itself without a map); cache_v=None reads
    the K cache as V.

    The reference scores every slot and masks t' > t with -1e9; those
    softmax weights are exactly 0, so reading slots 0..t only is the same.
    In bf16 the score, its quotient by sqrt(dk) (``divide_scores``) and the
    softmax weights round to bf16, the points the kernel rounds at."""
    if cache_v is None:
        cache_v = cache_k
    n, h, dk = q.shape
    keys, vals = cache_k[:, :, : t + 1], cache_v[:, :, : t + 1]  # (N, h, t+1, dk)
    if ancestry is not None:
        b, kb, _ = ancestry.shape
        base = torch.arange(b, device=q.device)[:, None, None] * kb
        rows = (ancestry[:, :, : t + 1].long() + base).reshape(n, t + 1)  # (N, t+1)
        slots = torch.arange(t + 1, device=q.device)
        keys = cache_k.transpose(1, 2)[rows, slots].transpose(1, 2)  # (N, h, t+1, dk)
        vals = cache_v.transpose(1, 2)[rows, slots].transpose(1, 2)
    scores = divide_scores(torch.einsum("nhd,nhtd->nht", q, keys), dk)
    return torch.einsum("nht,nhtd->nhd", torch.softmax(scores, dim=-1), vals)


def ancestry_self_attention(q, cache_k, cache_v: Optional[torch.Tensor], ancestry: Optional[torch.Tensor], t: int):
    """q: (N, h, dk); cache_k/v: (N, h, T_max, dk) with slot t already written,
    cache_v=None when the layer shares K and V (the kv mode);
    ancestry: (B, K, T_max) int32 with N = B*K, or None for the identity map;
    0 <= t < T_max. Returns (N, h, dk) in q's dtype."""
    check_float(q, "q")
    n, h, dk = q.shape
    t_max = cache_k.shape[2]
    for name, c in (("cache_k", cache_k), ("cache_v", cache_v)):
        if c is not None:
            check_tensor(c, name, (n, h, t_max, dk), q.dtype)
    kb = 1
    if ancestry is not None:
        if ancestry.dim() != 3 or ancestry.shape[0] * ancestry.shape[1] != n:
            raise ValueError(f"ancestry: expected (B, K, {t_max}) with B*K == {n}, got {tuple(ancestry.shape)}")
        kb = ancestry.shape[1]
        check_tensor(ancestry, "ancestry", (n // kb, kb, t_max), torch.int32)
    if not 0 <= t < t_max:
        raise ValueError(f"t={t} outside the cache of {t_max} slots")
    check_same_device(q, cache_k, cache_v, ancestry)
    if q.device.type == "cpu":
        return ancestry_self_attention_plain(q, cache_k, cache_v, ancestry, t)
    check_head_width(dk, "ancestry_self_attention")
    if h > 32 or t_max > MAX_SLOTS:
        raise ValueError(f"ancestry_self_attention kernel takes h <= 32, T_max <= {MAX_SLOTS}; got h={h} "
                         f"T_max={t_max}")
    out = torch.empty_like(q)
    if cache_v is None:
        KERNEL_KV.launch(_build.dtype_code(q), dk, q.data_ptr(), cache_k.data_ptr(), _build.ptr(ancestry),
                         out.data_ptr(), n, h, t_max, kb, t, score_divisor(dk, q.dtype), _build.stream_handle(q))
        return out
    KERNEL.launch(_build.dtype_code(q), dk, q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                  _build.ptr(ancestry), out.data_ptr(), n, h, t_max, kb, t, score_divisor(dk, q.dtype),
                  _build.stream_handle(q))
    return out


# ------------------------------------------------------------------ backward
def check_backward_supported(q, cache_v: Optional[torch.Tensor], ancestry: Optional[torch.Tensor]) -> None:
    """What the backward does not take yet, on every device."""
    if ancestry is not None:
        raise NotImplementedError("K2's backward through the ancestry map (beam-sample SCST) lands in a later slice")
    if cache_v is None:
        raise NotImplementedError("K2's backward in the kv mode lands in a later slice")
    if q.dtype != torch.float32:
        raise NotImplementedError(f"K2's backward is ported in f32 (bf16 SCST lands in a later slice); got {q.dtype}")


def ancestry_self_attention_backward_plain(q, cache_k, cache_v, dout, dcache_k, dcache_v, t: int):
    """The plain version: the autograd of ``ancestry_self_attention_plain``
    (identity map) over slots 0..t; its dK / dV of slots 0..t-1 are added
    into ``dcache_k`` / ``dcache_v`` in place and slot t of both is zeroed.
    Returns (dq, dk_t, dv_t), dk_t = dcache_k[:, :, t] (as received) + slot
    t's own dK."""
    with torch.enable_grad():
        qq = q.detach().requires_grad_()
        kk = cache_k[:, :, : t + 1].detach().requires_grad_()
        vv = cache_v[:, :, : t + 1].detach().requires_grad_()
        out = ancestry_self_attention_plain(qq, kk, vv, None, t)
        dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), dout)
    dk_t = dcache_k[:, :, t] + dk[:, :, t]
    dv_t = dcache_v[:, :, t] + dv[:, :, t]
    dcache_k[:, :, :t] += dk[:, :, :t]
    dcache_v[:, :, :t] += dv[:, :, :t]
    dcache_k[:, :, t] = 0
    dcache_v[:, :, t] = 0
    return dq, dk_t, dv_t


def ancestry_self_attention_backward(q, cache_k, cache_v, dout, dcache_k, dcache_v, t: int):
    """The backward of one decode step's K2 (identity map, unshared, f32).
    q, dout: (N, h, dk); cache_k/v: (N, h, T_max, dk), slots 0..t as the
    forward read them; dcache_k/v: (N, h, T_max, dk), the caches' gradient
    from the later steps, updated in place (slots < t += this step's dK /
    dV, slot t zeroed). Returns (dq, dk_t, dv_t), each (N, h, dk)."""
    check_backward_supported(q, cache_v, None)
    n, h, dk = q.shape
    t_max = cache_k.shape[2]
    check_tensor(dout, "dout", (n, h, dk), q.dtype)
    for name, c in (("cache_k", cache_k), ("cache_v", cache_v), ("dcache_k", dcache_k), ("dcache_v", dcache_v)):
        check_tensor(c, name, (n, h, t_max, dk), q.dtype)
    if not 0 <= t < t_max:
        raise ValueError(f"t={t} outside the cache of {t_max} slots")
    check_same_device(q, cache_k, cache_v, dout, dcache_k, dcache_v)
    if q.device.type == "cpu":
        return ancestry_self_attention_backward_plain(q, cache_k, cache_v, dout, dcache_k, dcache_v, t)
    if dk not in BWD_HEAD_WIDTHS:
        raise NotImplementedError(f"K2's backward kernel takes head width {BWD_HEAD_WIDTHS}; got dk={dk}")
    if h > 32 or t_max > MAX_SLOTS:
        raise ValueError(f"K2's backward kernel takes h <= 32, T_max <= {MAX_SLOTS}; got h={h} T_max={t_max}")
    dq, dk_t, dv_t = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    KERNEL_BWD.launch(dk, q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                      dcache_k.data_ptr(), dcache_v.data_ptr(), dk_t.data_ptr(), dv_t.data_ptr(), n, h, t_max, t,
                      score_divisor(dk, q.dtype), _build.stream_handle(q))
    return dq, dk_t, dv_t


class DecodeSelfStep(torch.autograd.Function):
    """One decode step's self-attention with gradients: write k_t, v_t into
    slot t of the caches (in place, ``mark_dirty``), K2 over slots 0..t.
    The caches go in and come out, which orders the steps' backwards (see
    the module's docstring)."""

    @staticmethod
    def forward(ctx, q, k_t, v_t, cache_k, cache_v, t: int):
        cache_k[:, :, t] = k_t
        cache_v[:, :, t] = v_t
        out = ancestry_self_attention(q, cache_k, cache_v, None, t)
        ctx.mark_dirty(cache_k, cache_v)
        ctx.save_for_backward(q)
        ctx.caches = (cache_k.detach(), cache_v.detach())  # aliases: later steps write slots > t only
        ctx.t = t
        ctx.set_materialize_grads(False)
        return out, cache_k, cache_v

    @staticmethod
    def backward(ctx, dout, dcache_k, dcache_v):
        (q,) = ctx.saved_tensors
        cache_k, cache_v = ctx.caches
        dcache_k = torch.zeros_like(cache_k) if dcache_k is None else dcache_k.contiguous()
        dcache_v = torch.zeros_like(cache_v) if dcache_v is None else dcache_v.contiguous()
        dout = torch.zeros_like(q) if dout is None else dout.contiguous()
        dq, dk_t, dv_t = ancestry_self_attention_backward(q, cache_k, cache_v, dout, dcache_k, dcache_v, ctx.t)
        return dq, dk_t, dv_t, dcache_k, dcache_v, None


def decode_self_attention(q, k_t, v_t, cache_k, cache_v: Optional[torch.Tensor], ancestry: Optional[torch.Tensor],
                          t: int):
    """One decode step of self-attention: k_t, v_t (N, h, dk) written into
    slot t of cache_k / cache_v (in place; cache_v=None under kv, where k_t
    is the one array's row), then K2 over slots 0..t. Where gradients are
    asked for (supermask SCST's gradient pass), the two run as
    ``DecodeSelfStep``, whose backward is K2's backward. Returns (N, h, dk)."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (q, k_t, v_t, cache_k, cache_v)):
        check_backward_supported(q, cache_v, ancestry)
        out, _, _ = DecodeSelfStep.apply(q, k_t, v_t, cache_k, cache_v, t)
        return out
    cache_k[:, :, t] = k_t
    if cache_v is not None:
        cache_v[:, :, t] = v_t
    return ancestry_self_attention(q, cache_k, cache_v, ancestry, t)
