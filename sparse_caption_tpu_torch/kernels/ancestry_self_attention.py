"""K2: decode-step self-attention through the beam-ancestry map
(``csrc/ancestry_self_attention.cu``).

``ancestry_self_attention`` launches the kernel for CUDA tensors and runs
``ancestry_self_attention_plain`` for CPU tensors; nothing else falls back.
With ``cache_v=None`` (a kv-shared layer, ACORT: one cache array read as K
and V) it launches the kernel's kv mode, which reads the one cache for both
the scores and the output. The kernel walks a short row's slots one at a
time and stages a longer row's in shared memory; ``staged`` is its rule
(the step, the head width, the dtype, the kv mode), ``smem_bytes`` the
staged path's block.

The backward (supermask and beam-sample SCST: the gradient pass runs the
decode itself, step by step, with gradients) is ``decode_self_attention``:
the step's write of slot t and K2, as one autograd Function
(``DecodeSelfStep``) whose backward is kernel K2's backward
(``csrc/ancestry_self_attention_bwd.cu``, the ancestry mode
``csrc/ancestry_self_attention_bwd_anc.cu``; ``ancestry_self_attention_backward``,
plain version ``ancestry_self_attention_backward_plain``, the autograd of
the plain forward). It is ported in f32 at head widths 64, 32 and 13, for
the identity map (the sampling decode) and through the beam-ancestry map
(the ancestry mode, its own entry point and launch count: slot t' of row j
receives the sum over the image's beams that read it, in beam order), each
with unshared K and V or in the kv mode (one cache, whose slot t' takes
both the score term and the value term, its own entry points and launch
counts); bf16 raises ``NotImplementedError`` on every device (the JAX
package's SCST step runs in the parameters' dtype, f32).

The cache is written in place at every step, and autograd would give no
order in which the steps' backwards run if each of them added to one
gradient buffer of the cache. So the order is made explicit by threading
the cache through each step's Function as an input and an output
(``mark_dirty``): step t's output cache is step t + 1's input, so step t's
backward runs after every later step's and receives the cache's gradient
(``dcache``, one (N, h, T_max, dk) buffer a cache array) with their
contributions already added. It adds its own for slots 0..t-1 into that
buffer, returns slot t's total (the buffer's slot t plus its own) as the
gradient of k_t and v_t, zeroes slot t (the input cache's slot t was
overwritten) and hands the buffer on to step t - 1. Under beam search the
cache rows never move; the map changes every step (the search gathers a
new one), so each step saves its own (B, K, T) copy. A design that restacked
the cache from the per-step k_t, v_t at every step would need no order,
but copies O(T^2) bytes and keeps every step's stacked copy for the
backward: at 64 x 15 samples, 17 steps and 6 layers about 3.6 GB of f32,
against one buffer a layer here. The step saves its q and aliases of the
caches; later steps write slots > t only, so slots 0..t are still the
step's when its backward reads them.
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
)
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
# the ancestry mode: slot t' of row j gets the sum over the image's rows r with ancestry[r, t'] == j
KERNEL_BWD_ANC = _build.CudaKernel("ancestry_self_attention_bwd_anc", "sct_ancestry_self_attention_bwd_anc", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
# the kv modes of both: one cache (K and V) and its one gradient buffer
KERNEL_BWD_KV = _build.CudaKernel("ancestry_self_attention_bwd", "sct_ancestry_self_attention_bwd_kv", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
KERNEL_BWD_ANC_KV = _build.CudaKernel("ancestry_self_attention_bwd_anc", "sct_ancestry_self_attention_bwd_anc_kv", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P,
])
BWD_HEAD_WIDTHS = (64, 32, 13)  # the backward kernel's instances (f32)
# cache slots the kernel takes: the rows PyTorch's warp softmax takes, whose
# layout the kernel follows (csrc: 32 lanes, at most 32 slots each)
MAX_SLOTS = 1024
CHUNK_SLOTS = 32  # slots a warp of the forward stages at once (csrc kK2ChunkSlots)
# the forward's bf16 steps from which the staged path runs (t + 1 slots at least; csrc k2_staged): by head
# width, (unshared, kv); the walk before them, and in f32 up to CHUNK_SLOTS slots
STAGED_FROM = {64: (12, 10), 32: (7, 7), 13: (5, 5)}
BLOCK_WARPS = 8  # (row, head) items a block of the forward takes, one warp each (csrc kK2BlockWarps)


def staged(dk: int, esize: int, kv: bool, t: int) -> bool:
    """Whether the forward at step t stages its slots (``csrc`` ``k2_staged``)
    or walks them one at a time (short rows: the design it replaced)."""
    if t + 1 > CHUNK_SLOTS:
        return True
    return esize == 2 and t + 1 >= STAGED_FROM[dk][int(kv)]


def slot_pitch(dk: int, esize: int) -> int:
    """Bytes a staged slot takes in the forward (``csrc`` ``k2_pitch``): dk
    elements + 16 where they are whole 16-byte vectors (dk 64, 32), else the
    16-byte envelope of a slot's row (dk 13: 48 bytes in bf16)."""
    nbytes = dk * esize
    return nbytes + 16 if nbytes % 16 == 0 else envelope_cap(nbytes)


def smem_bytes(dk: int, esize: int, t: int) -> int:
    """Shared memory of the forward's block at step t (``csrc``
    ``k2_smem_bytes``): BLOCK_WARPS warps, each its key and value stages of
    min(t + 1, CHUNK_SLOTS) slots, its row's t + 1 scores and cache rows and
    its q (4 bytes each, rounded up to 4), and its slots' staged rows'
    offsets (2 bytes each, rounded up to 8)."""
    t1 = t + 1
    return BLOCK_WARPS * (2 * min(t1, CHUNK_SLOTS) * slot_pitch(dk, esize) + 4 * (2 * -(-t1 // 4) * 4 + -(-dk // 4) * 4)
                          + 2 * -(-t1 // 8) * 8)


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
    if any(c is not None and c.data_ptr() % 16 for c in (cache_k, cache_v)):
        raise ValueError("ancestry_self_attention: the kernel copies the caches' slots by 16-byte blocks from "
                         "16-byte aligned data")
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
def check_backward_supported(q) -> None:
    """What the backward does not take, on every device: bf16 (the JAX
    package's SCST step runs in f32)."""
    if q.dtype != torch.float32:
        raise NotImplementedError(f"K2's backward is ported in f32 (the JAX package's SCST step runs in f32); "
                                  f"got {q.dtype}")


def anc_bwd_smem_bytes(dk: int, beams: int, t: int) -> int:
    """Shared memory of one block of the ancestry mode (``csrc`` ``anc_bwd_smem_bytes``):
    the image's beams' q and dout, then p, ds and the map's slots 0..t."""
    return 4 * beams * (2 * dk + 3 * (t + 1))


def ancestry_self_attention_backward_plain(q, cache_k, cache_v: Optional[torch.Tensor], dout, dcache_k,
                                           dcache_v: Optional[torch.Tensor], t: int,
                                           ancestry: Optional[torch.Tensor] = None):
    """The plain version: the autograd of ``ancestry_self_attention_plain``
    (through ``ancestry`` (B, K, T_max), or the identity map) over slots
    0..t; its dK / dV of slots 0..t-1 are added into ``dcache_k`` /
    ``dcache_v`` in place and slot t of both is zeroed. Returns (dq, dk_t,
    dv_t), dk_t = dcache_k[:, :, t] (as received) + slot t's own dK. Under
    kv (``cache_v`` and ``dcache_v`` None) the one cache's gradient is the
    two uses' sum, and dv_t is None."""
    kv = cache_v is None
    with torch.enable_grad():
        qq = q.detach().requires_grad_()
        kk = cache_k[:, :, : t + 1].detach().requires_grad_()
        vv = None if kv else cache_v[:, :, : t + 1].detach().requires_grad_()
        out = ancestry_self_attention_plain(qq, kk, vv, ancestry, t)
        grads = torch.autograd.grad(out, (qq, kk) if kv else (qq, kk, vv), dout)
    dq, dk_t = grads[0], dcache_k[:, :, t] + grads[1][:, :, t]
    dcache_k[:, :, :t] += grads[1][:, :, :t]
    dcache_k[:, :, t] = 0
    if kv:
        return dq, dk_t, None
    dv_t = dcache_v[:, :, t] + grads[2][:, :, t]
    dcache_v[:, :, :t] += grads[2][:, :, :t]
    dcache_v[:, :, t] = 0
    return dq, dk_t, dv_t


def ancestry_self_attention_backward(q, cache_k, cache_v: Optional[torch.Tensor], dout, dcache_k,
                                     dcache_v: Optional[torch.Tensor], t: int,
                                     ancestry: Optional[torch.Tensor] = None):
    """The backward of one decode step's K2 (f32). q, dout: (N, h, dk);
    cache_k/v: (N, h, T_max, dk), slots 0..t as the forward read them;
    dcache_k/v: (N, h, T_max, dk), the caches' gradient from the later
    steps, updated in place (slots < t += this step's dK / dV, slot t
    zeroed); cache_v and dcache_v None in the kv mode (one cache read as K
    and V; its gradient takes both terms); ancestry: the step's map (B, K,
    T_max) int32, N = B*K (the ancestry mode: slot t' of row j gets the sum
    over the image's rows r with ancestry[b, r, t'] == j), or None for the
    identity map. Returns (dq, dk_t, dv_t), each (N, h, dk); dv_t is None
    under kv."""
    check_backward_supported(q)
    kv = cache_v is None
    if kv != (dcache_v is None):
        raise ValueError("the kv mode takes one cache and one gradient buffer (cache_v and dcache_v both None)")
    n, h, dk = q.shape
    t_max = cache_k.shape[2]
    check_tensor(dout, "dout", (n, h, dk), q.dtype)
    for name, c in (("cache_k", cache_k), ("cache_v", cache_v), ("dcache_k", dcache_k), ("dcache_v", dcache_v)):
        if c is not None:
            check_tensor(c, name, (n, h, t_max, dk), q.dtype)
    kb = 1
    if ancestry is not None:
        kb = ancestry.shape[1] if ancestry.dim() == 3 else 0
        if kb == 0 or ancestry.shape[0] * kb != n:
            raise ValueError(f"ancestry: expected (B, K, {t_max}) with B*K == {n}, got {tuple(ancestry.shape)}")
        check_tensor(ancestry, "ancestry", (n // kb, kb, t_max), torch.int32)
    if not 0 <= t < t_max:
        raise ValueError(f"t={t} outside the cache of {t_max} slots")
    check_same_device(q, cache_k, cache_v, dout, dcache_k, dcache_v, ancestry)
    if q.device.type == "cpu":
        return ancestry_self_attention_backward_plain(q, cache_k, cache_v, dout, dcache_k, dcache_v, t, ancestry)
    if dk not in BWD_HEAD_WIDTHS:
        raise ValueError(f"K2's backward kernel takes head widths {BWD_HEAD_WIDTHS}; got dk={dk}")
    if h > 32 or t_max > MAX_SLOTS:
        raise ValueError(f"K2's backward kernel takes h <= 32, T_max <= {MAX_SLOTS}; got h={h} T_max={t_max}")
    dq, dk_t = torch.empty_like(q), torch.empty_like(q)
    dv_t = None if kv else torch.empty_like(q)
    sqrt_dk, stream = score_divisor(dk, q.dtype), _build.stream_handle(q)
    if ancestry is not None:
        if anc_bwd_smem_bytes(dk, kb, t) > _build.BLOCK_SMEM_LIMIT:
            raise ValueError(f"K2's backward ancestry mode: {kb} beams at t={t} exceed a block's shared memory")
        if kv:
            KERNEL_BWD_ANC_KV.launch(dk, q.data_ptr(), cache_k.data_ptr(), dout.data_ptr(), ancestry.data_ptr(),
                                     dq.data_ptr(), dcache_k.data_ptr(), dk_t.data_ptr(), n, h, kb, t_max, t, sqrt_dk,
                                     stream)
        else:
            KERNEL_BWD_ANC.launch(dk, q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), dout.data_ptr(),
                                  ancestry.data_ptr(), dq.data_ptr(), dcache_k.data_ptr(), dcache_v.data_ptr(),
                                  dk_t.data_ptr(), dv_t.data_ptr(), n, h, kb, t_max, t, sqrt_dk, stream)
    elif kv:
        KERNEL_BWD_KV.launch(dk, q.data_ptr(), cache_k.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                             dcache_k.data_ptr(), dk_t.data_ptr(), n, h, t_max, t, sqrt_dk, stream)
    else:
        KERNEL_BWD.launch(dk, q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                          dcache_k.data_ptr(), dcache_v.data_ptr(), dk_t.data_ptr(), dv_t.data_ptr(), n, h, t_max, t,
                          sqrt_dk, stream)
    return dq, dk_t, dv_t


class DecodeSelfStep(torch.autograd.Function):
    """One decode step's self-attention with gradients: write k_t (and v_t)
    into slot t of the caches (in place, ``mark_dirty``), K2 over slots 0..t
    through the step's ancestry map (or the identity). The caches go in and
    come out, which orders the steps' backwards (see the module's
    docstring). Under kv there is one cache, v_t and cache_v are None, and
    the Function returns (out, cache)."""

    @staticmethod
    def forward(ctx, q, k_t, v_t, cache_k, cache_v, ancestry, t: int):
        caches = (cache_k,) if cache_v is None else (cache_k, cache_v)
        cache_k[:, :, t] = k_t
        if cache_v is not None:
            cache_v[:, :, t] = v_t
        out = ancestry_self_attention(q, cache_k, cache_v, ancestry, t)
        ctx.mark_dirty(*caches)
        ctx.save_for_backward(q)
        ctx.caches = tuple(c.detach() for c in caches)  # aliases: later steps write slots > t only
        ctx.ancestry = None if ancestry is None else ancestry.clone()  # the step's map
        ctx.t = t
        ctx.set_materialize_grads(False)
        return (out, *caches)

    @staticmethod
    def backward(ctx, dout, *dcaches):
        (q,) = ctx.saved_tensors
        dcaches = [torch.zeros_like(c) if d is None else d.contiguous() for c, d in zip(ctx.caches, dcaches)]
        dout = torch.zeros_like(q) if dout is None else dout.contiguous()
        cache_v, dcache_v = (ctx.caches[1], dcaches[1]) if len(dcaches) == 2 else (None, None)
        dq, dk_t, dv_t = ancestry_self_attention_backward(q, ctx.caches[0], cache_v, dout, dcaches[0], dcache_v,
                                                          ctx.t, ctx.ancestry)
        return (dq, dk_t, dv_t, *dcaches, *([None] * (2 - len(dcaches))), None, None)


def decode_self_attention(q, k_t, v_t, cache_k, cache_v: Optional[torch.Tensor], ancestry: Optional[torch.Tensor],
                          t: int):
    """One decode step of self-attention: k_t, v_t (N, h, dk) written into
    slot t of cache_k / cache_v (in place; cache_v=None under kv, where k_t
    is the one array's row and v_t is not read), then K2 over slots 0..t.
    Where gradients are asked for (the SCST gradient pass that runs the
    decode again), the two run as ``DecodeSelfStep``, whose backward is K2's
    backward (through the ancestry map under beam search; the kv mode under
    kv). Returns (N, h, dk)."""
    if cache_v is None:
        v_t = None
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (q, k_t, v_t, cache_k, cache_v)):
        check_backward_supported(q)
        return DecodeSelfStep.apply(q, k_t, v_t, cache_k, cache_v, ancestry, t)[0]
    cache_k[:, :, t] = k_t
    if cache_v is not None:
        cache_v[:, :, t] = v_t
    return ancestry_self_attention(q, cache_k, cache_v, ancestry, t)
