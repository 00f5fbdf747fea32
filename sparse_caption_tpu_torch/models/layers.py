"""Shared model layers (port of ``sparse_caption_tpu/models/layers.py``).

Numerics kept from the reference:
* ``RefLayerNorm`` uses Bessel-corrected std + eps with f32 stats (it is not
  ``nn.LayerNorm``, which uses sqrt(biased var + eps))
* pre-norm residual ``x + dropout(f(norm(x)))``; sinusoidal PE in the
  activation dtype
* masked scores are filled with -1e9 in their own dtype, and the ORT geometry
  bias is added after the fill
* ORT geometry trig in f32, cast to the compute dtype before ``wg``
* in training the generator's log-probs are f32 (kernel K13 computes in f32
  and writes f32 or the compute dtype)

Train mode: a forward given ``rng`` (an ``ops.rng.TrainRandom`` or
``KeyedStream``) draws the supermask samples and the dropout masks from it;
``rng=None`` is eval. Every module that draws dropout holds a ``site`` id
(``assign_dropout_sites``) that keys a ``KeyedStream``'s draws: with one, the
decode draws in step mode at ``t`` and the teacher-forced replay draws all t
at once (kernel K8), and the two agree bit for bit. A layer called at several
slots of a ``share_layer`` plan gets the stream's slot view at each
(``ops.rng.slot_rng``), so each slot draws under its own site.
The residual add of sublayer i and the norm of sublayer i+1 run fused in
kernel K6 (``prenorm_stack``); the ORT encoder's attention in K1 (eval) or
K1's train variant with its backward K7; masked weights in K5; the
full-sequence attention of ``MultiHeadAttention`` (the decoder's in XE
teacher forcing and the SCST replay, the plain Transformer's encoder) in K14
with its backward K15, cross-attention reading one memory row per image.

The attention layers take ACORT's ``share_att`` layouts: "kv" (one
projection is K and V: the kv modes of K1 / K7, K2 and K3, and the one
tensor as k and v in K14 / K15) and "qk" (K from ``q_proj``; the unshared
kernels with q's projection as k).

Decode caches are explicit tensors ``(N, h, T_max, dk)``; ``decode_self``
writes slot ``t`` IN PLACE (the JAX package returns an updated copy). A
decode step runs with gradients where the caller asks (supermask SCST's
gradient pass, the JAX package's differentiable decode scan): the slot's
write and K2 then run as one autograd Function that threads the cache
(``kernels/ancestry_self_attention.py decode_self_attention``), K3 as one
whose backward is K3's backward, and a training supermask's q, k and v
products are the step's own K5 samples (not the cached fused projection).
Parameter names follow the flax leaf paths (``q_proj.weight`` <-
``q_proj/kernel``; see ``utils/convert_jax.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparse_caption_tpu_torch.kernels.add_ref_layernorm import add_ref_layernorm
from sparse_caption_tpu_torch.kernels.ancestry_self_attention import decode_self_attention
from sparse_caption_tpu_torch.kernels.box_attention import box_attention, geometry_width
from sparse_caption_tpu_torch.kernels.box_attention_bwd import box_attention_train
from sparse_caption_tpu_torch.kernels.decoder_attention import decoder_attention
from sparse_caption_tpu_torch.kernels.grouped_cross_attention import grouped_cross_attention
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax
from sparse_caption_tpu_torch.ops.attention import box_relational_embedding  # noqa: F401
from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedEmbedding, MaskedLinear
from sparse_caption_tpu_torch.ops.rng import dropout, keep_mask, site_id


class RefLayerNorm(nn.Module):
    """``a * (x - mean) / (std + eps) + b`` with unbiased std, stats in f32,
    result in the input dtype (kernel K6 without the residual)."""

    def __init__(self, d: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x):
        return add_ref_layernorm(x, None, self.weight, self.bias, eps=self.eps)


def sinusoid_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * -(math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class DropoutSite:
    """A module that draws dropout; ``site`` is set from its qualified name."""

    site: int = 0


def assign_dropout_sites(model: nn.Module) -> None:
    for name, m in model.named_modules():
        if isinstance(m, DropoutSite):
            m.site = site_id(name or "root")


class PositionalEncoding(nn.Module, DropoutSite):
    def __init__(self, d_model: int, dropout_rate: float = 0.1, max_len: int = 5000, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.register_buffer("pe", sinusoid_table(max_len, d_model, device), persistent=False)

    def forward(self, x, t: Optional[int] = None, rng=None):
        """x: (B, T, D); with ``t`` (incremental decode) x is (B, 1, D) at step t
        (and ``rng``, if keyed, is the step view at t). The f32 table is cast
        to x's dtype so a bf16 decode stays bf16."""
        pe = self.pe.to(x.dtype)
        x = x + (pe[None, : x.shape[1]] if t is None else pe[None, t: t + 1])
        return dropout(x, self.dropout_rate, rng, self.site)


class PositionwiseFeedForward(nn.Module, DropoutSite):
    MASKED_CALL_ORDER = ("w_1", "w_2")

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.1, mask_cfg: Optional[MaskConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.w_1 = MaskedLinear(d_model, d_ff, mask_cfg=mask_cfg, device=device, dtype=dtype)
        self.w_2 = MaskedLinear(d_ff, d_model, mask_cfg=mask_cfg, device=device, dtype=dtype)

    def forward(self, x, rng=None):
        return self.w_2(dropout(torch.relu(self.w_1(x, rng)), self.dropout_rate, rng, self.site), rng)


class SublayerConnection(nn.Module, DropoutSite):
    """Pre-norm residual wrapper: holds the sublayer's norm and its dropout
    rate; ``prenorm_stack`` runs it."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1, device=None, dtype=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm = RefLayerNorm(d_model, device=device, dtype=dtype)


# (sublayer, f, the random source its residual dropout draws from: its slot's)
Step = Tuple[SublayerConnection, Callable, object]


def prenorm_stack(x, steps: Sequence[Step], final_norm: RefLayerNorm):
    """``x = x + dropout(f(norm(x)))`` for every (sublayer, f, rng) in order,
    then ``final_norm(x)``. Sublayer i's residual add (with its dropout) runs
    fused with the norm of sublayer i+1, or with the final norm, in kernel
    K6: 1 + len(steps) launches."""
    first = steps[0][0].norm
    n = add_ref_layernorm(x, None, first.weight, first.bias, eps=first.eps)
    for i, (sub, fn, rng) in enumerate(steps):
        y = fn(n)
        nxt = steps[i + 1][0].norm if i + 1 < len(steps) else final_norm
        keep = keep_mask(y.shape, sub.dropout_rate, rng, y.device, sub.site)
        x, n = add_ref_layernorm(x, y, nxt.weight, nxt.bias, keep, 1.0 - sub.dropout_rate, eps=nxt.eps)
    return n


def _split_heads(x, h: int):
    """(B, T, D) -> (B, h, T, D/h), contiguous."""
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2).contiguous()


def _merge_heads(x):
    """(B, h, T, dk) -> (B, T, h*dk)."""
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


SHARE_ATT = (None, "kv", "qk")
# the input projections of each ``share_att`` layout (ACORT): "kv" projects
# K once and reads it as V too; "qk" takes K from ``q_proj``
PROJECTIONS = {None: ("q_proj", "k_proj", "v_proj"), "kv": ("q_proj", "kv_proj"), "qk": ("q_proj", "v_proj")}
# the masked projections in the order a full-sequence forward calls them
# (under "qk" ``q_proj`` runs twice, on the query and then on the key, and a
# training supermask draws for each call as in the JAX package)
CALL_ORDER = {None: ("q_proj", "k_proj", "v_proj"), "kv": ("q_proj", "kv_proj"), "qk": ("q_proj", "q_proj", "v_proj")}


def _check_share_att(share_att) -> None:
    if share_att not in SHARE_ATT:
        raise ValueError(f"share_att must be one of {SHARE_ATT}, got {share_att!r}")


class MultiHeadAttention(nn.Module, DropoutSite):
    """MHA with cached-decode methods. ``share_att`` (ACORT): None (q, k, v
    and out projections), "kv" (q, a shared kv projection whose output is
    both K and V, out) or "qk" (K from ``q_proj``, v, out). Under "kv" a
    decode cache holds one array, K, and the kernels K2 and K3 run their kv
    modes, which read each cached row once for both products, and so does
    the full-sequence attention (K14 / K15's kv modes)."""

    def __init__(self, num_heads: int, d_model: int, dropout_rate: float = 0.1, share_att: Optional[str] = None,
                 mask_cfg: Optional[MaskConfig] = None, device=None, dtype=None):
        super().__init__()
        assert d_model % num_heads == 0
        _check_share_att(share_att)
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.share_att = share_att
        self.MASKED_CALL_ORDER = CALL_ORDER[share_att] + ("out_proj",)
        for name in PROJECTIONS[share_att] + ("out_proj",):
            setattr(self, name, MaskedLinear(d_model, d_model, mask_cfg=mask_cfg, device=device, dtype=dtype))

    def forward(self, query, key, value, key_valid=None, causal: bool = False, rng=None, attn_dropout: bool = True):
        """Full-sequence attention (kernel K14, its backward K15). query: (N,
        Tq, D); key/value: (Nk, Tk, D) with Nk dividing N: each key row serves
        N / Nk consecutive query rows (an image's captions read its memory row,
        projected once); key_valid: (Nk, Tk) bool, False = masked key, or None;
        causal: position i attends keys <= i. ``attn_dropout=False`` skips the
        dropout on the probabilities (the SCST replay: the step decode it
        reproduces applies none)."""
        h = self.num_heads
        q = _split_heads(self.q_proj(query, rng), h)
        k, v = self.project_memory_kv(key, value, rng)
        keep = keep_mask((q.shape[0], h, q.shape[2], k.shape[2]), self.dropout_rate, rng if attn_dropout else None,
                         q.device, self.site)
        out = decoder_attention(q, k, v, key_valid, causal, keep, 1.0 - self.dropout_rate)
        return self.out_proj(_merge_heads(out), rng)

    def project_memory_kv(self, key, value=None, rng=None):
        """(B, S, D) -> K, V each (B, h, S, dk), contiguous; computed once per
        decode. Under "kv" V is K and comes back as None."""
        value = key if value is None else value
        h = self.num_heads
        if self.share_att == "kv":
            return _split_heads(self.kv_proj(key, rng), h), None
        k_proj = self.q_proj if self.share_att == "qk" else self.k_proj
        return _split_heads(k_proj(key, rng), h), _split_heads(self.v_proj(value, rng), h)

    def masked_kv(self) -> list:
        """The masked projections ``project_memory_kv`` calls, in order."""
        return [getattr(self, name) for name in CALL_ORDER[self.share_att][1:]]

    def decode_cross(self, x_t, mem_k, mem_v, mem_mask, rng=None):
        """x_t: (N, 1, D); mem_k/v: (B, h, S, dk), B dividing N (each image's
        beam rows share its memory row); mem_v=None means V is K (kernel K3's
        kv mode); mem_mask: (B, S) bool; rng: the train-mode step stream
        (a training supermask's q and out products). Runs kernel K3 (and,
        with gradients, its backward; in the kv mode when mem_v is None)."""
        n = x_t.shape[0]
        q = self.q_proj(x_t, rng).reshape(n, self.num_heads, -1)
        out = grouped_cross_attention(q, mem_k, mem_v, mem_mask)
        return self.out_proj(out.reshape(n, 1, -1), rng)

    def _fused_qkv(self):
        """The concatenated effective weight (P D, D) (a kept mask applied)
        and bias (P D,) of the layer's P input projections (q, k, v; q, kv
        under "kv"; q, v under "qk"). Built once and rebuilt only when a
        projection's tensors change (a load, a mask fold, an optimizer update
        and a dtype or device move all give a new storage or version)."""
        projs = [getattr(self, name) for name in PROJECTIONS[self.share_att]]
        tensors = [p for m in projs for p in (m.weight, m.bias, m.mask) if p is not None]
        key = tuple((p.data_ptr(), p._version) for p in tensors)
        if getattr(self, "_qkv_key", None) != key:
            with torch.no_grad():
                self._qkv = (torch.cat([m.effective_weight() for m in projs]), torch.cat([m.bias for m in projs]))
            self._qkv_key = key
        return self._qkv

    def _fused_qkv_step(self, x_t):
        """q, k and v of one decode step, each (N, h, dk), from one matmul over
        the concatenated input projections (one (2D, D) product under "kv" and
        "qk"); v is None under "kv", and k is q under "qk"."""
        w, b = self._fused_qkv()
        n = x_t.shape[0]
        out = F.linear(x_t.reshape(n, -1), w, b).reshape(n, -1, self.num_heads, w.shape[1] // self.num_heads)
        q = out[:, 0].contiguous()
        if self.share_att == "kv":
            return q, out[:, 1], None
        if self.share_att == "qk":
            return q, q, out[:, 1]
        return q, out[:, 1], out[:, 2]

    def _step_qkv(self, x_t, rng=None):
        """q, k and v of one decode step, as ``_fused_qkv_step`` gives them.
        Where the products are drawn or differentiated on every call (a
        training supermask's step samples, or gradients asked for), each
        projection runs on its own product, as the JAX package's non-fused
        path calls them ("qk": ``q_proj`` twice, a product each)."""
        if not torch.is_grad_enabled() and self.q_proj._per_call_mode(rng) is None:
            return self._fused_qkv_step(x_t)
        n, h = x_t.shape[0], self.num_heads
        q = self.q_proj(x_t, rng).reshape(n, h, -1)
        if self.share_att == "kv":
            return q, self.kv_proj(x_t, rng).reshape(n, h, -1), None
        k_t = (self.q_proj if self.share_att == "qk" else self.k_proj)(x_t, rng).reshape(n, h, -1)
        return q, k_t, self.v_proj(x_t, rng).reshape(n, h, -1)

    def decode_self(self, x_t, cache_k, cache_v, t: int, ancestry: Optional[torch.Tensor] = None, rng=None):
        """One causal step. x_t: (N, 1, D); cache_k/v: (N, h, T_max, dk), slot t
        written IN PLACE; cache_v=None under "kv" (one array, read as K and V:
        kernel K2's kv mode); ancestry: (B, K, T_max) int32 ancestor map (row
        b*K + k reads slot t' of row b*K + ancestry[b, k, t']) or None; rng:
        the train-mode step stream. Runs kernel K2 (and, with gradients, its
        backward: ``decode_self_attention``; in the kv mode under "kv")."""
        if (cache_v is None) != (self.share_att == "kv"):
            raise ValueError("a kv-shared layer caches one array (cache_v=None); every other layer two")
        q, k_t, v_t = self._step_qkv(x_t, rng)
        out = decode_self_attention(q, k_t, v_t, cache_k, cache_v, ancestry, t)
        return self.out_proj(out.reshape(x_t.shape[0], 1, -1), rng)


class BoxMultiHeadAttention(nn.Module, DropoutSite):
    """Geometry-biased self-attention of the ORT encoder: ``softmax(log(clamp(
    relu(wg . geo), 1e-6)) + fill(qk / sqrt(d)))`` with one (dim_g -> h)
    ``wg`` projection: dim_g 64, the trigonometric geometry, or with
    ``trigonometric_embedding=False`` dim_g 4, the raw log-deltas
    (``--no_box_trigonometric_embedding``). The attention runs in kernel
    K1, or with gradients in K1's train variant and K7; ``share_att`` as ``MultiHeadAttention``'s, "kv" through
    the kv modes of K1 and K7 (V is the K tensor; one gradient for it)."""

    def __init__(self, num_heads: int, d_model: int, dropout_rate: float = 0.1, share_att: Optional[str] = None,
                 mask_cfg: Optional[MaskConfig] = None, trigonometric_embedding: bool = True, device=None,
                 dtype=None):
        super().__init__()
        assert d_model % num_heads == 0
        _check_share_att(share_att)
        self.num_heads = num_heads
        self.trigonometric_embedding = trigonometric_embedding
        self.dropout_rate = dropout_rate
        self.share_att = share_att
        self.MASKED_CALL_ORDER = CALL_ORDER[share_att] + ("wg", "out_proj")
        for name in PROJECTIONS[share_att] + ("out_proj",):
            setattr(self, name, MaskedLinear(d_model, d_model, mask_cfg=mask_cfg, device=device, dtype=dtype))
        self.wg = MaskedLinear(geometry_width(trigonometric_embedding), num_heads, mask_cfg=mask_cfg, device=device,
                               dtype=dtype)

    def forward(self, x, boxes, mask, rng=None):
        """x: (B, R, D); boxes: (B, R, 4) f32; mask: (B, R) bool, False = padded."""
        h = self.num_heads
        q = _split_heads(self.q_proj(x, rng), h)
        if self.share_att == "kv":
            k, v = _split_heads(self.kv_proj(x, rng), h), None
        else:
            k = _split_heads((self.q_proj if self.share_att == "qk" else self.k_proj)(x, rng), h)
            v = _split_heads(self.v_proj(x, rng), h)
        wg_w = self.wg.effective_weight(rng)
        boxes = boxes.float().contiguous()
        if rng is None and not torch.is_grad_enabled():
            out = box_attention(q, k, v, boxes, wg_w, self.wg.bias, mask)
        else:
            b, r = x.shape[0], x.shape[1]
            keep = keep_mask((b, h, r, r), self.dropout_rate, rng, x.device, self.site)
            out = box_attention_train(q, k, v, boxes, wg_w, self.wg.bias, mask, keep, 1.0 - self.dropout_rate)
        return self.out_proj(_merge_heads(out), rng)


class InputEmbedding(nn.Module):
    """Token embedding scaled by sqrt(d_model)."""

    MASKED_CALL_ORDER = ("lut",)

    def __init__(self, vocab_size: int, d_model: int, mask_cfg: Optional[MaskConfig] = None, device=None,
                 dtype=None):
        super().__init__()
        self.scale = math.sqrt(d_model)
        self.lut = MaskedEmbedding(vocab_size, d_model, mask_cfg=mask_cfg, device=device, dtype=dtype)

    def forward(self, ids, rng=None):
        return self.lut(ids, rng) * self.scale


class Generator(nn.Module):
    """Linear + log_softmax output head (kernel K13). In eval the log-probs
    come out in the compute dtype; in training (``rng`` given) in f32."""

    MASKED_CALL_ORDER = ("proj",)

    def __init__(self, d_model: int, vocab_size: int, mask_cfg: Optional[MaskConfig] = None, device=None,
                 dtype=None):
        super().__init__()
        self.proj = MaskedLinear(d_model, vocab_size, mask_cfg=mask_cfg, device=device, dtype=dtype)

    def logits(self, x, rng=None):
        return self.proj(x, rng)

    def forward(self, x, rng=None):
        logits = self.proj(x, rng)
        return vocab_log_softmax(logits, torch.float32 if rng is not None else logits.dtype)
