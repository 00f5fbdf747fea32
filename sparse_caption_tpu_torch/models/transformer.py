"""Caption Transformer (port of ``sparse_caption_tpu/models/transformer.py``).

Pre-norm encoder-decoder with RefLayerNorm, sinusoidal PE and a log-softmax
generator. ``forward``/``encode`` run in eval (no gradients) or, with
``train=True`` and a random source (``ops.rng``), in train mode: dropout,
fresh supermask samples, f32 log-softmax, with gradients unless the caller
disabled them (the SCST sampling phase runs under ``torch.no_grad``). The
decode path keeps explicit static-shape caches: self K/V at
``B * rows_per_image`` rows written in place at slot ``t``, projected cross
K/V at ``B`` rows (one per image, shared by its beams or samples), and, for
beam search, a ``(B, K, T_max)`` ancestor map so beams reorder without
touching the K/V cache. A train-mode decode step draws its dropout from a
``KeyedStream`` at ``t``; ``decode_teacher_forced(train=True)`` replays every
step's draws in one pass. ``share_att_*`` / ``share_layer_*`` (ACORT) are
ported: each slot of a shared layer draws its keyed dropout under its own
site (``ops.rng.slot_rng``); a training supermask over shared layers raises.

A training supermask draws fresh masks at every decode step, so one
teacher-forced pass cannot replay its decode: supermask SCST's gradient pass
re-runs the decode itself with gradients (``engine/training.py
scan_log_probs``). ``init_cache(train=True)`` and ``decode_step_logits`` run
with gradients where the caller has them enabled (the JAX package's
``differentiable=True``); the cross K/V projection draws its masks once,
under the cache's stream, and every step its own K5 set under the step view
(keyed draws, K5's keyed mode), so the sampling pass and the gradient pass
draw the same masks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from sparse_caption_tpu_torch import resolve_device
from sparse_caption_tpu_torch.config import list_of_ints
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax
from sparse_caption_tpu_torch.models import register_model
from sparse_caption_tpu_torch.models.layers import (
    DropoutSite,
    Generator,
    InputEmbedding,
    MultiHeadAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RefLayerNorm,
    Step,
    SublayerConnection,
    assign_dropout_sites,
    prenorm_stack,
)
from sparse_caption_tpu_torch.ops.masked import (
    MaskConfig,
    MaskedEmbedding,
    MaskedLinear,
    assign_mask_sites,
    mask_set,
    masked_call_order,
)
from sparse_caption_tpu_torch.ops.rng import dropout, slot_rng


def _unique_layer_plan(num_layers: int, share_layer: Optional[Sequence[int]]) -> Tuple[int, Tuple[int, ...]]:
    """(n_unique, assignment) for layer sharing (reference transformer.py:133-142)."""
    if share_layer:
        share_layer = tuple(int(i) for i in share_layer)
        assert len(share_layer) == num_layers, (
            f"share_layer has {len(share_layer)} entries for num_layers={num_layers}; "
            "a short list would silently change the model depth")
        n_unique = len(set(share_layer))
        assert set(share_layer) == set(range(n_unique)), f"share_layer must use indices 0..{n_unique - 1}"
        return n_unique, share_layer
    return num_layers, tuple(range(num_layers))


def plan_slots(plan) -> List[Tuple[int, int]]:
    """(layer, slot) for each position of a layer plan: slot k is the
    layer's k-th call in the pass (its dropout site, ``ops.rng.slot_rng``)."""
    seen: Dict[int, int] = {}
    out = []
    for i in plan:
        out.append((i, seen.get(i, 0)))
        seen[i] = seen.get(i, 0) + 1
    return out


def train_rng(train: bool, rng):
    """The forward's random source: required in train mode, ignored in eval."""
    if train and rng is None:
        raise ValueError("train=True needs rng (an ops.rng.TrainRandom)")
    return rng if train else None


class EncoderLayer(nn.Module):
    MASKED_CALL_ORDER = ("self_attn", "feed_forward")

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout_rate: float = 0.1, share_att=None,
                 mask_cfg=None, **factory):
        super().__init__()
        self.self_attn = MultiHeadAttention(num_heads, d_model, dropout_rate, share_att, mask_cfg, **factory)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dropout_rate, mask_cfg, **factory)
        self.sub0 = SublayerConnection(d_model, dropout_rate, **factory)
        self.sub1 = SublayerConnection(d_model, dropout_rate, **factory)

    def steps(self, key_valid, rng=None) -> List[Step]:
        """The layer's two pre-norm sublayers for ``prenorm_stack``; key_valid: (B, S) bool."""
        return [(self.sub0, lambda y: self.self_attn(y, y, y, key_valid, rng=rng), rng),
                (self.sub1, lambda y: self.feed_forward(y, rng), rng)]


class DecoderLayer(nn.Module):
    MASKED_CALL_ORDER = ("self_attn", "src_attn", "feed_forward")

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout_rate: float = 0.1, share_att=None,
                 mask_cfg=None, **factory):
        super().__init__()
        self.self_attn = MultiHeadAttention(num_heads, d_model, dropout_rate, share_att, mask_cfg, **factory)
        self.src_attn = MultiHeadAttention(num_heads, d_model, dropout_rate, share_att, mask_cfg, **factory)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dropout_rate, mask_cfg, **factory)
        self.sub0 = SublayerConnection(d_model, dropout_rate, **factory)
        self.sub1 = SublayerConnection(d_model, dropout_rate, **factory)
        self.sub2 = SublayerConnection(d_model, dropout_rate, **factory)

    def steps(self, memory, mem_valid, tgt_valid, rng=None, attn_dropout: bool = True) -> List[Step]:
        """Full-sequence (teacher-forced) sublayers for ``prenorm_stack``:
        causal self-attention over the caption's valid tokens (``tgt_valid``
        (N, T) bool, or None for all) and cross-attention over the memory
        (B, S, D), one row per image for its N / B captions (``mem_valid`` (B,
        S) bool)."""
        return [(self.sub0, lambda y: self.self_attn(y, y, y, tgt_valid, True, rng, attn_dropout), rng),
                (self.sub1, lambda y: self.src_attn(y, memory, memory, mem_valid, False, rng, attn_dropout), rng),
                (self.sub2, lambda y: self.feed_forward(y, rng), rng)]

    def decode_steps(self, layer_cache: Dict, cross: Dict, t: int, mem_mask, ancestry=None, rng=None) -> List[Step]:
        """One decode step's sublayers. layer_cache: {self_k, self_v} (written
        in place at slot t; no self_v under kv); cross: {cross_k, cross_v} (no
        cross_v under kv); mem_mask: (B, S) bool;
        rng: the train-mode step stream (no attention-prob dropout here)."""
        return [(self.sub0, lambda y: self.self_attn.decode_self(
                    y, layer_cache["self_k"], layer_cache.get("self_v"), t, ancestry, rng), rng),
                (self.sub1, lambda y: self.src_attn.decode_cross(
                    y, cross["cross_k"], cross.get("cross_v"), mem_mask, rng), rng),
                (self.sub2, lambda y: self.feed_forward(y, rng), rng)]

    def decode_masked(self) -> list:
        """The masked layers one decode step calls, in order (the cross K/V
        projections are the cache's)."""
        return (masked_call_order(self.self_attn) + [self.src_attn.q_proj, self.src_attn.out_proj]
                + masked_call_order(self.feed_forward))


@register_model("transformer")
@register_model("transformer_prune")
class Transformer(nn.Module, DropoutSite):
    """Caption transformer. Parameters are created on ``device`` (default
    ``"cuda"``; raises without CUDA) in ``dtype`` and initialised like the JAX
    package (xavier-uniform matrices, zero biases, unit norms) from
    ``generator``."""

    COLLATE_FIELDS = ("att_feats", "att_masks")

    def __init__(self, vocab_size: int, d_model: int = 512, dim_feedforward: int = 2048, num_layers: int = 6,
                 num_heads: int = 8, att_feat_size: int = 2048, max_seq_length: int = 18, pad_id: int = 0,
                 bos_id: int = 2, eos_id: int = 3, unk_id: int = 1, share_att_encoder: Optional[str] = None,
                 share_att_decoder: Optional[str] = None, share_layer_encoder: Optional[Sequence[int]] = None,
                 share_layer_decoder: Optional[Sequence[int]] = None, mask_cfg: Optional[MaskConfig] = None,
                 dropout_rate: float = 0.1, drop_prob_src: float = 0.5,
                 *, device="cuda", dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_length = max_seq_length
        self.pad_id, self.bos_id, self.eos_id, self.unk_id = pad_id, bos_id, eos_id, unk_id
        self.mask_cfg = mask_cfg
        self.dropout_rate, self.drop_prob_src = dropout_rate, drop_prob_src
        self.share_layer_encoder, self.share_layer_decoder = share_layer_encoder, share_layer_decoder
        factory = dict(device=resolve_device(device), dtype=dtype)
        n_dec, self.dec_plan = _unique_layer_plan(num_layers, share_layer_decoder)
        self.tgt_embed = InputEmbedding(vocab_size, d_model, mask_cfg, **factory)
        self.pos_enc = PositionalEncoding(d_model, dropout_rate, device=factory["device"])
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, dim_feedforward, dropout_rate, share_att_decoder, mask_cfg, **factory)
            for _ in range(n_dec))
        self.decoder_norm = RefLayerNorm(d_model, **factory)
        self.generator = Generator(d_model, vocab_size, mask_cfg, **factory)
        self._build_encoder(att_feat_size, dim_feedforward, share_att_encoder, factory)
        self.reset_parameters(generator)
        assign_dropout_sites(self)
        assign_mask_sites(self)
        self.eval()

    def _build_encoder(self, att_feat_size, dim_feedforward, share_att, factory):
        n_enc, self.enc_plan = _unique_layer_plan(self.num_layers, self.share_layer_encoder)
        self.src_proj = MaskedLinear(att_feat_size, self.d_model, mask_cfg=self.mask_cfg, **factory)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(self.d_model, self.num_heads, dim_feedforward, self.dropout_rate, share_att, self.mask_cfg,
                         **factory)
            for _ in range(n_enc))
        self.encoder_norm = RefLayerNorm(self.d_model, **factory)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (MaskedLinear, MaskedEmbedding)):
                m.reset_parameters(generator)
            elif isinstance(m, RefLayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def _plans(self):
        return self.enc_plan, self.dec_plan

    def _train_rng(self, train: bool, rng):
        """``train_rng``, refusing what shared layers cannot do yet: the JAX
        package draws a fresh supermask sample for each slot of a shared
        layer. (Fresh dropout per slot holds: a call-order source draws
        anew at each call, a keyed stream under each slot's site.)"""
        rng = train_rng(train, rng)
        shared = any(len(set(plan)) < len(plan) for plan in self._plans())
        if rng is not None and shared and self.mask_cfg is not None and self.mask_cfg.is_supermask:
            raise NotImplementedError("a training supermask with share_layer (a fresh sample per slot) "
                                      "lands in a later slice")
        return rng

    # ------------------------------------------------------ masked products
    def _encoder_masked(self) -> list:
        """The encoder's masked layers in the order ``encode`` calls them."""
        return masked_call_order(self.src_proj, *(self.encoder_layers[i] for i in self.enc_plan))

    def _decoder_masked(self) -> list:
        """The masked layers of a teacher-forced decoder pass and the generator, in call order."""
        return masked_call_order(self.tgt_embed, *(self.decoder_layers[i] for i in self.dec_plan), self.generator)

    def _decode_step_masked(self) -> list:
        """The masked layers of one decode step and the generator, in call order."""
        return masked_call_order(self.tgt_embed) + [
            m for i in self.dec_plan for m in self.decoder_layers[i].decode_masked()] + masked_call_order(
            self.generator)

    def _cross_masked(self) -> list:
        """The cross K/V projections of ``init_cache(train=True)``, slot by slot."""
        return [m for i in self.dec_plan for m in self.decoder_layers[i].src_attn.masked_kv()]

    def mask_set(self, rng=None):
        """One K5 set (``ops/masked.py mask_set``) for the masked products of
        a teacher-forced pass: ``encode``, then the decoder and the generator."""
        return mask_set(self._encoder_masked() + self._decoder_masked(), rng)

    # ----------------------------------------------------------- encoding
    def encode(self, att_feats, att_masks, boxes=None, train: bool = False, rng=None) -> Dict[str, Any]:
        """att_feats: (B, S, F); att_masks: (B, S), 0 = padded. Returns the memory dict."""
        rng = self._train_rng(train, rng)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()), mask_set(self._encoder_masked(), rng):
            x = dropout(torch.relu(self.src_proj(att_feats, rng)), self.drop_prob_src, rng, self.site)
            steps = [s for i, k in plan_slots(self.enc_plan)
                     for s in self.encoder_layers[i].steps((att_masks != 0).contiguous(), slot_rng(rng, k))]
            return {"memory": prenorm_stack(x, steps, self.encoder_norm), "mask": att_masks}

    # ----------------------------------------------------- XE teacher force
    def _decode_full(self, tgt, memory, mem_mask, rng=None, replay: bool = False):
        """Decoder output (N, T, D) over the memory (B, S, D), B dividing N:
        each image's row serves its N / B captions. ``replay`` reproduces a
        train-mode decode: a causal-only key mask (the step decode attends
        every written slot <= t, pad or not), no attention-prob dropout, and
        ``rng`` a ``KeyedStream`` drawing every step's dropout at once."""
        tgt_valid = None if replay else (tgt != self.pad_id).contiguous()
        mem_valid = (mem_mask != 0).contiguous()
        x = self.pos_enc(self.tgt_embed(tgt, rng), rng=rng)
        steps = [s for i, k in plan_slots(self.dec_plan)
                 for s in self.decoder_layers[i].steps(memory, mem_valid, tgt_valid, slot_rng(rng, k),
                                                       attn_dropout=not replay)]
        return prenorm_stack(x, steps, self.decoder_norm)

    def forward(self, att_feats, att_masks, seqs, boxes=None, train: bool = False, rng=None):
        """XE log-probs (N, T-1, V) of seqs[:, 1:] (decoder input seqs[:, :-1]).
        ``train=True`` (with ``rng``) runs the train-mode forward with gradients."""
        rng = self._train_rng(train, rng)
        with torch.set_grad_enabled(train), self.mask_set(rng):
            enc = self.encode(att_feats, att_masks, boxes, train, rng)
            return self.generator(self._decode_full(seqs[:, :-1], enc["memory"], enc["mask"], rng), rng)

    # --------------------------------------------- SCST teacher-forced replay
    def decode_teacher_forced(self, memory_pytree: Dict[str, Any], seqs, train: bool = False, rng=None):
        """Log-probs (N, T-1, V) of ``seqs[:, 1:]`` given an encoded memory
        (N a multiple of its batch: an image's samples read its memory row).
        With ``train=True`` and the ``KeyedStream`` of a train-mode decode,
        the result equals that decode's per-step log-probs at every position
        up to its EOS (the replay of ``TimeDropout``); gradients flow unless
        the caller disabled them."""
        rng = self._train_rng(train, rng)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()), mask_set(self._decoder_masked(), rng):
            out = self._decode_full(seqs[:, :-1], memory_pytree["memory"], memory_pytree["mask"], rng, replay=train)
            return self.generator(out, rng)

    # ------------------------------------------------------------- decode
    def init_cache(self, memory_pytree: Dict[str, Any], max_steps: Optional[int] = None, rows_per_image: int = 1,
                   beam_ancestry: bool = False, train: bool = False, rng=None) -> Dict[str, Any]:
        """Static-shape decode cache: self K/V zeros at ``B * rows_per_image``
        rows (``self_k`` only in a kv-shared layer), projected cross K/V at B
        rows (``cross_k`` only under kv; in eval once per unique layer, shared
        by its slots; with ``train`` once per slot, under the train policy's
        masks, ``rng`` its random source: a training supermask's projections
        as one K5 set), and with ``beam_ancestry`` an identity ancestor map
        (B, rows_per_image, T_max) int32. With ``train`` and gradients
        enabled, the cross K/V carry them."""
        rng = self._train_rng(train, rng)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()), \
                mask_set(self._cross_masked() if train else [], rng):
            return self._init_cache(memory_pytree, max_steps, rows_per_image, beam_ancestry, train, rng)

    def _init_cache(self, memory_pytree, max_steps, rows_per_image, beam_ancestry, train, rng):
        memory = memory_pytree["memory"]
        b = memory.shape[0]
        rows = b * int(rows_per_image)
        t_max = int(max_steps or (self.max_seq_length + 1))
        dk = self.d_model // self.num_heads
        layers, cross, proj = [], [], {}
        for i, k in plan_slots(self.dec_plan):
            layer = self.decoder_layers[i]
            if train:
                ck, cv = layer.src_attn.project_memory_kv(memory, rng=slot_rng(rng, k))
            else:
                if i not in proj:
                    proj[i] = layer.src_attn.project_memory_kv(memory)
                ck, cv = proj[i]
            zeros = lambda: torch.zeros((rows, self.num_heads, t_max, dk), dtype=ck.dtype, device=ck.device)  # noqa: E731
            layers.append({"self_k": zeros()} if layer.self_attn.share_att == "kv"
                          else {"self_k": zeros(), "self_v": zeros()})
            cross.append({"cross_k": ck} if cv is None else {"cross_k": ck, "cross_v": cv})
        cache = {"layers": layers, "static": {"cross": cross}}
        if beam_ancestry:
            cache["ancestry"] = torch.arange(rows_per_image, dtype=torch.int32, device=memory.device)[
                None, :, None].repeat(b, 1, t_max)
        return cache

    def decode_step_logits(self, it, cache: Dict[str, Any], t: int, memory_pytree: Dict[str, Any],
                           train: bool = False, rng=None):
        """it: (N,) current tokens; t: step index. Returns (logits (N, V), cache);
        in train mode (``rng`` the decode's ``KeyedStream``) dropout and a
        training supermask's samples (one K5 set) draw at t, the logits are
        f32, and gradients flow where the caller has them enabled.

        The self K/V caches are written in place; the returned cache holds the
        ancestor map with slot t set to identity (each row wrote slot t itself)."""
        rng = self._train_rng(train, rng)
        rng = None if rng is None else rng.at(t)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()), \
                mask_set(self._decode_step_masked() if train else [], rng):
            return self._decode_step_logits(it, cache, t, memory_pytree, train, rng)

    def _decode_step_logits(self, it, cache, t, memory_pytree, train, rng):
        mem_mask = memory_pytree["mask"] != 0
        x = self.pos_enc(self.tgt_embed(it[:, None], rng), t=t, rng=rng)  # (N, 1, D)
        ancestry = cache.get("ancestry")
        if ancestry is not None:
            ancestry = ancestry.clone()
            ancestry[:, :, t] = torch.arange(ancestry.shape[1], dtype=ancestry.dtype, device=ancestry.device)
        steps = [s for j, (i, k) in enumerate(plan_slots(self.dec_plan)) for s in self.decoder_layers[i].decode_steps(
            cache["layers"][j], cache["static"]["cross"][j], t, mem_mask, ancestry, slot_rng(rng, k))]
        logits = self.generator.logits(prenorm_stack(x, steps, self.decoder_norm)[:, 0], rng)
        if train:
            logits = logits.float()
        new_cache = {"layers": cache["layers"], "static": cache["static"]}
        if ancestry is not None:
            new_cache["ancestry"] = ancestry
        return logits, new_cache

    @torch.no_grad()
    def decode_step(self, it, cache: Dict[str, Any], t: int, memory_pytree: Dict[str, Any], train: bool = False,
                    rng=None):
        """it: (N,) current tokens; t: step index. Returns (log-probs (N, V), cache)."""
        logits, cache = self.decode_step_logits(it, cache, t, memory_pytree, train, rng)
        return vocab_log_softmax(logits), cache

    @classmethod
    def from_config(cls, config, mask_cfg: Optional[MaskConfig] = None, **factory):
        """The model of a run config (the JAX package's ``from_config``
        defaults: 18 tokens, pad / bos / eos ids from the config, unk id 1);
        ``factory``: ``device``, ``dtype``, ``generator``."""

        def share_layer(v):
            if v is None or v == "":
                return None
            return tuple(list_of_ints(v)) if isinstance(v, str) else tuple(v)

        vocab_size = config.get("vocab_size")
        if vocab_size is None:
            raise ValueError("the config has no vocab_size (a tokenizer writes it)")
        return cls(vocab_size=vocab_size, d_model=config.get("d_model", 512),
                   dim_feedforward=config.get("dim_feedforward", 2048), num_layers=config.get("num_layers", 6),
                   num_heads=config.get("num_heads", 8), drop_prob_src=config.get("drop_prob_src", 0.5),
                   att_feat_size=config.get("att_feat_size", 2048), max_seq_length=config.get("max_seq_length", 18),
                   pad_id=config.get("pad_token_id", 0), bos_id=config.get("bos_token_id", 2),
                   eos_id=config.get("eos_token_id", 3), unk_id=1,
                   share_att_encoder=config.get("share_att_encoder"), share_att_decoder=config.get("share_att_decoder"),
                   share_layer_encoder=share_layer(config.get("share_layer_encoder")),
                   share_layer_decoder=share_layer(config.get("share_layer_decoder")), mask_cfg=mask_cfg, **factory)
