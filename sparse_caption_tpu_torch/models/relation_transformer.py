"""Object Relation Transformer (port of
``sparse_caption_tpu/models/relation_transformer.py``).

Encoder: ``att_embed`` (Linear + ReLU + dropout) then box-relation
self-attention layers (kernel K1; in training K1's train variant and K7)
over the region features; decoder, PE, generator and caching are the
caption Transformer's. ACORT is this model with the radix tokenizer,
``share_att_*="kv"`` and ``share_layer_*`` plans
(``resources/commands_acort.sh``); the box encoder runs its own plan, and
under a training supermask each of its slots draws its own sample (its K5
set names a shared layer once per slot, as the JAX package's
``box_enc_plan`` calls it).
``box_trigonometric_embedding=False`` (``--no_box_trigonometric_embedding``)
gives every box attention the 4-wide raw geometry.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from sparse_caption_tpu_torch.models import register_model
from sparse_caption_tpu_torch.models.layers import (
    BoxMultiHeadAttention,
    PositionwiseFeedForward,
    RefLayerNorm,
    Step,
    SublayerConnection,
    prenorm_stack,
)
from sparse_caption_tpu_torch.models.transformer import Transformer, _unique_layer_plan, plan_slots, train_rng
from sparse_caption_tpu_torch.ops.masked import MaskedLinear, mask_set, masked_call_order
from sparse_caption_tpu_torch.ops.rng import dropout, slot_rng


class BoxEncoderLayer(nn.Module):
    MASKED_CALL_ORDER = ("self_attn", "feed_forward")

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout_rate: float = 0.1, share_att=None,
                 mask_cfg=None, trigonometric_embedding: bool = True, **factory):
        super().__init__()
        self.self_attn = BoxMultiHeadAttention(num_heads, d_model, dropout_rate, share_att, mask_cfg,
                                               trigonometric_embedding, **factory)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dropout_rate, mask_cfg, **factory)
        self.sub0 = SublayerConnection(d_model, dropout_rate, **factory)
        self.sub1 = SublayerConnection(d_model, dropout_rate, **factory)

    def steps(self, boxes, mask, rng=None) -> List[Step]:
        return [(self.sub0, lambda y: self.self_attn(y, boxes, mask, rng), rng),
                (self.sub1, lambda y: self.feed_forward(y, rng), rng)]


@register_model("relation_transformer")
@register_model("relation_transformer_prune")
class RelationTransformer(Transformer):
    """ORT: box-relation encoder + cached transformer decoder."""

    COLLATE_FIELDS = ("att_feats", "att_masks", "boxes")

    def __init__(self, *args, box_trigonometric_embedding: bool = True, **kwargs):
        self.box_trigonometric_embedding = box_trigonometric_embedding  # _build_encoder (Transformer.__init__) reads it
        super().__init__(*args, **kwargs)

    def _build_encoder(self, att_feat_size, dim_feedforward, share_att, factory):
        n_enc, self.box_enc_plan = _unique_layer_plan(self.num_layers, self.share_layer_encoder)
        self.box_encoder_layers = nn.ModuleList(
            BoxEncoderLayer(self.d_model, self.num_heads, dim_feedforward, self.dropout_rate, share_att,
                            self.mask_cfg, self.box_trigonometric_embedding, **factory)
            for _ in range(n_enc))
        self.att_embed = MaskedLinear(att_feat_size, self.d_model, mask_cfg=self.mask_cfg, **factory)
        self.box_encoder_norm = RefLayerNorm(self.d_model, **factory)

    def _encoder_masked(self) -> list:
        return masked_call_order(self.att_embed, *(self.box_encoder_layers[i] for i in self.box_enc_plan))

    def encode(self, att_feats, att_masks, boxes=None, train: bool = False, rng=None) -> Dict[str, Any]:
        """att_feats: (B, R, F); att_masks: (B, R), 0 = padded; boxes: (B, R, 4)."""
        if boxes is None:
            raise ValueError("relation_transformer requires boxes")
        rng = train_rng(train, rng)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()), mask_set(self._encoder_masked(), rng):
            x = dropout(torch.relu(self.att_embed(att_feats, rng)), self.drop_prob_src, rng, self.site)
            mask = (att_masks != 0).contiguous()
            boxes = boxes.float().contiguous()
            steps = [s for i, k in plan_slots(self.box_enc_plan)
                     for s in self.box_encoder_layers[i].steps(boxes, mask, slot_rng(rng, k))]
            return {"memory": prenorm_stack(x, steps, self.box_encoder_norm), "mask": att_masks}

    @classmethod
    def from_config(cls, config, mask_cfg=None, **factory):
        return super().from_config(config, mask_cfg, **factory,
                                   box_trigonometric_embedding=not config.get("no_box_trigonometric_embedding", False))
