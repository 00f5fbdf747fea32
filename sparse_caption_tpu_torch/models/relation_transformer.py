"""Object Relation Transformer, eval mode (port of
``sparse_caption_tpu/models/relation_transformer.py``).

Encoder: ``att_embed`` (Linear + ReLU) then box-relation self-attention
layers (kernel K1) over the region features; decoder, PE, generator and
caching are the caption Transformer's.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from sparse_caption_tpu_torch import check_eval
from sparse_caption_tpu_torch.models import register_model
from sparse_caption_tpu_torch.models.layers import (
    BoxMultiHeadAttention,
    PositionwiseFeedForward,
    RefLayerNorm,
    SublayerConnection,
)
from sparse_caption_tpu_torch.models.transformer import Transformer, _unique_layer_plan
from sparse_caption_tpu_torch.ops.masked import MaskedLinear


class BoxEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int, share_att=None, mask_cfg=None, **factory):
        super().__init__()
        self.self_attn = BoxMultiHeadAttention(num_heads, d_model, share_att, mask_cfg, **factory)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, mask_cfg, **factory)
        self.sub0 = SublayerConnection(d_model, **factory)
        self.sub1 = SublayerConnection(d_model, **factory)

    def forward(self, x, boxes, mask):
        x = self.sub0(x, lambda y: self.self_attn(y, boxes, mask))
        return self.sub1(x, self.feed_forward)


@register_model("relation_transformer")
@register_model("relation_transformer_prune")
class RelationTransformer(Transformer):
    """ORT: box-relation encoder + cached transformer decoder."""

    def _build_encoder(self, att_feat_size, dim_feedforward, share_att, factory):
        _, self.box_enc_plan = _unique_layer_plan(self.num_layers, None)
        self.box_encoder_layers = nn.ModuleList(
            BoxEncoderLayer(self.d_model, self.num_heads, dim_feedforward, share_att, self.mask_cfg, **factory)
            for _ in self.box_enc_plan)
        self.att_embed = MaskedLinear(att_feat_size, self.d_model, mask_cfg=self.mask_cfg, **factory)
        self.box_encoder_norm = RefLayerNorm(self.d_model, **factory)

    @torch.no_grad()
    def encode(self, att_feats, att_masks, boxes=None, train: bool = False) -> Dict[str, Any]:
        """att_feats: (B, R, F); att_masks: (B, R), 0 = padded; boxes: (B, R, 4)."""
        check_eval(train)
        if boxes is None:
            raise ValueError("relation_transformer requires boxes")
        x = torch.relu(self.att_embed(att_feats))
        mask = (att_masks != 0).contiguous()
        boxes = boxes.float().contiguous()
        for i in self.box_enc_plan:
            x = self.box_encoder_layers[i](x, boxes, mask)
        return {"memory": self.box_encoder_norm(x), "mask": att_masks}
