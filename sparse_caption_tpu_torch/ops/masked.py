"""Masked (prunable) layers.

Port of ``sparse_caption_tpu/ops/masked.py``. The forward of a masked layer
multiplies its weight by a 0/1 sample of the mask:

* supermask, train: ``w * [u < sigmoid(m)]`` (a Bernoulli draw, ``u`` fresh
  per forward and layer), straight-through to ``m``; eval:
  ``w * round(sigmoid(m))``
* every other mask type: ``w * m``

A layer built for serving (``MaskConfig.keep_masks=False``) has no mask: the
eval sample is folded into the weight ONCE, at load (``fold_mask`` /
``fold_mask_``), and the layer runs as a plain Linear / Embedding. A layer
built for training keeps its mask as a separate f32 parameter ``mask`` in
the weight's layout (the JAX package's ``"masks"`` collection), and the
product runs in kernel K5 (``kernels/supermask.py``) on every forward. A
model's forward runs the products of the layers it calls as one set
(``mask_set``): one K5 launch each way for all of them.

A training supermask draws its sample from the forward's random source
(``rng.mask_draw``): uniforms from a ``TrainRandom`` (XE, K5's sample
mode), or a ``KeyedDraw`` from a ``KeyedStream`` (SCST, K5's keyed mode,
which makes the uniforms in the kernel from the layer's ``mask_site``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_caption_tpu_torch.kernels.supermask import MAX_SET, KeyedDraw, supermask_weight, supermask_weights
from sparse_caption_tpu_torch.pruning import SUPER_MASKS, VALID_MASKS


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Per-model pruning configuration threaded into prunable layers.

    ``keep_masks``: keep each mask as a trainable parameter (training, or
    loading masks unfolded) instead of folding it into the weight at load."""

    mask_type: str
    mask_init_value: float = 1.0
    bypass_sigmoid_grad: bool = False
    keep_masks: bool = False

    def __post_init__(self):
        if self.mask_type not in VALID_MASKS:
            raise ValueError(f"mask_type must be one of {VALID_MASKS}, got `{self.mask_type}`")

    @property
    def is_supermask(self) -> bool:
        return self.mask_type in SUPER_MASKS


def mask_sample(mask: torch.Tensor, cfg: MaskConfig) -> torch.Tensor:
    """Eval-mode multiplicative 0/1 sample of a mask tensor (f32)."""
    mask = mask.float()
    return torch.round(torch.sigmoid(mask)) if cfg.is_supermask else mask


def fold_mask(weight: torch.Tensor, mask: torch.Tensor, cfg: MaskConfig) -> torch.Tensor:
    """``weight * sample(mask)`` in the weight's dtype (exact: a 0/1 product)."""
    return (weight.float() * mask_sample(mask.to(weight.device), cfg)).to(weight.dtype)


def xavier_uniform_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot-uniform init of a 2-D tensor (the JAX package's ``xavier_uniform``;
    symmetric in fan-in/fan-out, so the (out, in) layout gives the same bound)."""
    bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def sample_mode(draws) -> str:
    """The K5 mode of a training supermask's draws: "keyed" for
    ``KeyedDraw``s, "sample" for uniform tensors (one kind a set)."""
    keyed = {isinstance(d, KeyedDraw) for d in draws}
    if len(keyed) > 1:
        raise ValueError("a set takes keyed draws or uniform tensors, not both")
    return "keyed" if keyed.pop() else "sample"


class _Prunable(nn.Module):
    mask_cfg: Optional[MaskConfig]
    mask_site: Optional[int] = None  # the 32-bit site of its keyed supermask draws (assign_mask_sites)

    def _init_mask(self) -> None:
        cfg = self.mask_cfg
        if cfg is None or not cfg.keep_masks:
            self.register_parameter("mask", None)
            return
        self.mask = nn.Parameter(torch.empty(self.weight.shape, device=self.weight.device, dtype=torch.float32))
        self._reset_mask()

    def _reset_mask(self) -> None:
        if self.mask is not None:
            nn.init.constant_(self.mask, self.mask_cfg.mask_init_value if self.mask_cfg.is_supermask else 1.0)

    @torch.no_grad()
    def fold_mask_(self, mask: torch.Tensor) -> None:
        """Fold a mask (in the weight's layout) into the weight, in place."""
        if self.mask_cfg is None:
            raise ValueError("layer has no mask config")
        if self.mask is not None:
            raise ValueError("layer keeps its mask as a parameter; build it with keep_masks=False to fold")
        if mask.shape != self.weight.shape:
            raise ValueError(f"mask shape {tuple(mask.shape)} != weight shape {tuple(self.weight.shape)}")
        self.weight.copy_(fold_mask(self.weight, mask, self.mask_cfg))

    def _per_call_mode(self, rng) -> Optional[str]:
        """The K5 mode of this layer's product where it runs on every call
        (a training supermask's sample, or a deterministic sample under
        autograd), else None (no kept mask, or a deterministic sample
        without autograd: the cached one)."""
        if self.mask is None:
            return None
        if self.mask_cfg.is_supermask and rng is not None:
            return "sample"
        if not torch.is_grad_enabled():
            return None
        return "round" if self.mask_cfg.is_supermask else "multiply"

    def effective_weight(self, rng=None) -> torch.Tensor:
        """The weight times the mask's sample (kernel K5), or the (folded)
        weight itself. ``rng``: a ``TrainRandom`` or ``KeyedStream`` in
        training, None in eval. Inside a ``mask_set`` that holds this layer,
        its product from the set's launch (the next one, for a layer the
        forward calls more than once).

        A deterministic sample (every mask type but a training supermask)
        computed without autograd is kept and reused until the weight or the
        mask changes (new storage or version): a decode then runs K5 once
        per tensor, not once per step."""
        from_set = self.__dict__.get("_set_w_eff")
        if from_set is not None:
            w = from_set.pop(0)
            if not from_set:
                del self.__dict__["_set_w_eff"]
            return w
        cfg = self.mask_cfg
        if self.mask is None:
            if rng is not None and cfg is not None:
                raise ValueError("this layer's mask was folded at load; build the model with "
                                 "MaskConfig(keep_masks=True) to train it")
            return self.weight
        mode = self._per_call_mode(rng)
        if mode is not None:
            u = rng.mask_draw(self, self.weight.shape, self.weight.device) if mode == "sample" else None
            mode = sample_mode([u]) if mode == "sample" else mode
            return supermask_weight(self.weight, self.mask, u, mode, cfg.bypass_sigmoid_grad)
        mode = "round" if cfg.is_supermask else "multiply"
        key = (self.weight.data_ptr(), self.weight._version, self.mask.data_ptr(), self.mask._version)
        if getattr(self, "_w_eff_key", None) != key:
            self._w_eff = supermask_weight(self.weight, self.mask, None, mode, cfg.bypass_sigmoid_grad)
            self._w_eff_key = key
        return self._w_eff


def assign_mask_sites(model: nn.Module) -> None:
    """Set every masked layer's ``mask_site``: the ``site_id`` of its qualified name."""
    from sparse_caption_tpu_torch.ops.rng import site_id

    for name, m in model.named_modules():
        if isinstance(m, _Prunable):
            m.mask_site = site_id(name)


def masked_call_order(*modules) -> list:
    """The masked layers under ``modules`` in the order their forwards call
    them: a masked layer itself, else the children its ``MASKED_CALL_ORDER``
    names, in turn (a module without one holds none)."""
    out = []
    for m in modules:
        if isinstance(m, _Prunable):
            out.append(m)
        else:
            out += masked_call_order(*(getattr(m, name) for name in getattr(m, "MASKED_CALL_ORDER", ())))
    return out


@contextlib.contextmanager
def mask_set(layers: Iterable[_Prunable], rng=None):
    """Run the masked products of ``layers`` as one set: one K5 launch each
    way (``supermask_weights``) in place of one a layer. ``layers`` in the
    order the forward calls them, a layer once per call (a shared layer's
    slots, a "qk" layer's ``q_proj``): a training supermask draws each call's
    uniforms from ``rng`` in that order, as the layers' own calls would, and
    the calls of one layer take its products in turn; a deterministic sample
    is computed once a layer and serves all its calls. Inside the context
    each layer's next ``effective_weight`` returns its product from the set;
    layers already in an open set, and layers whose product would be cached
    or folded (``_per_call_mode``), are left out."""
    if rng is None and not torch.is_grad_enabled():  # eval: every product is cached or folded
        yield
        return
    todo = [m for m in layers if "_set_w_eff" not in m.__dict__]
    modes = {m: m._per_call_mode(rng) for m in todo}
    todo = [m for m in todo if modes[m] is not None]
    if len({modes[m] for m in todo}) > 1:
        raise ValueError(f"a set takes one K5 mode; got {sorted({modes[m] for m in todo})}")
    calls = {}
    for m in todo:
        calls[m] = calls.get(m, 0) + 1
    try:
        if todo:
            mode = modes[todo[0]]
            sampled = mode == "sample"
            entries = todo if sampled else list(calls)
            us = [rng.mask_draw(m, m.weight.shape, m.weight.device) for m in entries] if sampled else None
            mode = sample_mode(us) if sampled else mode
            products = {m: [] for m in calls}
            for i in range(0, len(entries), MAX_SET):  # sets of more than MAX_SET products: one launch a chunk
                chunk = entries[i:i + MAX_SET]
                w_effs = supermask_weights([m.weight for m in chunk], [m.mask for m in chunk],
                                           None if us is None else us[i:i + MAX_SET], mode,
                                           chunk[0].mask_cfg.bypass_sigmoid_grad)
                for m, w in zip(chunk, w_effs):
                    products[m].append(w)
            del us
            for m, ws in products.items():
                m._set_w_eff = ws if sampled else ws * calls[m]
        yield
    finally:
        for m in calls:
            m.__dict__.pop("_set_w_eff", None)


class MaskedLinear(_Prunable):
    """Dense layer; ``weight`` is (out, in), and so is ``mask`` when kept."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 mask_cfg: Optional[MaskConfig] = None, device=None, dtype=None):
        super().__init__()
        self.mask_cfg = mask_cfg
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype)) if bias else None
        self._init_mask()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        xavier_uniform_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self._reset_mask()

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        return F.linear(x, self.effective_weight(rng), self.bias)


class MaskedEmbedding(_Prunable):
    """Embedding table (num_embeddings, features) with a foldable or kept mask."""

    def __init__(self, num_embeddings: int, features: int, mask_cfg: Optional[MaskConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        self.mask_cfg = mask_cfg
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, device=device, dtype=dtype))
        self._init_mask()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        xavier_uniform_(self.weight, generator)
        self._reset_mask()

    def forward(self, ids: torch.Tensor, rng=None) -> torch.Tensor:
        return F.embedding(ids, self.effective_weight(rng))


def split_params(model: nn.Module):
    """(params, masks): the model's parameters by name, masks (the kept
    ``mask`` of every prunable layer) apart from the rest."""
    mask_ids = {id(m.mask) for m in model.modules() if isinstance(m, _Prunable) and m.mask is not None}
    params, masks = {}, {}
    for name, p in model.named_parameters():
        (masks if id(p) in mask_ids else params)[name] = p
    return params, masks
