"""Random draws of a training forward (the JAX package's ``"mask"`` and
``"dropout"`` rng streams).

Two random sources can be handed to a train-mode forward; ``None`` in their
place means eval.

* ``TrainRandom`` (the XE step): every draw comes from one ``torch.Generator``
  in call order: ``mask_uniform`` gives the uniforms ``u`` of a supermask
  sample ``[u < sigmoid(m)]``, ``keep_mask`` a dropout keep-mask
  ``u < keep_prob``. Tests subclass it to replay the JAX side's uniforms.
  A masked layer asks for its sample's draw by ``mask_draw``, which is
  ``mask_uniform`` here.
* ``KeyedStream`` (SCST): a counter-based stream, so a draw does not depend
  on call order or device. A dropout site's keep-mask is a pure function of
  (key, site, t, row, column): Philox4x32-10 (kernel K8) keyed by the
  64-bit key, counter (site, t, row, column // 4). A tensor of shape
  ``(N, *mid, D)`` is read as (N, T, D) with T = prod(mid): row n, position
  j draws at t = j (the replay of ``TimeDropout``, ``models/layers.py:31-68``
  of the JAX package); a step view ``stream.at(t)`` draws a (N, 1, D)
  tensor at step t. Both give the same bits for the same (site, t, row,
  column), which is what makes the SCST teacher-forced replay equal the
  sampling decode. Sites are 32-bit ids from the module's qualified name
  (``site_id``). A layer that a ``share_layer`` plan calls at several slots
  draws at each slot under a site of its own: ``stream.for_slot(k)`` views
  the stream at slot k, whose draws use ``slot_site(site, k)`` (slot 0 and
  every unshared layer keep the module's site), so the JAX package's fresh
  dropout per call of a shared layer holds, and the decode and the replay
  derive the same site for the same slot. A supermask sample is keyed too
  (supermask SCST: the gradient pass redraws every decode step's masks):
  ``mask_draw`` gives a layer's ``KeyedDraw`` (key, site, t), which kernel
  K5's keyed mode turns into uniforms in registers: element e of the
  weight, in the port's (out, in) layout, draws Philox4x32-10 under the key
  with counter (site, t, e // 4, 0). The site is the layer's ``mask_site``
  (``ops/masked.py assign_mask_sites``: ``site_id`` of its qualified name),
  under ``slot_site`` at a slot view; t is the step view's, 0 outside one
  (the encode, and the cross K/V projection of ``init_cache(train=True)``,
  each under a key of its own). ``mask_uniform`` gives the same uniforms as
  a tensor (the plain Philox); tests subclass the stream and override
  ``mask_draw`` to hand in the JAX side's uniforms.

Both divide a kept value by the keep probability rounded to its dtype, as
the JAX package does (``ops/keep.py``).
"""

from __future__ import annotations

import copy
import math
import zlib
from typing import NamedTuple, Optional

import torch
from torch import nn

from sparse_caption_tpu_torch.kernels.keyed_dropout import keyed_dropout, keyed_keep_mask
from sparse_caption_tpu_torch.kernels.supermask import KeyedDraw
from sparse_caption_tpu_torch.ops.keep import apply_keep

M64 = (1 << 64) - 1


class TrainRandom:
    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _uniform(self, shape, device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)
        return u.to(device)

    def mask_uniform(self, layer: nn.Module, shape, device) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ``layer``'s mask (the weight's layout)."""
        return self._uniform(shape, device)

    def mask_draw(self, layer: nn.Module, shape, device) -> torch.Tensor:
        """The draw of ``layer``'s supermask sample: its uniforms, in call order."""
        return self.mask_uniform(layer, shape, device)

    def keep_mask(self, shape, keep_prob: float, device, site: Optional[int] = None) -> torch.Tensor:
        return self._uniform(shape, device) < keep_prob

    def dropout(self, x: torch.Tensor, keep_prob: float, site: Optional[int] = None) -> torch.Tensor:
        return apply_keep(x, self.keep_mask(x.shape, keep_prob, x.device, site), keep_prob)


def site_id(name: str) -> int:
    """The 32-bit id of a dropout site, from its qualified module name."""
    return zlib.crc32(name.encode())


def slot_site(site: int, slot: int) -> int:
    """The site of a module's draws at slot ``slot`` of a layer plan: the
    module's own at slot 0, a 32-bit id derived from it and the slot after."""
    return int(site) if slot == 0 else zlib.crc32(b"slot %d" % slot, int(site))


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def derive_key(seed: int, *tags: int) -> int:
    """A 64-bit key from a seed and integer tags (splitmix64 chain)."""
    k = splitmix64(seed & M64)
    for tag in tags:
        k = splitmix64(k ^ (tag & M64))
    return k


class KeyedStream:
    def __init__(self, key: int, t: Optional[int] = None, slot: int = 0):
        self.key = int(key) & M64
        self.t = t
        self.slot = int(slot)

    def _view(self, t: Optional[int], slot: int) -> "KeyedStream":
        view = copy.copy(self)  # a subclass's own state comes along
        view.t, view.slot = t, int(slot)
        return view

    def at(self, t: int) -> "KeyedStream":
        """The step view at decode step ``t``."""
        return self._view(int(t), self.slot)

    def for_slot(self, slot: int) -> "KeyedStream":
        """The view for the ``slot``-th call of a shared layer in one pass."""
        return self._view(self.t, slot)

    def _layout(self, shape):
        n, d = int(shape[0]), int(shape[-1])
        tl = math.prod(int(s) for s in shape[1:-1])
        if self.t is not None and tl != 1:
            raise ValueError(f"a step view draws (N, 1, D); got shape {tuple(shape)}")
        return n, tl, d, 0 if self.t is None else self.t

    def _site(self, site: Optional[int]) -> int:
        if site is None:
            raise ValueError("a keyed draw needs its dropout site id")
        return slot_site(site, self.slot)

    def keep_mask(self, shape, keep_prob: float, device, site: Optional[int] = None) -> torch.Tensor:
        n, tl, d, t0 = self._layout(shape)
        keep = keyed_keep_mask(self.key, self._site(site), t0, n, tl, d, keep_prob, device)
        return keep.reshape(tuple(shape))

    def dropout(self, x: torch.Tensor, keep_prob: float, site: Optional[int] = None) -> torch.Tensor:
        n, tl, d, t0 = self._layout(x.shape)
        out = keyed_dropout(x.reshape(n, tl, d).contiguous(), self.key, self._site(site), t0, keep_prob)
        return out.reshape(x.shape)

    def mask_draw(self, layer: nn.Module, shape, device) -> KeyedDraw:
        """``layer``'s supermask draw: (key, its site at this view's slot, t)."""
        site = getattr(layer, "mask_site", None)
        if site is None:
            raise ValueError("a keyed mask draw needs the layer's mask_site (ops/masked.py assign_mask_sites)")
        return KeyedDraw(self.key, slot_site(site, self.slot), 0 if self.t is None else self.t)

    def mask_uniform(self, layer: nn.Module, shape, device) -> torch.Tensor:
        """The uniforms of ``layer``'s keyed draw as a tensor (the plain Philox)."""
        return KeyedStream.mask_draw(self, layer, shape, device).uniform(shape, device)


class DecodeKeys(NamedTuple):
    sample: int  # Gumbel noise of the sampling step (kernel K9), under SAMPLE_SITE
    dropout: int  # the decoder's keyed dropout (step mode in the decode, replay in the gradient pass)
    cache: int  # the cross K/V projection of ``init_cache(train=True)``


SAMPLE_SITE = site_id("sample")


def decode_train_keys(seed: int) -> DecodeKeys:
    """The streams of a train-mode decode, derived from one seed (the JAX
    package's ``decoding/api.py decode_train_keys``). The SCST gradient pass
    derives the same dropout key to replay the decode."""
    return DecodeKeys(derive_key(seed, 1), derive_key(seed, 2), derive_key(seed, 3))


def slot_rng(rng, slot: int):
    """``rng`` as the layer at slot ``slot`` of a plan draws from it: a keyed
    stream's slot view; call-order sources (``TrainRandom``) and eval's None
    as they are."""
    return rng.for_slot(slot) if isinstance(rng, KeyedStream) else rng


def dropout(x: torch.Tensor, rate: float, rng, site: Optional[int] = None) -> torch.Tensor:
    """Dropout: ``x / keep`` where kept, 0 elsewhere; the identity in eval
    (``rng=None``) or at rate 0. ``site`` keys a ``KeyedStream``'s draw."""
    if rng is None or rate == 0.0:
        return x
    return rng.dropout(x, 1.0 - rate, site)


def keep_mask(shape, rate: float, rng, device, site: Optional[int] = None):
    """The keep-mask a fused kernel applies itself, or None (eval, rate 0)."""
    if rng is None or rate == 0.0:
        return None
    return rng.keep_mask(shape, 1.0 - rate, device, site)
