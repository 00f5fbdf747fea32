"""Weight bridge: the JAX package's variables -> the port's ``state_dict``.

Input is ``{"params": ..., "masks": ...}`` as nested dicts of numpy arrays
(convert flax arrays with ``np.asarray`` first; this module imports no JAX).
Flax leaf paths become parameter names:

* ``decoder_layers_3/self_attn/q_proj/kernel`` -> ``decoder_layers.3.self_attn.q_proj.weight``
  (``*_layers_N`` lists, and Up-Down's ``logit_N`` setup list, become
  ModuleList indices)
* Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed here, once;
  ``wg`` stays one (64, h) projection, i.e. a (h, 64) weight
* ``embedding`` -> ``weight``; RefLayerNorm ``scale`` -> ``weight``; ``bias`` -> ``bias``
* masks (same paths, leaf ``mask``) are folded into their weights with the
  eval semantics of ``ops/masked.py`` and do not appear in the result (serving);
  with ``fold_masks=False`` each becomes ``<module>.mask``, transposed like its
  kernel, for a model built with ``MaskConfig(keep_masks=True)`` (training)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sparse_caption_tpu_torch.ops.masked import MaskConfig, fold_mask

_LAYER_LIST = re.compile(r"^(\w+_layers|logit)_(\d+)$")
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _module_name(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path:
        m = _LAYER_LIST.match(p)
        parts.extend(m.groups() if m else (p,))
    return ".".join(parts)


def flax_path(name: str) -> Tuple[str, ...]:
    """The flax path of a port parameter name, the inverse of ``_module_name``:
    ``decoder_layers.0.self_attn.q_proj.mask`` -> ``("decoder_layers_0",
    "self_attn", "q_proj", "mask")``."""
    parts = []
    for p in name.split("."):
        if p.isdigit() and parts and _LAYER_LIST.match(f"{parts[-1]}_{p}"):
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(p)
    return tuple(parts)


def convert_jax_variables(variables: Mapping, mask_cfg: Optional[MaskConfig] = None,
                          fold_masks: bool = True) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "masks"}`` (numpy leaves) -> the port's state_dict (CPU tensors)."""
    params = _flatten(variables["params"])
    masks = _flatten(variables.get("masks", {}))
    if masks and fold_masks and mask_cfg is None:
        raise ValueError("variables carry masks; pass the model's MaskConfig to fold them")
    used = set()
    state = {}
    for path, arr in params.items():
        leaf = path[-1]
        if leaf not in _LEAF:
            raise KeyError(f"unknown flax leaf {'/'.join(path)}")
        t = torch.from_numpy(np.array(arr, copy=True))
        mask_path = path[:-1] + ("mask",)
        if leaf in ("kernel", "embedding") and mask_path in masks:
            m = torch.from_numpy(np.array(masks[mask_path], copy=True))
            if fold_masks:
                t = fold_mask(t, m, mask_cfg)
            else:
                state[".".join(filter(None, (_module_name(path[:-1]), "mask")))] = (
                    m.T.contiguous() if leaf == "kernel" else m)
            used.add(mask_path)
        if leaf == "kernel":
            t = t.T.contiguous()
        state[".".join(filter(None, (_module_name(path[:-1]), _LEAF[leaf])))] = t
    unused = set(masks) - used
    if unused:
        raise KeyError(f"masks without a kernel: {sorted('/'.join(p) for p in unused)}")
    return state


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load converted JAX variables into ``model`` (strict): masks folded, or
    kept as parameters when the model's MaskConfig says ``keep_masks``."""
    cfg = model.mask_cfg
    keep = cfg is not None and cfg.keep_masks
    model.load_state_dict(convert_jax_variables(variables, cfg, fold_masks=not keep))
    return model
