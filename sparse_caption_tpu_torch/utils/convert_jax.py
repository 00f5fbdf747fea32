"""Weight bridge: the JAX package's variables -> the port's ``state_dict``.

Input is ``{"params": ..., "masks": ...}`` as nested dicts of numpy arrays
(convert flax arrays with ``np.asarray`` first; this module imports no JAX).
Flax leaf paths become parameter names:

* ``decoder_layers_3/self_attn/q_proj/kernel`` -> ``decoder_layers.3.self_attn.q_proj.weight``
  (``*_layers_N`` lists, and Up-Down's ``logit_N`` setup list, become
  ModuleList indices)
* Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed here, once;
  ``wg`` stays one (dim_g, h) projection, i.e. a (h, 64) weight, or (h, 4) for
  the raw geometry (``--no_box_trigonometric_embedding``)
* ``embedding`` -> ``weight``; RefLayerNorm ``scale`` -> ``weight``; ``bias`` -> ``bias``
* masks (same paths, leaf ``mask``) are folded into their weights with the
  eval semantics of ``ops/masked.py`` and do not appear in the result (serving);
  with ``fold_masks=False`` each becomes ``<module>.mask``, transposed like its
  kernel, for a model built with ``MaskConfig(keep_masks=True)`` (training)

``to_jax_variables`` goes the other way: a port model's parameters as the
JAX package's ``{"params", "masks"}`` tree, flax names and layouts.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedEmbedding, MaskedLinear, fold_mask

_LAYER_LIST = re.compile(r"^(\w+_layers|logit)_(\d+)$")
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    """{path tuple: numpy leaf} of a nested dict."""
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
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


def to_jax_layout(t: torch.Tensor, transposed: bool) -> np.ndarray:
    """A port tensor as a C-ordered numpy array in the JAX layout (``jax_leaf``'s
    ``transposed``: a Dense kernel or its mask, (out, in) -> (in, out))."""
    t = t.detach().cpu()
    return (t.T if transposed else t).contiguous().numpy()


def from_jax_layout(arr: np.ndarray, transposed: bool) -> torch.Tensor:
    """The inverse of ``to_jax_layout``: a JAX-layout array as a CPU tensor in the port's layout."""
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.T.contiguous() if transposed else t


def convert_jax_variables(variables: Mapping, mask_cfg: Optional[MaskConfig] = None,
                          fold_masks: bool = True) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "masks"}`` (numpy leaves) -> the port's state_dict (CPU tensors)."""
    params = flatten_tree(variables["params"])
    masks = flatten_tree(variables.get("masks", {}))
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
            if fold_masks:
                t = fold_mask(t, torch.from_numpy(np.array(masks[mask_path], copy=True)), mask_cfg)
            else:
                state[".".join(filter(None, (_module_name(path[:-1]), "mask")))] = from_jax_layout(
                    masks[mask_path], leaf == "kernel")
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


def jax_leaf(module: torch.nn.Module, name: str) -> Tuple[str, bool]:
    """(flax leaf name, transposed) of parameter ``name`` of ``module``: a
    Dense kernel or its kept mask is transposed, (out, in) -> (in, out)."""
    if name == "mask":
        return "mask", isinstance(module, MaskedLinear)
    if name == "weight":
        if isinstance(module, MaskedLinear):
            return "kernel", True
        return ("embedding" if isinstance(module, MaskedEmbedding) else "scale"), False
    return name, False


def to_jax_variables(model: torch.nn.Module) -> Dict[str, Dict]:
    """The inverse of ``convert_jax_variables(fold_masks=False)``: the model's
    parameters as nested dicts of numpy arrays, ``{"params": ..., "masks":
    ...}``, by flax path and in the JAX package's layouts."""
    out: Dict[str, Dict] = {"params": {}, "masks": {}}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            leaf, transposed = jax_leaf(module, name)
            path = flax_path(".".join(filter(None, (mod_name, name))))[:-1] + (leaf,)
            arr = to_jax_layout(p, transposed)
            node = out["masks" if leaf == "mask" else "params"]
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = arr
    return out
