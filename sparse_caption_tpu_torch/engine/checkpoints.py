"""Checkpoints of the port (port of ``sparse_caption_tpu/engine/checkpoints.py``).

The port's own artifacts are ``torch.save`` files, ``<log_dir>/model_<tag>.pt``
(``model_init``, ``model_last``, ``model_best``, and the prune exports
``model_best_pruned`` / ``model_best_bin_mask``): ``{"params": {name:
tensor}, "masks": {name: tensor}, "step": updates done}`` with the model's
parameter names (``ops.masked.split_params``), on the CPU.

The JAX package's ``model_<tag>.msgpack`` files (flax msgpack pytrees of
``{"params", "masks"}``) are read too, without flax (``read_flax_msgpack``,
which needs the ``msgpack`` package) and converted by ``utils.convert_jax``:
a lottery run can rewind to a JAX run's ``model_init`` and a mask_freeze run
start from its ``model_best_bin_mask``. Its ``*.orbax`` directories are
out of reach.

``restore_lenient`` keeps the reference's rule: missing, extra or misshapen
keys go to ``restore_log.txt`` and do not fail the load.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparse_caption_tpu_torch.ops.masked import split_params
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables

logger = logging.getLogger(__name__)

PT_SUFFIX, MSGPACK_SUFFIX, ORBAX_SUFFIX = ".pt", ".msgpack", ".orbax"
_NDARRAY_EXT, _NPSCALAR_EXT = 1, 3  # flax serialization's msgpack ext type codes
_CHUNKED = "__msgpack_chunked_array__"


def find_ckpt(dirname: str, stem: str) -> str:
    """``<dirname>/<stem>.pt``, or the JAX package's ``.msgpack`` of that stem;
    where both exist the newer wins. With neither, the ``.pt`` path (so that
    the caller's error names it)."""
    pt, msg = (os.path.join(dirname, stem + s) for s in (PT_SUFFIX, MSGPACK_SUFFIX))
    has_pt, has_msg = os.path.isfile(pt), os.path.isfile(msg)
    if has_pt and has_msg:
        pick = pt if os.path.getmtime(pt) >= os.path.getmtime(msg) else msg
        logger.warning("both %s and %s exist; picking newer: %s", pt, msg, pick)
        return pick
    return msg if has_msg else pt


def save_variables(path: str, params: Mapping[str, torch.Tensor], masks: Mapping[str, torch.Tensor],
                   step: int = 0) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    torch.save({"params": cpu(params), "masks": cpu(masks), "step": int(step)}, path)
    return path


def save_checkpoint(path: str, model: nn.Module, step: int = 0) -> str:
    """The model's params and kept masks and the update count ``step`` into ``path`` (``model_<tag>.pt``)."""
    params, masks = split_params(model)
    return save_variables(path, params, masks, step)


def _unpack_ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":  # no numpy dtype: widen the bits to f32 exactly
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape).copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = tree["chunks"]
            return np.concatenate([chunks[str(i)] for i in range(len(chunks))]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax_msgpack(path: str) -> Dict:
    """A flax ``serialization.to_bytes`` file as nested dicts of numpy arrays:
    msgpack with ndarrays as ext type 1 (a packed (shape, dtype name, C-order
    bytes) triple), numpy scalars as ext type 3, and arrays over 2^30 bytes
    split into ``__msgpack_chunked_array__`` dicts."""
    try:
        import msgpack
    except ImportError as exc:  # the reader is the only user of msgpack in the port
        raise ImportError(f"reading {path} (a JAX package checkpoint) needs the `msgpack` package") from exc

    def ext_hook(code, data):
        if code == _NDARRAY_EXT:
            return _unpack_ndarray(data)
        if code == _NPSCALAR_EXT:
            return _unpack_ndarray(data)[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def load_checkpoint(path: str) -> Dict:
    """``{"params", "masks", "step"}`` of a checkpoint, by the port's
    parameter names: a ``.pt`` file as saved, a JAX ``.msgpack`` converted
    (masks unfolded, in the port's layouts; step 0)."""
    if path.endswith(ORBAX_SUFFIX) or os.path.isdir(path):
        raise ValueError(f"{path}: orbax checkpoints are not readable by the port")
    if path.endswith(MSGPACK_SUFFIX):
        tree = read_flax_msgpack(path)
        state = convert_jax_variables({"params": tree.get("params", {}), "masks": tree.get("masks", {})},
                                      fold_masks=False)
        masks = {k: v for k, v in state.items() if k == "mask" or k.endswith(".mask")}
        return {"params": {k: v for k, v in state.items() if k not in masks}, "masks": masks, "step": 0}
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_lenient(model: nn.Module, path: str, restore_log: Optional[str] = None
                    ) -> Tuple[int, List[str], List[str]]:
    """Copy every parameter and kept mask of ``path`` that ``model`` has, at
    its shape, into ``model``. Returns (the checkpoint's update count,
    missing, unexpected): names the model has and the checkpoint lacks (or
    holds at another shape), and names only the checkpoint has; both are
    appended to ``restore_log`` when given."""
    ckpt = load_checkpoint(path)
    saved = {**ckpt["params"], **ckpt.get("masks", {})}
    target = dict(model.named_parameters())
    missing = sorted(set(target) - set(saved))
    unexpected = sorted(set(saved) - set(target))
    for name in sorted(set(target) & set(saved)):
        if tuple(target[name].shape) != tuple(saved[name].shape):
            missing.append(f"{name} (shape mismatch {tuple(saved[name].shape)} vs {tuple(target[name].shape)})")
            continue
        target[name].copy_(saved[name])
    if restore_log and (missing or unexpected):
        os.makedirs(os.path.dirname(restore_log) or ".", exist_ok=True)
        with open(restore_log, "a") as f:
            if missing:
                f.write(f"Checkpoint `{path}` is missing parameters:\n" + "\n".join(missing) + "\n\n")
            if unexpected:
                f.write(f"Checkpoint `{path}` contains extra parameters:\n" + "\n".join(unexpected) + "\n\n")
        logger.info("restore: %d missing, %d unexpected keys (see %s)", len(missing), len(unexpected), restore_log)
    return int(ckpt.get("step", 0)), missing, unexpected
