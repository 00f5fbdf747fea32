"""Shared set-up of the port's parity tests: tiny ORT/Transformer configs, numpy
inputs from a seed, JAX variables from ``init`` and their conversion into the
PyTorch port (``sparse_caption_tpu_torch``), everything on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sparse_caption_tpu.ops.masked import MaskConfig as JaxMaskConfig
from sparse_caption_tpu_torch.models import get_model as port_get_model
from sparse_caption_tpu_torch.ops.masked import MaskConfig
from sparse_caption_tpu_torch.utils.convert_jax import load_jax_variables

V, D, FF, F, R, LAYERS, HEADS, T = 48, 32, 64, 8, 5, 2, 4, 7
KW = dict(vocab_size=V, d_model=D, dim_feedforward=FF, num_layers=LAYERS, num_heads=HEADS, att_feat_size=F,
          max_seq_length=T - 1)


def make_inputs(seed: int = 0, batch: int = 2):
    """att (B, R, F), att mask (B, R) with region R-1 of image 1 padded, pixel
    boxes (B, R, 4), BOS-led seqs (B, T) with pads."""
    rng = np.random.default_rng(seed)
    att = rng.normal(size=(batch, R, F)).astype(np.float32)
    amask = np.ones((batch, R), np.float32)
    amask[1, R - 1] = 0.0
    xy = rng.uniform(0, 400, size=(batch, R, 2))
    wh = rng.uniform(10, 200, size=(batch, R, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    seqs = rng.integers(4, V, size=(batch, T)).astype(np.int32)
    seqs[:, 0] = 2
    seqs[0, 5:] = [3, 0]
    seqs[1, 4:] = [3, 0, 0]
    return att, amask, boxes, seqs


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_variables(jax_model, inputs, mask_seed=None, mask_type="supermask"):
    att, amask, boxes, seqs = inputs
    variables = to_numpy(jax_model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(att), jnp.asarray(amask),
                                        jnp.asarray(seqs), jnp.asarray(boxes)))
    if mask_seed is not None:
        # random mask values so that folding prunes a real share of each weight
        rng = np.random.default_rng(mask_seed)

        def draw(m):
            if mask_type == "supermask":
                return rng.normal(0.0, 2.0, size=m.shape).astype(np.float32)
            return (rng.uniform(size=m.shape) < 0.6).astype(np.float32)

        variables["masks"] = jax.tree.map(draw, variables["masks"])
    return variables


def jax_mask_cfg(mask_type):
    return JaxMaskConfig(mask_type, 5.0 if mask_type == "supermask" else 1.0)


def port_mask_cfg(mask_type):
    return MaskConfig(mask_type)


def port_model(name, variables, mask_cfg=None):
    model = port_get_model(name)(**KW, mask_cfg=mask_cfg, device="cpu")
    return load_jax_variables(model, variables)


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)
