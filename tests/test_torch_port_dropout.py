"""Dropout's scaling of kept values in the PyTorch port, bit for bit against the
JAX package on the CPU.

flax ``nn.Dropout`` and the JAX package's ``TimeDropout`` divide a kept value
by the keep probability rounded to the activation's dtype (weak typing:
0.9 becomes 0.8984375 in bf16). Their keep-mask is read off their output and
handed to the port's ``TrainRandom.dropout``, to K6's plain version (the
sublayer dropout of the residual add) and to K8's plain apply (keyed
dropout), each of which must give the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sparse_caption_tpu.models.layers import TimeDropout
from sparse_caption_tpu_torch.kernels import keyed_dropout as k8
from sparse_caption_tpu_torch.kernels.add_ref_layernorm import add_ref_layernorm_plain
from sparse_caption_tpu_torch.ops.rng import TrainRandom

SHAPE = (4, 16, 250)  # (N, T, D): K8's layout


class GivenMask(TrainRandom):
    """Hands out a fixed keep-mask (the JAX side's)."""

    def __init__(self, keep):
        super().__init__(torch.Generator())
        self.keep = keep

    def keep_mask(self, shape, keep_prob, device, site=None):
        assert tuple(shape) == tuple(self.keep.shape)
        return self.keep


def _jax_dropout(module: str, x, rate: float):
    key = {"dropout": jax.random.PRNGKey(0)}
    if module == "nn.Dropout":
        return nn.Dropout(rate).apply({}, x, deterministic=False, rngs=key)
    return TimeDropout(rate).apply({}, x, train=True, rngs=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("module", ["nn.Dropout", "TimeDropout"])
def test_kept_values_are_bit_equal_to_jax(module, rate, dtype, monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    x += np.where(x < 0, -0.1, 0.1).astype(np.float32)  # no zeros: a zero output means dropped
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(_jax_dropout(module, jnp.asarray(x, jdt), rate).astype(jnp.float32))
    keep = torch.from_numpy(ref != 0)
    assert 0 < keep.float().mean().item() < 1
    xt = torch.from_numpy(x).to(tdt)
    keep_prob = 1.0 - rate

    outs = {"TrainRandom.dropout": GivenMask(keep).dropout(xt, keep_prob)}
    s, _ = add_ref_layernorm_plain(torch.zeros_like(xt), xt, torch.ones(SHAPE[-1], dtype=tdt),
                                   torch.zeros(SHAPE[-1], dtype=tdt), keep, keep_prob)
    outs["K6 plain"] = s
    monkeypatch.setattr(k8, "keyed_keep_mask_plain", lambda *args: keep)
    outs["K8 plain apply"] = k8.keyed_dropout_plain(xt, 1, 2, 0, keep_prob)
    for name, out in outs.items():
        assert out.dtype == tdt, name
        got = out.float().numpy()
        n_diff = int((got != ref).sum())
        assert n_diff == 0, f"{name}: {n_diff} of {int(keep.sum())} kept elements differ from {module}"
