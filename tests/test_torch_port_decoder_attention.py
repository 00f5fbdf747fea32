"""The decoder's full-sequence attention of the PyTorch port (the plain version
behind kernels K14 / K15) against the JAX package on the CPU, at small widths
(d 32, 4 heads, 6 query positions, 6 or 5 keys, f32):

* ``MultiHeadAttention`` against the JAX layer with the XE target mask (pad
  keys and the causal rule) and with a region mask where one image has no
  valid region (its rows average every value uniformly), the memory one row
  per image for 3 query rows each (the JAX side repeats it);
* the attention function with a dropout keep-mask, handed to the JAX
  function as its ``dropout`` callable with the same divisor;
* the grouped memory (one K/V row per image) against the repeated layout;
* the read-outs of ``chip_smoke.py``'s check that K14's P~ equals K15's,
  on the plain version in bf16: with V = the identity the output is P~,
  and with dO = the identity on one group member dV is that member's P~
  transposed, both exactly;
* the bf16 kernels' shared-memory sizes (``bf16_forward_smem``,
  ``bf16_backward_smem``) counted by hand.

Tolerances: outputs 1e-5; each gradient within 1e-5 of its tensor's largest
entry plus 1e-6 of the largest gradient of all (the two sides sum the same
terms in other orders; the key projection's bias has a gradient of 0 in exact
arithmetic, a softmax ignoring a shift of every score, so both sides give
rounding noise).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import D, HEADS, t, to_numpy
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.kernels._build import BLOCK_SMEM_LIMIT
from sparse_caption_tpu_torch.kernels.decoder_attention import (
    bf16_backward_smem,
    bf16_forward_smem,
    decoder_attention,
)
from sparse_caption_tpu_torch.models import layers as pl
from sparse_caption_tpu_torch.ops.attention import NEG_INF, divide_scores
from sparse_caption_tpu_torch.ops.keep import apply_keep, keep_divisor
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables

TQ, B, G, S, PAD = 6, 2, 3, 5, 0
DK = D // HEADS


def _close(port, ref, atol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=atol)


def _grad_close(port, ref, name="", top=0.0):
    """Within 1e-5 of the tensor's largest entry plus 1e-6 of ``top``, the
    largest gradient of all, and 1e-6."""
    ref = np.asarray(ref)
    atol = 1e-5 * np.abs(ref).max() + 1e-6 * top + 1e-6
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=0, atol=atol, err_msg=name)


def _case(kind, rng):
    """(query (N, TQ, D), keys (Nk, Tk, D), JAX dense mask (N, 1, TQ|1, Tk),
    port key_valid (Nk, Tk), causal, group)."""
    if kind == "self":
        n = B * G
        x = rng.normal(size=(n, TQ, D)).astype(np.float32)
        tokens = rng.integers(4, 40, size=(n, TQ))
        tokens[0, 4:] = PAD
        tokens[4, 2:] = PAD
        valid = tokens != PAD
        dense = valid[:, None, None, :] & np.tril(np.ones((TQ, TQ), bool))[None, None]
        return x, x, dense, valid, True, 1
    x = rng.normal(size=(B * G, TQ, D)).astype(np.float32)
    mem = rng.normal(size=(B, S, D)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[0] = False  # an image with every region padded
    valid[1, -2:] = False
    return x, mem, np.repeat(valid, G, 0)[:, None, None, :], valid, False, G


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_mha_matches_jax(kind):
    """``MultiHeadAttention.forward`` (projections + K14's plain version) vs
    the JAX layer: output and the gradients of the query, the keys' source
    and all four projections. Cross-attention reads one memory row per image
    for its 3 query rows; the JAX side repeats it."""
    rng = np.random.default_rng(1 if kind == "self" else 2)
    x, mem, dense, valid, causal, group = _case(kind, rng)
    cot = rng.normal(size=x.shape).astype(np.float32)
    mha = jl.MultiHeadAttention(num_heads=HEADS, d_model=D)
    jv = to_numpy(mha.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x), jnp.asarray(x)))
    jv = jax.tree.map(lambda a: a + rng.normal(0, 0.1, size=a.shape).astype(np.float32), jv)  # nonzero biases

    def jfn(params, x, mem):
        src = x if kind == "self" else jnp.repeat(mem, group, axis=0)
        return mha.apply(params, x, src, src, jnp.asarray(dense))

    ref, vjp = jax.vjp(jfn, jv, jnp.asarray(x), jnp.asarray(mem))
    port = pl.MultiHeadAttention(HEADS, D)
    port.load_state_dict(convert_jax_variables(jv))
    px = t(x).requires_grad_()
    pm = px if kind == "self" else t(mem).requires_grad_()
    before = launch_counts()
    out = port(px, pm, pm, t(valid), causal)
    assert launch_counts() == before  # CPU tensors take the plain version
    _close(out, ref)
    if kind == "cross":
        uniform = port.out_proj(port.v_proj(pm)[:1].mean(1, keepdim=True).expand(G, TQ, D))  # image 0: all padded
        _close(out[:G], uniform.detach())
    leaves = [px] + ([] if kind == "self" else [pm]) + list(port.parameters())
    grads = torch.autograd.grad(out, leaves, t(cot))
    dparams, dx, dmem = vjp(jnp.asarray(cot))
    _grad_close(grads[0], dx, "query")
    if kind == "cross":
        _grad_close(grads[1], dmem, "memory")
    ref_params = convert_jax_variables(to_numpy(dparams))
    top = max(float(np.abs(np.asarray(r)).max()) for r in [dx, dmem, *ref_params.values()])
    for (name, _), g in zip(port.named_parameters(), grads[len(leaves) - len(ref_params):]):
        _grad_close(g, ref_params[name], name, top)


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_attention_with_keep_mask_matches_jax(kind):
    """K14's plain version with the dropout keep-mask on the probabilities vs
    the JAX ``scaled_dot_attention`` with the same mask as its ``dropout``
    callable (kept probabilities / keep): output and dq, dk, dv."""
    rng = np.random.default_rng(3 if kind == "self" else 4)
    tk = TQ if kind == "self" else S
    nk = B * G if kind == "self" else B
    q = rng.normal(size=(B * G, HEADS, TQ, DK)).astype(np.float32)
    k, v = (rng.normal(size=(nk, HEADS, tk, DK)).astype(np.float32) for _ in range(2))
    cot = rng.normal(size=q.shape).astype(np.float32)
    keep = rng.uniform(size=(B * G, HEADS, TQ, tk)) < 0.7
    if kind == "self":
        valid = np.ones((nk, tk), bool)
        valid[1, 3:] = False
        dense = valid[:, None, None, :] & np.tril(np.ones((TQ, TQ), bool))[None, None]
    else:
        valid = np.ones((nk, tk), bool)
        valid[0] = False
        valid[1, 1] = False
        dense = np.repeat(valid, G, 0)[:, None, None, :]
    group = (B * G) // nk

    def jfn(q, k, v):
        kr, vr = jnp.repeat(k, group, axis=0), jnp.repeat(v, group, axis=0)
        return jl.scaled_dot_attention(q, kr, vr, mask=jnp.asarray(dense),
                                       dropout=lambda p: jnp.where(jnp.asarray(keep), p / 0.7, 0.0))

    ref, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    pq, pk, pv = (t(a).requires_grad_() for a in (q, k, v))
    out = decoder_attention(pq, pk, pv, t(valid), kind == "self", t(keep), 0.7)
    _close(out, ref)
    grads = torch.autograd.grad(out, (pq, pk, pv), t(cot))
    for g, r, name in zip(grads, vjp(jnp.asarray(cot)), ("dq", "dk", "dv")):
        _grad_close(g, r, name)
    if kind == "cross":  # image 0's rows: uniform over its padded keys, no gradient to q or k
        assert float(grads[0][:G].abs().max()) == 0.0 and float(grads[1][0].abs().max()) == 0.0
        assert float(grads[2][0].abs().max()) > 0.0


def test_grouped_memory_equals_repeated_layout():
    """Cross-attention over one memory row per image equals the same layer
    over the memory repeated to every query row (the JAX package's layout):
    output and every gradient, the k/v projections' included, within 1e-5."""
    rng = np.random.default_rng(5)
    x, mem, _, valid, _, group = _case("cross", rng)
    cot = t(rng.normal(size=x.shape).astype(np.float32))
    port = pl.MultiHeadAttention(HEADS, D)
    for p in port.parameters():
        with torch.no_grad():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, size=tuple(p.shape)).astype(np.float32)))
    runs = []
    for grouped in (True, False):
        px, pm = t(x).requires_grad_(), t(mem).requires_grad_()
        src = pm if grouped else pm.repeat_interleave(group, 0)
        kv = t(valid) if grouped else t(valid).repeat_interleave(group, 0)
        out = port(px, src, src, kv)
        runs.append((out, torch.autograd.grad(out, [px, pm, *port.parameters()], cot)))
    (out_g, grads_g), (out_r, grads_r) = runs
    _close(out_g, out_r.detach())
    names = ["query", "memory"] + [n for n, _ in port.named_parameters()]
    for name, g, r in zip(names, grads_g, grads_r):
        _grad_close(g, r, name)
    assert float(grads_g[names.index("k_proj.weight")].abs().max()) > 1e-3


def test_wrapper_checks_inputs():
    q = torch.zeros(6, HEADS, TQ, DK)
    kv = torch.zeros(2, HEADS, S, DK)
    valid = torch.ones(2, S, dtype=torch.bool)
    assert decoder_attention(q, kv, kv, valid).shape == q.shape
    with pytest.raises(ValueError, match="split"):
        decoder_attention(q, torch.zeros(4, HEADS, S, DK), torch.zeros(4, HEADS, S, DK))
    with pytest.raises(ValueError, match="causal"):
        decoder_attention(q, kv, kv, valid, causal=True)
    with pytest.raises(TypeError):
        decoder_attention(q, kv, kv, valid.float())
    with pytest.raises(ValueError):
        decoder_attention(q, kv, kv, valid, keep=torch.ones(6, HEADS, TQ, TQ, dtype=torch.bool))
    with pytest.raises(TypeError):
        decoder_attention(q, kv.double(), kv.double(), valid)
    # K15's bf16 kernel holds a K/V row's whole group in shared memory: the
    # wrapper's limit follows the kernel's layout (checked against the C
    # function by chip_smoke.py)
    assert bf16_backward_smem(17, 36, 5) < bf16_backward_smem(17, 36, 15) < BLOCK_SMEM_LIMIT
    assert bf16_backward_smem(64, 64, 6) == 0


@pytest.mark.parametrize("tq,tk,group,want", [
    # two stages of (K, V: tk rows; q, dO: group x tq rows) x 72 bf16, a zero
    # row of 72, dS and P~: group x (tq padded to 16) rows x ((tk padded to
    # 16) + 8)
    (17, 17, 1, 2 * (2 * (34 + 34) * 72 + 72 + 2 * 32 * 40)),  # the XE self call: 24,848 B
    (17, 36, 5, 2 * (2 * (72 + 170) * 72 + 72 + 2 * 160 * 56)),  # the XE cross call: 105,680 B
    (17, 36, 15, 2 * ((72 + 510) * 72 + 72 + 2 * 480 * 56)),  # a 15-sample group: one stage, 191,472 B
    (64, 64, 5, 2 * ((128 + 640) * 72 + 72 + 2 * 320 * 72)),  # one stage, 202,896 B of 232,448
])
def test_bf16_backward_smem_counts_by_hand(tq, tk, group, want):
    assert bf16_backward_smem(tq, tk, group) == want
    assert want in (24848, 105680, 191472, 202896)


@pytest.mark.parametrize("tq,tk,group,keep,want", [
    # two stages of (K, V: tk rows; q: group x tq rows) in rows of 144 B and,
    # with a keep-mask, each member's tq x tk flags in a region rounded up to
    # 16 B with 15 to spare; a zero row of 144 B
    (17, 17, 1, True, 2 * ((34 + 17) * 144 + 304) + 144),  # the XE self call: 15,440 B
    (17, 36, 5, True, 2 * ((72 + 85) * 144 + 5 * 640) + 144),  # the XE cross call: 51,760 B
    (17, 36, 15, False, 2 * (72 + 255) * 144 + 144),  # the replay's cross call without dropout: 94,320 B
    (64, 64, 16, True, (128 + 1024) * 144 + 16 * 4112 + 144),  # one stage: 231,824 B of 232,448
    (64, 64, 17, True, 0),  # not even one stage fits
])
def test_bf16_forward_smem_counts_by_hand(tq, tk, group, keep, want):
    assert bf16_forward_smem(tq, tk, group, keep) == want
    assert want in (15440, 51760, 94320, 231824, 0)


@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("with_keep", [False, True])
def test_identity_readouts_give_p_exactly(kind, with_keep):
    """With V = the identity (v[b, h, j] = e_j) the output is P~; with dO =
    the identity (dO[n, h, i] = e_i) on group member m and 0 on the others,
    dV[b, h, j, i] = P~_m[i, j]. Bit for bit in bf16: each element sums one
    bf16 value with zeros."""
    g = torch.Generator().manual_seed(3)
    dt = torch.bfloat16
    b, group, tq, tk = (4, 1, 7, 7) if kind == "self" else (2, 3, 7, 5)
    n, nk = b * group, (b * group if kind == "self" else b)
    q = torch.randn(n, HEADS, tq, DK, generator=g).to(dt)
    k = torch.randn(nk, HEADS, tk, DK, generator=g).to(dt)
    valid = torch.arange(tk)[None] < torch.randint(1, tk + 1, (nk, 1), generator=g)
    valid[0] = kind != "cross"  # cross: a K/V row with every key masked
    keep = torch.rand(n, HEADS, tq, tk, generator=g) < 0.9 if with_keep else None
    causal = kind == "self"
    # P~ as the plain version forms it, K/V repeated to the query rows
    kr, vr = k.repeat_interleave(n // nk, 0), valid.repeat_interleave(n // nk, 0)
    mask = vr[:, None, None, :] & (torch.tril(torch.ones(tq, tk, dtype=torch.bool)) if causal else True)
    scores = divide_scores(torch.matmul(q, kr.transpose(-1, -2)), DK).masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    p = apply_keep(p, keep, keep_divisor(0.9, dt)) if with_keep else p
    eye = torch.eye(DK, dtype=dt)
    v = eye[:tk].expand(nk, HEADS, tk, DK).contiguous().requires_grad_()
    out = decoder_attention(q, k, v, valid, causal, keep, 0.9)
    assert torch.equal(out[..., :tk], p) and not out[..., tk:].any()
    for m in range(group):
        dout = torch.zeros(n, HEADS, tq, DK, dtype=dt)
        dout.view(nk, n // nk, HEADS, tq, DK)[:, m] = eye[:tq]
        (dv,) = torch.autograd.grad(out, v, dout, retain_graph=True)
        assert torch.equal(dv[..., :tq].transpose(-1, -2), p.view(nk, n // nk, HEADS, tq, tk)[:, m])
