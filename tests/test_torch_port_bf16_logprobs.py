"""bf16 log-probs at the JAX package's rounding points, on the CPU.

``jax.nn.log_softmax`` on a bf16 row (``sparse_caption_tpu/models/layers.py:472``,
``models/up_down.py:124``) rounds x - max, the f32 sum of the exps and its log
to bf16 before their difference. The port's plain rule
(``kernels/vocab_log_softmax.py rounded_log_softmax``; ``csrc/common.cuh``
``lsm_*`` in K13, K4 and K9) follows it: held here bit for bit through K13's,
K4's and K9's plain versions and through one bf16 eval Generator step. K4's
held-path threshold (``csrc/beam_topk.cu`` x_lo) is re-derived for those
rounding points: a torch model of it keeps every entry that reaches the
threshold, and loses some without its margin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_common import t
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu_torch.kernels import beam_topk as k4
from sparse_caption_tpu_torch.kernels import sample_step as k9
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import rounded_log_softmax, vocab_log_softmax_plain
from sparse_caption_tpu_torch.models import layers as pl

ROWS = 48


def _rows(vocab: int, scale: float, seed: int, rows: int = ROWS):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((rows, vocab)) * scale).astype(np.float32)).to(torch.bfloat16)


def _jax_log_softmax(x):
    """``jax.nn.log_softmax`` of the bf16 rows x, as f32."""
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return torch.from_numpy(np.array(jax.nn.log_softmax(jx, axis=-1).astype(jnp.float32)))


@pytest.mark.parametrize("scale", [1.0, 3.0, 10.0])
@pytest.mark.parametrize("vocab", [10_000, 771])
def test_plain_rule_is_jax_log_softmax_bit_for_bit(vocab, scale):
    """K13's plain version, K4's raw log-probs (at its top-k and over the row)
    and K9's log-probs equal ``jax.nn.log_softmax`` on the same bf16 rows at
    every entry."""
    x = _rows(vocab, scale, seed=int(scale * 10) + vocab)
    want = _jax_log_softmax(x)
    y = vocab_log_softmax_plain(x)
    assert y.dtype == torch.bfloat16 and torch.equal(y.float(), want)
    lp, _ = k4.constrained_logprobs(x)
    assert torch.equal(lp, want)
    _, idx, raw = k4.beam_topk_plain(x, 5)
    assert torch.equal(raw, want.gather(1, idx.long()))
    prev = torch.zeros(ROWS, dtype=torch.int32)
    assert torch.equal(k9.sample_logprobs(x, prev, False), want)


def test_plain_rule_rounds_only_bf16_to_bf16():
    """In f32, and from bf16 logits to f32 log-probs (the Generator's train
    site, where the JAX package casts the logits to f32 first), the rule is
    the f32 log-softmax rounded once; bf16 -> bf16 rounds apart from it."""
    x = _rows(10_000, 10.0, seed=3, rows=16)
    once = torch.log_softmax(x.float(), dim=-1)
    assert torch.equal(rounded_log_softmax(x.float()), once)
    assert torch.equal(rounded_log_softmax(x, torch.float32), once)
    assert torch.equal(vocab_log_softmax_plain(x, torch.float32), once)
    assert not torch.equal(rounded_log_softmax(x).float(), once.to(torch.bfloat16).float())


def test_plain_gradient_is_the_f32_log_softmax_gradient():
    """The rule moves the bf16 values only: ``vocab_log_softmax_plain``'s
    gradient stays the f32 log-softmax's, rounded to the input's dtype (what
    K13's backward computes from its f32 stats)."""
    x = _rows(771, 3.0, seed=4, rows=8).requires_grad_()
    dy = _rows(771, 1.0, seed=5, rows=8)
    (got,) = torch.autograd.grad(vocab_log_softmax_plain(x), x, dy)
    xf = x.detach().float().requires_grad_()
    (want,) = torch.autograd.grad(torch.log_softmax(xf, dim=-1), xf, dy.float())
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("scale", [3.0, 10.0])
def test_bf16_eval_generator_step_matches_jax_bit_for_bit(scale):
    """One eval step of the Generator in bf16: the JAX package's (Dense, then
    ``jax.nn.log_softmax`` in bf16) and the port's (``F.linear``, then K13's
    plain version) on the same weights. The rows of x are one-hot, so both
    frameworks form the same bf16 logits exactly; the log-probs then agree
    bit for bit."""
    d, vocab = 64, 10_000
    rng = np.random.default_rng(int(scale))
    kernel = (rng.standard_normal((d, vocab)) * scale).astype(np.float32)
    bias = (rng.standard_normal(vocab) * 0.5).astype(np.float32)
    x = np.eye(d, dtype=np.float32)
    kernel_b, bias_b = (torch.from_numpy(a).to(torch.bfloat16) for a in (kernel, bias))
    jparams = {"params": {"proj": {"kernel": jnp.asarray(kernel_b.float().numpy()).astype(jnp.bfloat16),
                                   "bias": jnp.asarray(bias_b.float().numpy()).astype(jnp.bfloat16)}}}
    want = jl.Generator(vocab).apply(jparams, jnp.asarray(x, jnp.bfloat16))
    gen = pl.Generator(d, vocab, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        gen.proj.weight.copy_(kernel_b.t())
        gen.proj.bias.copy_(bias_b)
        got = gen(t(x, torch.bfloat16))
        logits = gen.logits(t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert torch.equal(logits, (kernel_b.float() + bias_b.float()).to(torch.bfloat16))
    assert torch.equal(got.float(), torch.from_numpy(np.array(want.astype(jnp.float32))))


def _x_lo(thr, m, lse, margin: bool = True):
    """K4's held-path lower bound on a logit that may reach `thr`
    (``csrc/beam_topk.cu``, bf16), in f32; without `margin` (a planted
    fault) the bare thr + m + lse."""
    f = torch.float32
    thr, m, lse = (torch.as_tensor(v, dtype=f) for v in (thr, m, lse))
    base = (thr + m) + lse
    if not margin:
        return base
    return (base - (2.0 * thr.abs() + lse.abs()) * 2.0 ** -7) - (thr.abs() + m.abs() + lse.abs()) * 2.0 ** -20


@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_k4_threshold_margin_keeps_every_entry_that_reaches_it(scale):
    """For each of a row's 40 largest bf16 log-probs taken as the threshold,
    every entry whose log-prob (the rule) reaches it has a logit at or above
    x_lo, so the held path inserts it; with the margin left out some row loses
    an entry (equal log-probs from smaller logits)."""
    x = _rows(10_000, scale, seed=7 + int(scale), rows=32)
    xf = x.float()
    lp = rounded_log_softmax(x).float()
    m = xf.amax(dim=-1, keepdim=True)
    sh = (xf - m).to(torch.bfloat16).float()
    lse = torch.log(torch.exp(sh).sum(dim=-1, keepdim=True).to(torch.bfloat16).float()).to(torch.bfloat16).float()
    thrs = torch.topk(lp, 40, dim=-1).values
    lost_bare = 0
    for j in range(thrs.shape[1]):
        thr = thrs[:, j: j + 1]
        reach = lp >= thr
        assert not (reach & (xf < _x_lo(thr, m, lse))).any()
        lost_bare += int((reach & (xf < _x_lo(thr, m, lse, margin=False))).sum())
    assert lost_bare > 0


def test_k4_margin_rows_lose_their_tie_without_the_margin():
    """``chip_smoke.k4_margin_rows`` (the card's check of the margin): the
    plain version's 5th winner is the lowest index of a three-way tie whose
    logits all lie below the bare threshold thr + m + lse, and at or above
    x_lo with the margin."""
    x = chip_smoke.k4_margin_rows(16, 10_000, "cpu")
    xf = x.float()
    vals, idx, _ = k4.beam_topk_plain(x, 5)
    ties = [8 * (row % 16) + 8 * 50 for row in range(16)]
    assert idx[:, 4].tolist() == ties and bool((vals[:, 4] == -8.75).all())
    lp = rounded_log_softmax(x).float()
    m = xf.amax(dim=-1, keepdim=True)
    sh = (xf - m).to(torch.bfloat16).float()
    lse = torch.log(torch.exp(sh).sum(dim=-1, keepdim=True).to(torch.bfloat16).float()).to(torch.bfloat16).float()
    thr = vals[:, 4:5]
    reach = lp >= thr
    assert int((reach & (xf < _x_lo(thr, m, lse, margin=False))).sum()) == 3 * 16
    assert not (reach & (xf < _x_lo(thr, m, lse))).any()
