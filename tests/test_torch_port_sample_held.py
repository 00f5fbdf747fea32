"""The rules of K9's and K4's held paths (``csrc/sample_step.cu``
``sample_held_kernel``, ``csrc/beam_topk.cu`` ``beam_topk_held_kernel``),
held on the CPU against the port's plain versions and the JAX package.

- K9's entry rule: each warp of the held block draws the z of its largest
  logit not banned, z_ref is the largest of those, and an entry takes no
  log where 1 - u lies above its group's bound exp(amax - z_ref + delta)
  (1 + 2^-14) (``chip_smoke.k9_skip_model``). The token it picks is the
  plain version's and the JAX step's (``decoding/sample.py``:
  ``jax.random.categorical`` on its own draws, replayed; the Gumbel
  method's ``sample_next_word`` on the uniforms handed in), on flat, peaked
  and banned rows; on rows built so that the winner's 1 - u sits at its
  bound (``_bound_rows``) it is the winner, and each margin taken away (or
  one grid point of u more skipped) moves the token on some row.
- The held layout (``chip_smoke.held_block`` / ``held_threads``) and its
  largest block, ``row_softmax.cuh kTopkHeldMaxThreads``; K9's operation
  count (``chip_smoke.k9_ops_ms``) by hand.
- K4's held diverse rows: each thread's best constrained value from its
  entries no penalty touches, the threshold the k-th of those, the
  penalised entries (the earlier groups' tokens, the ban, EOS, UNK) valued
  apart (count first, then f32(count x lambda) subtracted once)
  (``_held_diverse_topk``): values and indices bit for bit as
  ``beam_topk_plain``'s and as the JAX diverse step's (``decoding/beam.py``
  penalties, then ``_row_topk``).

Tolerances: none; tokens, values and indices bit for bit (the model and the
plain version share the f32 arithmetic of each value).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sparse_caption_tpu.decoding import beam as jax_beam
from sparse_caption_tpu.decoding import sample as jax_sample
from sparse_caption_tpu_torch.kernels import beam_topk as k4
from sparse_caption_tpu_torch.kernels import sample_step as k9
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import rounded_log_softmax

CSRC = Path(k9.__file__).parent / "csrc"
V9 = 2048  # held rows of 64 threads: two warps in f32 and in bf16


def test_held_layout_matches_the_cuda_header():
    """``chip_smoke.HELD_MAX_THREADS`` and the 32 entries a thread of
    ``held_block`` are row_softmax.cuh's kTopkHeldMaxThreads and kRowHeld
    (the one constant K4's and K9's held paths launch with), and
    ``held_threads`` gives the blocks the kernels take."""
    src = (CSRC / "row_softmax.cuh").read_text()
    (max_threads,) = re.findall(r"constexpr int kTopkHeldMaxThreads = (\d+);", src)
    (per_thread,) = re.findall(r"constexpr int kRowHeld = (\d+);", src)
    assert int(max_threads) == chip_smoke.HELD_MAX_THREADS and int(per_thread) == 32
    for name in ("sample_step.cu", "beam_topk.cu"):
        assert "held_row_threads<T>(V, kTopkHeldMaxThreads)" in (CSRC / name).read_text()
    assert [chip_smoke.held_threads(v, e) for v, e in ((10000, 2), (10000, 4), (10240, 2), (10248, 2), (771, 4),
                                                       (2048, 4), (2048, 2))] == [320, 320, 320, 0, 0, 64, 64]


def test_k9_ops_ms_counts_philox_and_sfu_work():
    """``k9_ops_ms``: a Philox call (40 multiplies at 64 an SM a clock) a
    group of 4, against an expf an entry, an __expf a group and two logf an
    entry that takes the logs at 16 an SM a clock, the larger of the two."""
    n, vocab, logged, clock, sms = 960, 10000, 10000, 1.98e9, 132
    groups = 960 * 2500
    t_mul = 40 * groups / (64 * sms * clock)
    t_sfu = (n * vocab + groups + 2 * logged) / (16 * sms * clock)
    assert t_mul > t_sfu
    assert chip_smoke.k9_ops_ms(n, vocab, logged, clock, sms) == pytest.approx(t_mul * 1e3, rel=1e-12)
    assert chip_smoke.k9_ops_ms(n, vocab, 10 ** 8, clock, sms) == pytest.approx(
        (n * vocab + groups + 2 * 10 ** 8) / (16 * sms * clock) * 1e3, rel=1e-12)


# ------------------------------------------------------------ K9's entry rule
def _k9_rows(dtype) -> tuple:
    """(logits (8, V9) in dtype, prev (8,) int32): rows 0-2 at scale 3 (the
    rule draws nearly every group), 3-5 at scale 10 (peaked: few groups
    draw), row 6 whose banned token is its largest logit, row 7 of equal
    logits."""
    rng = np.random.default_rng(20)
    x = rng.normal(size=(8, V9)).astype(np.float32)
    x[:3] *= 3
    x[3:6] *= 10
    x[6] *= 3
    prev = rng.integers(4, V9, 8).astype(np.int32)
    prev[6] = int(np.argmax(x[6]))
    x[7] = 0.5
    return torch.from_numpy(x).to(dtype), torch.from_numpy(prev)


def _plain_tokens(logits, prev, ban: bool, method: str, temperature: float, noise) -> torch.Tensor:
    n = logits.shape[0]
    seq, seq_lp = torch.zeros(n, 3, dtype=torch.int32), torch.zeros(n, 3)
    return k9.sample_step_plain(logits, prev, torch.ones(n, dtype=torch.bool), seq, seq_lp, 1,
                                temperature=temperature, ban_prev=ban, noise=noise, sample_method=method)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("temperature,ban", [(1.0, False), (0.7, True)])
def test_k9_noise_rule_random_matches_plain_and_jax(dtype, temperature, ban):
    """Random mode: the rules' token is the plain version's and
    ``jax.random.categorical``'s (the decode loop's random step) on the same
    banned log-probs, JAX's uniforms replayed (its Gumbel noise is
    -log(-log(u))); few entries take the logs, but in the row of equal
    logits."""
    logits, prev = _k9_rows(dtype)
    c = k9.sample_logprobs(logits, prev, ban)
    key = jax.random.PRNGKey(21)
    u = torch.from_numpy(np.array(jax.random.uniform(key, tuple(c.shape), minval=np.finfo(np.float32).tiny)))
    ref = np.asarray(jax.random.categorical(key, jnp.asarray(c.numpy()) / temperature, axis=-1))
    token, logged = chip_smoke.k9_skip_model(logits, c, u, "random", temperature, prev if ban else None)
    np.testing.assert_array_equal(token.numpy(), ref)
    g = -torch.log(-torch.log(u))
    np.testing.assert_array_equal(_plain_tokens(logits, prev, ban, "random", temperature, g).numpy(), ref)
    assert logged[:7].float().mean() < 0.01 and logged[torch.arange(8), token].all()  # row 7: every entry ties


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k9_noise_rule_gumbel_matches_plain_and_jax(dtype, monkeypatch):
    """The Gumbel method: the rule's token is the plain version's and
    ``sample_next_word``'s (JAX) on the uniforms handed in."""
    logits, prev = _k9_rows(dtype)
    c = k9.sample_logprobs(logits, prev, False)
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(22), tuple(c.shape))))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u.numpy()))
    ref, _ = jax_sample.sample_next_word(jnp.asarray(c.numpy()), "gumbel", 1.0, jax.random.PRNGKey(0))
    token, _ = chip_smoke.k9_skip_model(logits, c, u, "gumbel", 1.0)
    np.testing.assert_array_equal(token.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(_plain_tokens(logits, prev, False, "gumbel", 1.0, u).numpy(), np.asarray(ref))


BOUND_CASES = (("random", chip_smoke.K9_BOUND_TEMPERATURE, 0.25), ("random", 1.0, 25.0), ("gumbel", 1.0, 25.0))


def _bound_rows(bump: float) -> tuple:
    """64 f32 rows of V9 as ``chip_smoke.entry_bound_rows`` builds them on
    the card, from numpy: u on the kernel's grid ((b * 2 + 1) 2^-24), the
    row's winner j at a column of its choosing with 1 - u = (2k + 1) 2^-24,
    k < 200 (on the card, the keyed u nearest 1); logits 0 but `bump` at j.
    Returns (logits, u, j)."""
    rng = np.random.default_rng(24)
    n = 64
    b = rng.integers(0, 2 ** 23 - 4096, size=(n, V9))
    j = rng.integers(0, V9, size=n)
    b[np.arange(n), j] = 2 ** 23 - 1 - rng.integers(0, 200, size=n)
    u = torch.from_numpy((b * 2 + 1).astype(np.float32) * np.float32(2.0 ** -24))
    logits = torch.zeros(n, V9)
    logits[torch.arange(n), torch.from_numpy(j)] = bump
    return logits, u, torch.from_numpy(j)


@pytest.mark.parametrize("fault", ["", "no_delta", "no_scale", "kmax"], ids=["rule", "no_delta", "no_scale", "kmax"])
def test_k9_entry_rule_at_its_bound(fault):
    """On rows whose winner's 1 - u sits at its own bound (its warp draws
    z_ref = its z): the rule's token is the winner's and the plain
    version's on every row, at T = K9_BOUND_TEMPERATURE (|a| about 4,500,
    the add's rounding 2.4e-4) and at T 1 (random and Gumbel). Each margin
    taken away (delta, or its term scaled by |z_ref| + |amax|) or one grid
    point of u more skipped (the bits' bound one higher) moves the token on
    some row: the rows the card check builds the same way tell them apart."""
    moved = 0
    prev = torch.zeros(64, dtype=torch.int32)
    for method, temperature, bump in BOUND_CASES:
        logits, u, j = _bound_rows(bump)
        c = k9.sample_logprobs(logits, prev, False)
        token, _ = chip_smoke.k9_skip_model(logits, c, u, method, temperature, fault=fault)
        if not fault:
            noise = u if method == "gumbel" else -torch.log(-torch.log(u))
            assert torch.equal(token, j)
            assert torch.equal(_plain_tokens(logits, prev, False, method, temperature, noise).long(), j)
        moved += int((token != j).sum())
    assert (moved > 0) == bool(fault)


# --------------------------------------------------------- K4's diverse rows
def _held_diverse_topk(logits, k: int, ban, ban_eos, eos_id: int, unk_id: int, div_tokens, lam: float,
                       penalised_in_best: bool = False) -> tuple:
    """K4's held selection on diverse rows in PyTorch: thread t holds the
    16-byte vectors t, t + nt, ... (nt whole warps, 32 values a thread);
    each thread's best is the largest log-prob of its entries that no
    penalty touches (`penalised_in_best`: of all its entries, the fault);
    the threshold is the k-th largest best (-inf if fewer than k); every
    entry whose log-prob reaches it is a candidate, a penalised one valued
    apart (the ban, EOS, UNK added in f32, then count x lambda, count first,
    subtracted once); the top k candidates by value, then the lower index.
    Returns (values, indices)."""
    n, vocab = logits.shape
    ue = 16 // logits.element_size()
    units = -(-vocab // ue)
    nt = chip_smoke.held_block(units, ue)
    lp = rounded_log_softmax(logits).float()
    rows = torch.arange(n)
    group = n // div_tokens.shape[0]
    counts = torch.zeros(n, vocab).index_put_(
        (rows.repeat_interleave(div_tokens.shape[1]), div_tokens.repeat_interleave(group, 0).long().flatten()),
        torch.ones(n * div_tokens.shape[1]), accumulate=True)
    marked = counts > 0
    marked[rows, ban.long()] = True
    marked[:, eos_id] |= ban_eos
    marked[:, unk_id] = True
    c = lp.clone()
    c[rows, ban.long()] += k4.NEG_BIG
    c[:, eos_id] += torch.where(ban_eos, k4.NEG_BIG, 0.0)
    c[:, unk_id] += -1000.0
    c = torch.where(counts > 0, c - counts * torch.tensor(lam, dtype=torch.float32), c)
    value = torch.where(marked, c, lp)
    thread = ((torch.arange(vocab) // ue) % nt).expand(n, vocab)
    offered = lp if penalised_in_best else torch.where(marked, -float("inf"), lp)
    best = torch.full((n, nt), -float("inf")).scatter_reduce(1, thread, offered, "amax")
    thr = torch.sort(best, dim=-1, descending=True).values[:, k - 1:k]
    cand = torch.where(lp >= thr, value, -float("inf"))
    vals, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].int()


def _diverse_rows(images: int, width: int, p: int, vocab: int, dtype, seed: int) -> dict:
    """K4's inputs as ``chip_smoke.diverse_rows`` builds them, from numpy:
    an image's first word chosen twice (three times in every other image);
    even images: it leads its rows (6.0), the last token follows (5.5); odd
    images: every token 0.1 above the row's largest logit. A banned token a
    row, bad endings on a third of the rows, the UNK penalty."""
    rng = np.random.default_rng(seed)
    n = images * width
    x = rng.normal(size=(n, vocab)).astype(np.float32)
    toks = rng.integers(4, vocab, size=(images, p)).astype(np.int32)
    toks[:, 1] = toks[:, 0]
    toks[::2, 2 % p] = toks[::2, 0]
    for r in range(n):
        img = r // width
        if img % 2 == 0:
            x[r, toks[img, p - 1]] = 5.5
            x[r, toks[img, 0]] = 6.0
        else:
            x[r, toks[img]] = x[r].max() + np.float32(0.1)
    return dict(logits=torch.from_numpy(x).to(dtype), div_tokens=torch.from_numpy(toks),
                ban_token=torch.from_numpy(rng.integers(0, vocab, n).astype(np.int32)),
                ban_eos=torch.from_numpy(rng.random(n) < 0.3), eos_id=3, unk_id=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("images,width,p,vocab", [(8, 2, 4, 2000), (4, 3, 256, 771)], ids=["P4", "P256-V771"])
def test_k4_held_diverse_selection_matches_plain_and_jax(dtype, images, width, p, vocab):
    """The held diverse selection's values and indices equal
    ``beam_topk_plain``'s and the JAX diverse step's (beam.py's penalties on
    the same log-probs, then ``_row_topk``) bit for bit; with the penalised
    entries left in the threads' bests the threshold moves past a winner on
    some row (the rows tell the rule apart)."""
    kw = _diverse_rows(images, width, p, vocab, dtype, seed=23 + p)
    logits, lam = kw.pop("logits"), 0.3
    vals, idx = _held_diverse_topk(logits, width, kw["ban_token"], kw["ban_eos"], kw["eos_id"], kw["unk_id"],
                                   kw["div_tokens"], lam)
    pvals, pidx, _ = k4.beam_topk_plain(logits, width, div_lambda=lam, **kw)
    assert torch.equal(vals, pvals) and torch.equal(idx, pidx)
    lp = jnp.asarray(rounded_log_softmax(logits).float().numpy())
    c = lp + jax.nn.one_hot(kw["ban_token"].numpy(), vocab) * k4.NEG_BIG
    c = c + jnp.where(kw["ban_eos"].numpy()[:, None] & (jnp.arange(vocab)[None] == 3), k4.NEG_BIG, 0.0)
    c = c.at[:, 1].add(-1000.0)
    change = jnp.sum(jax.nn.one_hot(jnp.asarray(kw["div_tokens"].numpy()), vocab), axis=1)
    c = c - jnp.repeat(change, width, axis=0) * lam
    ref_vals, ref_idx = (np.asarray(a) for a in jax_beam._row_topk(c, width))
    np.testing.assert_array_equal(vals.numpy(), ref_vals)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    fvals, _ = _held_diverse_topk(logits, width, kw["ban_token"], kw["ban_eos"], kw["eos_id"], kw["unk_id"],
                                  kw["div_tokens"], lam, penalised_in_best=True)
    assert not torch.equal(fvals, pvals)
