"""The two identities K9's top-k and nucleus modes rest on
(``csrc/sample_step.cu``), held on the CPU against the JAX package's
``decoding/sample.py modified_sample_logits``.

- Top-k: the port's c (``kernels/sample_step.py sample_logprobs``) and s =
  c / T (``decoding/sample.py divide_by_temperature``) are non-decreasing in
  the logit, so the k-th largest s (with repeats, as ``lax.top_k``) is s of
  the k-th largest logit other than the banned one, with the banned entry's
  s merged in on its own. The kernel takes the k-th logit in the pass that
  reads the row; ``_kth_from_logits`` is that rule in PyTorch.
- Nucleus: the cut found by a search over the bits of p with exact
  62-bit fixed-point masses of the keys at or above each probe, after a
  prefilter that leaves out entries far below the cut (``_bisect_cut`` and
  ``_prefilter``, a numpy model of ``nucleus_cut``): the same kept set as the
  sort and cumsum, and the exact sum of the kept p as the denominator.

Tolerances: the k-th values and the filtered rows bit for bit (the same f32
arithmetic on the same c); the nucleus kept sets exactly on rows whose
cutoff sums lie clear of p (XLA's cumsum rounds; the model's sums are
exact) and on rows built so that the sums are exact; renormalised
log-probs within 1e-6 (one rounding of the denominator against XLA's f32
sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_caption_tpu.decoding import sample as jax_sample
from sparse_caption_tpu_torch.decoding.sample import divide_by_temperature, modified_sample_logits
from sparse_caption_tpu_torch.kernels import sample_step as k9

STEP_LP_TOL = 1e-6
FIXED_ONE = 1 << 62  # the fixed-point grid of the nucleus's sums


# ------------------------------------------------------------------ top-k
def _rows(dtype) -> tuple:
    """(logits (8, 64) in dtype, prev (8,) int32): random rows at scale 3; a
    row of eight equal top logits (ties at the 3rd), one whose banned token
    is its largest logit, one whose banned token is its second, a row of equal
    logits (every entry ties), one whose top logits differ by less than c's
    rounding in bf16."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(8, 64)).astype(np.float32) * 3
    prev = rng.integers(4, 64, 8).astype(np.int32)
    x[1, 10:18] = 9.0
    x[2, prev[2]] = x[2].max() + 1.0
    x[3, prev[3]] = np.sort(x[3])[-2]
    x[4] = 0.5
    x[5, :6] = 7.0 + np.arange(6, dtype=np.float32) * 2e-3
    return torch.from_numpy(x).to(dtype), torch.from_numpy(prev)


def _kth_from_logits(logits, prev, k: int, temperature: float):
    """The kernel's rule: the k-th and (k-1)-th largest logits other than the
    banned one, their s through the port's own c and s, the banned entry's s
    merged in (kth = its s if it lies above the k-th and k = 1, else the
    smaller of it and the (k-1)-th)."""
    rows = torch.arange(logits.shape[0])
    s_free = divide_by_temperature(k9.sample_logprobs(logits, prev, False), temperature)
    s_ban = divide_by_temperature(k9.sample_logprobs(logits, prev, True), temperature)[rows, prev.long()]
    x = logits.float().clone()
    x[rows, prev.long()] = -float("inf")
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    kth = s_free.gather(1, order[:, k - 1:k])[:, 0] if k <= x.shape[1] - 1 else torch.full_like(s_ban, -float("inf"))
    if k == 1:
        return torch.where(s_ban > kth, s_ban, kth)
    before = s_free.gather(1, order[:, k - 2:k - 1])[:, 0]
    return torch.where(s_ban > kth, torch.minimum(s_ban, before), kth)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
def test_kth_value_from_the_kth_logit(dtype, temperature, k):
    """The k-th largest s, found from the k-th largest logit (the ban merged
    in), equals ``torch.topk`` of the banned s bit for bit at k 1, 3 (ties at
    the k-th in row 1), 8, and V = 64 (the ban's s is then the k-th); the
    row it filters is JAX's ``modified_sample_logits`` on the same c."""
    logits, prev = _rows(dtype)
    c = k9.sample_logprobs(logits, prev, True)
    s = divide_by_temperature(c, temperature)
    want = torch.topk(s, k, dim=-1).values[:, -1]
    got = _kth_from_logits(logits, prev, k, temperature)
    assert torch.equal(got, want)
    filtered = torch.where(s >= got[:, None], s, -1e30)
    ref = np.asarray(jax_sample.modified_sample_logits(jnp.asarray(c.numpy()), f"top{k}", temperature))
    np.testing.assert_array_equal(filtered.numpy(), ref)
    kept = (filtered > -1e29).sum(1)
    assert (kept >= min(k, 63)).all()
    if k == 3:
        assert kept[1] == 8  # the eight equal top logits all kept
    if k == 1:  # the banned largest logit is not the row's top-1
        assert filtered[2, prev[2]] == -1e30 and kept[2] == 1
    if k == 64:  # every entry kept, the banned one (its s about -1e30 / T) the k-th
        rows = torch.arange(8)
        assert (s >= got[:, None]).all() and torch.equal(got, s[rows, prev.long()])


# ---------------------------------------------------------------- nucleus
def _fixed(p: np.ndarray) -> np.ndarray:
    """62-bit fixed point of f32 p in [0, 1], truncated (exact for p >= 2^-39)."""
    return np.floor(p.astype(np.float64) * float(FIXED_ONE)).astype(np.uint64)


def _bisect_cut(p: np.ndarray, top_p: float, take=None):
    """A numpy model of ``nucleus_cut``: (kept (V,) bool, denom f32). The
    keys are p's bits (0 where `take`, the prefilter, is False); M(K) is the
    exact mass of the keys >= K in 62-bit fixed point; the crossing entry's
    key is K* = max{K : M(K) >= top_p} (the kernel probes 7 thresholds a
    step; here a bisection over the 31 bits);
    the g entries of p = K*'s value come in index order, the crossing one the
    j* = ceil((top - M(K* + 1)) / p) - 1-th. A row whose total stays below
    top_p keeps every entry."""
    p = np.asarray(p, np.float32)
    take = np.ones(p.shape, bool) if take is None else take
    keys = np.where(take, p.view(np.uint32), 0).astype(np.int64)
    fixed = [int(f) for f in np.where(take, _fixed(p), 0)]
    top = int(np.ceil(np.float64(np.float32(top_p)) * float(FIXED_ONE)))

    def mass(k):
        return sum(f for key, f in zip(keys, fixed) if key >= k)

    total = mass(0)
    if total < top:
        return np.ones(p.shape, bool), np.float32(total / FIXED_ONE)
    lo, hi, m_lo, m_hi = 0, 0x3F800001, total, 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        m = mass(mid)
        lo, m_lo, hi, m_hi = (mid, m, hi, m_hi) if m >= top else (lo, m_lo, mid, m)
    pf = int(_fixed(np.array([lo], np.uint32).view(np.float32))[0])
    cnt, jstar = (m_lo - m_hi) // pf, -(-(top - m_hi) // pf) - 1
    equal = np.flatnonzero(keys == lo)
    assert len(equal) == cnt
    kept = (keys > lo) | np.isin(np.arange(p.size), equal[: jstar + 1])
    return kept, np.float32((m_hi + (jstar + 1) * pf) / FIXED_ONE)


def _prefilter(e: np.ndarray, top_p: float) -> np.ndarray:
    """The kernel's prefilter on e = exp(s - max): the highest level 2^-6,
    2^-12, 2^-18, 2^-24 whose mass of e at or above it reaches (top_p +
    2^-12) of the sum takes the entries with e >= level (1 - 2^-21); else
    every entry."""
    total = float(e.astype(np.float64).sum())
    for j in range(1, 5):
        level = 2.0 ** (-6 * j)
        if float(e[e >= level].astype(np.float64).sum()) >= (np.float32(top_p) + 2.0 ** -12) * total:
            return e >= np.float32(level * (1 - 2.0 ** -21))
    return np.ones(e.shape, bool)


def _sorted_rule(p: np.ndarray, top_p: float) -> np.ndarray:
    """The sort's kept set with exact prefix sums: the first n_keep = 1 +
    #{j <= V - 2 : csum[j] < top_p} entries of the stable descending order."""
    order = np.argsort(-p, kind="stable")
    csum = np.cumsum(_fixed(p[order]).astype(object))
    top = int(np.ceil(np.float64(np.float32(top_p)) * float(FIXED_ONE)))
    n_keep = 1 + int(sum(1 for j in range(p.size - 1) if csum[j] < top))
    kept = np.zeros(p.size, bool)
    kept[order[:n_keep]] = True
    return kept


def _log_probs(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _nucleus_rows():
    """(name, f32 log-probs (1, V), top_p): a peaked row, a flat row that keeps
    about 90% of its entries, a row of equal p (1/32, exact), the four
    quarters at p = 0.5, a row of groups of equal p whose cut falls inside a
    group (the last digit, taken by index), and a row whose exact total stays
    below p = 1 - 2^-24 (the V - 2 rule binds: every entry kept)."""
    rng = np.random.default_rng(5)
    quarters = np.full((1, 20), -1000.0, np.float32)
    quarters[0, [3, 6, 11, 17]] = 10.0
    rows = [("peaked", rng.normal(size=(1, 300)).astype(np.float32) * 3, 0.9),
            ("flat", rng.normal(size=(1, 300)).astype(np.float32) * 0.05, 0.9),
            ("equal p", np.zeros((1, 32), np.float32), 0.55), ("quarters", quarters, 0.5),
            ("groups", np.repeat(np.float32([2.0, 1.0, 0.0]), [5, 20, 30])[None], 0.7)]
    rows = [(name, _log_probs(x), top) for name, x, top in rows]
    top = float(np.float32(1 - 2 ** -24))
    for seed in range(200):  # the first seeded row whose p (JAX's softmax) sum below top exactly
        lp = _log_probs(np.random.default_rng(100 + seed).normal(size=(1, 24)).astype(np.float32))
        p = np.asarray(jax.nn.softmax(jnp.asarray(lp), axis=-1))[0]
        if int(_fixed(p).astype(object).sum()) < int(np.ceil(np.float64(top) * FIXED_ONE)):
            rows.append(("total below p", lp, top))
            break
    return rows


NUCLEUS_ROWS = _nucleus_rows()


@pytest.mark.parametrize("name,lp,top_p", NUCLEUS_ROWS, ids=[r[0] for r in NUCLEUS_ROWS])
def test_nucleus_cut_on_exact_sums_gives_jax_kept_set(name, lp, top_p):
    """The model's kept set equals the sorted rule's on exact sums and
    JAX's ``modified_sample_logits`` (XLA's f32 cumsum) on these rows, whose
    cutoff sums lie clear of p or are exact; log(p / denom) of the kept
    entries within 1e-6 of JAX's; the prefilter changes neither the kept set
    nor the denominator."""
    assert len(NUCLEUS_ROWS) == 6
    method = f"top{top_p}"
    probs = np.asarray(jax.nn.softmax(jnp.asarray(lp), axis=-1))[0]
    kept, denom = _bisect_cut(probs, top_p)
    np.testing.assert_array_equal(kept, _sorted_rule(probs, top_p))
    ref = np.asarray(jax_sample.modified_sample_logits(jnp.asarray(lp), method, 1.0))[0]
    np.testing.assert_array_equal(kept, ref > -1e29)
    np.testing.assert_allclose(np.log(probs[kept] / denom), ref[kept], rtol=0, atol=STEP_LP_TOL)
    e = np.exp(lp[0] - lp[0].max()).astype(np.float32)  # the kernel's p = e / sum, with and without its prefilter
    p_k = (e / e.sum(dtype=np.float32)).astype(np.float32)
    take = _prefilter(e, top_p)
    kept_all, denom_all = _bisect_cut(p_k, top_p)
    kept_pre, denom_pre = _bisect_cut(p_k, top_p, take)
    np.testing.assert_array_equal(kept_pre, kept_all)
    assert denom_pre == denom_all
    if name == "peaked":  # the prefilter leaves out half of the row
        assert take.sum() < 0.5 * take.size
    n = int(kept.sum())
    if name == "quarters":  # 0.25 + 0.25 = 0.5 = p: the second quarter ends the prefix
        assert n == 2 and np.array_equal(np.flatnonzero(kept), [3, 6]) and denom == np.float32(0.5)
    if name == "equal p":  # 17 / 32 < 0.55 <= 18 / 32: the first 18 by index
        assert np.array_equal(np.flatnonzero(kept), np.arange(18))
    if name == "flat":
        assert 0.85 * lp.shape[1] < n < lp.shape[1]
    if name == "groups":  # the cut inside the group of 20 equal p, taken by index
        assert 5 < n < 25 and kept[:n].all() and not kept[n:].any()
    if name == "total below p":
        assert kept.all()


def test_plain_nucleus_matches_jax_above_16384():
    """The plain nucleus (``modified_sample_logits``) against JAX's at V =
    20,000 (the kernel's limit is now NUCLEUS_MAX_VOCAB), T 0.7, rows whose
    cutoff sums lie clear of p."""
    x = np.random.default_rng(6).normal(size=(3, 20000)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(lp) / np.float32(0.7), axis=-1)).astype(np.float64)
    csum = np.cumsum(-np.sort(-probs, axis=1), axis=1)
    assert (np.abs(csum - 0.9).min(axis=1) > 1e-6).all()
    ref = np.asarray(jax_sample.modified_sample_logits(jnp.asarray(lp), "top0.9", 0.7))
    got = modified_sample_logits(torch.from_numpy(lp.copy()), "top0.9", 0.7).numpy()
    np.testing.assert_array_equal(got > -1e29, ref > -1e29)
    assert ((got > -1e29).sum(1) > 1000).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=STEP_LP_TOL)


def test_shared_memory_limit_of_the_row_holding_modes():
    """``sample_smem`` (the C function's copy): 4 bytes an entry for the
    nucleus and for top-k above TOPK_REGISTER, none for the register top-k
    and the other modes; NUCLEUS_MAX_VOCAB the largest V within the block's
    dynamic limit, at least 49,152."""
    modes = k9.MODES
    assert k9.sample_smem(10000, modes["nucleus"], 0) == 40000
    assert k9.sample_smem(10000, modes["topk"], 3) == k9.sample_smem(10000, modes["topk"], 32) == 0
    assert k9.sample_smem(10000, modes["topk"], 33) == 40000
    assert k9.sample_smem(10000, modes["random"], 0) == k9.sample_smem(10000, modes["gumbel"], 0) == 0
    limit = k9.NUCLEUS_MAX_VOCAB
    assert limit == 56064 and limit >= 49152
    assert k9.sample_smem(limit, modes["nucleus"], 0) <= k9.MAX_DYNAMIC_SMEM
    assert k9.sample_smem(limit + 1, modes["nucleus"], 0) > k9.MAX_DYNAMIC_SMEM
