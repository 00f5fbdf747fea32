"""K2's backward in the ancestry mode and K3's backward as their Hopper
kernels plan the work, on the CPU: a torch model of each plan
(``csrc/ancestry_self_attention_bwd_anc.cu``, ``csrc/grouped_cross_attention_bwd.cu``)
held against the plain versions and ``jax.vjp`` of the JAX package's
``decode_self`` / ``decode_cross`` (identity projections, so the layer is
the attention alone), each with a planted fault that the comparison sees.

- K2: the inverted map (each (row, slot)'s readers in increasing order,
  from a first reader and a next reader a (reader, slot)) on the identity,
  from-beam-0 and random maps; the touched pairs staged a chunk of slots at
  a time (every slot at once, a few slots, one slot, or none: read in
  place), dk 13 read at its offset in a 16-byte envelope; dq summed chunk by
  chunk; dK / dV summed over each pair's reader list.
- K3: the staged rows (dk 13 from the 16-byte envelopes of the memory spans
  and of each q and dout row, repacked at width 16), dq summed over slices
  of the regions and joined, and pass 2's partition of (region, 16-byte
  group) outputs over the block's threads, each summing rows 0..rep-1.
The constants the Python side mirrors from the two sources are read back
from them."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_caption_tpu.models.layers import MultiHeadAttention as JaxMHA
from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
from sparse_caption_tpu_torch.kernels._checks import padded_width
from sparse_caption_tpu_torch.ops.attention import NEG_INF, score_divisor

CSRC = Path(_build.__file__).resolve().parent / "csrc"
TOL = dict(rtol=0, atol=1e-5)
THREADS = 512  # both kernels' blocks (csrc kAncBwdThreads, kCrossBwdThreads)


def _to_j(x):
    return jnp.asarray(x.detach().numpy())


def _eye_mha(h: int, dk: int, kv: bool):
    """The JAX package's attention layer with identity projections."""
    d = h * dk
    eye = {"kernel": jnp.eye(d), "bias": jnp.zeros(d)}
    names = ("q_proj", "kv_proj", "out_proj") if kv else ("q_proj", "k_proj", "v_proj", "out_proj")
    return (JaxMHA(num_heads=h, d_model=d, dropout_rate=0.0, share_att="kv" if kv else None),
            {"params": {name: eye for name in names}})


def _flat(x):
    """x's elements, then 16 NaNs: what a 16-byte envelope may read past the last element."""
    return torch.cat([x.contiguous().reshape(-1), torch.full((16,), float("nan"))])


def _dot4(a, b):
    """a . b as the kernels sum it: four partial sums over d = 4 g + i, then
    (x + y) + (z + w) (a width that is not whole vectors: one chain)."""
    prod = a * b
    if prod.shape[-1] % 4:
        return prod.sum(-1)
    part = prod.reshape(*prod.shape[:-1], -1, 4).sum(-2)
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


# ------------------------------------------------------------------ K2's backward, ancestry mode
def anc_map(kind: str, b: int, k: int, t_max: int, step: int, seed: int = 3):
    """A (B, K, T_max) map as a beam search leaves it at `step` (slot `step`
    the identity: each row wrote it)."""
    rng = np.random.default_rng(seed)
    anc = {"identity": np.tile(np.arange(k)[None, :, None], (b, 1, t_max)),
           "from_beam_0": np.zeros((b, k, t_max), np.int64),
           "random": rng.integers(0, k, (b, k, t_max))}[kind].astype(np.int32)
    anc[:, :, step] = np.arange(k)
    return torch.from_numpy(anc)


def inverted_map(anc_b, t_: int, fault: str = ""):
    """Step 1 of the plan for one image's map (K, T_max): a thread per
    (reader r, slot s) scans slot s's K entries; next[r, s] is the next
    reader of r's row (-1 none), first[j, s] the first reader of row j (-1
    none). `fault` "next_dropped": no next reader recorded."""
    k = anc_b.shape[0]
    first = torch.full((k, t_ + 1), -1, dtype=torch.int64)
    nxt = torch.full((k, t_ + 1), -1, dtype=torch.int64)
    for s in range(t_ + 1):
        col = anc_b[:, s].long()
        for r in range(k):
            same = (col == col[r]).nonzero().flatten().tolist()
            later = [o for o in same if o > r]
            if later and fault != "next_dropped":
                nxt[r, s] = later[0]
            if same[0] == r:
                first[col[r], s] = r
    return first, nxt


def readers(first, nxt, j: int, s: int) -> list:
    out, r = [], int(first[j, s])
    while r >= 0:
        out.append(r)
        r = int(nxt[r, s])
    return out


def k2_anc_bwd_model(q, ck, cv, dout, dck, dcv, t_: int, anc, cw=None, fault: str = ""):
    """The plan of csrc/ancestry_self_attention_bwd_anc.cu for (image, head)
    blocks: the inverted map; the touched pairs' K slots read a chunk of `cw`
    slots at a time (by default ``anc_bwd_chunk_slots``; 0: in place), at dk
    13 from the 16-byte envelope of the slot at its offset, V in place (the
    kv mode's one array is K); scores and dout
    . v (``_dot4``), the softmax, D and ds; dq summed chunk by chunk, each
    chunk's part added to the last; dK, dV over each pair's readers in order,
    added into dck / dcv in place (slot t's total to dk_t / dv_t, the slot
    zeroed). `fault`: "next_dropped" (the inverted map without next
    readers), "offset_ignored" (dk 13: a slot read from its envelope's
    start), "chunk_overwrites" (a chunk's dq part replaces the last).
    Returns (dq, dk_t, dv_t)."""
    n, h, dk = q.shape
    kb, t_max, t1 = anc.shape[1], ck.shape[2], t_ + 1
    kv = cv is None
    cw = k2.anc_bwd_chunk_slots(dk, kb, t_) if cw is None else cw
    span = cw if cw > 0 else t1
    chunks = [(s0, min(s0 + span, t1)) for s0 in range(0, t1, span)]
    divisor = torch.tensor(score_divisor(dk, torch.float32))
    flat_k, flat_v = _flat(ck), _flat(ck if kv else cv)
    dq, dk_t = torch.empty_like(q), torch.empty_like(q)
    dv_t = None if kv else torch.empty_like(q)

    def slot(flat, row: int, hh: int, s: int, staged: bool = True):
        """Slot s of (row, head): K staged (at dk 13 from its envelope), V read in place."""
        e0 = ((row * h + hh) * t_max + s) * dk
        if dk % 4 == 0 or cw == 0 or not staged:
            return flat[e0: e0 + dk]
        off = 0 if fault == "offset_ignored" else e0 % 4
        env = flat[e0 - e0 % 4: e0 - e0 % 4 + 16]  # 4 copies of 16 bytes
        return env[off: off + dk]

    for b in range(n // kb):
        amap = anc[b].long()
        first, nxt = inverted_map(anc[b], t_, fault)
        rows = b * kb + amap[:, :t1]  # (K, T1): the cache row each reader reads at each slot
        for hh in range(h):
            qr, gr = q[b * kb:(b + 1) * kb, hh], dout[b * kb:(b + 1) * kb, hh]
            sc, dp = torch.empty(kb, t1), torch.empty(kb, t1)
            for s0, s1 in chunks:
                for r in range(kb):
                    for s in range(s0, s1):
                        sc[r, s] = _dot4(qr[r], slot(flat_k, int(rows[r, s]), hh, s)) / divisor
                        dp[r, s] = _dot4(gr[r], slot(flat_v, int(rows[r, s]), hh, s, staged=kv))
            p = torch.softmax(sc, dim=-1)
            ds = p * (dp - (p * dp).sum(-1, keepdim=True)) / divisor
            dqr = torch.zeros(kb, dk)
            for c, (s0, s1) in enumerate(chunks):
                part = torch.zeros(kb, dk)
                for r in range(kb):
                    for s in range(s0, s1):
                        part[r] += ds[r, s] * slot(flat_k, int(rows[r, s]), hh, s)
                dqr = part if c == 0 or fault == "chunk_overwrites" else dqr + part
            dq[b * kb:(b + 1) * kb, hh] = dqr
            for j in range(kb):
                row = b * kb + j
                for s in range(t1):
                    who = readers(first, nxt, j, s)
                    last = s == t_
                    if not who and not last:
                        continue
                    gk, gv = torch.zeros(dk), torch.zeros(dk)
                    for r in who:
                        gk = gk + ds[r, s] * qr[r]
                        gv = gv + p[r, s] * gr[r]
                    if kv:
                        tot = dck[row, hh, s] + (gk + gv)
                        if last:
                            dk_t[row, hh] = tot
                            dck[row, hh, s] = 0
                        else:
                            dck[row, hh, s] = tot
                    elif last:
                        dk_t[row, hh], dv_t[row, hh] = dck[row, hh, s] + gk, dcv[row, hh, s] + gv
                        dck[row, hh, s], dcv[row, hh, s] = 0, 0
                    else:
                        dck[row, hh, s] += gk
                        dcv[row, hh, s] += gv
    return dq, dk_t, dv_t


def _k2_inputs(seed: int, b: int, k: int, h: int, t_max: int, dk: int, kv: bool):
    g = torch.Generator().manual_seed(seed)
    n = b * k
    q, dout = torch.randn(n, h, dk, generator=g), torch.randn(n, h, dk, generator=g)
    caches = [torch.randn(n, h, t_max, dk, generator=g) for _ in range(1 if kv else 2)]
    dcaches = [torch.randn(n, h, t_max, dk, generator=g) for _ in caches]
    return q, dout, caches, dcaches


def _k2_run(fn, q, dout, caches, dcaches0, step, anc, **kw):
    """fn's (dq, dk_t, dv_t) and the gradient buffers after it (fresh copies of dcaches0)."""
    kv = len(caches) == 1
    dcs = [c.clone() for c in dcaches0]
    out = fn(q, caches[0], None if kv else caches[1], dout, dcs[0], None if kv else dcs[1], step, anc, **kw)
    return [x for x in out if x is not None] + dcs


@pytest.mark.parametrize("kind", ["identity", "from_beam_0", "random"])
def test_k2_inverted_map_lists_each_pairs_readers_in_order(kind):
    """first / next give, for every (row j, slot s), exactly the readers r
    with anc[r, s] == j in increasing r, and no list for an untouched pair;
    the from-beam-0 map gives beam 0 every reader of the early slots."""
    k, t_max, step = 15, 25, 24
    anc = anc_map(kind, 2, k, t_max, step)
    for b in range(2):
        first, nxt = inverted_map(anc[b], step)
        for s in range(step + 1):
            for j in range(k):
                assert readers(first, nxt, j, s) == [r for r in range(k) if int(anc[b, r, s]) == j]
        if kind == "from_beam_0":
            assert readers(first, nxt, 0, 0) == list(range(k)) and int(first[1:, :step].max()) == -1
        if kind == "identity":
            assert torch.equal(first, torch.arange(k)[:, None].expand(k, step + 1)) and int(nxt.max()) == -1


@pytest.mark.parametrize("kind", ["identity", "from_beam_0", "random"])
@pytest.mark.parametrize("dk,kv", [(64, False), (64, True), (32, True), (13, False), (13, True)])
def test_k2_anc_bwd_plan_matches_plain(dk, kv, kind):
    """The plan at the first, a middle and the last step of a 7-slot cache
    (2 images x 5 beams, 2 heads; every slot staged at once) against
    ``ancestry_self_attention_backward_plain``: dq, dk_t (, dv_t) and the
    buffers after, element by element within 1e-5."""
    b, k, h, t_max = 2, 5, 2, 7
    q, dout, caches, dc0 = _k2_inputs(dk + 3 * kv, b, k, h, t_max, dk, kv)
    for step in (0, 3, t_max - 1):
        anc = anc_map(kind, b, k, t_max, step)
        got = _k2_run(k2_anc_bwd_model, q, dout, caches, dc0, step, anc)
        ref = _k2_run(k2.ancestry_self_attention_backward_plain, q, dout, caches, dc0, step, anc)
        for a, c in zip(got, ref):
            torch.testing.assert_close(a, c, **TOL)


@pytest.mark.parametrize("dk,kv", [(64, False), (32, True), (13, False), (13, True)])
def test_k2_anc_bwd_plan_matches_jax_vjp(dk, kv):
    """The plan against ``jax.vjp`` of ``decode_self`` through the map's
    one-hot (q = k_t (= v_t) = x_t): the input's gradient dq + dk_t (+ dv_t),
    the buffers' slots < t JAX's cache gradient added, slot t zeroed, later
    slots untouched; 2 images x 4 beams, 2 heads, step 4 of 7, a random map."""
    b, k, h, t_max, step = 2, 4, 2, 7, 4
    n, d = b * k, h * dk
    anc = anc_map("random", b, k, t_max, step, seed=dk)
    x, dout, caches, dc0 = _k2_inputs(dk + kv, b, k, h, t_max, dk, kv)
    for c in caches:
        c[:, :, step] = x
    dq, dk_t, *rest = _k2_run(k2_anc_bwd_model, x, dout, caches, dc0, step, anc)
    dv_t, dcs = (None, rest) if kv else (rest[0], rest[1:])
    mha, params = _eye_mha(h, dk, kv)
    onehot = jax.nn.one_hot(jnp.asarray(anc.numpy()), k, dtype=jnp.float32)

    def fn(xx, *cs):
        return mha.apply(params, xx, cs[0], None if kv else cs[1], step, False, onehot, method="decode_self")[0]

    _, vjp = jax.vjp(fn, _to_j(x.reshape(n, 1, d)), *map(_to_j, caches))
    jx, *jc = (torch.from_numpy(np.array(a)) for a in vjp(_to_j(dout.reshape(n, 1, d))))
    own = dq + (dk_t - dc0[0][:, :, step])
    if not kv:
        own = own + (dv_t - dc0[1][:, :, step])
    torch.testing.assert_close(own, jx.reshape(n, h, dk), **TOL)
    for got, before, want in zip(dcs, dc0, jc):
        torch.testing.assert_close(got[:, :, :step] - before[:, :, :step], want[:, :, :step], **TOL)
        assert not got[:, :, step].any() and torch.equal(got[:, :, step + 1:], before[:, :, step + 1:])


@pytest.mark.parametrize("cw", [0, 1, 3])
@pytest.mark.parametrize("dk,kv", [(64, False), (13, True)])
def test_k2_anc_bwd_chunked_walk_matches_plain(dk, kv, cw):
    """The long-cache walk: chunks of 3 slots and of 1 (staged again for
    dq), and none staged (the slots read in place), at the last step of a
    10-slot cache on a random map, against the plain version."""
    b, k, h, t_max = 1, 5, 2, 10
    step = t_max - 1
    q, dout, caches, dc0 = _k2_inputs(7 + dk + cw, b, k, h, t_max, dk, kv)
    anc = anc_map("random", b, k, t_max, step, seed=cw)
    got = _k2_run(k2_anc_bwd_model, q, dout, caches, dc0, step, anc, cw=cw)
    ref = _k2_run(k2.ancestry_self_attention_backward_plain, q, dout, caches, dc0, step, anc)
    for a, c in zip(got, ref):
        torch.testing.assert_close(a, c, **TOL)


@pytest.mark.parametrize("dk,k,t_,want", [
    (64, 15, 16, 17),    # the ORT's beam SCST: the whole grid of K, 69 KB
    (32, 15, 24, 25),    # ACORT-small's kv layers
    (64, 15, 1023, 9),   # the longest cache: chunks of 9 slots
    (13, 15, 1023, 38),
    (64, 18, 1023, 0),   # the fixed part leaves no room for a slot: read in place
])
def test_k2_anc_chunk_slots_by_hand(dk, k, t_, want):
    """``anc_bwd_chunk_slots``: (232,448 - the fixed part rounded to 16
    bytes) // (K x pitch x 4), at most t + 1."""
    fixed = -(-4 * k * (2 * dk + 3 * (t_ + 1)) // 16) * 16
    pitch = dk + 4 if dk % 4 == 0 else 20
    hand = 0 if fixed >= 232448 else min(t_ + 1, (232448 - fixed) // (4 * k * pitch))
    assert k2.anc_bwd_chunk_slots(dk, k, t_) == hand == want


@pytest.mark.parametrize("fault,dk,cw", [("next_dropped", 64, None), ("offset_ignored", 13, None),
                                         ("chunk_overwrites", 32, 2)])
def test_k2_anc_bwd_planted_faults_are_seen(fault, dk, cw):
    """Each fault of the plan moves a result past the tolerance: a reader
    list cut to its first reader (random map), a dk 13 slot read from its
    envelope's start, a chunk's dq part replacing the last."""
    b, k, h, t_max = 2, 5, 2, 7
    step = t_max - 1
    q, dout, caches, dc0 = _k2_inputs(11, b, k, h, t_max, dk, False)
    anc = anc_map("random", b, k, t_max, step)
    got = _k2_run(k2_anc_bwd_model, q, dout, caches, dc0, step, anc, cw=cw, fault=fault)
    ref = _k2_run(k2.ancestry_self_attention_backward_plain, q, dout, caches, dc0, step, anc)
    assert not all(torch.allclose(a, c, **TOL, equal_nan=False) for a, c in zip(got, ref))


# ------------------------------------------------------------------ K3's backward
def k3_bwd_model(q, mk, mv, mask, dout, fault: str = "", threads: int = THREADS):
    """The plan of csrc/grouped_cross_attention_bwd.cu for (image, head)
    blocks: K, V, q and dout staged at the padded width P (dk 13: from the
    16-byte envelopes of the memory spans and of each q and dout row,
    repacked, pad columns zero); scores, dout . v (``_dot4``), the softmax and
    ds (0 where masked); dq over Z = 128 / P slices of the regions, joined;
    pass 2's (region, group of 4 dims) outputs dealt to the block's threads
    in turn, each summing rows 0..rep-1. `fault`: "repack_shift" (dk 13: the
    spans read one element on), "slice_dropped" (dq without its last slice),
    "first_row_skipped" (pass 2 from row 1). Returns (dq, dK, dV or None,
    the times pass 2 wrote each (image, head, region, group), each thread's
    items)."""
    n, h, dk = q.shape
    b_, _, s_, _ = mk.shape
    rep, kv = n // b_, mv is None
    p_ = padded_width(dk)
    g_, z_ = p_ // 4, 32 // (p_ // 4)
    divisor = torch.tensor(score_divisor(dk, torch.float32))
    flats = {"k": _flat(mk), "v": _flat(mk if kv else mv), "q": _flat(q), "g": _flat(dout)}
    shift = 1 if fault == "repack_shift" else 0
    dq, dmk = torch.empty_like(q), torch.empty_like(mk)
    dmv = None if kv else torch.empty_like(mk)
    written = torch.zeros(b_, h, s_, g_, dtype=torch.int64)
    per_thread = torch.zeros(threads, dtype=torch.int64)

    def rows(which: str, e0: int, count: int, stride: int):
        """`count` rows of dk elements, row i at element e0 + i stride, at width P."""
        out = torch.zeros(count, p_)
        for i in range(count):
            # dk 13: the span's envelope holds it from its offset; "repack_shift" reads one element on
            e = e0 + i * stride + (shift if dk % 4 else 0)
            out[i, :dk] = flats[which][e: e + dk]
        return out

    for b in range(b_):
        for hh in range(h):
            base = (b * h + hh) * s_ * dk
            ks = rows("k", base, s_, dk)
            vs = rows("v", base, s_, dk)
            qs = rows("q", (b * rep * h + hh) * dk, rep, h * dk)
            gs = rows("g", (b * rep * h + hh) * dk, rep, h * dk)
            sc = _dot4(qs[:, None], ks[None]) / divisor
            sc = torch.where(mask[b][None], sc, torch.tensor(NEG_INF))
            p = torch.softmax(sc, dim=-1)
            dp = _dot4(gs[:, None], vs[None])
            ds = torch.where(mask[b][None], p * (dp - (p * dp).sum(-1, keepdim=True)) / divisor, 0.0)
            parts = [ds[:, z::z_] @ ks[z::z_] for z in range(z_ - (fault == "slice_dropped"))]
            dq[b * rep:(b + 1) * rep, hh] = torch.stack(parts).sum(0)[:, :dk]
            for e in range(s_ * g_):
                j, g = divmod(e, g_)
                per_thread[e % threads] += 1
                written[b, hh, j, g] += 1
                gk, gv = torch.zeros(4), torch.zeros(4)
                for r in range(1 if fault == "first_row_skipped" else 0, rep):
                    gk = gk + ds[r, j] * qs[r, 4 * g: 4 * g + 4]
                    gv = gv + p[r, j] * gs[r, 4 * g: 4 * g + 4]
                cols = slice(4 * g, min(4 * g + 4, dk))
                width = cols.stop - cols.start
                if kv:
                    dmk[b, hh, j, cols] = (gk + gv)[:width]
                else:
                    dmk[b, hh, j, cols], dmv[b, hh, j, cols] = gk[:width], gv[:width]
    return dq, dmk, dmv, written, per_thread


def _k3_inputs(seed: int, b: int, rep: int, h: int, s: int, dk: int, kv: bool):
    g = torch.Generator().manual_seed(seed)
    q, dout = torch.randn(b * rep, h, dk, generator=g), torch.randn(b * rep, h, dk, generator=g)
    mems = [torch.randn(b, h, s, dk, generator=g) for _ in range(1 if kv else 2)]
    mask = torch.rand(b, s, generator=g) < 0.8
    mask[:, 0] = True
    mask[-1] = False  # the last image has no valid region
    return q, dout, mems, mask


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("regions", [1, 36, 64])
@pytest.mark.parametrize("rep", [1, 5, 15, 16])
def test_k3_bwd_pass2_partition_matches_plain(rep, regions, kv):
    """Pass 2's partition: every (region, 16-byte group) of an (image, head)
    written once, a thread holding at most ceil(S x G / 512) of them, and the
    plan's dq, dK (, dV) against ``grouped_cross_attention_backward_plain``
    within 1e-5; masked regions' dK exactly 0. Head widths in turn: 64 at
    rep 1 and 15, 32 at 5, 13 at 16 (G = 16, 8, 4)."""
    dk = {1: 64, 5: 32, 15: 64, 16: 13}[rep]
    q, dout, mems, mask = _k3_inputs(rep + regions + kv, 2, rep, 2, regions, dk, kv)
    mv = None if kv else mems[1]
    dq, dmk, dmv, written, per_thread = k3_bwd_model(q, mems[0], mv, mask, dout)
    g_ = padded_width(dk) // 4
    assert bool((written == 1).all()) and int(per_thread.max()) == -(-regions * g_ // THREADS) * 2 * 2
    ref = k3.grouped_cross_attention_backward_plain(q, mems[0], mv, mask, dout)
    for got, want in zip((dq, dmk, dmv), ref):
        if want is not None:
            torch.testing.assert_close(got, want, **TOL)
    if not kv:
        assert not dmk[~mask[:, None, :, None].expand_as(dmk)].any()


@pytest.mark.parametrize("dk,kv", [(64, False), (64, True), (32, True), (13, False), (13, True)])
def test_k3_bwd_plan_matches_jax_vjp(dk, kv):
    """The plan against ``jax.vjp`` of ``decode_cross`` (identity
    projections): dq of every row and each image's memory gradient summed
    over its rows (kv: dK + dV); 3 images x 3 rows, 2 heads, 33 regions (at
    dk 13 no span 16-byte aligned), the last image with no valid region."""
    b, rep, h, s = 3, 3, 2, 33
    d = h * dk
    q, dout, mems, mask = _k3_inputs(dk + kv, b, rep, h, s, dk, kv)
    dq, dmk, dmv, _, _ = k3_bwd_model(q, mems[0], None if kv else mems[1], mask, dout)
    mha, params = _eye_mha(h, dk, kv)
    jmask = jnp.asarray(mask.numpy())[:, None, None, :].astype(jnp.float32)

    def fn(x, *ms):
        return mha.apply(params, x, ms[0], None if kv else ms[1], jmask, method="decode_cross")

    _, vjp = jax.vjp(fn, _to_j(q.reshape(b * rep, 1, d)), *map(_to_j, mems))
    jq, *jm = (torch.from_numpy(np.array(a)) for a in vjp(_to_j(dout.reshape(b * rep, 1, d))))
    torch.testing.assert_close(dq, jq.reshape(b * rep, h, dk), **TOL)
    for got, want in zip((dmk, dmv), jm):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("fault,dk", [("repack_shift", 13), ("slice_dropped", 32), ("first_row_skipped", 64)])
def test_k3_bwd_planted_faults_are_seen(fault, dk):
    """Each fault of the plan moves a result past the tolerance."""
    q, dout, mems, mask = _k3_inputs(5, 2, 5, 2, 36, dk, False)
    got = k3_bwd_model(q, mems[0], mems[1], mask, dout, fault=fault)[:3]
    ref = k3.grouped_cross_attention_backward_plain(q, mems[0], mems[1], mask, dout)
    assert not all(torch.allclose(a, c, **TOL) for a, c in zip(got, ref))


# ------------------------------------------------------------------ the sources' constants
def test_bwd_layouts_match_the_cuda_sources():
    """Both kernels' blocks of 512 threads, K2's stage pitch and chunk rule,
    K3's pitch, raw stage and shared memory, as the Python side mirrors
    them; K3's formula by hand at the paths' shapes."""
    anc = (CSRC / "ancestry_self_attention_bwd_anc.cu").read_text()
    cross = (CSRC / "grouped_cross_attention_bwd.cu").read_text()
    assert "constexpr int kAncBwdThreads = 512;" in anc and "constexpr int kCrossBwdThreads = 512;" in cross
    assert "return dk % 4 == 0 ? dk + 4 : 20;" in anc
    assert [k2.anc_bwd_stage_pitch(dk) for dk in (64, 32, 13)] == [68, 36, 20]
    assert "return fit < (size_t)(t + 1) ? (int)fit : t + 1;" in anc
    assert "const size_t slot = (size_t)K * anc_stage_pitch(dk) * sizeof(float);" in anc
    assert "return padded_width(dk) + 4;" in cross and "return (4 * n + 12 + 15) / 16 * 4;" in cross
    assert k3.bwd_raw_floats(36 * 13) == 472  # 118 copies of 16 bytes: 1,872 bytes at an offset up to 12
    # ORT: K, V 36 rows of 68 floats, 15 q and dout rows of 64, p and ds 15 x 36, 36 flags
    assert k3.bwd_smem(64, 36, 15) == (2 * 36 * 68 + 2 * 15 * 64 + 2 * 15 * 36) * 4 + 36
    # ORT-xsmall: width 16, the raw stage's two spans of 472 floats and 2 x 15 rows of 16
    assert k3.bwd_smem(13, 36, 15) == (2 * 36 * 20 + 2 * 15 * 16 + 2 * 472 + 2 * 15 * 16 + 2 * 15 * 36) * 4 + 36
    assert re.search(r"__launch_bounds__\(kAncBwdThreads, 2\)", anc)
    assert re.search(r"__launch_bounds__\(kCrossBwdThreads, 2\)", cross)
