"""K2's forward staged in shared memory, and K3's head-width-13 staging, on
the CPU: a torch model of each design's plan (which slots a warp copies,
over which 16-byte envelopes, at what offsets, and which staged row and
slot each beam reads) held against the plain versions and the JAX package;
the constants the Python side mirrors from the CUDA sources; the bound's
byte count and the loss rule of ``chip_smoke.py``; ``_build.build_all``'s
own compile seconds; and bf16 log-probs on peaked rows at the JAX
package's rounding points, far from one rounding from f32."""

import functools
import re
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_common import t, to_numpy
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
from sparse_caption_tpu_torch.kernels._checks import envelope_cap
from sparse_caption_tpu_torch.kernels.sample_step import sample_logprobs
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax_plain
from sparse_caption_tpu_torch.models import layers as pl
from sparse_caption_tpu_torch.ops.attention import NEG_INF, score_divisor
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables

CSRC = Path(_build.__file__).resolve().parent / "csrc"
KEY = jax.random.PRNGKey(0)
HEADS, BEAM, IMAGES = 8, 5, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _bytes(x):
    """x's bytes, then 32 bytes of 0xFF (a NaN in f32 and in bf16): what an
    envelope may read past the tensor's last element."""
    return torch.cat([x.contiguous().view(-1).view(torch.uint8), torch.full((32,), 255, dtype=torch.uint8)])


def _envelope(raw, start: int, nbytes: int):
    """The 16-byte envelope of the span of `nbytes` at byte `start` of a
    16-byte aligned tensor: (its bytes, the span's offset in it)."""
    lo = start // 16 * 16
    copies = -(-(start - lo + nbytes) // 16)
    return raw[lo: lo + 16 * copies], start - lo


def _round(x, dtype):
    return x.to(dtype).float()


def k2_staged_model(q, ck, cv, anc, t_: int, fault: str = ""):
    """K2's forward as csrc/ancestry_self_attention.cu's warps compute it, from
    the caches' bytes: the warp of (row n, head h) reads its map (slot s of
    row b K + anc[b, k, s]) and stages its slots in chunks of CHUNK_SLOTS, at
    dk 64 and 32 a slot's dk elements exactly (16-byte copies from 16-byte
    aligned addresses), at dk 13 the 16-byte envelope of a slot's 26 bytes,
    the slot read at its offset in it; the scores, softmax and p v from the
    stage, at the kernel's rounding points (the sums in another order).
    `fault` plants one of the chip mutants: "ancestor_ignored", "offset_by_one"
    (dk 13), "neighbour_row" (the row of the next beam). Returns (out, the
    envelopes' (offset, over-read bytes))."""
    n, h, dk = q.shape
    dtype, es = q.dtype, q.element_size()
    kb = 1 if anc is None else anc.shape[1]
    t_max, t1 = ck.shape[2], t_ + 1
    rb, pitch, cw = dk * es, k2.slot_pitch(dk, es), min(t1, k2.CHUNK_SLOTS)
    raws = {"k": _bytes(ck), "v": _bytes(ck if cv is None else cv)}
    divisor = torch.tensor(score_divisor(dk, dtype))
    out, envelopes = torch.empty_like(q), []
    rn = torch.arange(n)
    if anc is None or fault == "ancestor_ignored":
        rows = rn[:, None].expand(n, t1)
    else:
        rows = (rn // kb * kb)[:, None] + anc.reshape(n, t_max)[:, :t1].long()
    if fault == "neighbour_row":
        rows = rows // kb * kb + (rows % kb + 1) % kb

    def stage(which, r, hh, c0, c1):
        """A warp's stage of slots [c0, c1): (c1 - c0, dk) as read from shared memory."""
        st = torch.empty(c1 - c0, dk, dtype=dtype)
        for s in range(c0, c1):
            start = ((int(rows[r, s]) * h + hh) * t_max + s) * rb
            env, off = _envelope(raws[which], start, rb)
            assert env.numel() <= pitch and (rb % 16 != 0 or (off == 0 and env.numel() == rb))
            if which == "k":
                envelopes.append((off, env.numel() - rb))
            off += es if fault == "offset_by_one" else 0
            st[s - c0] = raws[which][start - start % 16 + off: start - start % 16 + off + rb].view(dtype)
        return st

    for r in range(n):
        for hh in range(h):
            keys, vals = torch.empty(t1, dk), torch.empty(t1, dk)
            for c0 in range(0, t1, cw):
                c1 = min(c0 + cw, t1)
                keys[c0:c1] = stage("k", r, hh, c0, c1).float()
                vals[c0:c1] = stage("v", r, hh, c0, c1).float()
            sc = _round(_round(keys @ q[r, hh].float(), dtype) / divisor, dtype)
            p = _round(torch.softmax(sc, dim=-1), dtype)
            out[r, hh] = (p @ vals).to(dtype)
    return out, envelopes


def _cache_inputs(seed, dk, t_max, dtype=torch.float32, images=IMAGES, beams=BEAM, heads=HEADS):
    rng = np.random.default_rng(seed)
    n = images * beams
    q, ck, cv = (torch.tensor(rng.normal(size=shape).astype(np.float32)).to(dtype)
                 for shape in ((n, heads, dk), (n, heads, t_max, dk), (n, heads, t_max, dk)))
    anc = torch.tensor(rng.integers(0, beams, size=(images, beams, t_max)).astype(np.int32))
    root = torch.tensor(rng.integers(0, beams, size=(images,)).astype(np.int32))
    return q, ck, cv, anc, root


# ------------------------------------------------------------------ the header mirror
def test_k2_layout_constants_match_the_cuda_source():
    """``CHUNK_SLOTS``, ``BLOCK_WARPS``, ``slot_pitch``, ``smem_bytes`` and
    ``envelope_cap`` are the CUDA sources' kK2ChunkSlots, kK2BlockWarps,
    k2_pitch, k2_smem_bytes and vec.cuh's envelope_cap, and K3's
    ``UNIT_HEADS`` its kXHeads."""
    src = (CSRC / "ancestry_self_attention.cu").read_text()
    (chunk,) = re.findall(r"constexpr int kK2ChunkSlots = (\d+);", src)
    (warps,) = re.findall(r"constexpr int kK2BlockWarps = (\d+);", src)
    assert (int(chunk), int(warps)) == (k2.CHUNK_SLOTS, k2.BLOCK_WARPS)
    assert "return dk * es % 16 == 0 ? dk * es + 16 : (dk * es + 15) / 16 * 16 + 16;" in src
    assert ("return 2 * cw * k2_pitch(dk, es) + 4 * (2 * k2_round4(t + 1) + k2_round4(dk)) + 2 * k2_round8(t + 1);"
            in src)
    assert "{ return kK2BlockWarps * k2_warp_bytes(dk, es, t); }" in src
    vec = (CSRC / "vec.cuh").read_text()
    assert "inline int envelope_cap(int bytes) { return (bytes + 15) / 16 * 16 + 16; }" in vec
    assert [envelope_cap(b) for b in (0, 1, 16, 26, 442, 1872)] == [16, 32, 32, 48, 464, 1888]
    (heads,) = re.findall(r"constexpr int kXHeads = (\d+);", (CSRC / "grouped_cross_attention.cu").read_text())
    assert int(heads) == k3.UNIT_HEADS
    assert [k2.slot_pitch(dk, es) for dk, es in ((64, 2), (32, 2), (64, 4), (32, 4), (13, 2), (13, 4))] == [
        144, 80, 272, 144, 48, 80]


@pytest.mark.parametrize("dk,es,t_,want", [
    # the ORT's serving step: 8 warps, each K and V stages of 17 slots at 144 bytes, 17 scores and rows
    # (rounded to 20), q (64 floats) and 17 staged offsets of 2 bytes (rounded to 24)
    (64, 2, 16, 8 * (2 * 17 * 144 + 4 * (2 * 20 + 64) + 2 * 24)),
    # ORT-xsmall: a slot's 26 bytes staged in its 48-byte envelope
    (13, 2, 16, 8 * (2 * 17 * 48 + 4 * (2 * 20 + 16) + 2 * 24)),
    # ACORT's 26 slots
    (32, 2, 25, 8 * (2 * 26 * 80 + 4 * (2 * 28 + 32) + 2 * 32)),
    # the longest cache, f32: stages of 32 slots, 1,024 scores, rows and offsets, within a block's 232,448 bytes
    (64, 4, 1023, 8 * (2 * 32 * 272 + 4 * (2 * 1024 + 64) + 2 * 1024)),
])
def test_k2_smem_by_hand(dk, es, t_, want):
    assert k2.smem_bytes(dk, es, t_) == want <= _build.BLOCK_SMEM_LIMIT


def test_k2_step_rule_matches_the_cuda_source():
    """``staged`` is csrc k2_staged: rows past CHUNK_SLOTS slots always
    stage; in bf16 from STAGED_FROM slots (12 and 10 at dk 64 unshared and
    kv, 7 at 32, 5 at 13: the crossovers measured against the walk); f32
    walks up to 32 slots; K2_WALK_STEP walks at every width."""
    src = (CSRC / "ancestry_self_attention.cu").read_text()
    assert "const int from = dk == 64 ? (kv ? 10 : 12) : (dk == 32 ? 7 : 5);" in src
    assert k2.STAGED_FROM == {64: (12, 10), 32: (7, 7), 13: (5, 5)}
    assert [k2.staged(64, 2, False, t) for t in (10, 11, 31, 32)] == [False, True, True, True]
    assert [k2.staged(64, 2, True, t) for t in (8, 9)] == [False, True]
    assert [k2.staged(13, 2, False, t) for t in (3, 4)] == [False, True]
    assert [k2.staged(64, 4, False, t) for t in (16, 31, 32)] == [False, False, True]
    assert not any(k2.staged(dk, es, kv, chip_smoke.K2_WALK_STEP) for dk in (64, 32, 13) for es in (2, 4)
                   for kv in (False, True))


# ------------------------------------------------------------------ K2's staging plan
@functools.lru_cache(maxsize=None)
def _layers(dk: int, kv: bool):
    """JAX's and the port's MultiHeadAttention at d = 8 dk, the same weights."""
    d = HEADS * dk
    mha = jl.MultiHeadAttention(num_heads=HEADS, d_model=d, share_att="kv" if kv else None)
    x = jnp.zeros((1, 1, d), jnp.float32)
    jv = mha.init(KEY, x, x, x)
    port = pl.MultiHeadAttention(HEADS, d, share_att="kv" if kv else None)
    port.load_state_dict(convert_jax_variables(to_numpy(jv)))
    return mha, jv, port.eval()


@pytest.mark.parametrize("kind", chip_smoke.K2_MAPS)
@pytest.mark.parametrize("t_max", [17, 26, 60])
@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("dk", [64, 32, 13])
def test_k2_staging_plan_matches_plain_and_jax(dk, kv, t_max, kind):
    """The staged design (f32) at the first, middle and last step of the
    cache, on a uniform random map and on one collapsed as a real search
    leaves it (every beam from one beam over the first floor(t / 2) slots):
    against ``ancestry_self_attention_plain``, and, through the layer's
    projections, against JAX's ``MultiHeadAttention.decode_self`` with the
    map as its one-hot (1e-5)."""
    rng = np.random.default_rng(dk + t_max + 7 * kv)
    n, d = IMAGES * BEAM, HEADS * dk
    mha, jv, port = _layers(dk, kv)
    x_t = rng.normal(size=(n, 1, d)).astype(np.float32)
    ck = rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    cv = None if kv else rng.normal(size=(n, HEADS, t_max, dk)).astype(np.float32)
    anc0 = torch.tensor(rng.integers(0, BEAM, size=(IMAGES, BEAM, t_max)).astype(np.int32))
    root = torch.tensor(rng.integers(0, BEAM, size=(IMAGES,)).astype(np.int32))
    for step in chip_smoke.k2_steps(t_max):
        anc = chip_smoke.k2_map(anc0, kind, step, root)
        ref, _, _ = mha.apply(jv, jnp.asarray(x_t), jnp.asarray(ck), None if kv else jnp.asarray(cv), step,
                              method="decode_self", ancestry_onehot=jax.nn.one_hot(jnp.asarray(anc), BEAM))
        with torch.no_grad():
            q, k_t, v_t = port._step_qkv(t(x_t), None)
            pk, pv = t(ck), None if kv else t(cv)
            pk[:, :, step] = k_t
            if not kv:
                pv[:, :, step] = v_t
            staged, _ = k2_staged_model(q, pk, pv, anc, step)
            torch.testing.assert_close(staged, k2.ancestry_self_attention_plain(q, pk, pv, anc, step), **TOL)
            got = port.out_proj(staged.reshape(n, 1, d))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dk,kv,t_max,dtype", [
    (64, False, 250, torch.float32),   # 32-slot chunks: the chunks of pass 1 and 2
    (64, True, 250, torch.bfloat16),
    (13, False, 1024, torch.bfloat16),  # 32 chunks of envelopes
    (13, True, 60, torch.bfloat16),
    (32, False, 26, torch.bfloat16),
])
def test_k2_staging_plan_long_caches_and_bf16(dk, kv, t_max, dtype):
    """Chunks (T_max past a warp's stage of 32 slots) and bf16, at the last
    step, one image: against the plain version, bf16 within chip_smoke's
    bound (2 u |ref| + 8 u rms(V)), f32 within 1e-5."""
    q, ck, cv, anc, root = _cache_inputs(dk + t_max, dk, t_max, dtype, images=1)
    cv = None if kv else cv
    step = t_max - 1
    anc_t = chip_smoke.k2_map(anc, "collapsed", step, root)
    got, _ = k2_staged_model(q, ck, cv, anc_t, step)
    ref = k2.ancestry_self_attention_plain(q, ck, cv, anc_t, step)
    _, good, worst = chip_smoke.close(got, ref, dtype, chip_smoke.rms(ck if kv else cv))
    assert good, worst


def test_k2_identity_map_stages_each_row_its_own_span():
    """The SCST sampling decode's instance: no map, every row reads its own
    slots (960 rows there; 6 here), dk 64 and 13."""
    for dk in (64, 13):
        q, ck, cv, _, _ = _cache_inputs(dk, dk, 17, images=6, beams=1)
        for step in chip_smoke.k2_steps(17):
            got, _ = k2_staged_model(q, ck, cv, None, step)
            torch.testing.assert_close(got, k2.ancestry_self_attention_plain(q, ck, cv, None, step), **TOL)


@pytest.mark.parametrize("t_max", chip_smoke.K2_ODD_SPANS)
def test_k2_dk13_slots_start_at_every_even_offset_and_over_read_at_most_22_bytes(t_max):
    """At dk 13 slot s of (row, head) starts ((row H + head) T_max + s) 26
    bytes in (bf16): its offset in a 16-byte block takes every even value at
    T_max 17, 26 and 60, and its envelope (2 or 3 copies) reads at most 22
    bytes past it."""
    q, ck, cv, anc, _ = _cache_inputs(t_max, 13, t_max, torch.bfloat16)
    _, env = k2_staged_model(q, ck, cv, chip_smoke.k2_map(anc, "uniform", t_max - 1), t_max - 1)
    assert {off for off, _ in env} == set(range(0, 16, 2)) and max(extra for _, extra in env) == 22


@pytest.mark.parametrize("fault,dk", [("ancestor_ignored", 64), ("neighbour_row", 32), ("neighbour_row", 13),
                                      ("offset_by_one", 13)])
def test_k2_planted_faults_of_the_plan_are_seen(fault, dk):
    """Each index fault the chip mutants plant, in the model, moves the
    output past the tolerance."""
    q, ck, cv, anc, root = _cache_inputs(3, dk, 17)
    step = 16
    anc_t = chip_smoke.k2_map(anc, "uniform", step, root)
    got, _ = k2_staged_model(q, ck, cv, anc_t, step, fault=fault)
    ref = k2.ancestry_self_attention_plain(q, ck, cv, anc_t, step)
    assert not torch.allclose(got, ref, **TOL)


# ------------------------------------------------------------------ K3's dk 13 repack
def k3_repack_model(q, mk, mv, mask, fault: str = ""):
    """K3's bf16 kernel at dk 13 as csrc/grouped_cross_attention.cu stages a
    unit (an image's heads h0, h0 + 1): the K span (its heads' S rows), the
    V span and each beam's q span (its 2 heads) copied whole over their
    16-byte envelopes, then repacked into rows of kXLd = 24 elements,
    columns 13-15 zero; the scores, softmax and P V from those rows.
    `fault` "repack_shift": every row repacked from one column on."""
    b_, h, s, dk = mk.shape
    rep, dtype, es = q.shape[0] // b_, q.dtype, q.element_size()
    raw_q, raw_k, raw_v = _bytes(q), _bytes(mk), _bytes(mk if mv is None else mv)
    divisor = torch.tensor(score_divisor(dk, dtype))
    out = torch.empty_like(q)
    shift = 1 if fault == "repack_shift" else 0

    def rows_of(raw, start_elem, nrows):
        """`nrows` rows of dk elements at element `start_elem`: the span's envelope, then its rows at width 24."""
        env, off = _envelope(raw, start_elem * es, nrows * dk * es)
        assert env.numel() <= envelope_cap(nrows * dk * es)
        tile = torch.zeros(nrows, 24, dtype=dtype)
        base = start_elem * es + shift * es  # the span's first byte: off bytes into its envelope
        for r in range(nrows):
            tile[r, :dk] = raw[base + r * dk * es: base + (r + 1) * dk * es].view(dtype)
        return tile.float()

    for b in range(b_):
        for h0 in range(0, h, k3.UNIT_HEADS):
            hn = min(k3.UNIT_HEADS, h - h0)
            kt = rows_of(raw_k, (b * h + h0) * s * dk, hn * s)
            vt = rows_of(raw_v, (b * h + h0) * s * dk, hn * s)
            for r in range(rep):
                qt = rows_of(raw_q, ((b * rep + r) * h + h0) * dk, hn)
                for hl in range(hn):
                    sc = _round(_round(kt[hl * s: (hl + 1) * s, :16] @ qt[hl, :16], dtype) / divisor, dtype)
                    sc = torch.where(mask[b], sc, _round(torch.tensor(NEG_INF), dtype))
                    p = _round(torch.softmax(sc, -1), dtype)
                    o = p @ vt[hl * s: (hl + 1) * s, :16]
                    out[b * rep + r, h0 + hl] = o[:dk].to(dtype)
    return out


@pytest.mark.parametrize("regions,rep,heads,kv", [(36, 5, 8, False), (36, 5, 8, True), (33, 3, 5, False),
                                                  (20, 7, 8, True)])
def test_k3_dk13_repack_matches_plain_and_jax(regions, rep, heads, kv):
    """The dk 13 unit's envelope copies and repack (f32 here: the same spans
    at 4 bytes an element) against ``grouped_cross_attention_plain`` and
    JAX's ``decode_cross`` through the layer (1e-5); at 33 regions and 5
    heads no span is 16-byte aligned and the last unit has one head."""
    rng = np.random.default_rng(regions + rep)
    dk, d = 13, heads * 13
    x_t = rng.normal(size=(IMAGES * rep, 1, d)).astype(np.float32)
    mk = rng.normal(size=(IMAGES, heads, regions, dk)).astype(np.float32)
    mv = None if kv else rng.normal(size=(IMAGES, heads, regions, dk)).astype(np.float32)
    amask = np.ones((IMAGES, regions), np.float32)
    amask[1, -3:] = 0.0
    mha = jl.MultiHeadAttention(num_heads=heads, d_model=d, share_att="kv" if kv else None)
    x0 = jnp.zeros((1, 1, d), jnp.float32)
    jv = mha.init(KEY, x0, x0, x0)
    ref = mha.apply(jv, jnp.asarray(x_t), jnp.asarray(mk), None if kv else jnp.asarray(mv),
                    jnp.asarray(amask)[:, None, None, :], method="decode_cross")
    port = pl.MultiHeadAttention(heads, d, share_att="kv" if kv else None).eval()
    port.load_state_dict(convert_jax_variables(to_numpy(jv)))
    with torch.no_grad():
        q = port.q_proj(t(x_t), None).reshape(IMAGES * rep, heads, dk)
        valid = t(amask) != 0
        got = k3_repack_model(q, t(mk), None if kv else t(mv), valid)
        torch.testing.assert_close(got, k3.grouped_cross_attention_plain(q, t(mk), None if kv else t(mv), valid),
                                   **TOL)
        np.testing.assert_allclose(port.out_proj(got.reshape(IMAGES * rep, 1, d)).numpy(), np.asarray(ref), **TOL)


def test_k3_dk13_repack_in_bf16_and_its_planted_shift():
    """bf16 at ORT-xsmall's shape (36 regions, beam 5): the repack against
    the plain version within chip_smoke's bound; the repack shifted by one
    column (the chip mutant) is far outside it."""
    rng = np.random.default_rng(13)
    q, mk, mv = (torch.tensor(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
                 for shape in ((IMAGES * BEAM, HEADS, 13), (IMAGES, HEADS, 36, 13), (IMAGES, HEADS, 36, 13)))
    valid = torch.tensor(np.arange(36)[None, :] < np.array([[30], [36]]))
    ref = k3.grouped_cross_attention_plain(q, mk, mv, valid)
    _, good, worst = chip_smoke.close(k3_repack_model(q, mk, mv, valid), ref, torch.bfloat16, chip_smoke.rms(mv))
    assert good, worst
    _, good, _ = chip_smoke.close(k3_repack_model(q, mk, mv, valid, "repack_shift"), ref, torch.bfloat16,
                                  chip_smoke.rms(mv))
    assert not good


# ------------------------------------------------------------------ chip_smoke's helpers
def test_k2_bytes_count_each_named_pair_once():
    """K2's bound at step t: the distinct (row, slot) pairs a map names over
    slots 0..t (K and V, or the one kv cache), q and out a row, the map's
    columns 0..t; the identity map: every row's own slots, no map."""
    anc = torch.tensor([[[0, 0, 0, 1], [0, 1, 1, 1], [2, 2, 0, 2]]], dtype=torch.int32)  # (1, 3, 4)
    # slot 0: rows {0, 2}; slot 1: {0, 1, 2}; slot 2: {0, 1}: 7 pairs over slots 0..2
    row = HEADS * 64 * 2
    assert chip_smoke.k2_bytes(3, 2, torch.bfloat16, anc) == (2 * 7 + 2 * 3) * row + 4 * 3 * 3
    assert chip_smoke.k2_bytes(3, 2, torch.bfloat16, anc, kv=True) == (7 + 2 * 3) * row + 4 * 3 * 3
    assert chip_smoke.k2_bytes(3, 0, torch.bfloat16, anc) == (2 * 2 + 2 * 3) * row + 4 * 3
    assert chip_smoke.k2_bytes(960, 16, torch.float32, None, dk=13) == (2 * 960 * 17 + 2 * 960) * HEADS * 13 * 4


def test_k2_map_collapses_the_first_half():
    anc = torch.randint(0, 5, (3, 5, 17), generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    root = torch.tensor([4, 0, 2], dtype=torch.int32)
    got = chip_smoke.k2_map(anc, "collapsed", 9, root)
    assert torch.equal(got[:, :, :4], root[:, None, None].expand(3, 5, 4))
    assert torch.equal(got[:, :, 4:9], anc[:, :, 4:9]) and torch.equal(got[:, :, 10:], anc[:, :, 10:])
    assert torch.equal(got[:, :, 9], torch.arange(5, dtype=torch.int32).expand(3, 5))
    assert torch.equal(chip_smoke.k2_map(anc, "uniform", 9)[:, :, :9], anc[:, :, :9])
    assert chip_smoke.k2_steps(17) == (0, 8, 16) and chip_smoke.k2_steps(26) == (0, 12, 25)


def test_steps_loss_sums_the_linear_gap_over_the_path_by_hand():
    """Launches a step x the sum over steps of (time - bound), both linear in
    t between the timed steps: gaps 0.5 at t = 0, 1.0 at t = 2 (so 0.75 at
    t = 1), 2.0 at t = 4 (1.5 at t = 3): 2 x 5.75."""
    timed = {0: (1.0, 0.5), 2: (2.0, 1.0), 4: (3.0, 1.0)}
    assert chip_smoke.steps_loss(2, 5, timed) == pytest.approx(2 * (0.5 + 0.75 + 1.0 + 1.5 + 2.0))
    # one timed gap everywhere: launches x steps x gap (the old full-gap rule at a constant gap)
    assert chip_smoke.steps_loss(6, 17, {0: (0.2, 0.1), 8: (0.2, 0.1), 16: (0.2, 0.1)}) == pytest.approx(
        6 * 17 * 0.1)
    with pytest.raises(ValueError):
        chip_smoke.steps_loss(6, 17, {0: (0.2, 0.1), 8: (0.2, 0.1)})


def test_check_k2_forward_runs_every_step_and_map_with_its_faults():
    """chip_smoke's K2 check on the CPU (where the wrapper runs the plain
    version): four steps (the three timed ones and K2_WALK_STEP) x two maps,
    each compared, its fault shown apart from the reference past step 0,
    and the kv mode bit-equal to the unshared call."""
    q, ck, _, anc, root = _cache_inputs(5, 32, 9, torch.bfloat16)
    seen, faults, equal = [], [], []

    def compare(name, out, ref, scale, fault=None):
        seen.append(name)
        if fault is not None:
            faults.append(not torch.equal(fault, ref))
        return float((out.float() - ref.float()).abs().max())

    bits = lambda *a: None  # noqa: E731
    err = chip_smoke.check_k2_forward("k2 kv", q, ck, None, anc, root, compare, bits,
                                      lambda name, a, b: equal.append(torch.equal(a, b)))
    assert err == 0.0 and all(faults) and len(faults) == 6 and all(equal)
    assert seen == [f"k2 kv t={s} {kind}" for s in (0, 3, 4, 8) for kind in chip_smoke.K2_MAPS]


# ------------------------------------------------------------------ the build's own seconds
def test_build_all_reports_each_librarys_own_compile_seconds(tmp_path, monkeypatch):
    """Libraries compile in parallel; each reports the seconds of its own
    compiler process (0.2 and 0.6 s here, a stand-in nvcc), not the time
    its wait returned in the sources' order."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nfor a; do out=$src; src=$a; done\n"
                    "case \"$src\" in *slow*) sleep 0.6;; *) sleep 0.2;; esac\n"
                    "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift; done\n")
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("slow", "fast"):
        (csrc / f"{name}.cu").write_text("// stand-in\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", ("slow", "fast"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    t0 = time.perf_counter()
    seconds = _build.build_all()
    assert time.perf_counter() - t0 < 1.2  # in parallel
    assert 0.55 < seconds["slow"] < 1.0 and 0.15 < seconds["fast"] < 0.5
    assert _build.build_all() == {}  # loaded: nothing to build


# ------------------------------------------------------------------ bf16 log-probs on peaked rows
def _bf16_ulps(a, b):
    bits = [torch.as_tensor(x).to(torch.bfloat16).view(torch.int16).int() for x in (a, b)]
    return (bits[0] - bits[1]).abs()


def test_k9_bf16_peaked_logprobs_round_in_two_orders():
    """bf16 rows at scale 10, V = 10,000 (the peaked rows of K9's check):
    ``jax.nn.log_softmax`` on the bf16 logits (``models/layers.py:472``)
    rounds x - max and the log-sum to bf16 before their difference. The
    port's plain rule (``vocab_log_softmax_plain``, K13's, K4's and K9's
    twin, and ``sample_logprobs``) rounds at the same points: equal to JAX's
    at every entry. One rounding from f32 (the order the port followed
    before) is far from it: most chosen log-probs differ, next to 0 by more
    than 64 bf16 ulps, and entries up to 0.5 apart."""
    rng = np.random.default_rng(0)
    rows, vocab = 256, 10_000
    x = torch.tensor(rng.standard_normal((rows, vocab)).astype(np.float32) * 10).to(torch.bfloat16)
    jx = torch.tensor(np.asarray(jax.nn.log_softmax(jnp.asarray(x.float().numpy(), jnp.bfloat16), axis=-1)
                                 .astype(jnp.float32)))
    vp = vocab_log_softmax_plain(x).float()
    sp = sample_logprobs(x, torch.zeros(rows, dtype=torch.int32), False)
    assert torch.equal(vp, jx) and torch.equal(sp, jx)
    once = torch.log_softmax(x.float(), dim=-1).to(torch.bfloat16).float()
    chosen = (torch.arange(rows), x.float().argmax(1))
    far = _bf16_ulps(jx[chosen], once[chosen])
    assert far.max() > 64 and (far > 0).float().mean() > 0.5
    assert (jx - once).abs().max() <= 0.5
