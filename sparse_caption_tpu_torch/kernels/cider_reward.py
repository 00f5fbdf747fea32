"""K10: the SCST reward, CIDEr-D x 10 + BLEU-1..4 per sampled caption
(``csrc/cider_reward.cu``).

``cider_reward(ids, img_idx, table, pack, ...)`` scores each row of ``ids``
against the references of its image: first-EOS truncation with pad/bos
skipped anywhere, n-grams packed into (hi, lo) uint32 keys, tf and
first-occurrence dedup by all-pairs key equality, the candidate's idf from
the open-addressed df table (linear probe), the clipped cross term against
the image's (R, L) reference pack, the Gaussian length penalty (sigma 6,
"length" counting bigrams) and the BLEU brevity penalty. CUDA tensors launch
the kernel; CPU tensors run ``cider_reward_plain``, a vectorised torch port
of ``_grams``, ``_df_lookup`` and ``_score_one``
(``sparse_caption_tpu/scst/device_reward.py:309-389``). f32 throughout, as
the JAX device function is. Nothing else falls back.

uint32 keys travel as int32 tensors holding the same bits; the plain
version widens them to int64 and wraps its arithmetic mod 2^32.

Radix mode (``radix=RadixSpec(...)``, ACORT's digit ids): each row of digits
is first regrouped into word ids (``radix_to_word``, the plain version, a
port of ``make_radix_to_word_fn``, ``sparse_caption_tpu/scst/
device_reward.py:235-280``), which are then scored as word rows with the
word-level eos / pad / bos ids 3 / 0 / 2. On the card the kernel does the
regroup in its prologue, in the same launch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_same_device, check_tensor

KERNEL = _build.CudaKernel("cider_reward", "sct_cider_reward", [
    _build.P, _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
    _build.F32, _build.I, _build.I, _build.I, _build.F32, _build.F32, _build.F32, _build.F32, _build.F32, _build.I,
    _build.I, _build.I, _build.I, _build.P, _build.P,
])
N_GRAMS = 4
SIGMA = 6.0
M32 = 0xFFFFFFFF
MAX_T, MAX_R = 32, 32  # the kernel's G = 4T <= 128 gram slots (one per thread) and refs per image
PACK_KEYS = ("hi", "lo", "val", "cnt", "norms", "lens", "wlens", "ref_valid", "n_refs")
WORD_EOS, WORD_PAD, WORD_BOS, WORD_UNK = 3, 0, 2, 1  # the word-level ids of a regrouped row


class RadixSpec(NamedTuple):
    """ACORT's radix code: ``tokens_per_word`` base-``base`` digits a word over
    a word vocabulary of ``word_vocab_size`` entries (pad, unk, bos, eos and
    the words; the last word slot is <unk>'s)."""

    base: int
    tokens_per_word: int
    word_vocab_size: int

    @property
    def n_words(self) -> int:
        return self.word_vocab_size - 3  # <unk> shares the last word slot

    def word_slots(self, t: int) -> int:
        """Word slots of a row of ``t`` digits: ceil(t / tokens_per_word)."""
        return -(-t // self.tokens_per_word)


def check_radix(spec: RadixSpec) -> RadixSpec:
    spec = RadixSpec(int(spec.base), int(spec.tokens_per_word), int(spec.word_vocab_size))
    if spec.base < 2 or spec.tokens_per_word < 1 or spec.n_words < 1:
        raise ValueError(f"bad radix spec {spec}")
    assert spec.base ** spec.tokens_per_word < 2 ** 31, "radix word values overflow int32"
    return spec


def radix_to_word(ids: torch.Tensor, spec: RadixSpec) -> torch.Tensor:
    """(N, T) radix digit ids -> (N, ceil(T / tpw)) int32 word ids (the plain
    version of K10's radix mode): truncate at the first radix <eos>, drop
    pad and bos digits anywhere, group the rest by ``tokens_per_word`` (a
    short tail filled with digit 1), value = sum of max(d - 1, 0) base^(tpw -
    1 - k), word v + 4 for v < n_words - 1 and <unk> 1 otherwise, word pad
    0 after the last word."""
    spec = check_radix(spec)
    base, tpw = spec.base, spec.tokens_per_word
    n, t = ids.shape
    ids = ids.long()
    is_eos = ids == base + 2
    keep = ((torch.cumsum(is_eos, 1) - is_eos.long()) == 0) & (ids != 0) & (ids != base + 1) & ~is_eos
    pos = torch.cumsum(keep, 1) - 1
    n_digits = keep.sum(1)
    t_w = spec.word_slots(t)
    d = torch.ones((n, t_w * tpw + 1), dtype=torch.long, device=ids.device)  # the fill digit 1; the last column a sink
    d.scatter_(1, torch.where(keep, pos, torch.full_like(pos, t_w * tpw)), ids)
    d = torch.clamp(d[:, : t_w * tpw] - 1, min=0).reshape(n, t_w, tpw)
    powers = torch.tensor([base ** (tpw - 1 - j) for j in range(tpw)], dtype=torch.long, device=ids.device)
    v = (d * powers).sum(2)
    wid = torch.where(v < spec.n_words - 1, v + 4, torch.full_like(v, WORD_UNK))
    valid = torch.arange(t_w, device=ids.device)[None, :] < -(-n_digits[:, None] // tpw)
    return torch.where(valid, wid, torch.full_like(wid, WORD_PAD)).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value in int64."""
    return x.long() & M32


def _mul32(a: int, x: torch.Tensor) -> torch.Tensor:
    """(a * x) mod 2^32 for int64 x in [0, 2^32), without overflowing int64."""
    return (a * (x & 0xFFFF) + (((a * (x >> 16)) & 0xFFFF) << 16)) & M32


def mix(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The df table's uint32 hash of a packed gram key (``device_reward._mix``)."""
    h = _mul32(2654435761, hi) ^ _mul32(0x9E3779B9, lo)
    h = h ^ (h >> 16)
    h = _mul32(0x85EBCA6B, h)
    return h ^ (h >> 13)


def grams(ids: torch.Tensor, eos_id: int, pad_id: int, bos_id: int):
    """(N, T) ids -> gram keys (hi, lo) (N, 4T) int64, order (4T,), validity
    (N, 4T) and caption length (N,): slot n*T + s holds the (n+1)-gram
    starting at word s of the compacted caption."""
    n_rows, t = ids.shape
    ids = ids.long()
    is_eos = ids == eos_id
    before_eos = (torch.cumsum(is_eos, 1) - is_eos.long()) == 0
    valid = before_eos & ~is_eos & (ids != pad_id) & (ids != bos_id)
    pos = torch.cumsum(valid, 1) - 1
    length = valid.sum(1)
    u = torch.zeros((n_rows, t + 1), dtype=torch.long, device=ids.device)
    u.scatter_(1, torch.where(valid, pos, torch.full_like(pos, t)), ids + 1)
    u = torch.cat([u[:, :t], torch.zeros((n_rows, 3), dtype=torch.long, device=ids.device)], 1)
    u0, u1, u2, u3 = (u[:, i: i + t] for i in range(4))
    zt = torch.zeros_like(u0)
    ghi = torch.cat([zt, zt, u0, (u0 << 16) | u1], 1)
    glo = torch.cat([u0, (u0 << 16) | u1, (u1 << 16) | u2, (u2 << 16) | u3], 1)
    starts = torch.arange(t, device=ids.device)
    gvalid = torch.cat([starts[None, :] <= (length[:, None] - n) for n in range(1, N_GRAMS + 1)], 1)
    gn = torch.arange(N_GRAMS, device=ids.device).repeat_interleave(t)
    return ghi, glo, gn, gvalid, length


def df_lookup(table: Dict[str, torch.Tensor], probe: int, ghi, glo):
    """log(max(1, df)) of each gram, 0 where the table has no entry."""
    thi_all, tlo_all = _u32(table["hi"]), _u32(table["lo"])
    size = thi_all.shape[0]
    idx = ((mix(ghi, glo) & (size - 1))[..., None] + torch.arange(probe, device=ghi.device)) % size
    thi, tlo = thi_all[idx], tlo_all[idx]
    hit = (thi == ghi[..., None]) & (tlo == glo[..., None]) & ((thi | tlo) != 0)
    return torch.where(hit, table["val"][idx], torch.zeros((), device=ghi.device)).sum(-1)


def first_occurrence(eqv, gvalid):
    """(N, G) bool: a valid gram slot with no earlier slot of the same key."""
    return gvalid & (torch.tril(eqv, -1).sum(2) == 0)


def length_penalty(lh, rlens):
    """(N, R) Gaussian penalty of the candidate's against each ref's "length"."""
    return torch.exp(-((lh[:, None] - rlens) ** 2) / (2 * SIGMA ** 2))


def cider_reward_plain(ids, img_idx, table: Dict[str, torch.Tensor], pack: Dict[str, torch.Tensor], *, probe: int,
                       ref_len: float, eos_id: int = 3, pad_id: int = 0, bos_id: int = 2, cider_weight: float = 1.0,
                       bleu_weight: Sequence[float] = (0.0, 0.0, 0.0, 0.0)):
    dev = ids.device
    f32 = torch.float32
    ghi, glo, gn, gvalid, length = grams(ids, eos_id, pad_id, bos_id)
    eq = (ghi[:, :, None] == ghi[:, None, :]) & (glo[:, :, None] == glo[:, None, :])
    eqv = eq & gvalid[:, None, :] & gvalid[:, :, None]
    tf = eqv.sum(2)
    first = first_occurrence(eqv, gvalid)
    dfv = df_lookup(table, probe, ghi, glo)
    vals = tf.to(f32) * (torch.tensor(ref_len, dtype=f32, device=dev) - dfv)
    onehot = torch.nn.functional.one_hot(gn, N_GRAMS).to(f32)  # (G, 4)
    fv = first.to(f32)
    cnorm = torch.sqrt(torch.einsum("gn,zg->zn", onehot, fv * vals * vals))
    lh = torch.clamp(length - 1, min=0).to(f32)
    rhi, rlo = _u32(pack["hi"][img_idx]), _u32(pack["lo"][img_idx])  # (N, R, L)
    rval, rcnt = pack["val"][img_idx], pack["cnt"][img_idx]
    rnorms, rlens, rwlens = pack["norms"][img_idx], pack["lens"][img_idx], pack["wlens"][img_idx].long()
    rvalid, n_refs = pack["ref_valid"][img_idx], pack["n_refs"][img_idx]
    m = ((ghi[:, :, None, None] == rhi[:, None]) & (glo[:, :, None, None] == rlo[:, None])
         & ((rhi | rlo) != 0)[:, None] & first[:, :, None, None])  # (N, G, R, L)
    contrib = torch.minimum(vals[:, :, None, None], rval[:, None]) * rval[:, None] * m.to(f32)
    num = torch.einsum("gn,zgr->zrn", onehot, contrib.sum(-1))  # (N, R, 4)
    denom = cnorm[:, None, :] * rnorms
    sim = torch.where(denom > 0, num / torch.where(denom > 0, denom, torch.ones_like(denom)), torch.zeros_like(num))
    sim = sim * (length_penalty(lh, rlens) * rvalid)[:, :, None]
    cider = 10.0 * sim.mean(2).sum(1) / torch.clamp(n_refs, min=1.0)
    total = cider_weight * cider
    if max(bleu_weight) > 0:
        max_ref = torch.where(m, rcnt[:, None], torch.zeros((), device=dev)).amax((2, 3))  # (N, G)
        correct = torch.einsum("gn,zg->zn", onehot, torch.minimum(tf.to(f32), max_ref) * fv)
        guess = torch.clamp(length[:, None] - torch.arange(N_GRAMS, device=dev), min=0).to(f32)
        key = torch.where(rvalid > 0, (rwlens - length[:, None]).abs() * 2048 + rwlens,
                          torch.full_like(rwlens, 1 << 20))
        reflen = rwlens.gather(1, key.argmin(1, keepdim=True))[:, 0].to(f32)
        bleu = torch.cumprod((correct + 1e-15) / (guess + 1e-9), 1)
        bleu = bleu ** (1.0 / torch.arange(1, N_GRAMS + 1, device=dev, dtype=f32))
        ratio = (length.to(f32) + 1e-15) / (reflen + 1e-9)
        penalty = torch.where(ratio < 1, torch.exp(1.0 - 1.0 / ratio), torch.ones_like(ratio))
        total = total + ((bleu * penalty[:, None]) * torch.tensor(bleu_weight, dtype=f32, device=dev)).sum(1)
    return total


def _check(ids, img_idx, table, pack):
    n, t = ids.shape
    check_tensor(ids, "ids", (n, t), torch.int32)
    check_tensor(img_idx, "img_idx", (n,), torch.int32)
    size = table["hi"].shape[0]
    if size & (size - 1):
        raise ValueError(f"df table size {size} is not a power of 2")
    for k, dt in (("hi", torch.int32), ("lo", torch.int32), ("val", torch.float32)):
        check_tensor(table[k], f"table[{k}]", (size,), dt)
    b, r, length = pack["hi"].shape
    shapes = {"hi": ((b, r, length), torch.int32), "lo": ((b, r, length), torch.int32),
              "val": ((b, r, length), torch.float32), "cnt": ((b, r, length), torch.float32),
              "norms": ((b, r, N_GRAMS), torch.float32), "lens": ((b, r), torch.float32),
              "wlens": ((b, r), torch.int32), "ref_valid": ((b, r), torch.float32), "n_refs": ((b,), torch.float32)}
    for k in PACK_KEYS:
        check_tensor(pack[k], f"pack[{k}]", *shapes[k])
    check_same_device(ids, img_idx, *table.values(), *(pack[k] for k in PACK_KEYS))
    return n, t, b, r, length, size


def cider_reward(ids, img_idx, table: Dict[str, torch.Tensor], pack: Dict[str, torch.Tensor], *, probe: int,
                 ref_len: float, eos_id: int = 3, pad_id: int = 0, bos_id: int = 2, cider_weight: float = 1.0,
                 bleu_weight: Sequence[float] = (0.0, 0.0, 0.0, 0.0), radix: Optional[RadixSpec] = None):
    """ids: (N, T) int32 sampled captions; img_idx: (N,) int32, each row's
    image in the pack; table: df hash table {hi, lo (size,) int32 bits, val
    (size,) f32}, ``probe`` its probe depth; pack: the batch's reference
    pack (``scst.device_reward.build_ref_pack`` on the device); ``ref_len``:
    log of the df corpus's image count. Returns (N,) f32
    ``cider_weight * CIDEr-D * 10 + sum_n bleu_weight[n] * BLEU-(n+1)``.
    With ``radix`` the rows are radix digits, regrouped into words first
    (eos / pad / bos then name word ids, 3 / 0 / 2 for ACORT)."""
    n, t, b, r, length, size = _check(ids, img_idx, table, pack)
    bleu_weight = [float(w) for w in bleu_weight]
    if len(bleu_weight) != N_GRAMS:
        raise ValueError(f"bleu_weight needs {N_GRAMS} entries, got {len(bleu_weight)}")
    kw = dict(probe=probe, ref_len=ref_len, eos_id=eos_id, pad_id=pad_id, bos_id=bos_id, cider_weight=cider_weight,
              bleu_weight=bleu_weight)
    if radix is not None:
        radix = check_radix(radix)
    if ids.device.type == "cpu":
        if radix is not None:
            ids = radix_to_word(ids, radix)
        return cider_reward_plain(ids, img_idx, table, pack, **kw)
    words = t if radix is None else radix.word_slots(t)
    if words > MAX_T or r > MAX_R:
        raise ValueError(f"cider_reward kernel takes T <= {MAX_T} words and R <= {MAX_R}; got T={words} R={r}")
    base, tpw, n_words = (0, 0, 0) if radix is None else (radix.base, radix.tokens_per_word, radix.n_words)
    out = torch.empty((n,), dtype=torch.float32, device=ids.device)
    KERNEL.launch(ids.data_ptr(), n, t, img_idx.data_ptr(), table["hi"].data_ptr(), table["lo"].data_ptr(),
                  table["val"].data_ptr(), size, probe, *(pack[k].data_ptr() for k in PACK_KEYS), r, length,
                  ref_len, eos_id, pad_id, bos_id, cider_weight, *bleu_weight, int(max(bleu_weight) > 0),
                  base, tpw, n_words, out.data_ptr(), _build.stream_handle(ids))
    return out
