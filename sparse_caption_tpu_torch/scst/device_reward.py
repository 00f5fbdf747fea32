"""The in-step SCST reward: CIDEr-D x 10 + BLEU-1..4 of sampled ids on the
device (port of ``sparse_caption_tpu/scst/device_reward.py``).

Host half (numpy, copied from ``device_reward.py:62-225``): n-grams are
packed into (hi, lo) uint32 keys (16 bits per token id + 1); the train
corpus's document frequencies become an open-addressed hash table
(``DfTable``, linear probing, load factor <= 0.25); the references of a
batch become a pack of tf-idf vectors, norms and lengths
(``build_ref_pack``, ``scst_ref_pack``). OOV reference words get per-image
ids above the vocabulary, so they never match a sampled token. Device half:
``make_reward_fn`` scores sampled ids in kernel K10
(``kernels/cider_reward.py``; ACORT's radix digits through its radix mode,
which regroups them into words in the same launch), and
``leave_one_out_baseline`` is the sample-mean baseline. ``DeviceReward``
builds the scorer, df table and ref packs of a run from its tokenizer
(``engine/training.py _init_device_reward`` and ``_scst_ref_pack`` of the
JAX package, 261-331).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_caption_tpu_torch.kernels.cider_reward import (
    N_GRAMS,
    PACK_KEYS,
    WORD_BOS,
    WORD_EOS,
    WORD_PAD,
    RadixSpec,
    check_radix,
    cider_reward,
)
from sparse_caption_tpu_torch.metrics.cider import load_df_pickle


# --------------------------------------------------------------------- keys
def _mix(hi, lo):
    """uint32 hash of a packed gram key (numpy uint32 arrays wrap mod 2^32)."""
    h = hi * np.uint32(2654435761) ^ (lo * np.uint32(0x9E3779B9))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    return h


def _pack(ids: Sequence[int]) -> Tuple[int, int]:
    """Pack <= 4 token ids (each + 1, 16 bits, first token most significant)
    into a (hi, lo) uint32 pair; grams of different lengths never collide."""
    k = 0
    for i in ids:
        assert 0 <= i < 0xFFFF - 1, f"token id {i} exceeds 16-bit packing"
        k = (k << 16) | (i + 1)
    return (k >> 32) & 0xFFFFFFFF, k & 0xFFFFFFFF


def _bits(a: np.ndarray) -> torch.Tensor:
    """A uint32 array as an int32 tensor holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


# ----------------------------------------------------------------- df table
class DfTable:
    """Open-addressed uint32 hash table of the train-corpus document
    frequencies, holding ``log(max(1, df))`` per in-vocab gram. Built with
    numpy arrays; ``to(device)`` gives the kernel's tensors (keys as int32
    bits)."""

    def __init__(self, hi, lo, val, probe: int, ref_len: float):
        self.hi, self.lo, self.val = hi, lo, val
        self.probe = int(probe)
        self.ref_len = float(ref_len)
        self.size = int(hi.shape[0])

    @classmethod
    def build(cls, df: Dict[Tuple[str, ...], float], ref_len: float, token_to_id: Dict[str, int]) -> "DfTable":
        keys: List[Tuple[int, int]] = []
        vals: List[float] = []
        for gram, dfv in df.items():
            ids = [token_to_id.get(w) for w in gram]
            if any(i is None for i in ids):
                continue  # OOV gram: unreachable from sampled ids
            keys.append(_pack(ids))
            vals.append(math.log(max(1.0, float(dfv))))
        n = max(1, len(keys))
        size = 1
        while size < 4 * n:
            size *= 2
        hi = np.zeros(size, np.uint32)
        lo = np.zeros(size, np.uint32)
        val = np.zeros(size, np.float32)
        mask = size - 1
        k_hi = np.asarray([k[0] for k in keys], np.uint32)
        k_lo = np.asarray([k[1] for k in keys], np.uint32)
        idx0 = _mix(k_hi, k_lo) & np.uint32(mask) if keys else np.zeros(0, np.uint32)
        max_probe = 0
        for i in range(len(keys)):
            idx = int(idx0[i])
            d = 0
            while hi[idx] or lo[idx]:
                idx = (idx + 1) & mask
                d += 1
            hi[idx], lo[idx], val[idx] = k_hi[i], k_lo[i], vals[i]
            max_probe = max(max_probe, d)
        return cls(hi, lo, val, probe=max_probe + 1, ref_len=float(ref_len))

    @classmethod
    def from_pickle(cls, path: str, token_to_id: Dict[str, int]) -> "DfTable":
        df, ref_len = load_df_pickle(path)
        return cls.build(df, ref_len, token_to_id)

    def to(self, device) -> "DfTable":
        """The (numpy) table as tensors on ``device``."""
        return DfTable(_bits(self.hi).to(device), _bits(self.lo).to(device), torch.from_numpy(self.val).to(device),
                       self.probe, self.ref_len)


# ----------------------------------------------------------------- ref pack
def _precook_words(words: List[str]) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = {}
    for n in range(1, N_GRAMS + 1):
        for i in range(len(words) - n + 1):
            g = tuple(words[i: i + n])
            counts[g] = counts.get(g, 0) + 1
    return counts


def build_ref_pack(gts: List[List[str]], df: Dict, ref_len: float, token_to_id: Dict[str, int], vocab_size: int,
                   max_refs: int = None, max_grams: int = None) -> Dict[str, np.ndarray]:
    """Per-reference tf-idf vectors of a batch of images (``gts[i]``: the
    reference caption strings of image i), as numpy arrays: key hi/lo,
    tf-idf value and raw count (B, R, L); norms (B, R, 4); bigram "lengths"
    and word counts (B, R); ref validity (B, R) and counts (B,). Values use
    the string df, exactly as the host scorer does."""
    b = len(gts)
    r_max = max_refs or max(len(r) for r in gts)
    cooked = [[_precook_words(s.split()) for s in refs] for refs in gts]
    l_max = max(1, max_grams or max((len(c) for refs in cooked for c in refs), default=1))
    hi = np.zeros((b, r_max, l_max), np.uint32)
    lo = np.zeros((b, r_max, l_max), np.uint32)
    val = np.zeros((b, r_max, l_max), np.float32)
    cnt = np.zeros((b, r_max, l_max), np.float32)
    norms = np.zeros((b, r_max, N_GRAMS), np.float32)
    lens = np.zeros((b, r_max), np.float32)
    wlens = np.zeros((b, r_max), np.int32)
    ref_valid = np.zeros((b, r_max), np.float32)
    n_refs = np.zeros((b,), np.float32)
    for i, refs in enumerate(cooked):
        assert len(refs) <= r_max, f"image {i}: {len(refs)} refs > max_refs {r_max}"
        n_refs[i] = len(refs)
        oov: Dict[str, int] = {}
        for r, counts in enumerate(refs):
            ref_valid[i, r] = 1.0
            assert len(counts) <= l_max, f"image {i} ref {r}: {len(counts)} grams > max_grams {l_max}"
            norm = [0.0] * N_GRAMS
            length = wlen = 0
            for j, (gram, tf) in enumerate(counts.items()):
                ids = [token_to_id[w] if w in token_to_id else oov.setdefault(w, vocab_size + len(oov)) for w in gram]
                khi, klo = _pack(ids)
                dfv = math.log(max(1.0, float(df.get(gram, 0.0))))
                n = len(gram) - 1
                v = float(tf) * (ref_len - dfv)
                hi[i, r, j], lo[i, r, j], val[i, r, j] = khi, klo, v
                cnt[i, r, j] = float(tf)
                norm[n] += v * v
                if n == 0:
                    wlen += tf  # unigram tf total == word count
                if n == 1:
                    length += tf  # reference quirk: "length" counts bigrams
            norms[i, r] = [math.sqrt(x) for x in norm]
            lens[i, r] = length
            wlens[i, r] = wlen
    return {"hi": hi, "lo": lo, "val": val, "cnt": cnt, "norms": norms, "lens": lens, "wlens": wlens,
            "ref_valid": ref_valid, "n_refs": n_refs}


def ref_pack_to(pack: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy ref pack as the kernel's tensors on ``device`` (keys as int32 bits)."""
    return {k: (_bits(pack[k]) if k in ("hi", "lo") else torch.from_numpy(np.ascontiguousarray(pack[k]))).to(device)
            for k in PACK_KEYS}


def scst_ref_pack(gts: List[List[str]], df: Dict, table: DfTable, token_to_id: Dict[str, int], vocab_size: int,
                  device) -> Dict[str, torch.Tensor]:
    """A batch's ref pack on ``device``, with L bucketed to a multiple of 32
    (4 x the longest reference's word count bounds its grams), as the JAX
    engine's ``_scst_ref_pack`` does (``engine/training.py:314-331``)."""
    r = max(len(x) for x in gts)
    gram_ub = max(4 * len(s.split()) for refs in gts for s in refs)
    l_max = ((max(gram_ub, 1) + 31) // 32) * 32
    pack = build_ref_pack(gts, df, table.ref_len, token_to_id, vocab_size=vocab_size, max_refs=r, max_grams=l_max)
    return ref_pack_to(pack, device)


# ------------------------------------------------------------ device scorer
def make_reward_fn(table: DfTable, eos_id: int = 3, pad_id: int = 0, bos_id: int = 2, cider_weight: float = 1.0,
                   bleu_weight: Sequence[float] = (0.0, 0.0, 0.0, 0.0), regroup: Optional[RadixSpec] = None):
    """``score(ids (N, T) int32, img_idx (N,) int32, pack) -> (N,) f32``:
    CIDEr-D x 10 x ``cider_weight`` + BLEU-1..4 x ``bleu_weight`` on the
    ids' device (kernel K10 there, its plain version on the CPU); ``pack`` is
    a ref pack on that device (``scst_ref_pack``). ``regroup``: a
    ``RadixSpec`` (base, tokens per word, word vocabulary size) when the ids
    are ACORT's radix digits (the JAX package's ``make_radix_to_word_fn``);
    eos / pad / bos then name the regrouped row's word ids (3 / 0 / 2)."""
    if regroup is not None:
        if not isinstance(regroup, RadixSpec):
            raise TypeError(f"regroup takes a RadixSpec (base, tokens per word, word vocab size), got {regroup!r}")
        regroup = check_radix(regroup)
    bleu_weight = tuple(float(w) for w in bleu_weight)
    assert len(bleu_weight) == N_GRAMS
    on_device: Dict[torch.device, DfTable] = {}

    def score(ids, img_idx, pack):
        tbl = on_device.get(ids.device)
        if tbl is None:
            tbl = on_device[ids.device] = table.to(ids.device)
        return cider_reward(ids, img_idx, {"hi": tbl.hi, "lo": tbl.lo, "val": tbl.val}, pack, probe=tbl.probe,
                            ref_len=tbl.ref_len, eos_id=eos_id, pad_id=pad_id, bos_id=bos_id,
                            cider_weight=cider_weight, bleu_weight=bleu_weight, radix=regroup)

    return score


class DeviceReward:
    """The device reward of a run (``--scst_reward device``): the df table,
    the scorer and the batches' ref packs, built from the run's tokenizer,
    its df (``load_df_pickle``) and its config, as the JAX package's
    ``TrainingModule._init_device_reward`` / ``_scst_ref_pack`` do
    (``engine/training.py:261-331``). Word and radix tokenizers only: the
    scoring vocabulary is the WORD vocabulary, radix digits are regrouped
    into word ids inside K10. ``fn`` is ``make_reward_fn``'s scorer."""

    def __init__(self, tokenizer, df: Dict, ref_len: float, config):
        from sparse_caption_tpu_torch.tokenizers.radix import RadixTokenizer
        from sparse_caption_tpu_torch.tokenizers.word import WordTokenizer

        is_radix = isinstance(tokenizer, RadixTokenizer)
        assert type(tokenizer) is WordTokenizer or is_radix, (
            "--scst_reward device requires word or radix tokenization (sampled ids are words / regroupable "
            "digits); char/bpe captions score on decoded word strings -> use --scst_reward host")
        self.df = df
        self.tok2id = dict(tokenizer._token_to_id)
        # private OOV ref ids must clear every (regrouped) WORD id
        self.vocab_size = len(tokenizer.vocab)
        self.table = DfTable.build(df, ref_len, self.tok2id)
        regroup = None
        eos, pad, bos = tokenizer.eos_token_id, tokenizer.pad_token_id, tokenizer.bos_token_id
        if is_radix:
            regroup = RadixSpec(tokenizer.radix_base, tokenizer.tokens_per_word, len(tokenizer.vocab))
            eos, pad, bos = WORD_EOS, WORD_PAD, WORD_BOS  # regrouped ids use WORD conventions
        self.regroup = regroup
        self.fn = make_reward_fn(self.table, eos_id=eos, pad_id=pad, bos_id=bos,
                                 cider_weight=float(config.get("scst_cider_weight", 1.0)),
                                 bleu_weight=[float(x) for x in config.get("scst_bleu_weight", [0.0] * N_GRAMS)],
                                 regroup=regroup)

    @classmethod
    def from_pickle(cls, tokenizer, df_path: str, config) -> "DeviceReward":
        df, ref_len = load_df_pickle(df_path)
        return cls(tokenizer, df, ref_len, config)

    def ref_pack(self, gts: List[List[str]], device) -> Dict[str, torch.Tensor]:
        """A batch's ref pack on ``device`` (``scst_ref_pack``)."""
        return scst_ref_pack(gts, self.df, self.table, self.tok2id, self.vocab_size, device)


def leave_one_out_baseline(sc: torch.Tensor, spi: int) -> torch.Tensor:
    """The sample-mean baseline: each sample's mean over its image's OTHER
    samples. ``sc`` is (B * spi,)."""
    if spi < 2:
        raise ValueError(f"sample-mean baseline needs >= 2 samples per image, got {spi}")
    sums = sc.reshape(-1, spi).sum(-1)
    return (sums.repeat_interleave(spi) - sc) / (spi - 1)
