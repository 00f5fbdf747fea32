"""Radix tokenizer (a copy of ``sparse_caption_tpu/tokenizers/radix.py``):
base-N re-encoding of word ids (ACORT's compact vocab).

Semantics match the reference ``RadixTokenizer``
(``sparse_caption/tokenizer.py:550-725``):

* underlying model is the word tokenizer; each *word* id ``w >= 4`` is
  re-encoded as ``tokens_per_word`` base-``radix_base`` digits, each digit
  shifted by +1 so digits occupy ids ``1..radix_base``
* id layout: ``0 = <pad>``, ``1..radix_base`` digits,
  ``radix_base+1 = <bos>``, ``radix_base+2 = <eos>``; vocab = radix_base + 3
* ``<unk>`` maps to the digits of the **last word slot** (reference
  ``tokenizer.py:570-574``)
* ``max_seq_length`` is counted in radix tokens; the word budget is
  ``(max_seq_length - 2) // tokens_per_word + 2`` (reference
  ``tokenizer.py:604-615``)
* decode truncates at the first ``<eos>``, groups the remaining ids into
  words of ``tokens_per_word`` digits (padding short tails with digit 1),
  and inverts the base-N code
"""

from __future__ import annotations

import logging
from typing import List

from sparse_caption_tpu_torch.tokenizers import register_tokenizer
from sparse_caption_tpu_torch.tokenizers.word import WordTokenizer

logger = logging.getLogger(__name__)


def decimal_to_base(n: int, base: int) -> List[int]:
    """Base-10 -> base-N digit list, each digit shifted +1 (so 0 -> [1])."""
    if base < 2:
        raise ValueError("base must be >= 2")
    if n == 0:
        return [1]
    digits = []
    while n:
        digits.append(int(n % base) + 1)
        n //= base
    return digits[::-1]


def base_to_decimal(digits, base: int) -> int:
    res = 0
    for d in digits:
        res = res * base + max(int(d) - 1, 0)
    return res


@register_tokenizer("radix")
class RadixTokenizer(WordTokenizer):
    MODEL_TYPE = "word"  # underlying artifact is the word vocab
    DEFAULT_MAX_SEQ_LENGTH = 26  # radix tokens (reference tokenizer.py:604-615)

    def __init__(self, config):
        self.radix_base = int(config.get("radix_base", 768))
        super().__init__(config)
        n_words = len(self.vocab) - 3  # exclude <pad>, <bos>, <eos>; <unk> shares the last word slot
        self.tokens_per_word = len(decimal_to_base(n_words, self.radix_base))
        # word id w (>= 4) -> digits of (w - 4), left-padded with digit 1
        self._unk_digits = self._word_digits(n_words - 1)
        # overwrite config entries written by the word-level __init__
        config.vocab_size = len(self)
        for attr in self.special_token_attributes:
            setattr(config, attr, getattr(self, attr))

    def _word_digits(self, word_slot: int) -> List[int]:
        d = decimal_to_base(word_slot, self.radix_base)
        return [1] * (self.tokens_per_word - len(d)) + d

    # ------------------------------------------------------------- encode
    def _encode_radix(self, word_ids: List[int]) -> List[int]:
        out: List[int] = []
        for w in word_ids:
            if w == 0:  # <pad>
                out.append(self.pad_token_id)
            elif w == 1:  # <unk> -> last word slot
                out.extend(self._unk_digits)
            elif w == 2:  # <bos>
                out.append(self.bos_token_id)
            elif w == 3:  # <eos>
                out.append(self.eos_token_id)
            else:
                out.extend(self._word_digits(w - 4))
        return out

    def encode(self, input_str: str, add_bos_eos: bool = True, max_seq_length: int = 30) -> List[int]:
        word_budget = (max_seq_length - 2) // self.tokens_per_word + 2 if max_seq_length > 0 else 0
        word_ids = self._encode_word_ids(self._split(input_str), add_bos_eos, word_budget)
        return self._cap(self._encode_radix(word_ids), max_seq_length)

    def encode_tokenized(self, input_list: List[str], add_bos_eos: bool = True, max_seq_length: int = 30) -> List[int]:
        word_budget = (max_seq_length - 2) // self.tokens_per_word + 2 if max_seq_length > 0 else 0
        word_ids = self._encode_word_ids(input_list, add_bos_eos, word_budget)
        return self._cap(self._encode_radix(word_ids), max_seq_length)

    @staticmethod
    def _cap(ids: List[int], max_seq_length: int) -> List[int]:
        # hard cap in RADIX space (reference tokenizer.py:626-631): the word
        # budget keeps most captions inside the limit, but a truncation
        # that drops <eos> can still leave bos + budget words one digit
        # over — the contract is len(ids) <= max_seq_length, not "callers
        # re-truncate"
        return ids[:max_seq_length] if max_seq_length > 0 else ids

    # ------------------------------------------------------------- decode
    def _decode_word_ids(self, radix_ids: List[int]) -> List[int]:
        if self.eos_token_id in radix_ids:
            radix_ids = radix_ids[: radix_ids.index(self.eos_token_id)]
        word_ids: List[int] = []
        group: List[int] = []
        for rid in radix_ids:
            if rid == self.pad_token_id or rid == self.bos_token_id:
                continue  # specials are single-token; never part of a digit group
            group.append(rid)
            if len(group) == self.tokens_per_word:
                word_ids.append(base_to_decimal(group, self.radix_base) + 4)
                group = []
        if group:  # short tail: pad with digit 1 (reference grouper fillvalue=1)
            group += [1] * (self.tokens_per_word - len(group))
            word_ids.append(base_to_decimal(group, self.radix_base) + 4)
        return word_ids

    def decode(self, input_ids) -> str:
        ids = self._ids_to_list(input_ids)
        word_ids = self._decode_word_ids(ids)
        words = []
        n_words = len(self.vocab) - 3
        for w in word_ids:
            if w - 4 == n_words - 1:
                words.append("<unk>")  # last slot is reserved for <unk>
            elif 4 <= w < len(self.vocab):
                words.append(self.vocab[w])
            else:
                words.append("<unk>")
        return " ".join(words)

    def token_to_id(self, token: str) -> List[int]:
        return self._encode_radix([WordTokenizer.token_to_id(self, token)])

    def id_to_token(self, token_id: int) -> str:
        if token_id == self.pad_token_id:
            return "<pad>"
        if token_id == self.bos_token_id:
            return "<bos>"
        if token_id == self.eos_token_id:
            return "<eos>"
        return f"<digit_{token_id}>"

    def __len__(self) -> int:
        return self.radix_base + 3

    @property
    def pad_token_id(self) -> int:
        return 0

    @property
    def unk_token_id(self):
        return self._unk_digits

    @property
    def bos_token_id(self) -> int:
        return self.radix_base + 1

    @property
    def eos_token_id(self) -> int:
        return self.radix_base + 2

    def _update_config(self, config) -> None:
        # deferred: radix attributes exist only after __init__ body runs
        pass

    @staticmethod
    def add_argparse_args(parser) -> None:
        WordTokenizer.add_argparse_args(parser)
        parser.add_argument("--radix_base", type=int, default=768, help="radix base")
