"""Word-level tokenizer (a copy of ``sparse_caption_tpu/tokenizers/word.py``:
frequency-capped whitespace vocabulary).

Functional equivalent of the reference ``WordTokenizer``
(``sparse_caption/tokenizer.py:543-549``, a SentencePiece ``word`` model):
COCO captions are pre-tokenized lowercase text, so the SP word model is a
whitespace vocabulary of the ``vocab_size - 4`` most frequent words with
fixed specials ``pad=0 unk=1 bos=2 eos=3``.  The vocabulary artifact is a
JSON file under ``<log_dir>/tokenizer/``; when ``config.start_from`` points
at another run the artifact is copied instead of retrained (reference
``tokenizer.py:378-395``).

The JAX package's optional C++ batch encoder (``native/``) is not copied:
the pure Python path is the authoritative one there too.
"""

from __future__ import annotations

import json
import logging
import os
from collections import Counter
from typing import List

import numpy as np

from sparse_caption_tpu_torch.tokenizers import register_tokenizer
from sparse_caption_tpu_torch.tokenizers.base import Tokenizer, maybe_copy_from

logger = logging.getLogger(__name__)

SPECIALS = ("<pad>", "<unk>", "<bos>", "<eos>")


@register_tokenizer("word")
class WordTokenizer(Tokenizer):
    MODEL_TYPE = "word"
    DEFAULT_MAX_SEQ_LENGTH = 18  # incl. BOS/EOS (reference collate.py:174-177)

    def __init__(self, config):
        self.config = config
        self.tokenizer_dir = os.path.join(config.log_dir, "tokenizer")
        self.vocab_path = os.path.join(self.tokenizer_dir, f"{self.MODEL_TYPE}.vocab.json")
        self._train_or_load()
        self._update_config(config)
        logger.info("%s: init complete, vocab_size=%d", type(self).__name__, len(self))

    # ----------------------------------------------------------- training
    def _train_or_load(self) -> None:
        if not os.path.isfile(self.vocab_path):
            if not maybe_copy_from(self.config.get("start_from", ""),
                                   os.path.basename(self.vocab_path), self.tokenizer_dir):
                self._train()
        with open(self.vocab_path) as f:
            self.vocab: List[str] = json.load(f)["vocab"]
        self._token_to_id = {t: i for i, t in enumerate(self.vocab)}

    def _train(self) -> None:
        train_files = self.config.get("tokenizer_train_files")
        if not isinstance(train_files, str):
            raise ValueError(f"{type(self).__name__}: `tokenizer_train_files` required when no vocab artifact exists")
        counts: Counter = Counter()
        for path in train_files.split(","):
            with open(path) as f:
                for line in f:
                    counts.update(line.strip().split())
        max_words = int(self.config.get("vocab_size", 10001)) - len(SPECIALS)
        # frequency order, deterministic tie-break on the word string
        words = [w for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:max_words]]
        vocab = list(SPECIALS) + words
        os.makedirs(self.tokenizer_dir, exist_ok=True)
        with open(self.vocab_path, "w") as f:
            json.dump({"model_type": self.MODEL_TYPE, "vocab": vocab}, f)
        logger.info("%s: trained vocab (%d entries) -> %s", type(self).__name__, len(vocab), self.vocab_path)

    # ------------------------------------------------------------- encode
    def _split(self, input_str: str) -> List[str]:
        return input_str.strip().split()

    def _encode_word_ids(self, input_list: List[str], add_bos_eos: bool, max_seq_length: int) -> List[int]:
        """Tokens -> word ids with bos=2/eos=3 and truncation (non-polymorphic)."""
        ids = [self._token_to_id.get(t, 1) for t in input_list]
        if add_bos_eos:
            ids = [2] + ids + [3]
        if max_seq_length and max_seq_length > 0:
            ids = ids[:max_seq_length]
        return ids

    def encode(self, input_str: str, add_bos_eos: bool = True, max_seq_length: int = 16) -> List[int]:
        return self.encode_tokenized(self._split(input_str), add_bos_eos, max_seq_length)

    def encode_tokenized(self, input_list: List[str], add_bos_eos: bool = True, max_seq_length: int = 16) -> List[int]:
        return self._encode_word_ids(input_list, add_bos_eos, max_seq_length)

    def encode_batch(self, captions, max_seq_length: int):
        """Batch encode -> (N, max_seq_length) int32, zero-padded."""
        out = np.zeros((len(captions), max_seq_length), np.int32)
        for i, c in enumerate(captions):
            ids = self.encode(c, add_bos_eos=True, max_seq_length=max_seq_length)[:max_seq_length]
            out[i, : len(ids)] = ids
        return out

    def decode(self, input_ids) -> str:
        ids = self._ids_to_list(input_ids)
        words = []
        for i in ids:
            if i == self.eos_token_id:
                break
            if i in (self.pad_token_id, self.bos_token_id):
                continue
            words.append(self.vocab[i] if 0 <= i < len(self.vocab) else "<unk>")
        return " ".join(words)

    def token_to_id(self, token: str) -> int:
        return self._token_to_id.get(token, self.unk_token_id)

    def id_to_token(self, token_id: int) -> str:
        if not 0 <= token_id < len(self.vocab):
            raise ValueError(f"token_id {token_id} out of range [0, {len(self.vocab)})")
        return self.vocab[token_id]

    def __len__(self) -> int:
        return len(self.vocab)

    @staticmethod
    def add_argparse_args(parser) -> None:
        parser.add_argument("--tokenizer_train_files", type=str, default=None,
                            help="comma-separated paths to tokenizer training text files")
        parser.add_argument("--vocab_size", type=int, default=10001, help="maximum vocabulary size incl. specials")
