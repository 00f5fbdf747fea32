"""Tokenizer ABC (a copy of ``sparse_caption_tpu/tokenizers/base.py``).

The contract:
``encode(str, add_bos_eos, max_seq_length)``, ``encode_tokenized(list)``,
``decode(ids)``, ``token_to_id`` / ``id_to_token``, special-token id
properties, and the post-init write-back of vocab size + special ids into the
run Config (reference ``tokenizer.py:300-310``).
"""

from __future__ import annotations

import os
import shutil
from abc import ABC, abstractmethod
from typing import List

import numpy as np


class Tokenizer(ABC):
    special_token_attributes = (
        "bos_token_id",
        "eos_token_id",
        "unk_token_id",
        "pad_token_id",
    )

    def _update_config(self, config) -> None:
        """Write vocab size + special ids into the run config (once)."""
        config.vocab_size = len(self)
        for attr in self.special_token_attributes:
            if attr not in config:
                setattr(config, attr, getattr(self, attr))

    # ------------------------------------------------------------------ api
    @abstractmethod
    def encode(self, input_str: str, add_bos_eos: bool = True, max_seq_length: int = 16) -> List[int]:
        ...

    @abstractmethod
    def encode_tokenized(self, input_list: List[str], add_bos_eos: bool = True, max_seq_length: int = 16) -> List[int]:
        ...

    @abstractmethod
    def decode(self, input_ids) -> str:
        ...

    @abstractmethod
    def token_to_id(self, token: str):
        ...

    @abstractmethod
    def id_to_token(self, token_id: int) -> str:
        ...

    @abstractmethod
    def __len__(self) -> int:
        ...

    @property
    def vocab_size(self) -> int:
        return len(self)

    # special ids — fixed layout pad=0 unk=1 bos=2 eos=3 (reference tokenizer.py:424-426)
    @property
    def pad_token_id(self) -> int:
        return 0

    @property
    def unk_token_id(self) -> int:
        return 1

    @property
    def bos_token_id(self) -> int:
        return 2

    @property
    def eos_token_id(self) -> int:
        return 3

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _ids_to_list(input_ids) -> List[int]:
        if isinstance(input_ids, np.ndarray):
            if input_ids.ndim == 0:
                return [int(input_ids)]
            if input_ids.ndim == 1:
                return [int(x) for x in input_ids.tolist()]
            raise ValueError(f"decode() takes 0D/1D ids, got {input_ids.ndim}D")
        if hasattr(input_ids, "tolist") and not isinstance(input_ids, list):
            return Tokenizer._ids_to_list(np.asarray(input_ids))
        return [int(x) for x in input_ids]

    def decode_batch(self, ids_2d) -> List[str]:
        arr = np.asarray(ids_2d)
        return [self.decode(arr[i]) for i in range(arr.shape[0])]


def maybe_copy_from(start_from: str, artifact_name: str, dst_dir: str) -> str | None:
    """Copy a tokenizer artifact from another run dir into ``dst_dir``
    (parity: reference tokenizer.py:378-395 copies the .model on
    start_from). Returns the copied path, or None if there is nothing to
    reuse."""
    if not start_from:
        return None
    if os.path.isfile(start_from):
        start_from = os.path.dirname(start_from)
    src = os.path.join(start_from, "tokenizer", artifact_name)
    if not os.path.isfile(src):
        return None
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, artifact_name)
    shutil.copy2(src, dst)
    return dst
