"""The CIDEr-D document-frequency table (copy of what the SCST reward needs
from ``sparse_caption_tpu/metrics/cider.py:33-62,127-141``; numpy and the
standard library only).

A df pickle holds ``{'document_frequency': {ngram: df}, 'ref_len': <raw
image count>}`` (the reference's ``prepro_ngrams.py:115-133`` contract, so
reference-produced pickles such as ``coco-train-words.p`` load unchanged);
the scorer applies ``log`` to ``ref_len`` at load.
"""

from __future__ import annotations

import math
import pickle
from collections import defaultdict
from typing import Dict, Sequence, Tuple

N_GRAMS = 4


def precook(sentence: str, n: int = N_GRAMS) -> Dict[Tuple[str, ...], int]:
    """n-gram counts (1..n) of a whitespace-tokenized sentence."""
    words = sentence.split()
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i: i + k])] += 1
    return counts


def load_df_pickle(path: str) -> Tuple[Dict[Tuple[str, ...], float], float]:
    """(document frequencies, log of the reference image count)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    return data["document_frequency"], math.log(float(data["ref_len"]))


def build_df_pickle(tokenized_refs: Sequence[Sequence[str]], out_path: str) -> None:
    """Write the SCST df pickle of a training corpus (one list of reference
    captions per image)."""
    df: Dict = defaultdict(float)
    for refs in tokenized_refs:
        ngrams = set()
        for r in refs:
            ngrams.update(precook(r).keys())
        for ng in ngrams:
            df[ng] += 1
    # document_frequency stays a defaultdict(float): the reference scorer
    # indexes it with unseen ngrams
    data = {"document_frequency": df, "ref_len": float(len(tokenized_refs))}
    with open(out_path, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
