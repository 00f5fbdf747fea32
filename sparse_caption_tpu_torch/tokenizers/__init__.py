"""Tokenizer registry (a copy of ``sparse_caption_tpu/tokenizers/__init__.py``
for the word and radix tokenizers).

Word-level models only: a frequency-capped whitespace vocabulary with fixed
special ids ``pad=0, unk=1, bos=2, eos=3``, stored as a JSON artifact under
``<log_dir>/tokenizer/``; the radix tokenizer re-encodes its word ids as
base-N digits (ACORT). Encoding is pure Python (the JAX package's optional
ctypes batch encoder is not copied).
"""

from sparse_caption_tpu_torch.registry import Registry

TOKENIZER_REGISTRY: Registry = Registry("tokenizer")
register_tokenizer = TOKENIZER_REGISTRY.register


def get_tokenizer(name: str):
    TOKENIZER_REGISTRY.import_all("sparse_caption_tpu_torch.tokenizers")
    return TOKENIZER_REGISTRY.get(name.lower())


from sparse_caption_tpu_torch.tokenizers.base import Tokenizer  # noqa: E402,F401
