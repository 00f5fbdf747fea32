"""Run configuration helpers (a copy of what the port needs from
``sparse_caption_tpu/config.py``).

``Config`` is the attribute bag that components read with ``get`` and write
derived values back into (the tokenizer records the vocabulary size and the
special ids); ``str_to_none`` and ``list_of_ints`` are the argparse types of
the ACORT flags (``--share_att_*``, ``--share_layer_*``). JSON persistence
and config migrations are not copied.
"""

from __future__ import annotations

from typing import Any, List


class Config:
    """Attribute bag over a plain dict."""

    def __init__(self, **kwargs: Any):
        self.__dict__["_data"] = dict(kwargs)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_data"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def to_dict(self) -> dict:
        return dict(self._data)


def str_to_none(s: str):
    """argparse type: 'none'/'null'/'' -> None, else the string itself."""
    return None if str(s).lower() in ("none", "null", "") else s


def list_of_ints(s: str) -> List[int]:
    """argparse type: '0,0,0,1,1,1' -> [0, 0, 0, 1, 1, 1]; also takes the
    python-tuple form of the ACORT recipe, '(0, 0, 0, 1, 1, 1)'."""
    if not s:
        return []
    s = str(s).replace(" ", "").strip("()[]")
    if not s:
        return []
    return [int(x) for x in s.split(",")]
