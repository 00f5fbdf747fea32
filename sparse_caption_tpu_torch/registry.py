"""Generic decorator registries.

The reference uses one hand-rolled registry per component family
(models ``sparse_caption/models/__init__.py:16-55``, datasets
``sparse_caption/data/__init__.py:26-67``, tokenizers
``sparse_caption/tokenizer.py:32-66``), each with its own auto-import loop.
Here a single ``Registry`` class backs all of them.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise ValueError(f"{self.kind} '{name}' already registered")
            self._entries[name] = obj
            setattr(obj, "REGISTRY_NAME", name)
            return obj

        return deco

    def get(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} '{name}'; available: {sorted(self._entries)}"
            )
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)

    def import_all(self, package: str) -> None:
        """Import every module of *package* so decorator registrations run."""
        pkg = importlib.import_module(package)
        for mod in pkgutil.iter_modules(pkg.__path__):
            if not mod.name.startswith("_"):
                importlib.import_module(f"{package}.{mod.name}")
