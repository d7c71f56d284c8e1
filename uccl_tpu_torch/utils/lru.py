"""LRU-bounded cache of built callables — the ``_fns`` pattern.

Port copy of ``uccl_tpu/utils/lru.py`` (jax-free there too). The JAX
package caches one compiled program per shape; eager PyTorch compiles
nothing, so the port's serving stacks keep no such cache, and this class
stays for callers that build something costly per key.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable


class LRUFnCache:
    """``get(key, build)``: return the cached value or build+insert it,
    evicting least-recently-used entries beyond ``cap``."""

    def __init__(self, cap: int = 16):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = cap
        self._d: OrderedDict = OrderedDict()

    def get(self, key, build: Callable):
        val = self._d.get(key)
        if val is None:
            val = self._d[key] = build()
            while len(self._d) > self.cap:
                self._d.popitem(last=False)
        else:
            self._d.move_to_end(key)  # LRU: a hit refreshes recency
        return val

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d
