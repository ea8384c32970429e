"""Host-side (CPU) cache.

``LRUCache`` of ``falcon_ttdforgnns_tpu/utils/host_cache.py`` (an
OrderedDict LRU with hit/miss stats, `tt_utils.py:204-278`), copied: the
reorder permutations' memo (``graph/reorder.py``) keeps its entries in it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict


class LRUCache:
    def __init__(self, capacity: int):
        self.cache: OrderedDict = OrderedDict()
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if key in self.cache:
            self.cache.move_to_end(key)
            self.hits += 1
            return self.cache[key]
        self.misses += 1
        return None

    def put(self, key, value) -> None:
        if key in self.cache:
            self.cache.move_to_end(key)
        elif len(self.cache) >= self.capacity:
            self.cache.popitem(last=False)
        self.cache[key] = value

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses}
