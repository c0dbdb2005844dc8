"""Byte-budgeted in-process hot cache for the serving gateway (the port's copy
of `spectre_tpu/gateway/cache.py`).

The gateway's working set is small and immutable — sealed update packs
and pre-encoded sealed responses are content-addressed, so a cached
entry can never go stale; the only cache policy needed is a byte budget
(``SPECTRE_GATEWAY_CACHE_MB``) with LRU eviction. Evictions are counted
(``gateway_cache_evictions``) because every eviction of a sealed entry
is a future ``gateway_store_fallbacks`` — the two counters together
tell the operator whether the budget fits the hot set.

Same discipline as the MSM fixed-base table LRU: explicit sizes
(the caller states the entry's byte cost — values may be tuples holding
parsed indexes whose ``sys.getsizeof`` would lie), thread-safe,
oversize entries pass through uncached instead of thrashing the budget.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from ..utils.health import HEALTH

CACHE_MB_ENV = "SPECTRE_GATEWAY_CACHE_MB"
DEFAULT_CACHE_MB = 64.0


def _budget_bytes(cache_mb: float | None) -> int:
    if cache_mb is None:
        cache_mb = float(os.environ.get(CACHE_MB_ENV) or DEFAULT_CACHE_MB)
    return max(0, int(cache_mb * (1 << 20)))


class GatewayCache:
    """LRU keyed by arbitrary hashable keys, bounded by a byte budget.

    ``put`` takes the entry's byte cost explicitly; an entry larger than
    the whole budget is refused (the caller serves it uncached) rather
    than evicting the entire hot set for one oversized pack."""

    def __init__(self, cache_mb: float | None = None, health=HEALTH):
        self.budget = _budget_bytes(cache_mb)
        self.health = health
        self._lock = threading.Lock()
        self._entries: "OrderedDict[object, tuple]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0

    def get(self, key):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return ent[0]

    def put(self, key, value, nbytes: int) -> bool:
        """Insert (or refresh) `key`; returns False when the entry is
        larger than the whole budget and was not cached."""
        nbytes = int(nbytes)
        if nbytes > self.budget:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.budget and self._entries:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._bytes -= evicted
                self.health.incr("gateway_cache_evictions")
        return True

    def invalidate(self, key) -> None:
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._bytes -= ent[1]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "budget_bytes": self.budget, "hits": self._hits,
                    "misses": self._misses}
