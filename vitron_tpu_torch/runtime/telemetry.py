"""Captured-program cache telemetry and eviction.

Port of `vitron_tpu/runtime/telemetry.py`, whose code it keeps as it is.
Where the JAX package caches one jitted program per shape bucket, the port
caches one captured CUDA graph per bucket together with the static input
and output buffers it was captured on: `Generator`'s decode chunks per
(steps, batch, cache length, sampled) and `PagedServer.step_n`'s per
(steps, batch, table width, sampled). `ProgramCache` is the bounded LRU
those call sites use, and every cache self-registers so `/stats` can report
live graph counts and hit rates (apps/serve.py /stats).
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Callable, Dict, Optional


class ProgramCache:
    """Bounded LRU of captured programs with hit/miss/eviction counters.

    Evicting drops the only reference to the entry; its CUDA graph, the
    graph's private memory and its static buffers are freed when the entry
    is collected."""

    def __init__(self, name: str, max_entries: int = 32,
                 register: bool = True):
        self.name = name
        self.max_entries = max_entries
        self._d: "collections.OrderedDict[Any, Any]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        if register:
            _register(self)

    def get(self, key: Any, build: Callable[[], Any]) -> Any:
        fn = self._d.get(key)
        if fn is not None:
            self.hits += 1
            self._d.move_to_end(key)
            return fn
        self.misses += 1
        fn = build()
        self._d[key] = fn
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1
        return fn

    def lookup(self, key: Any) -> Optional[Any]:
        """dict.get-style probe (counts a hit or miss)."""
        fn = self._d.get(key)
        if fn is None:
            self.misses += 1
            return None
        self.hits += 1
        self._d.move_to_end(key)
        return fn

    def store(self, key: Any, fn: Any) -> Any:
        self._d[key] = fn
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1
        return fn

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def stats(self) -> Dict[str, int]:
        return {"programs": len(self._d), "max": self.max_entries,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


_LOCK = threading.Lock()
# weak values: the registry is an observability view, not an owner — a
# pipeline/server dropped by its creator must be collectable along with
# its captured graphs (otherwise every reconstructed pipeline pins its
# graphs forever, the exact growth the bounded LRU exists to prevent)
_REGISTRY: "weakref.WeakValueDictionary[str, ProgramCache]" = (
    weakref.WeakValueDictionary())


def _register(cache: ProgramCache) -> None:
    with _LOCK:
        # later caches with the same name (e.g. a second pipeline instance)
        # get a disambiguating suffix
        name = cache.name
        i = 2
        while name in _REGISTRY:
            name = f"{cache.name}#{i}"
            i += 1
        cache.name = name
        _REGISTRY[name] = cache


def all_stats() -> Dict[str, Dict[str, int]]:
    """{cache name: stats} for every live program cache (the /stats view)."""
    with _LOCK:
        return {name: c.stats() for name, c in list(_REGISTRY.items())}


def reset() -> None:
    """Testing hook: forget all registered caches."""
    with _LOCK:
        _REGISTRY.clear()
