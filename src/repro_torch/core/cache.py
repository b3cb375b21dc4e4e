"""FIFO-capped caches shared across executors and the serve subsystem.

Each executor once had its own capped dict; the serve layer runs several
executors (one per workload family, plus equivalence/baseline twins) against
one stream of topologies, so caches are now first-class objects that can be
*shared*: one :class:`FIFOCache` instance, keyed by
``(namespace, topology fingerprint, policy fingerprint)``, serves every
engine that is handed it. The namespace must identify the impl set (the
serve engine uses ``(family, id(impls))``), not just a family label —
otherwise engines built around different weights would alias each other's
entries. Hit/miss counters feed ``ServeStats``.

Caches are **thread-safe**: schedule/plan/executable caches are shared
per-server objects, and the planned async round pipelining (ROADMAP open
item: pack the next round's shards host-side while a dispatch is still in
flight) will touch them from more than one thread — ``get`` and
``__setitem__`` (lookup + counter bump, insert + eviction) must be atomic.
A single re-entrant lock per cache guards both; reads through plain dict
access (``in``, ``len``, iteration in tests) stay lock-free, which is safe
under CPython for individual dict operations. The serve engine loop itself
is still single-threaded today.
"""

from __future__ import annotations

import threading


class FIFOCache(dict):
    """Insertion-ordered dict with a FIFO size cap and hit/miss counters.

    Subclasses ``dict`` so existing code (and tests) that treat caches as
    plain dicts keep working; only ``get`` counts hits/misses and only
    ``__setitem__`` evicts (oldest-inserted first, never the key being set).
    """

    def __init__(self, maxsize: int):
        super().__init__()
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get(self, key, default=None):
        with self._lock:
            if key in self:
                self.hits += 1
                return super().__getitem__(key)
            self.misses += 1
            return default

    def peek(self, key, default=None):
        """Lookup without touching hit/miss counters or (for LRU) entry age.

        The async-compile engine probes executable readiness every round
        while a background build is in flight; those probes are not cache
        traffic and must not skew the hit-rate stats the benches gate on.
        """
        with self._lock:
            if key in self:
                return super().__getitem__(key)
            return default

    def __setitem__(self, key, value) -> None:
        with self._lock:
            if key not in self:
                while len(self) >= self.maxsize:
                    super().pop(next(iter(self)))
            super().__setitem__(key, value)


class LRUCache(FIFOCache):
    """FIFOCache that refreshes a key's age on ``get``.

    The bucketed-plan executable cache wants this: a handful of bucket
    signatures serve an unbounded topology stream, and the hot buckets must
    not be evicted just because they were *compiled* early. Eviction removes
    the least-recently-*used* entry instead of the oldest-inserted one.
    """

    def get(self, key, default=None):
        with self._lock:
            if key in self:
                self.hits += 1
                value = super(FIFOCache, self).pop(key)  # re-insert at end
                super(FIFOCache, self).__setitem__(key, value)
                return value
            self.misses += 1
            return default
