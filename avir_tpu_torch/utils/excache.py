"""Bounded executor cache with weakref-safe identity tokens.

The driver (models/avir.py) caches one built
executor per (geometry, params, ...) key.  Two hygiene requirements:

  - the cache must be BOUNDED: a long-lived resizer fed many distinct
    geometries (e.g. a thumbnail service) must not grow its executor
    map without limit — eviction is LRU;
  - cache keys for CUSTOM DITHERER callables must be identity-safe
    across garbage collection: ``id(fn)`` can be reused by a new
    callable after ``fn`` is collected, silently hitting a stale
    executor.  ``token()`` hands out a monotonically increasing token
    per live callable, tracked by weak reference, so a recycled id can
    never alias a previous key.

``token()`` is O(1): tokens are indexed by ``id(obj)`` with the live
object verified by weakref, and entries whose referent died are queued
by the weakref callback (lock-free ``deque.append``) and reaped under
the lock on the next call.  Note that tokens are IDENTITY-based: a
custom ditherer must be a long-lived callable — passing a fresh lambda
(or a freshly bound method, ``obj.method`` creates a new object each
access) on every resize gets a fresh token each time and rebuilds +
recompiles the executor per call.  Hold one reference to the callable
for the service's lifetime.

The reference has no analog (its resizer holds one filter bank and the
user manages object lifetime, avir.h:4630-4639); this is hygiene for
the long-lived-service usage mode the framework targets.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from collections import OrderedDict, deque


class ExecutorCache:
    """Thread-safe LRU map from hashable keys to built executors."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._map: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # id(obj) -> (token, weakref-or-obj).  Un-weakreffable
        # callables are pinned by strong reference instead (their id
        # then stays valid for the life of the pin), pruned only by
        # clear().
        self._toks: dict[int, tuple[int, object]] = {}
        # ids whose weak referent died; appended by the weakref
        # callback WITHOUT the lock (deque.append is atomic and the
        # callback may fire on any thread, including re-entrantly
        # under this very lock), drained inside token().
        self._dead: deque[int] = deque()
        self._tok_iter = itertools.count()

    def __len__(self) -> int:
        return len(self._map)

    def get_or_build(self, key, build):
        """Return the cached value for ``key``, building (outside the
        lock is NOT needed — builds are idempotent and rare) and
        LRU-evicting as necessary."""
        with self._lock:
            fn = self._map.get(key)
            if fn is not None:
                self._map.move_to_end(key)
                return fn
        fn = build()
        with self._lock:
            # Another thread may have built concurrently; keep the
            # first entry so all callers share one executor.
            cur = self._map.get(key)
            if cur is not None:
                self._map.move_to_end(key)
                return cur
            self._map[key] = fn
            while len(self._map) > self.maxsize:
                self._map.popitem(last=False)
        return fn

    def token(self, obj) -> int:
        """Identity token for a live callable, safe against id() reuse.

        Tokens are never recycled: a new callable always gets a fresh
        token even if it occupies a collected callable's memory (the
        dead entry is reaped before the id can be re-registered, and a
        live-entry hit verifies the referent IS ``obj``)."""
        oid = id(obj)
        with self._lock:
            # Reap entries whose referent died.  Guard against id
            # reuse racing the reap: only drop an entry that is still
            # dead (a reused id re-registered below would have
            # replaced the entry with a live one at the same key).
            while True:
                try:
                    did = self._dead.popleft()
                except IndexError:
                    break
                ent = self._toks.get(did)
                if ent is not None and isinstance(ent[1], weakref.ref) \
                        and ent[1]() is None:
                    del self._toks[did]
            ent = self._toks.get(oid)
            if ent is not None:
                tok, ref = ent
                target = ref() if isinstance(ref, weakref.ref) else ref
                if target is obj:
                    return tok
                # Dead (not yet reaped) or id reused: fall through and
                # overwrite with a fresh token.
            tok = next(self._tok_iter)
            try:
                self._toks[oid] = (
                    tok,
                    weakref.ref(obj, lambda _r: self._dead.append(oid)),
                )
            except TypeError:  # no __weakref__ slot: pin identity
                self._toks[oid] = (tok, obj)
            return tok

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._toks.clear()
            self._dead.clear()
