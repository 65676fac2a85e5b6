"""Shared ``stats()`` mixin for the persistent ObjectStore backends.

Port of ``ceph_tpu/objectstore/statfs.py``.

MemStore maintains its totals exactly and incrementally at the
transaction swap (O(1) per ``stats()``); the persistent backends'
on-disk layouts make per-op delta accounting invasive, so they memoize
ONE usage scan and invalidate it per queued transaction.  A quiet store
answers every mgr report from the cache; a store under write load pays
one scan per report interval at most -- bounded, and only for the
persistent-backend deployments (the default memstore path never scans).
"""

from __future__ import annotations

from typing import Dict


class ScanStatsMixin:
    """``stats()`` = memoized usage scan; subclasses call
    ``_stats_invalidate()`` from ``queue_transaction``."""

    _stats_cache = None

    def _stats_invalidate(self) -> None:
        self._stats_cache = None

    def stats(self) -> Dict[str, int]:
        cached = self._stats_cache
        if cached is not None:
            return dict(cached)
        shards = metas = nbytes = 0
        for oid in self.list_objects():
            try:
                size = self.stat(oid)
            except FileNotFoundError:
                continue  # raced a concurrent transaction
            nbytes += size
            if oid.endswith("@meta"):
                metas += 1
            else:
                shards += 1
        cached = {
            "objects": shards + metas,
            "shards": shards,
            "metas": metas,
            "bytes": nbytes,
        }
        self._stats_cache = cached
        return dict(cached)
