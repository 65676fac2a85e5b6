"""HitSet: object-access tracking (reference: src/osd/HitSet.{h,cc}).

Port of ``ceph_tpu/osd/hitset.py``.

The reference records which objects a PG touched during a time period
so the cache-tiering agent can rank hotness; implementations trade
memory for precision -- ExplicitHashHitSet (exact set of hashes),
BloomHitSet (bloom filter with a target false-positive probability) --
behind one insert/contains interface, with periodic rollover keeping
the last N archived sets (pg_pool_t hit_set_period / hit_set_count).

The tracker lives on the OSD and feeds from the client-op path; the
admin socket exposes the same introspection the reference's
``ceph osd pool set hit_set_*`` + tier agent consume.
"""

from __future__ import annotations

import hashlib
import math
import time
from collections import deque
from typing import Deque, List, Optional


class ExplicitHitSet:
    """Exact membership (ExplicitHashHitSet role)."""

    kind = "explicit_hash"

    def __init__(self):
        self._hashes = set()

    def insert(self, oid: str) -> None:
        self._hashes.add(hash(oid) & 0xFFFFFFFF)

    def contains(self, oid: str) -> bool:
        return (hash(oid) & 0xFFFFFFFF) in self._hashes

    def __len__(self) -> int:
        return len(self._hashes)


class BloomHitSet:
    """Bloom filter sized for ``target_size`` insertions at ``fpp``
    false-positive probability (BloomHitSet over compressible_bloom_
    filter; the reference sizes from hit_set_fpp the same way)."""

    kind = "bloom"

    def __init__(self, target_size: int = 10_000, fpp: float = 0.01):
        self.fpp = fpp
        # standard bloom sizing: m = -n ln p / (ln 2)^2, k = m/n ln 2
        m = max(64, int(-target_size * math.log(fpp) / (math.log(2) ** 2)))
        self.nbits = m
        self.nhash = max(1, round(m / target_size * math.log(2)))
        self._bits = bytearray((m + 7) // 8)
        self._count = 0

    def _positions(self, oid: str) -> List[int]:
        # double hashing: h1 + i*h2 gives k independent-enough probes
        d = hashlib.blake2b(oid.encode(), digest_size=16).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little") | 1
        return [(h1 + i * h2) % self.nbits for i in range(self.nhash)]

    def insert(self, oid: str) -> None:
        # one _positions walk serves both the membership probe and the
        # bit sets (insert-via-contains paid the blake2b twice; this
        # runs on every client op through the hit-set tracker)
        bits = self._bits
        seen = True
        for p in self._positions(oid):
            mask = 1 << (p & 7)
            if not bits[p >> 3] & mask:
                seen = False
                bits[p >> 3] |= mask
        if not seen:
            self._count += 1  # approx DISTINCT count, comparable to
            # ExplicitHitSet's len and to the fpp sizing basis

    def contains(self, oid: str) -> bool:
        return all(self._bits[p >> 3] & (1 << (p & 7))
                   for p in self._positions(oid))

    def __len__(self) -> int:
        return self._count


def make_hitset(kind: str, **kw):
    if kind == "bloom":
        return BloomHitSet(**kw)
    if kind == "explicit_hash":
        return ExplicitHitSet()
    raise ValueError(f"unknown hitset type {kind!r}")


class HitSetTracker:
    """Per-OSD periodic tracker (the PG hit_set machinery): the current
    set absorbs accesses; every ``period`` seconds it is archived and a
    fresh one started, keeping the newest ``count`` archives -- the
    window the tiering agent scans to estimate object temperature."""

    def __init__(self, kind: str = "bloom", period: float = 600.0,
                 count: int = 4, **kw):
        self.kind = kind
        self.period = period
        self.count = count
        self._kw = kw
        self.current = make_hitset(kind, **kw)
        self.current_start = time.time()
        self.archived: Deque[tuple] = deque(maxlen=count)

    def _maybe_roll(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        # after a long idle gap, skip straight to the retention window:
        # every older period is an empty archive anyway, and one roll
        # per elapsed period keeps archive spans honest (a single roll
        # spanning N idle periods would keep a stale object "hot" for
        # the whole window)
        horizon = self.period * (self.count + 1)
        if now - self.current_start > horizon + self.period:
            self.archived.append((
                self.current_start, self.current_start + self.period,
                self.current))
            self.current = make_hitset(self.kind, **self._kw)
            self.current_start = now - horizon
        while now - self.current_start >= self.period:
            self.archived.append((
                self.current_start, self.current_start + self.period,
                self.current))
            self.current = make_hitset(self.kind, **self._kw)
            self.current_start += self.period

    def record(self, oid: str, now: Optional[float] = None) -> None:
        self._maybe_roll(now)
        self.current.insert(oid)

    def record_many(self, oids, now: Optional[float] = None) -> None:
        """Batch form of :meth:`record` (the OSD's array-batched op
        path): one roll check covers the whole run."""
        self._maybe_roll(now)
        insert = self.current.insert
        for oid in oids:
            insert(oid)

    def temperature(self, oid: str, now: Optional[float] = None) -> float:
        """Fraction of retained periods (newest weighted heaviest) in
        which the object appears -- the agent's hotness estimate."""
        self._maybe_roll(now)
        sets = [h for _s, _e, h in self.archived] + [self.current]
        if not sets:
            return 0.0
        weight = total = 0.0
        for i, hs in enumerate(sets):
            w = float(i + 1)  # newest last, heaviest
            total += w
            if hs.contains(oid):
                weight += w
        return weight / total

    def dump(self) -> dict:
        return {
            "kind": self.kind,
            "period": self.period,
            "current_entries": len(self.current),
            "archived": [
                {"start": s, "end": e, "entries": len(h)}
                for s, e, h in self.archived
            ],
        }
