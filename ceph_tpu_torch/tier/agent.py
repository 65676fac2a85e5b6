"""Tier agent: the hitset-driven promote / flush / evict loop.

Port of ``ceph_tpu/tier/agent.py``.  Reference: the cache-tier agent (src/osd/PrimaryLogPG.cc agent_work +
TierAgentState) that walks objects ranking hotness from hit sets and
promotes/flushes/evicts against the cache pool's targets.  Here the
agent is one async tick riding the OSD's background tick loop (a peer
of ``scrub_tick`` in ``osd/shard.py``), and the cache device is the
accelerator's own memory:

* **flush**: dirty entries left behind by a failed/abandoned
  write-through fan-out are dropped (the shards hold the authoritative
  bytes; see ``DeviceTierStore.flush_dirty``);
* **promote**: objects this OSD is PRIMARY for whose hit-set
  temperature clears ``osd_tier_promote_temp`` and which are not yet
  resident get their full shard set gathered (consistent-cut read, the
  codec reconstructing any missing position) and shipped in ONE batched
  device transfer (``put_many``), at most
  ``osd_tier_promote_max_per_tick`` objects per tick;
* **evict**: the store is trimmed back under ``osd_tier_hbm_bytes``
  coldest-first (temperature, then LRU).

Only pools whose cache mode is ``writeback`` or ``readproxy`` take
part; the mode comes from ``ECCluster.set_tier_mode`` in-process (the
JAX package also takes it from the mon's `osd tier cache-mode` via the
osdmap; the port has no mon yet).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.osd import ecutil


class TierAgent:
    """One OSD's promote/flush/evict agent over its hosted pools."""

    def __init__(self, shard):
        self.shard = shard

    # -- candidate selection -----------------------------------------------

    def _is_primary(self, backend, oid: str) -> bool:
        acting = backend.acting_set(oid)
        for s in range(backend.km):
            if backend._shard_up(acting, s):
                return f"osd.{acting[s]}" == self.shard.name
        return False

    def _promotion_candidates(self, active, limit: int,
                              thresh: float) -> List[tuple]:
        """(pool, backend, oid) triples worth promoting this tick:
        locally-held base objects this OSD leads, hot by hit-set
        temperature, not yet resident.  Reuses the scrub cursor's cached
        base listing so a big store is not re-scanned per tick."""
        shard = self.shard
        tier = shard.tier
        bases = shard._scrub_base_list()
        tags = getattr(shard, "_scrub_pool_tags", {})
        out: List[tuple] = []
        for base in bases:
            if len(out) >= limit:
                break
            if "~" in base:
                continue  # clones are cold history; heads only
            tag = tags.get(base)
            for pool, backend in active.items():
                if not backend._pool_match(tag):
                    continue
                if tier.contains(pool, base):
                    break
                if shard.hitsets.temperature(base) < thresh:
                    break
                if not self._is_primary(backend, base):
                    break
                out.append((pool, backend, base))
                break
        return out

    # -- promotion gather --------------------------------------------------

    async def _gather_block(self, backend, oid: str) -> Optional[Tuple]:
        """(shard-major host block [km, shard_len], version, logical
        size) for one object, or None when it cannot be assembled right
        now.  Reads a consistent cut of every up shard (scrub op class:
        background priority) and reconstructs missing positions through
        the codec, so the resident block always holds ALL km shards --
        a later degraded acting set never forces a decode on the hit
        path."""
        km = backend.km
        acting = backend.acting_set(oid)
        up = [s for s in range(km) if backend._shard_up(acting, s)]
        if len(up) < backend.k:
            return None
        chunks, logical_size, _attrs, version = \
            await backend._gather_consistent(
                oid, up, acting, op_class="scrub", up_shards=up
            )
        if len(chunks) < backend.k or logical_size is None or \
                tuple(version) == (0, ""):
            return None
        shard_len = len(next(iter(chunks.values())))
        if shard_len == 0:
            return None  # zero-byte object: nothing to keep resident
        missing = [s for s in range(km) if s not in chunks]
        if missing:
            rebuilt = ecutil.decode_shards(backend.ec, chunks, missing)
            for s in missing:
                chunks[s] = rebuilt[s]
        block = np.stack(
            [np.asarray(chunks[s], dtype=np.uint8) for s in range(km)]
        )
        return block, tuple(version), logical_size

    # -- the tick ----------------------------------------------------------

    async def tick(self) -> dict:
        """One agent round; returns {"promoted", "flushed",
        "evicted_bytes"} for the caller's accounting."""
        from ceph_tpu_torch.utils.config import get_config

        shard = self.shard
        stats = {"promoted": 0, "flushed": 0, "evicted_bytes": 0}
        active = {
            name: b for name, b in shard.pools.items()
            if getattr(b, "tier_mode", "none") != "none"
            and getattr(b, "ec", None) is not None
        }
        if not active:
            return stats
        cfg = get_config()
        thresh = float(cfg.get_val("osd_tier_promote_temp"))
        limit = int(cfg.get_val("osd_tier_promote_max_per_tick"))

        stats["flushed"] = shard.tier.flush_dirty()

        # the consistent-cut gathers below span awaits; a sub-write
        # applying inside that window invalidates BEFORE the block is
        # resident (a no-op) and put_many would insert the stale cut.
        # The watch collects every invalidated oid for the window so
        # the insert step can drop them (asyncsan rmw-across-await at
        # the tier layer; a false drop just defers one tick).
        watch = shard.tier.watch_invalidations()
        try:
            items = []
            for pool, backend, oid in self._promotion_candidates(
                active, limit, thresh
            ):
                got = await self._gather_block(backend, oid)
                if got is None or oid in watch:
                    continue
                block, version, logical_size = got
                items.append((pool, oid, block, version, logical_size))
            if items:
                # filter + insert must be ONE yield-free step or the
                # window the watch closes reopens between them
                # cephlint: atomic-section tier-promote-cut
                fresh = [it for it in items if it[1] not in watch]
                if fresh:
                    stats["promoted"] = shard.tier.put_many(fresh)
                # cephlint: end-atomic-section
        finally:
            shard.tier.unwatch(watch)

        stats["evicted_bytes"] = shard.tier.evict_to_budget()
        return stats
