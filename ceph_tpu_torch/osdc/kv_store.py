"""key_value_store: a sorted KV index over RADOS omap buckets.

Port of ``ceph_tpu/osdc/kv_store.py``: the same index and bucket
objects and omap values, through the port's ``utils/encoding.py``.

Reference: src/key_value_store (KvFlatBtreeAsync, ~4.2k LoC) -- a flat
one-level B-tree: an index object maps each bucket's HIGH key to the
bucket object holding that key range in its omap; buckets split when
they outgrow ``max_per_bucket`` and merge with a neighbor when they
empty.  Reads are two hops (index, then bucket); scans walk buckets in
index order, which keeps enumeration sorted without a global object.

The reference makes split/merge crash-safe with prefixed index markers;
here a rebalance writes the new bucket objects FIRST, then routes the
low half by adding its index key (readers stay consistent at every
step), and finally CAS-flips the old high key -- a lost CAS means a
concurrent rebalance won, and the loser rolls its buckets back.  A
crash mid-split leaves the old (oversized but correct) state.  Bucket
names come from a CAS-allocated sequence persisted in the index, so a
reopened store never reuses a live bucket name.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.utils.encoding import Decoder, Encoder

#: index omap: key = high key of the bucket ("\xff..." for the last),
#: value = encoded bucket object name
HIGH_LAST = "\xff"


def _enc(v) -> bytes:
    return Encoder().value(v).bytes()


def _dec(b):
    return Decoder(b).value() if b else None


class KvStore:
    SEQ_KEY = "_seq"

    def __init__(self, backend, name: str, max_per_bucket: int = 64):
        self.backend = backend
        self.name = name
        self.max_per_bucket = max_per_bucket

    @property
    def _index(self) -> str:
        return f"kvs.{self.name}.index"

    async def _new_bucket(self) -> str:
        """CAS-allocated bucket name persisted in the index: a reopened
        store must never hand out a LIVE bucket's name (an in-memory
        counter restarting at 0 would merge a future split into a
        foreign bucket, or delete it)."""
        while True:
            cur = await self.backend.omap_get(self._index, [self.SEQ_KEY])
            raw = cur.get(self.SEQ_KEY)
            n = (_dec(raw) or 0) + 1
            ok, _ = await self.backend.omap_cas(
                self._index, self.SEQ_KEY, raw, _enc(n))
            if ok:
                return f"kvs.{self.name}.b{n:08d}"

    async def _index_map(self) -> Dict[str, str]:
        try:
            omap = await self.backend.omap_get(self._index)
        except (FileNotFoundError, IOError):
            omap = {}
        out = {k: _dec(v) for k, v in omap.items()
               if k not in (self.SEQ_KEY, self.LOCK_KEY)}
        if not out:
            b = await self._new_bucket()
            ok, _ = await self.backend.omap_cas(
                self._index, HIGH_LAST, None, _enc(b))
            if not ok:  # racing first writer created the terminal bucket
                omap = await self.backend.omap_get(self._index)
                return {k: _dec(v) for k, v in omap.items()
                        if k not in (self.SEQ_KEY, self.LOCK_KEY)}
            out = {HIGH_LAST: b}
        return out

    def _bucket_for(self, index: Dict[str, str], key: str) -> Tuple[str, str]:
        """(high, bucket) whose range covers ``key``: the smallest high
        key >= key (the B-tree descent)."""
        for high in sorted(index):
            if key <= high or high == HIGH_LAST:
                return high, index[high]
        high = max(index)
        return high, index[high]

    # -- point ops ---------------------------------------------------------
    #
    # Concurrency model (a reduction vs the reference's prefixed index
    # markers, documented): any number of READERS run against live
    # rebalances -- a stale index resolution retries through the fresh
    # index, and writes re-validate their bucket against the index
    # after landing.  Concurrent WRITERS to the same key range are
    # last-writer-wins, like the backend omap they ride on.

    async def _bucket_put(self, bucket: str, key: str,
                          value: bytes) -> None:
        """Per-key CAS write: the backend's plain omap_set is a
        full-state last-writer-wins RMW, so two concurrent writers to
        one bucket would silently clobber each other's keys; omap_cas
        is the backend's atomicity primitive."""
        for _ in range(16):
            cur = (await self.backend.omap_get(bucket, [key])).get(key)
            ok, _c = await self.backend.omap_cas(bucket, key, cur, value)
            if ok:
                return
        raise IOError(f"bucket put contended: {key!r}")

    async def _bucket_rm(self, bucket: str, key: str) -> None:
        for _ in range(16):
            cur = (await self.backend.omap_get(bucket, [key])).get(key)
            if cur is None:
                return
            ok, _c = await self.backend.omap_cas(bucket, key, cur, None)
            if ok:
                return
        raise IOError(f"bucket rm contended: {key!r}")

    async def set(self, key: str, value: bytes) -> None:
        if not key or key >= HIGH_LAST:
            raise ValueError(f"key out of range: {key!r}")
        for _ in range(8):
            index = await self._index_map()
            high, bucket = self._bucket_for(index, key)
            await self._bucket_put(bucket, key, bytes(value))
            # re-validate: a concurrent split may have deleted the
            # bucket between our resolve and the write, destroying it
            fresh = await self._index_map()
            cur_high = next((h for h, b in fresh.items() if b == bucket),
                            None)
            if cur_high is None:
                continue  # bucket rebalanced away: redo via fresh index
            entries = await self.backend.omap_get(bucket)
            if len(entries) > self.max_per_bucket:
                await self._split(fresh, cur_high, bucket, entries)
            return
        raise IOError(f"set {key!r} kept losing to rebalances")

    async def get(self, key: str) -> bytes:
        for attempt in range(2):
            index = await self._index_map()
            _high, bucket = self._bucket_for(index, key)
            try:
                omap = await self.backend.omap_get(bucket, [key])
            except (FileNotFoundError, IOError):
                omap = {}
            if key in omap:
                return omap[key]
            if attempt == 0:
                continue  # maybe a stale index mid-split: re-resolve
        raise KeyError(key)

    async def remove(self, key: str) -> None:
        removed_once = False
        for _ in range(8):
            index = await self._index_map()
            high, bucket = self._bucket_for(index, key)
            omap = await self.backend.omap_get(bucket, [key])
            if key not in omap:
                if removed_once:
                    return  # our removal stuck through the rebalance
                # a rebalance may have moved it mid-resolve: one
                # re-resolve before declaring it missing
                fresh = await self._index_map()
                if self._bucket_for(fresh, key)[1] != bucket:
                    continue
                raise KeyError(key)
            await self._bucket_rm(bucket, key)
            removed_once = True
            fresh = await self._index_map()
            if bucket not in fresh.values():
                continue  # a split may have carried the key: re-check
            if len(fresh) > 1:
                rest = await self.backend.omap_get(bucket)
                if not rest:
                    await self._drop_bucket(fresh, high, bucket)
            return
        raise IOError(f"remove {key!r} kept losing to rebalances")

    # -- scans (sorted by construction) ------------------------------------

    async def items(self, prefix: str = "") -> List[Tuple[str, bytes]]:
        for _ in range(4):
            result = await self._items_once(prefix)
            if result is not None:
                return result
        raise IOError("scan kept losing to rebalances")

    async def _items_once(self, prefix: str):
        """One scan pass; None when a bucket vanished mid-scan (a split
        deleted it after our index read -- its keys live on in the new
        buckets, so the whole enumeration must restart on the fresh
        index rather than silently omit them)."""
        index = await self._index_map()
        out: List[Tuple[str, bytes]] = []
        prev_high = ""
        for high in sorted(index):
            # range pruning: a bucket covers (prev_high, high]; skip
            # buckets entirely below the prefix range, stop once a
            # previous high sorts after every possible "prefix*" key
            if prefix and high != HIGH_LAST and high < prefix:
                prev_high = high
                continue
            if prefix and prev_high > prefix and \
                    not prev_high.startswith(prefix):
                break
            omap = await self.backend.omap_get(index[high])
            if not omap:
                fresh = await self._index_map()
                if index[high] not in fresh.values():
                    return None  # bucket rebalanced away mid-scan
            for k in sorted(omap):
                if k.startswith(prefix):
                    out.append((k, omap[k]))
            prev_high = high
        return out

    async def keys(self, prefix: str = "") -> List[str]:
        return [k for k, _ in await self.items(prefix)]

    # -- rebalance (KvFlatBtreeAsync split / rebalance) --------------------

    LOCK_KEY = "_rebalance_lock"
    LOCK_TTL = 30.0

    async def _try_rebalance_lock(self) -> Optional[bytes]:
        """Opportunistic CAS lock serializing rebalances: two
        concurrent splits of overlapping ranges can strand a landed
        write inside a rolled-back bucket, so only one rebalance runs
        at a time; a loser simply defers (an oversized bucket is
        correct, merely unbalanced -- the next set retries).  A crashed
        holder's lock is stolen after LOCK_TTL."""
        import time as _time

        token = _enc({"t": _time.time()})
        ok, cur = await self.backend.omap_cas(
            self._index, self.LOCK_KEY, None, token)
        if ok:
            return token
        held = _dec(cur) if cur else None
        if held and _time.time() - held.get("t", 0) > self.LOCK_TTL:
            ok, _ = await self.backend.omap_cas(
                self._index, self.LOCK_KEY, cur, token)
            if ok:
                return token
        return None

    async def _unlock_rebalance(self, token: bytes) -> None:
        await self.backend.omap_cas(
            self._index, self.LOCK_KEY, token, None)

    async def _rollback_new_bucket(self, new_bucket: str,
                                   planned: Dict[str, bytes],
                                   old_bucket: str) -> None:
        """Undo an uncommitted split bucket.  A writer may have landed
        in it during its brief index visibility (including a stolen-
        lock race): anything beyond the planned copy is carried back to
        the still-live old bucket before the object goes."""
        try:
            cur = await self.backend.omap_get(new_bucket)
        except (FileNotFoundError, IOError):
            cur = {}
        for k, v in cur.items():
            if planned.get(k) != v:
                await self._bucket_put(old_bucket, k, v)
        await self._delete_bucket_obj(new_bucket)

    async def _delete_bucket_obj(self, bucket: str) -> None:
        await self.backend.omap_clear(bucket)
        try:
            await self.backend.remove_object(bucket)
        except (FileNotFoundError, IOError):
            pass

    async def _split(self, index: Dict[str, str], high: str,
                     bucket: str, entries: Dict[str, bytes]) -> None:
        token = await self._try_rebalance_lock()
        if token is None:
            return  # another rebalance is live: defer (stay oversized)
        try:
            await self._split_locked(index, high, bucket, entries)
        finally:
            await self._unlock_rebalance(token)

    async def _split_locked(self, index: Dict[str, str], high: str,
                            bucket: str,
                            entries: Dict[str, bytes]) -> None:
        ordered = sorted(entries)
        mid = len(ordered) // 2
        low_keys, high_keys = ordered[:mid], ordered[mid:]
        lo_bucket = await self._new_bucket()
        hi_bucket = await self._new_bucket()
        # 1. new buckets first (no reader can see them yet)
        await self.backend.omap_set(
            lo_bucket, {k: entries[k] for k in low_keys})
        await self.backend.omap_set(
            hi_bucket, {k: entries[k] for k in high_keys})
        # 2. route the low half: readers now find low keys in lo_bucket
        #    and everything else still in the (complete) old bucket
        ok, _ = await self.backend.omap_cas(
            self._index, low_keys[-1], None, _enc(lo_bucket))
        if not ok:
            # a concurrent rebalance created this boundary: yield
            await self._rollback_new_bucket(lo_bucket, entries, bucket)
            await self._rollback_new_bucket(hi_bucket, entries, bucket)
            return
        # 3. commit point: CAS the old high key to the new high bucket;
        #    a loser rolls everything back (the old state was correct,
        #    merely oversized)
        ok, _ = await self.backend.omap_cas(
            self._index, high, _enc(bucket), _enc(hi_bucket))
        if not ok:
            await self.backend.omap_cas(
                self._index, low_keys[-1], _enc(lo_bucket), None)
            await self._rollback_new_bucket(lo_bucket, entries, bucket)
            await self._rollback_new_bucket(hi_bucket, entries, bucket)
            return
        # writes that slipped into the OLD bucket between our copy and
        # the commit (and passed their validation against the
        # still-present index entry) must be carried over, not
        # destroyed with the bucket
        late = await self.backend.omap_get(bucket)
        extra = {k: v for k, v in late.items()
                 if entries.get(k) != v}
        for k, v in extra.items():
            dst = lo_bucket if k <= low_keys[-1] else hi_bucket
            await self._bucket_put(dst, k, v)  # CAS: writers may be live
        # late DELETIONS too: a key removed from the old bucket during
        # the window is absent from `late`, but its snapshot copy sits
        # in a new bucket -- without this it silently resurrects
        for k in set(entries) - set(late):
            dst = lo_bucket if k <= low_keys[-1] else hi_bucket
            await self._bucket_rm(dst, k)
        await self._delete_bucket_obj(bucket)

    async def _drop_bucket(self, index: Dict[str, str], high: str,
                           bucket: str) -> None:
        """An emptied bucket merges away: its range folds into the next
        bucket up (or the last bucket absorbs the tail range)."""
        if high == HIGH_LAST:
            return  # the terminal bucket always exists
        token = await self._try_rebalance_lock()
        if token is None:
            return  # defer: an empty bucket is correct, merely wasteful
        try:
            await self._drop_bucket_locked(high, bucket)
        finally:
            await self._unlock_rebalance(token)

    async def _drop_bucket_locked(self, high: str, bucket: str) -> None:
        ok, _ = await self.backend.omap_cas(
            self._index, high, _enc(bucket), None)
        if not ok:
            return  # the range moved under us
        # a write may have slipped in between our emptiness check and
        # the index removal (and validated against the still-present
        # entry): re-check, and restore the range instead of destroying
        # the key -- writes landing after the removal fail their own
        # validation and retry elsewhere
        rest = await self.backend.omap_get(bucket)
        if rest:
            await self.backend.omap_cas(
                self._index, high, None, _enc(bucket))
            return
        await self._delete_bucket_obj(bucket)

    async def stats(self) -> dict:
        index = await self._index_map()
        sizes = {}
        for high in sorted(index):
            omap = await self.backend.omap_get(index[high])
            sizes[index[high]] = len(omap)
        return {"buckets": len(index), "entries": sum(sizes.values()),
                "per_bucket": sizes}
