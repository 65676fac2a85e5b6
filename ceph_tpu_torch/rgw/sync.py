"""RGW multisite sync: replicate one zone's object store into another.

Port of ``ceph_tpu/rgw/sync.py``.

Reference: src/rgw/rgw_sync.cc + rgw_data_sync.cc -- a secondary zone
tails the master's metadata/data logs and converges its buckets.  This
subset is the COMPARE-based converge (the `radosgw-admin bucket sync
run` full-sync role): each pass reconciles users, the bucket directory,
and per-bucket state (index entries by size+etag, version instances,
ACL stores, versioning config), copying changed objects and deleting
vanished ones.  Incremental efficiency comes from the etag
short-circuit instead of the reference's bilog tailing -- an unchanged
object costs one index-entry comparison, no data I/O.

One agent per direction, like rbd-mirror's daemon; run it from a cron /
mgr module / test loop.  Multipart uploads IN PROGRESS are not synced
(the reference's data sync also only ships completed objects).
"""

from __future__ import annotations

from typing import Dict

from ceph_tpu_torch.rgw.gateway import (BUCKETS_OID, USERS_OID, acl_oid,
                                        bucket_index_oid, obj_oid, ver_obj_oid,
                                        versions_oid)


class RGWSyncAgent:
    """Converge ``dst`` (a secondary zone's pools) toward ``src``.

    ``src``/``dst`` are (data_backend, index_backend) pairs -- the same
    two handles an RGWGateway takes (index may equal data)."""

    def __init__(self, src, dst):
        self.src_data, self.src_index = src
        self.dst_data, self.dst_index = dst

    async def sync_once(self) -> Dict[str, int]:
        """One converge pass; returns op counts (test/ops surface)."""
        stats = {"users": 0, "buckets": 0, "acls": 0,
                 "objects_copied": 0, "objects_deleted": 0,
                 "versions_copied": 0}
        await self._sync_omap(USERS_OID, stats, "users")
        src_buckets = await self.src_index.omap_get(BUCKETS_OID)
        dst_buckets = await self.dst_index.omap_get(BUCKETS_OID)
        for name, raw in src_buckets.items():
            if dst_buckets.get(name) != raw:
                await self.dst_index.omap_set(BUCKETS_OID, {name: raw})
                stats["buckets"] += 1
            await self._sync_bucket(name, stats)
        # buckets deleted on the master vanish on the secondary
        for name in set(dst_buckets) - set(src_buckets):
            await self._purge_bucket(name, stats)
        return stats

    async def _sync_omap(self, oid: str, stats, counter: str) -> None:
        src = await self.src_index.omap_get(oid)
        dst = await self.dst_index.omap_get(oid)
        delta = {k: v for k, v in src.items() if dst.get(k) != v}
        if delta:
            await self.dst_index.omap_set(oid, delta)
            stats[counter] += len(delta)
        gone = [k for k in dst if k not in src]
        if gone:
            await self.dst_index.omap_rm(oid, gone)

    @staticmethod
    def _version_data_oid(bucket: str, vk: str, raw: bytes):
        """Data oid backing one versions-omap entry, or None (markers
        have no body).  'put' bodies live at the version oid, archived
        pre-versioning 'plain' bodies at the plain oid."""
        key, _, vid = vk.rpartition("\x00")
        kind = raw.decode().split("\x00")[3]
        if kind == "put":
            return ver_obj_oid(bucket, key, vid)
        if kind == "plain":
            return obj_oid(bucket, key)
        return None

    async def _sync_bucket(self, bucket: str, stats) -> None:
        # ACL store + versioning config converge wholesale (small omaps)
        await self._sync_omap(acl_oid(bucket), stats, "acls")
        # VERSION INSTANCES FIRST: they own version bodies ('put' AND the
        # archived pre-versioning 'plain' bodies), and the index entries
        # written below must never point at data not yet shipped
        src_vers = await self.src_index.omap_get(versions_oid(bucket))
        dst_vers = await self.dst_index.omap_get(versions_oid(bucket))
        for vk, raw in src_vers.items():
            if dst_vers.get(vk) == raw:
                continue
            if vk != "_seq":
                data_oid = self._version_data_oid(bucket, vk, raw)
                if data_oid is not None:
                    try:
                        data = await self.src_data.read(data_oid)
                    except IOError:
                        continue  # deleted on the live master mid-pass:
                        # the next pass converges (entry not recorded)
                    await self.dst_data.write(data_oid, data)
                    stats["versions_copied"] += 1
            await self.dst_index.omap_set(versions_oid(bucket), {vk: raw})
        gone = [vk for vk in dst_vers if vk not in src_vers]
        if gone:
            for vk in gone:
                if vk == "_seq":
                    continue
                data_oid = self._version_data_oid(bucket, vk, dst_vers[vk])
                if data_oid is not None:
                    try:
                        await self.dst_data.remove_object(data_oid)
                    except IOError:
                        pass
            await self.dst_index.omap_rm(versions_oid(bucket), gone)
        # BUCKET INDEX: plain (no-vid) entries carry their own data;
        # vid-pointing entries reference bodies the version pass shipped
        src_idx = await self.src_index.omap_get(bucket_index_oid(bucket))
        dst_idx = await self.dst_index.omap_get(bucket_index_oid(bucket))
        for key, raw in src_idx.items():
            if dst_idx.get(key) == raw:
                continue  # etag/size/vid unchanged: no data I/O
            parts = raw.decode().split("\x00")
            if len(parts) <= 3:  # plain object: ship the body
                try:
                    data = await self.src_data.read(obj_oid(bucket, key))
                except IOError:
                    continue  # deleted on the live master mid-pass
                await self.dst_data.write(obj_oid(bucket, key), data)
            stats["objects_copied"] += 1
            await self.dst_index.omap_set(bucket_index_oid(bucket),
                                          {key: raw})
        gone_keys = set(dst_idx) - set(src_idx)
        # plain bodies still referenced by an archived 'plain' version
        # (the null-version role) must survive their index entry; only
        # worth computing when there are deletions to guard
        plain_archived = set() if not gone_keys else {
            vk.rpartition("\x00")[0] for vk, vraw in src_vers.items()
            if vk != "_seq" and vraw.decode().split("\x00")[3] == "plain"
        }
        for key in gone_keys:
            parts = dst_idx[key].decode().split("\x00")
            if len(parts) <= 3 and key not in plain_archived:
                # plain body owned by the index entry; version bodies
                # (incl. plain-archived ones) stay -- a delete marker on
                # the master hides the key but ?versionId reads must
                # keep working (review r5)
                try:
                    await self.dst_data.remove_object(obj_oid(bucket, key))
                except IOError:
                    pass
            await self.dst_index.omap_rm(bucket_index_oid(bucket), [key])
            stats["objects_deleted"] += 1

    async def _purge_bucket(self, bucket: str, stats) -> None:
        idx = await self.dst_index.omap_get(bucket_index_oid(bucket))
        for key in idx:
            parts = idx[key].decode().split("\x00")
            if len(parts) <= 3:
                try:
                    await self.dst_data.remove_object(obj_oid(bucket, key))
                except IOError:
                    pass
            stats["objects_deleted"] += 1
        # every archived version body goes with the bucket (they are
        # unreachable once the versions omap is cleared -- review r5)
        vers = await self.dst_index.omap_get(versions_oid(bucket))
        for vk, vraw in vers.items():
            if vk == "_seq":
                continue
            data_oid = self._version_data_oid(bucket, vk, vraw)
            if data_oid is not None:
                try:
                    await self.dst_data.remove_object(data_oid)
                except IOError:
                    pass
        await self.dst_index.omap_clear(bucket_index_oid(bucket))
        await self.dst_index.omap_clear(acl_oid(bucket))
        await self.dst_index.omap_clear(versions_oid(bucket))
        await self.dst_index.omap_rm(BUCKETS_OID, [bucket])
        stats["buckets"] += 1
