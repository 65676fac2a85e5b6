"""librados-style client API (Rados / IoCtx surface).

Reference: src/librados (Rados cluster handle, IoCtx per pool with
write_full/read/remove/stat, pool create with an EC profile validated by
instantiating the plugin -- the OSDMonitor::get_erasure_code role,
reference src/mon/OSDMonitor.cc:5353).  Synchronous wrappers drive the
async mini-cluster; aio_* variants return awaitables.

Port of ``ceph_tpu/client.py``.  A pool runs on the card unless its
profile asks for the CPU: a profile that names no plugin gets ``cuda``
(the JAX package's fallback is ``jerasure``), and so does the default
profile, ``osd_pool_default_erasure_code_profile``.  ``device=cpu`` in a
``cuda`` profile runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from ceph_tpu_torch.osd.cluster import DEFAULT_PLUGIN, ECCluster
from ceph_tpu_torch.osd.ecbackend import SIZE_KEY, shard_oid
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.utils.config import get_config


class Rados:
    """Cluster handle: owns the OSDs and the pools."""

    def __init__(self, n_osds: int = 8):
        self.n_osds = n_osds
        self._pools: Dict[str, ECCluster] = {}
        self._loop = asyncio.new_event_loop()

    # -- pool ops (mon-role: profile validation at create time) ------------

    def pool_create(self, name: str, profile: Optional[Dict[str, str]] = None,
                    pool_type: str = "erasure", size: int = 3):
        """Create a pool.  ``pool_type`` mirrors `ceph osd pool create
        <name> replicated|erasure` (reference src/mon/OSDMonitor.cc:5529):
        replicated pools take ``size`` full copies and no EC profile."""
        if name in self._pools:
            raise ValueError(f"pool {name} exists")
        if pool_type == "replicated":
            if size < 1 or size > self.n_osds:
                raise ValueError(f"bad replicated size {size}")
            self._pools[name] = self._run(
                self._make_pool({"size": str(size)}, pool_type)
            )
            return self.open_ioctx(name)
        if profile is None:
            text = get_config().get_val("osd_pool_default_erasure_code_profile")
            profile = dict(kv.split("=", 1) for kv in text.split())
        # validate the profile by instantiating the codec (monitor behavior)
        check = dict(profile)
        plugin = check.pop("plugin", DEFAULT_PLUGIN)
        registry_mod.instance().factory(plugin, check)
        self._pools[name] = self._run(self._make_pool(profile, pool_type))
        return self.open_ioctx(name)

    async def _make_pool(self, profile, pool_type="erasure"):
        return ECCluster(self.n_osds, dict(profile), pool_type=pool_type)

    def pool_delete(self, name: str) -> None:
        pool = self._pools.pop(name, None)
        if pool is not None:
            self._run(pool.shutdown())

    def list_pools(self) -> List[str]:
        return sorted(self._pools)

    def open_ioctx(self, name: str) -> "IoCtx":
        if name not in self._pools:
            raise KeyError(f"no pool {name}")
        return IoCtx(self, self._pools[name])

    def shutdown(self) -> None:
        for name in list(self._pools):
            self.pool_delete(name)
        self._loop.close()

    def _run(self, coro):
        return self._loop.run_until_complete(coro)


class IoCtx:
    """Per-pool I/O context (librados::IoCtx role)."""

    def __init__(self, rados: Rados, cluster: ECCluster):
        self._rados = rados
        self._cluster = cluster
        #: self-managed snapshot state (librados: the APPLICATION owns the
        #: snap context -- rados_ioctx_selfmanaged_snap_* -- exactly as
        #: librbd keeps snap ids in its own header object)
        self._snap_seq = 0
        self._snaps: List[int] = []  # live snap ids, newest first
        self.snap_read: Optional[int] = None  # set_snap_read target

    # -- self-managed snapshots (librados selfmanaged_snap_* surface) ------

    def _snapc(self) -> Optional[dict]:
        if not self._snaps:
            return None
        return {"seq": self._snap_seq, "snaps": list(self._snaps)}

    def selfmanaged_snap_create(self) -> int:
        """Allocate a snap id; subsequent writes preserve pre-snap state
        via COW clones (reference rados_ioctx_selfmanaged_snap_create)."""
        self._snap_seq += 1
        self._snaps.insert(0, self._snap_seq)
        return self._snap_seq

    def selfmanaged_snap_remove(self, snapid: int) -> None:
        """Drop a snap id and trim clones it alone kept alive (the
        SnapMapper/snap-trimmer role, run client-side: trims fan out
        concurrently, one round per object)."""
        import asyncio as _aio

        if snapid in self._snaps:
            self._snaps.remove(snapid)
        backend = self._cluster.backend
        live = list(self._snaps)
        heads = [o for o in self.list_objects() if "~" not in o]

        async def trim_all():
            await _aio.gather(
                *(backend.snap_trim(oid, live) for oid in heads)
            )

        self._rados._run(trim_all())

    def selfmanaged_snap_rollback(self, oid: str, snapid: int) -> None:
        self._rados._run(
            self._cluster.backend.snap_rollback(
                oid, snapid, snapc=self._snapc()
            )
        )

    def set_snap_read(self, snapid: Optional[int]) -> None:
        """Route subsequent reads to the object state at ``snapid``
        (None = head)."""
        self.snap_read = snapid

    def list_snaps(self, oid: str) -> dict:
        return self._rados._run(self._cluster.backend.list_snaps(oid))

    # -- sync surface ------------------------------------------------------

    def write_full(self, oid: str, data: bytes) -> None:
        self._rados._run(
            self._cluster.backend.write(oid, data, snapc=self._snapc())
        )

    def read(self, oid: str) -> bytes:
        return self._rados._run(
            self._cluster.backend.read(oid, snap=self.snap_read)
        )

    def remove(self, oid: str) -> None:
        self._rados._run(
            self._cluster.backend.remove_object(oid, snapc=self._snapc())
        )

    def stat(self, oid: str) -> int:
        """Logical object size from the HIGHEST-VERSIONED reachable
        shard's xattrs (a first-reachable answer could be a stale
        removal tombstone, or a stale copy, on a replica that was down
        through the newest writes).  A replicated-pool removal tombstone
        (whiteout "removed", osd/replicated.py) stats as
        absent, matching the EC pool's physical delete."""
        from ceph_tpu_torch.osd.pg import VERSION_KEY, WHITEOUT_KEY, vt

        backend = self._cluster.backend
        acting = backend.acting_set(oid)
        best = None  # (version, size, whiteout)
        for s in range(backend.km):
            if acting[s] is None:
                continue
            store = self._cluster.osds[acting[s]].store
            soid = shard_oid(oid, s)
            try:
                size = store.getattr(soid, SIZE_KEY)
            except FileNotFoundError:
                continue
            if size is None:
                continue
            ver = vt(store.getattr(soid, VERSION_KEY))
            if best is None or ver > best[0]:
                best = (ver, size, store.getattr(soid, WHITEOUT_KEY))
        if best is None or best[2] == "removed":
            raise FileNotFoundError(oid)
        return best[1]

    def list_objects(self) -> List[str]:
        from ceph_tpu_torch.osd.pg import (POOL_KEY, VERSION_KEY,
                                           WHITEOUT_KEY, vt)

        live: Dict[str, tuple] = {}     # base -> newest live version
        removed: Dict[str, tuple] = {}  # base -> newest tombstone version
        for osd in self._cluster.osds:
            for soid in osd.store.list_objects():
                if soid.endswith("@meta") and \
                        osd.store.getattr(soid, "_meta_removed"):
                    continue  # removal tombstone, not a live object
                ptag = osd.store.getattr(soid, POOL_KEY)
                if ptag is not None and ptag != self._cluster.pool:
                    continue  # a co-hosted pool's object
                base = soid.rsplit("@", 1)[0]
                ver = vt(osd.store.getattr(soid, VERSION_KEY))
                # replicated plain-removal tombstone (whiteout "removed",
                # osd/replicated.py): a dead name unless a NEWER
                # live copy exists (the object was re-created after)
                bucket = removed if osd.store.getattr(
                    soid, WHITEOUT_KEY) == "removed" else live
                prev = bucket.get(base)
                # None sentinel: version-less objects (omap-only meta
                # twins, pre-versioning writes) decode as (0, "") and
                # must still register as live
                if prev is None or ver > prev:
                    bucket[base] = ver
        return sorted(
            b for b, v in live.items()
            if b not in removed or v > removed[b]
        )

    def scrub(self, oid: str) -> dict:
        return self._rados._run(self._cluster.deep_scrub(oid))

    # -- omap / cls exec / watch-notify (librados metadata surface) --------

    def omap_set(self, oid: str, kvs: Dict[str, bytes]) -> None:
        self._rados._run(self._cluster.backend.omap_set(oid, kvs))

    def omap_get(self, oid: str, keys: Optional[List[str]] = None
                 ) -> Dict[str, bytes]:
        return self._rados._run(self._cluster.backend.omap_get(oid, keys))

    def omap_rm(self, oid: str, keys: List[str]) -> None:
        self._rados._run(self._cluster.backend.omap_rm(oid, keys))

    def exec(self, oid: str, cls: str, method: str, inp: bytes = b""):
        """Invoke a server-side object-class method (librados exec)."""
        return self._rados._run(
            self._cluster.backend.exec(oid, cls, method, inp)
        )

    def watch(self, oid: str, callback) -> None:
        self._rados._run(self._cluster.backend.watch(oid, callback))

    def unwatch(self, oid: str) -> None:
        self._rados._run(self._cluster.backend.unwatch(oid))

    def notify(self, oid: str, payload=None, timeout: float = 5.0) -> dict:
        return self._rados._run(
            self._cluster.backend.notify(oid, payload, timeout)
        )

    def lock_exclusive(self, oid: str, name: str, cookie: str) -> int:
        from ceph_tpu_torch.utils.encoding import Encoder

        ret, _ = self.exec(oid, "lock", "lock", Encoder().value(
            {"name": name, "locker": cookie, "type": "exclusive"}
        ).bytes())
        return ret

    def unlock(self, oid: str, name: str, cookie: str) -> int:
        from ceph_tpu_torch.utils.encoding import Encoder

        ret, _ = self.exec(oid, "lock", "unlock", Encoder().value(
            {"name": name, "locker": cookie}
        ).bytes())
        return ret

    # -- async surface -----------------------------------------------------

    def aio_write_full(self, oid: str, data: bytes):
        return self._cluster.write(oid, data)

    def aio_read(self, oid: str):
        return self._cluster.read(oid)
