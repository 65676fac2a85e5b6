"""Client for a multi-process cluster: a thin Objecter over TCP.

Port of ``ceph_tpu/daemon/client.py``.  The client builds the pool's
codec only for its chunk count (a profile without ``plugin`` gets the
port's default, ``cuda``, as the daemons do; a profile on ``cuda`` raises
without CUDA unless it says ``device=cpu``); the chunk math runs in the
primary OSD's process.

The reference's architecture: the client computes placement
(the librados Objecter role, src/osdc/Objecter.cc:2784 _calc_target) and
sends ONE op per I/O to the primary OSD daemon, which hosts the EC
engine and fans out sub-ops to the acting set
(src/osd/PrimaryLogPG.cc do_op; src/osd/ECBackend.cc:1976 fan-out).
If the primary dies mid-op the Objecter probes it, marks it down and
retries against the next up shard -- primary failover without any
client-side chunk work.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ceph_tpu_torch.msg.tcp import TCPMessenger
from ceph_tpu_torch.osd.cluster import DEFAULT_PLUGIN
from ceph_tpu_torch.osd.objecter import Objecter
from ceph_tpu_torch.osd.placement import CrushPlacement
from ceph_tpu_torch.plugins import registry as registry_mod


class RemoteClient:
    def __init__(self, backend: Objecter, messenger: TCPMessenger,
                 n_osds: int):
        self.backend = backend
        self.messenger = messenger
        self.n_osds = n_osds

    @classmethod
    async def connect(
        cls,
        addr_map: "str | Dict[str, Tuple[str, int]]",
        profile: Dict[str, str],
        name: str = "client",
        hosts=None,
        keyring=None,
        pool: str = "ecpool",
        op_timeout: float = 30.0,
    ) -> "RemoteClient":
        if isinstance(addr_map, str):
            from ceph_tpu_torch.utils import aio

            addr_map = {
                k: tuple(v)
                for k, v in (await aio.read_json(addr_map)).items()
            }
        if isinstance(keyring, str):
            from ceph_tpu_torch.auth import KeyRing

            keyring = KeyRing.load(keyring)
        n_osds = sum(1 for k in addr_map if k.startswith("osd."))
        messenger = TCPMessenger(name, addr_map, keyring=keyring)
        await messenger.start()

        # the client needs only the pool width (k+m, or replica count)
        # for placement; chunk math happens on the primary OSD
        profile = dict(profile)
        if profile.pop("pool_type", "erasure") == "replicated":
            km = int(profile.get("size", 3))
        else:
            plugin = profile.pop("plugin", DEFAULT_PLUGIN)
            ec = registry_mod.instance().factory(plugin, profile)
            km = ec.get_chunk_count()
        placement = CrushPlacement(n_osds, km, hosts=hosts)
        backend = Objecter(
            messenger, km, n_osds, placement=placement, name=name,
            pool=pool, op_timeout=op_timeout,
        )
        client = cls(backend, messenger, n_osds)
        n_mons = sum(1 for k in addr_map if k.startswith("mon."))
        if n_mons:
            # map-driven routing (reference Objecter::_maybe_request_map):
            # subscribe to osdmap epochs; up/down marks and CRUSH weights
            # come from the mon, not just from client-side probing
            from ceph_tpu_torch.mon.monitor import MonClient
            from ceph_tpu_torch.mon.osdmap import apply_map_view

            monc = MonClient(messenger, n_mons, name)
            state = {"epoch": 0}

            async def mon_hook(msg):
                if await monc.handle_reply(msg):
                    return
                if msg.get("type") == "osdmap":
                    apply_map_view(msg["map"], state, messenger,
                                   placements=[placement])

            backend.mon_hook = mon_hook
            client.monc = monc
            await monc.subscribe()
        return client

    async def probe_osds(self) -> Dict[str, bool]:
        """Heartbeat round: refresh the liveness view of every OSD."""
        out = {}
        for i in range(self.n_osds):
            name = f"osd.{i}"
            out[name] = await self.messenger.probe(name)
        return out

    # -- I/O surface -------------------------------------------------------

    async def write(self, oid: str, data: bytes) -> None:
        await self.backend.write(oid, data)

    async def read(self, oid: str) -> bytes:
        return await self.backend.read(oid)

    async def write_range(self, oid: str, offset: int, data: bytes) -> None:
        await self.backend.write_range(oid, offset, data)

    async def read_range(self, oid: str, offset: int, length: int) -> bytes:
        return await self.backend.read_range(oid, offset, length)

    async def close(self) -> None:
        await self.messenger.shutdown()
