"""Cluster-path benchmark: the EC write/read cycle over REAL TCP sockets.

Port of ``ceph_tpu/msg/cluster_bench.py`` over the port's ``OSDShard``,
``Objecter`` and ``CrushPlacement``, on ``msg/tcp.py`` with the wire
codec the configuration gives (the native C codec by default; the result
says which ran under ``"wire_codec"``, and :func:`python_wire_codec`
runs the Python codec for an A/B).  Beyond the JAX package's result,
each mode reports the transfer ledger of its write and read passes
(``residency``: H2D ops per fused granule, library builds) and the
result's ``steady_library_builds`` sums the builds of every timed pass
(the codec is warmed first, so it is 0 unless a pass built a library).

The storage-path bench (``osd/storage_bench.py``) measures the host codec
cycle in-process; this stage measures the DISTRIBUTED path the ROADMAP
north star actually serves: a client Objecter sends each op over
localhost TCP to the primary OSD daemon, which fans k+m EC sub-ops out to
its peers over lossless OSD<->OSD connections and gathers the commit
quorum -- every byte crossing a real socket through ``msg/tcp.py``.

Two wire modes, same daemons, same payloads:

* ``cork=False`` -- the per-message baseline: one frame join + one
  ``writer.write`` + one ``drain()`` per message, one standalone ACK
  frame + drain per received lossless message (the per-message shape);
* ``cork=True``  -- corked scatter-gather: per-connection frame queues
  flushed as single ``writelines`` bursts, zero-copy part-list payloads,
  piggybacked/batched cumulative acks.

Bit-exactness is gated BEFORE timing: both modes must store identical
shard bytes and round-trip every payload.  The JSON result carries the
wall times plus the messenger wire-shape counters (frames per burst,
bytes per drain, piggybacked-ack ratio) summed over every daemon.

Used by ``ceph_tpu_torch/tools/ec_benchmark.py --workload cluster-path``,
phase 3j of ``chip_smoke.py`` and tests/test_torch_cluster_path.py.
"""

from __future__ import annotations

import asyncio
import contextlib
import socket
import time
from typing import Dict, List, Optional

import numpy as np


def wire_codec_name() -> str:
    """The wire codec messengers built now run: ``"native"`` or
    ``"python"`` (raises where the native codec is asked for and cannot
    be built)."""
    from ceph_tpu_torch.native import wire_codec

    return "python" if wire_codec.native() is None else "native"


@contextlib.contextmanager
def python_wire_codec():
    """``osd_wire_codec_native=false`` for the length of the block (the
    Python codec, the A/B baseline of the native one), restored after."""
    from ceph_tpu_torch.utils.config import get_config

    cfg = get_config()
    prior = cfg.get_val("osd_wire_codec_native")
    cfg.set_val("osd_wire_codec_native", False)
    try:
        yield
    finally:
        cfg.set_val("osd_wire_codec_native", prior)


def free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def make_payloads(n_objects: int, obj_bytes: int, seed: int = 0
                  ) -> Dict[str, bytes]:
    rng = np.random.RandomState(seed)
    return {
        f"cp{i}": rng.randint(0, 256, size=obj_bytes,
                              dtype=np.uint8).tobytes()
        for i in range(n_objects)
    }


class ClusterHarness:
    """One localhost TCP cluster: n_osds OSDShard daemons (each on its
    own TCPMessenger/port) + a client Objecter messenger.  With a
    ``keyring`` (a ``KeyRing`` holding every entity's key) every
    connection runs the cephx handshake and every frame is signed."""

    def __init__(self, ec, n_osds: int, *, cork: bool,
                 pool: str = "ecpool", keyring=None):
        self.ec = ec
        self.n_osds = n_osds
        self.cork = cork
        self.pool = pool
        self.keyring = keyring
        self.messengers = []
        self.osds = []
        self.client = None
        self.objecter = None

    async def start(self) -> None:
        from ceph_tpu_torch.device import codec_device
        from ceph_tpu_torch.msg.fault import FaultInjector
        from ceph_tpu_torch.msg.tcp import TCPMessenger
        from ceph_tpu_torch.osd.placement import CrushPlacement
        from ceph_tpu_torch.osd.shard import OSDShard

        ports = free_ports(self.n_osds + 1)
        addr = {f"osd.{i}": ("127.0.0.1", ports[i])
                for i in range(self.n_osds)}
        addr["client"] = ("127.0.0.1", ports[self.n_osds])
        km = self.ec.get_chunk_count()
        placement = CrushPlacement(self.n_osds, km)
        for i in range(self.n_osds):
            m = TCPMessenger(f"osd.{i}", addr, fault=FaultInjector(),
                             keyring=self.keyring, cork=self.cork)
            await m.start()
            shard = OSDShard(i, m, device=codec_device(self.ec))
            shard.host_pool(self.pool, self.ec, self.n_osds, placement)
            self.messengers.append(m)
            self.osds.append(shard)
        self.client = TCPMessenger("client", addr, fault=FaultInjector(),
                                   keyring=self.keyring, cork=self.cork)
        await self.client.start()
        from ceph_tpu_torch.osd.objecter import Objecter

        self.objecter = Objecter(self.client, km, self.n_osds,
                                 placement=placement, pool=self.pool)
        self.messengers.append(self.client)

    async def run_writes(self, payloads: Dict[str, bytes],
                         writers: int, batch: int = 0) -> float:
        """Write every payload with ``writers`` concurrent client
        workers; returns the wall time.  ``batch`` > 1 drives the
        vectorized submit path: each worker hands ``batch``-sized op
        chunks to ``Objecter.write_many`` -- one submit stage crossing
        and one wire burst per chunk instead of per op."""
        queue = list(payloads.items())
        t0 = time.perf_counter()

        async def worker():
            while queue:
                if batch > 1:
                    chunk = [queue.pop() for _ in
                             range(min(batch, len(queue)))]
                    if chunk:
                        await self.objecter.write_many(chunk)
                else:
                    oid, data = queue.pop()
                    await self.objecter.write(oid, data)

        await asyncio.gather(*(worker() for _ in range(max(1, writers))))
        return time.perf_counter() - t0

    async def run_reads(self, payloads: Dict[str, bytes],
                        readers: int, batch: int = 0) -> tuple:
        """Read every object back; returns (wall, {oid: bytes})."""
        queue = list(payloads)
        got: Dict[str, bytes] = {}
        t0 = time.perf_counter()

        async def worker():
            while queue:
                if batch > 1:
                    chunk = [queue.pop() for _ in
                             range(min(batch, len(queue)))]
                    if chunk:
                        for oid, data in zip(
                                chunk, await self.objecter.read_many(chunk)):
                            got[oid] = data
                else:
                    oid = queue.pop()
                    got[oid] = await self.objecter.read(oid)

        await asyncio.gather(*(worker() for _ in range(max(1, readers))))
        return time.perf_counter() - t0, got

    def shard_bytes(self) -> Dict[tuple, bytes]:
        """Every stored shard object's data bytes (the bit-exactness
        contract; attrs carry version stamps and are excluded)."""
        out = {}
        for osd in self.osds:
            for soid in osd.store.list_objects():
                if soid.rpartition("@")[2] == "meta":
                    continue
                out[(osd.osd_id, soid)] = osd.store.read(soid)
        return out

    def wire_counters(self) -> Dict[str, int]:
        """Messenger wire-shape counters summed over every daemon."""
        total: Dict[str, int] = {}
        for m in self.messengers:
            for key, val in m.counters.items():
                total[key] = total.get(key, 0) + val
        return total

    async def shutdown(self) -> None:
        for m in self.messengers:
            await m.shutdown()


class WireHarness:
    """Messenger-level stage: the k+m sub-op fan-out message shape over
    real sockets, with the OSD op pipeline out of the way.

    One ``primary`` messenger fans a shard-sized payload out to every
    peer (the ECSubWrite shape: one message per peer per op, lossless
    OSD<->OSD policy) and an op completes when every peer's reply
    arrives -- the commit-quorum round trip.  ``inflight`` models a
    loaded primary (many PGs, many concurrent client ops), which is
    what gives the per-peer cork queues real bursts to gather.  This is
    the stage where the corked/zero-copy architecture is isolated from
    the (mode-independent) codec and OSD costs the full-stack stage
    also pays."""

    def __init__(self, n_peers: int, *, cork: bool):
        self.n_peers = n_peers
        self.cork = cork
        self.messengers = []
        self.primary = None
        self._replies: Dict[int, int] = {}
        self._done: Dict[int, asyncio.Future] = {}

    async def start(self) -> None:
        from ceph_tpu_torch.msg.fault import FaultInjector
        from ceph_tpu_torch.msg.tcp import TCPMessenger

        ports = free_ports(self.n_peers + 1)
        addr = {f"osd.{i}": ("127.0.0.1", ports[i])
                for i in range(self.n_peers + 1)}
        # peers echo a tiny committed-reply per received sub-op payload
        for i in range(1, self.n_peers + 1):
            m = TCPMessenger(f"osd.{i}", addr, fault=FaultInjector(),
                             cork=self.cork)
            await m.start()

            async def echo(src, msg, m=m):
                await m.send_message(m.node, src, ("committed", msg[0]))

            m.register(f"osd.{i}", echo)
            self.messengers.append(m)
        self.primary = TCPMessenger("osd.0", addr, fault=FaultInjector(),
                                    cork=self.cork)
        await self.primary.start()

        async def gather(src, msg):
            tid = msg[1]
            left = self._replies.get(tid, 0) - 1
            self._replies[tid] = left
            if left <= 0:
                fut = self._done.pop(tid, None)
                if fut is not None and not fut.done():
                    fut.set_result(True)

        self.primary.register("osd.0", gather)
        self.messengers.append(self.primary)

    async def run_ops(self, n_ops: int, shard_bytes: int,
                      inflight: int) -> float:
        """``n_ops`` fan-out/commit rounds with ``inflight`` concurrent
        ops; returns the wall."""
        payload = bytes(shard_bytes)
        loop = asyncio.get_event_loop()
        queue = list(range(n_ops))
        t0 = time.perf_counter()

        async def op_worker():
            while queue:
                tid = queue.pop()
                self._replies[tid] = self.n_peers
                fut = self._done[tid] = loop.create_future()
                await self.primary.send_messages("osd.0", [
                    (f"osd.{i}", (tid, s, payload))
                    for s, i in enumerate(range(1, self.n_peers + 1))
                ])
                await fut
                self._replies.pop(tid, None)

        await asyncio.gather(*(op_worker() for _ in range(inflight)))
        return time.perf_counter() - t0

    async def shutdown(self) -> None:
        for m in self.messengers:
            await m.shutdown()


async def _wire_cycle(n_peers: int, n_ops: int, shard_bytes: int,
                      inflight: int, *, cork: bool) -> dict:
    h = WireHarness(n_peers, cork=cork)
    await h.start()
    try:
        # warm: connections + session handshakes outside the timed region
        await h.run_ops(max(4, inflight), shard_bytes, inflight)
        wall = await h.run_ops(n_ops, shard_bytes, inflight)
        counters = {}
        for m in h.messengers:
            for key, val in m.counters.items():
                counters[key] = counters.get(key, 0) + val
    finally:
        await h.shutdown()
    msgs = n_ops * n_peers
    return {
        "wall_write_s": round(wall, 6),
        "msgs_per_s": round(2 * msgs / wall),  # sub-ops + replies
        "sub_op_bytes": shard_bytes,
        "inflight": inflight,
        "counters": dict(counters, **_counter_ratios(counters)),
    }


def _counter_ratios(c: Dict[str, int]) -> Dict[str, float]:
    acks = c.get("acks_piggybacked", 0) + c.get("acks_standalone", 0)
    return {
        "frames_per_burst": round(
            c["frames_sent"] / c["bursts"], 3) if c.get("bursts") else None,
        "bytes_per_drain": round(
            c["bytes_sent"] / c["drains"], 1) if c.get("drains") else None,
        "ack_piggyback_ratio": round(
            c.get("acks_piggybacked", 0) / acks, 3) if acks else None,
    }


async def _one_cycle(ec, n_osds: int, payloads: Dict[str, bytes],
                     writers: int, *, cork: bool, keyring=None) -> dict:
    from ceph_tpu_torch.osd.storage_bench import (_ledger_delta,
                                                  _ledger_snapshot)

    h = ClusterHarness(ec, n_osds, cork=cork, keyring=keyring)
    await h.start()
    try:
        # warm the CRUSH placement cache outside the timed region (pure
        # host math, identical in both modes -- the wire is what this
        # stage measures; a real cluster computes placement from a
        # long-lived map, not per first-touch)
        for oid in payloads:
            h.objecter.acting_set(oid)
        l0 = _ledger_snapshot()
        write_s = await h.run_writes(payloads, writers)
        l1 = _ledger_snapshot()
        read_s, got = await h.run_reads(payloads, writers)
        l2 = _ledger_snapshot()
        for oid, data in payloads.items():
            if got.get(oid) != data:
                raise AssertionError(
                    f"cluster-path: read-back of {oid} mismatched")
        counters = h.wire_counters()
        shards = h.shard_bytes()
    finally:
        await h.shutdown()
    nbytes = sum(len(p) for p in payloads.values())
    residency = {"write": _ledger_delta(l0, l1),
                 "read": _ledger_delta(l1, l2)}
    return {
        "wall_write_s": round(write_s, 6),
        "wall_read_s": round(read_s, 6),
        "write_MiBs": round(nbytes / write_s / (1 << 20), 3),
        "read_MiBs": round(nbytes / read_s / (1 << 20), 3),
        "counters": dict(counters, **_counter_ratios(counters)),
        "residency": residency,
        "steady_library_builds": (residency["write"]["library_builds"]
                                  + residency["read"]["library_builds"]),
        "_shards": shards,
    }


def run_cluster_path_bench(ec, *, n_objects: int = 64,
                           obj_bytes: int = 16 << 10, writers: int = 8,
                           iters: int = 2, seed: int = 4321,
                           n_osds: Optional[int] = None,
                           keep_shards: bool = False,
                           keep_cycles: bool = False) -> dict:
    """Full comparison: per-message vs corked over real localhost TCP,
    bit-exactness gated (read-back inside every cycle + shard bytes
    compared across modes), best-of-``iters`` walls; returns the
    JSON-ready dict.  ``keep_shards`` adds the corked mode's stored
    shard bytes under ``"_shards"`` (for callers that hold them against
    another codec); ``keep_cycles`` adds every cycle's walls, in run
    order, under ``"_cycles"``: ``(wall_write_s, wall_read_s)`` for
    ``per_message`` and ``corked``, ``wall_write_s`` for
    ``wire_per_message`` and ``wire_corked``."""
    from ceph_tpu_torch.osd.elastic_bench import warm_codec

    codec = wire_codec_name()

    if n_osds is None:
        n_osds = ec.get_chunk_count()
    payloads = make_payloads(n_objects, obj_bytes, seed)
    warm_codec(ec)
    loop = asyncio.new_event_loop()
    best: Dict[str, dict] = {}
    shards: Dict[str, dict] = {}
    cycles: Dict[str, list] = {}
    try:
        for mode, cork in (("per_message", False), ("corked", True)):
            for it in range(max(1, iters)):
                r = loop.run_until_complete(_one_cycle(
                    ec, n_osds, payloads, writers, cork=cork))
                shards[mode] = r.pop("_shards")
                cycles.setdefault(mode, []).append(
                    (r["wall_write_s"], r["wall_read_s"]))
                if mode not in best or \
                        r["wall_write_s"] < best[mode]["wall_write_s"]:
                    best[mode] = r
    finally:
        loop.close()
    # bit-exactness across modes: identical shard bytes, object for
    # object (read-back equality was already gated inside each cycle)
    if set(shards["per_message"]) != set(shards["corked"]):
        raise AssertionError("cluster-path: shard sets differ across modes")
    for key in shards["per_message"]:
        if shards["per_message"][key] != shards["corked"][key]:
            raise AssertionError(
                f"cluster-path: shard {key} differs between corked and "
                "per-message modes")
    # messenger-level wire stage: same fan-out shape (k+m sub-ops +
    # commit replies per op), shard-sized payloads, loaded-primary
    # concurrency -- the corked-vs-per-message architecture isolated
    # from the mode-independent codec/OSD costs above
    k = ec.get_data_chunk_count()
    m = ec.get_chunk_count() - k
    shard_bytes = max(1, obj_bytes // max(1, k))
    wire: Dict[str, dict] = {}
    loop = asyncio.new_event_loop()
    try:
        for mode, cork in (("per_message", False), ("corked", True)):
            for _ in range(max(1, iters)):
                r = loop.run_until_complete(_wire_cycle(
                    ec.get_chunk_count(), 4 * n_objects, shard_bytes,
                    4 * writers, cork=cork))
                cycles.setdefault(f"wire_{mode}", []).append(
                    r["wall_write_s"])
                if mode not in wire or \
                        r["wall_write_s"] < wire[mode]["wall_write_s"]:
                    wire[mode] = r
    finally:
        loop.close()
    per_msg, corked = best["per_message"], best["corked"]
    out = {
        "n_objects": n_objects,
        "obj_bytes": obj_bytes,
        "writers": writers,
        "n_osds": n_osds,
        "k": k,
        "m": m,
        "bit_exact": True,  # the gates raised otherwise
        "per_message": per_msg,
        "corked": corked,
        "write_speedup": round(
            per_msg["wall_write_s"] / corked["wall_write_s"], 3)
        if corked["wall_write_s"] else None,
        "read_speedup": round(
            per_msg["wall_read_s"] / corked["wall_read_s"], 3)
        if corked["wall_read_s"] else None,
        "wire_per_message": wire["per_message"],
        "wire_corked": wire["corked"],
        "wire_write_speedup": round(
            wire["per_message"]["wall_write_s"]
            / wire["corked"]["wall_write_s"], 3)
        if wire["corked"]["wall_write_s"] else None,
        "steady_library_builds": (per_msg["steady_library_builds"]
                                  + corked["steady_library_builds"]),
        "wire_codec": codec,
    }
    if keep_shards:
        out["_shards"] = shards["corked"]
    if keep_cycles:
        out["_cycles"] = cycles
    return out
