"""LoadClient: one simulated application client over an Objecter.

Port of ``ceph_tpu/loadgen/clients.py``.  One deliberate difference: a
closed-loop client with no think time yields to the event loop after
every op, so ops that fail without awaiting anything cannot livelock the
loop (the JAX package's client spins there).

Bounded by construction (the million-client contract): every in-flight
op holds a permit from a per-client budget semaphore
(``loadgen_client_inflight``), so an open-loop client whose arrivals
outrun the cluster parks -- counted as ``arrivals_shed`` -- instead of
accumulating unbounded tasks/futures; the observed in-flight high-water
mark is surfaced as the ``client_inflight_hwm`` perf counter on the
harness-wide PerfCounters.

Each client works an isolated object namespace (``<name>-o<i>``), so a
thousand concurrent clients never write-conflict by construction and
per-client achieved throughput is a clean fairness signal.  The
transactional kinds keep exactly-once books: ``cas_ok``/``exec_ok``
count acked successes, ``indeterminate`` counts ops whose outcome was
lost to a timeout (possible only under chaos), and the scenario runner
closes the loop by reading the final counters back -- the
zero-double-apply gate.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, List, Optional

from ceph_tpu_torch.loadgen.arrival import ClosedLoop, OpenLoop
from ceph_tpu_torch.loadgen.profiles import WorkloadProfile
from ceph_tpu_torch.utils.encoding import Decoder, Encoder

#: per-client latency reservoir bound (the scenario pools these; a
#: million clients x unbounded lists would BE the OOM this module
#: exists to prevent)
LATENCY_RESERVOIR = 128
#: preallocated image bytes for the extent (rbd-style) kinds
IMAGE_BYTES = 64 << 10


@dataclasses.dataclass
class ClientStats:
    ops: int = 0
    errors: int = 0
    bytes_moved: int = 0
    cas_ok: int = 0
    exec_ok: int = 0
    cas_indet: int = 0
    exec_indet: int = 0
    arrivals_shed: int = 0
    by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: bounded latency sample (reservoir past LATENCY_RESERVOIR)
    latencies: List[float] = dataclasses.field(default_factory=list)
    _seen: int = 0

    @property
    def indeterminate(self) -> int:
        return self.cas_indet + self.exec_indet

    def note_latency(self, rng, dt: float) -> None:
        self._seen += 1
        if len(self.latencies) < LATENCY_RESERVOIR:
            self.latencies.append(dt)
        else:
            slot = rng.randrange(self._seen)
            if slot < LATENCY_RESERVOIR:
                self.latencies[slot] = dt


class LoadClient:
    """One profile-driven client; ``objecter`` carries its identity,
    pool and qos_class."""

    def __init__(self, objecter, profile: WorkloadProfile, rng, *,
                 arrival=None, inflight: Optional[int] = None,
                 perf=None, batch_ops: int = 1):
        if inflight is None:
            from ceph_tpu_torch.utils.config import get_config

            inflight = int(get_config().get_val("loadgen_client_inflight"))
        self.objecter = objecter
        self.profile = profile
        self.rng = rng
        #: closed-loop vectorized submit: > 1 gathers this many sampled
        #: ops per cycle and hands the put/get share to
        #: Objecter.submit_many -- one submit stage crossing and one
        #: wire burst per chunk (non-batchable kinds still run
        #: individually, keeping the transactional books exact)
        self.batch_ops = max(1, int(batch_ops))
        self.arrival = arrival if arrival is not None else ClosedLoop()
        self.stats = ClientStats()
        self.perf = perf
        self._budget = asyncio.Semaphore(max(1, inflight))
        self._inflight = 0
        self._inflight_hwm = 0
        self._written: List[str] = []
        self._meta_written = False
        self._image_ready = False
        self._oid_seq = 0
        self._tasks: set = set()

    # -- namespace ----------------------------------------------------------

    @property
    def name(self) -> str:
        return self.objecter.name

    def _data_oid(self, new: bool) -> str:
        if new or not self._written:
            self._oid_seq += 1
            oid = f"{self.name.split('@')[0]}-o{self._oid_seq}"
            return oid
        return self._written[self.rng.randrange(len(self._written))]

    @property
    def _meta_oid(self) -> str:
        return f"{self.name.split('@')[0]}-meta"

    @property
    def _cas_oid(self) -> str:
        return f"{self.name.split('@')[0]}-cnt"

    @property
    def _exec_oid(self) -> str:
        return f"{self.name.split('@')[0]}-exn"

    @property
    def _image_oid(self) -> str:
        return f"{self.name.split('@')[0]}-img"

    # -- one op -------------------------------------------------------------

    async def _do_op(self, kind: str, size: int) -> None:
        ob = self.objecter
        payload = b"L" * size if size else b""
        if kind == "get" and not self._written:
            kind = "put"  # first touch seeds the namespace
        if kind in ("range_write", "range_read") and not self._image_ready:
            await ob.write(self._image_oid, b"\0" * IMAGE_BYTES)
            # concurrent ops of one open-loop client can race the lazy
            # image preallocation; the duplicate write is idempotent and
            # the flag is re-checked yield-free before the store
            if not self._image_ready:
                self._image_ready = True
        if kind == "put":
            # grow the working set to 16 objects before re-writing:
            # CRUSH then spreads every client's demand over all the
            # primaries, which is what lets per-OSD QoS reservations
            # add up to the cluster-wide floor
            oid = self._data_oid(new=len(self._written) < 16)
            await ob.write(oid, payload)
            if oid not in self._written:
                self._written.append(oid)
                del self._written[:-16]  # bounded namespace memory
            self.stats.bytes_moved += size
        elif kind == "get":
            got = await ob.read(self._data_oid(new=False))
            self.stats.bytes_moved += len(got)
        elif kind == "range_write":
            off = self.rng.randrange(max(1, IMAGE_BYTES - size))
            await ob.write_range(self._image_oid, off, payload)
            self.stats.bytes_moved += size
        elif kind == "range_read":
            off = self.rng.randrange(max(1, IMAGE_BYTES - size))
            got = await ob.read_range(self._image_oid, off, size)
            self.stats.bytes_moved += len(got)
        elif kind == "meta_set":
            key = f"k{self.rng.randrange(16)}"
            await ob.omap_set(self._meta_oid, {key: b"v"})
            if not self._meta_written:  # yield-free re-check (racing
                self._meta_written = True  # ops both only ever set it)
        elif kind == "meta_get":
            if not self._meta_written:
                await ob.omap_set(self._meta_oid, {"k0": b"v"})
                if not self._meta_written:
                    self._meta_written = True
            else:
                await ob.omap_get(self._meta_oid)
        elif kind == "cas":
            cur = (await ob.omap_get(self._cas_oid, ["n"])).get("n")
            nxt = Encoder().value(
                (Decoder(cur).value() if cur else 0) + 1).bytes()
            try:
                ok, _seen = await ob.omap_cas(self._cas_oid, "n", cur, nxt)
            except IOError:
                # outcome lost (chaos window): the counter may or may
                # not have advanced -- booked as indeterminate so the
                # exactly-once gate can bound, not guess
                self.stats.cas_indet += 1
                raise
            if ok:
                self.stats.cas_ok += 1
        elif kind == "exec":
            try:
                ret, _out = await ob.exec(self._exec_oid, "version", "inc")
            except IOError:
                self.stats.exec_indet += 1
                raise
            if ret == 0:
                self.stats.exec_ok += 1
        else:
            raise ValueError(f"unknown op kind {kind!r}")

    async def _one_batched(self) -> None:
        """One closed-loop cycle through the vectorized submit: sample
        ``batch_ops`` ops, hand the put/get share to
        ``Objecter.submit_many`` as one batch (per-op outcomes booked
        from its return_exceptions slots), and run the remaining kinds
        -- omap/cas/exec carry their own exactly-once accounting --
        through the per-op path unchanged."""
        batched: List[tuple] = []   # submit_many (kind, oid, fields)
        booked: List[tuple] = []    # (kind, size, oid)
        rest: List[tuple] = []
        for _ in range(self.batch_ops):
            kind, size = self.profile.sample(self.rng)
            if kind == "get" and not self._written:
                kind = "put"  # first touch seeds the namespace
            if kind == "put":
                oid = self._data_oid(new=len(self._written) < 16)
                batched.append(("write", oid,
                                {"data": b"L" * size, "snapc": None}))
                booked.append((kind, size, oid))
            elif kind == "get":
                oid = self._data_oid(new=False)
                batched.append(("read", oid, {"snap": None}))
                booked.append((kind, size, oid))
            else:
                rest.append((kind, size))
        if batched:
            t0 = time.perf_counter()
            results = await self.objecter.submit_many(
                batched, return_exceptions=True)
            dt = time.perf_counter() - t0
            for (kind, size, oid), res in zip(booked, results):
                self.stats.by_kind[kind] = \
                    self.stats.by_kind.get(kind, 0) + 1
                if isinstance(res, asyncio.CancelledError):
                    raise res
                if isinstance(res, BaseException):
                    self.stats.errors += 1
                    continue
                if kind == "put":
                    if oid not in self._written:
                        self._written.append(oid)
                        del self._written[:-16]
                    self.stats.bytes_moved += size
                else:
                    self.stats.bytes_moved += len(res or b"")
                self.stats.ops += 1
                # ops of one batch resolve concurrently: the batch wall
                # IS each op's latency
                self.stats.note_latency(self.rng, dt)
        for kind, size in rest:
            self.stats.by_kind[kind] = self.stats.by_kind.get(kind, 0) + 1
            t0 = time.perf_counter()
            try:
                await self._do_op(kind, size)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 -- chaos makes individual
                # op failures expected; the scenario gates on the books
                self.stats.errors += 1
                continue
            self.stats.ops += 1
            self.stats.note_latency(self.rng, time.perf_counter() - t0)

    async def _one(self) -> None:
        kind, size = self.profile.sample(self.rng)
        self.stats.by_kind[kind] = self.stats.by_kind.get(kind, 0) + 1
        t0 = time.perf_counter()
        try:
            await self._do_op(kind, size)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 -- chaos makes individual op
            # failures expected; the scenario gates on the books
            self.stats.errors += 1
            return
        self.stats.ops += 1
        self.stats.note_latency(self.rng, time.perf_counter() - t0)

    # -- the drive loops ----------------------------------------------------

    def _note_inflight(self, delta: int) -> None:
        self._inflight += delta
        if self._inflight > self._inflight_hwm:
            self._inflight_hwm = self._inflight
            if self.perf is not None:
                self.perf.hwm("client_inflight_hwm", self._inflight_hwm)

    async def run(self, stop: asyncio.Event) -> None:
        """Drive ops until ``stop`` is set, then drain in-flight work."""
        if isinstance(self.arrival, OpenLoop):
            await self._run_open(stop)
        else:
            await self._run_closed(stop)

    async def _run_closed(self, stop: asyncio.Event) -> None:
        while not stop.is_set():
            async with self._budget:
                self._note_inflight(1)
                try:
                    if self.batch_ops > 1:
                        await self._one_batched()
                    else:
                        await self._one()
                finally:
                    self._note_inflight(-1)
            gap = self.arrival.gap(self.rng)
            if gap > 0:
                try:
                    await asyncio.wait_for(stop.wait(), timeout=gap)
                except asyncio.TimeoutError:
                    pass
            else:
                # an op that fails before its first await (no up
                # primary: the objecter raises at once) yields nothing;
                # without this the loop would spin and starve the tasks
                # that could bring an OSD back, and the run's own stop
                await asyncio.sleep(0)

    async def _run_open(self, stop: asyncio.Event) -> None:
        loop = asyncio.get_event_loop()
        while not stop.is_set():
            gap = self.arrival.gap(self.rng)
            if gap > 0:
                try:
                    await asyncio.wait_for(stop.wait(), timeout=gap)
                    break
                except asyncio.TimeoutError:
                    pass
            # bounded fan-out: each spawned op holds a budget permit;
            # an arrival past the budget parks here (and is counted)
            # instead of growing the task set without bound
            if self._budget.locked():
                self.stats.arrivals_shed += 1
            # the permit's ownership TRANSFERS to the spawned op task
            # (_one_open releases it in its finally), so it is held
            # across this loop's parks by design -- the same sanctioned
            # shape as the messenger's dispatch-throttle budget
            await self._budget.acquire()  # cephlint: disable=async-lock-across-await
            spawned = False
            try:
                self._note_inflight(1)
                task = loop.create_task(self._one_open())
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                spawned = True
            finally:
                if not spawned:  # failed spawn must not leak the permit
                    self._note_inflight(-1)
                    self._budget.release()
        if self._tasks:
            await asyncio.wait(self._tasks, timeout=10.0)

    async def _one_open(self) -> None:
        try:
            await self._one()
        finally:
            self._note_inflight(-1)
            self._budget.release()
